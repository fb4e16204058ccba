"""Shared layers: norms, RoPE, GQA projections, the full-sequence attention
block of the training forward, the dense and paged KV writes, the dense and
paged decode / chunked-prefill attention blocks, the dense and paged
chunk-verify and tree-verify blocks of speculative decoding, SwiGLU MLP.

Counterpart of ``repro.models.layers``: plain functions over explicit
parameter dicts that keep the reference's names and layouts.  Where the
reference returns a new KV pool or cache, these functions update its
tensors IN PLACE (the reference's jit donates them) and return them.

Under an ``act_sharding`` context on a model axis larger than 1 the
attention and MLP blocks run Megatron-style on this rank's weight blocks:
the local head counts come from the local weights' shapes, a rank whose q
heads split while the KV heads do not uses the KV heads its q heads map to
(a split across a GQA group raises), and the row-parallel output is summed
over ``model``.  The dense decode on a sequence-split cache attends its
block with #3's partial form and merges the blocks' partials
(``attention_decode``).
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import act_sharding as AS

Params = Any


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(
    x: torch.Tensor, weight: Optional[torch.Tensor], eps: float = 1e-6
) -> torch.Tensor:
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    if weight is not None:
        y = y * weight.float()
    return y.to(x.dtype)


def layer_norm(
    x: torch.Tensor, weight: Optional[torch.Tensor], eps: float = 1e-5
) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    return y.to(x.dtype)


def norm(
    cfg: ModelConfig, x: torch.Tensor, weight: Optional[torch.Tensor]
) -> torch.Tensor:
    if cfg.norm_type == "layernorm":
        return layer_norm(x, weight if cfg.parametric_norm else None)
    return rms_norm(x, weight if cfg.parametric_norm else None)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(
    head_dim: int, theta: float, device: torch.device
) -> torch.Tensor:
    """Inverse frequencies, shape [head_dim // 2], fp32."""
    exponent = (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
        / head_dim
    )
    return 1.0 / (theta**exponent)


def apply_rope(
    x: torch.Tensor, positions: torch.Tensor, theta: float
) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: broadcastable to [..., S].  Split-half
    rotation with fp32 angles, as the reference."""
    hd = x.shape[-1]
    inv_freq = rope_frequencies(hd, theta, x.device)
    angles = positions[..., None].float() * inv_freq  # [..., S, hd/2]
    cos = torch.cos(angles)[..., None, :]  # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention: projections, paged KV write, paged cores
# ---------------------------------------------------------------------------


def head_mask(
    cfg: ModelConfig, dtype: torch.dtype, device: torch.device,
    start: int = 0, count: Optional[int] = None,
) -> Optional[torch.Tensor]:
    """1/0 mask selecting the real q-head slots ``start .. start + count -
    1`` of the ``H_phys`` (None when unpadded; ``count`` defaults to all).
    Slot ``s`` is real iff ``s % group_phys`` is below the logical group
    size, keeping GQA's head -> kv mapping exact."""
    if not cfg.padded_heads:
        return None
    kv = max(cfg.num_kv_heads, 1)
    group_phys = cfg.num_heads_physical // kv
    group_log = cfg.num_heads // kv
    count = cfg.num_heads_physical - start if count is None else count
    m = (torch.arange(start, start + count, device=device) % group_phys) < group_log
    return m.to(dtype)


def local_heads(cfg: ModelConfig, p: Params) -> tuple[int, int]:
    """(first physical q head, q heads) of this rank's ``wq`` block: its
    model-rank's block when the heads split, else all of them."""
    n = p["wq"].shape[1]
    return (AS.model_rank() * n if n < cfg.num_heads_physical else 0), n


def _local_kv(cfg: ModelConfig, p: Params, k: torch.Tensor, v: torch.Tensor) -> tuple:
    """The KV heads this rank's q heads read, [.., kvH, hd] -> [.., n, hd]:
    all of ``k`` / ``v`` unless the q heads split and the KV heads do not
    (``wk`` whole); then the heads of the q block's GQA groups, which must
    hold whole groups or lie inside one."""
    h0, n = local_heads(cfg, p)
    kvh = cfg.num_kv_heads
    if n == cfg.num_heads_physical or k.shape[-2] < kvh:
        return k, v
    group = cfg.num_heads_physical // kvh
    if n % group and group % n:
        raise ValueError(
            f"{cfg.name}: {n} q heads a rank split its GQA groups of {group} "
            f"(q heads {h0} .. {h0 + n - 1} over {kvh} KV heads)")
    lo, hi = h0 // group, (h0 + n - 1) // group + 1
    return k[..., lo:hi, :], v[..., lo:hi, :]


def init_attention(
    cfg: ModelConfig, gen: torch.Generator, d_model: int, dtype: torch.dtype
) -> Params:
    """Same shapes and scales as ``repro.models.layers.init_attention``; the
    numbers come from ``gen``, not from JAX's PRNG."""
    hd = cfg.resolved_head_dim
    h = cfg.num_heads_physical
    dev = gen.device
    scale = d_model**-0.5

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    p = {
        "wq": normal(d_model, h, hd) * scale,
        "wk": normal(d_model, cfg.num_kv_heads, hd) * scale,
        "wv": normal(d_model, cfg.num_kv_heads, hd) * scale,
        "wo": normal(h, hd, d_model) * (cfg.num_heads * hd) ** -0.5,
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((cfg.num_kv_heads, hd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((cfg.num_kv_heads, hd), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul over the flattened heads."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _project_qkv(
    cfg: ModelConfig, p: Params, x: torch.Tensor, positions: torch.Tensor
):
    """q/k/v projections, optional bias, qk-norm BEFORE RoPE."""
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(
    cfg: ModelConfig, p: Params, out: torch.Tensor
) -> torch.Tensor:
    """Mask padded head slots, then einsum("bshk,hkd->bsd") over this
    rank's heads, summed over ``model`` when the heads split."""
    h0, n = local_heads(cfg, p)
    mask = head_mask(cfg, out.dtype, out.device, h0, n)
    if mask is not None:
        out = out * mask[None, None, :, None]
    h, k, d = p["wo"].shape
    y = out.reshape(*out.shape[:-2], h * k) @ p["wo"].reshape(h * k, d)
    return AS.reduce_from_model(y) if AS.split("bthd") else y


def tp_entry(x: torch.Tensor, kind: str) -> torch.Tensor:
    """``x`` entering a block whose ``kind`` activations split over
    ``model``: ``copy_to_model`` there, else ``x`` as it is."""
    return AS.copy_to_model(x) if AS.split(kind) else x


def attention_block(
    cfg: ModelConfig, p: Params, x: torch.Tensor, *, impl: str = "auto"
) -> torch.Tensor:
    """Full-sequence causal attention (train).  x: [B, S, d] at positions
    0 .. S-1; the core is ``ops.attention`` (the flash kernel on CUDA);
    padded head slots are zeroed (and so are their gradients)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(cfg, p, tp_entry(x, "bthd"), positions)
    k, v = _local_kv(cfg, p, k, v)
    out = ops.attention(q, k, v, causal=True, impl=impl)
    return _out_proj(cfg, p, out)


#: the 8-bit cache types (the serve steps' ``cache_dtype``)
FP8_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)
#: float8_e4m3fn's rounding midpoint past its largest value (448): JAX's
#: cast turns a larger magnitude into NaN, torch's saturates it to 448
_E4M3_OVERFLOW = 464.0


def to_cache(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` cast to a cache's ``dtype`` as JAX's ``astype`` casts it.  A
    plain ``.to`` but for the codes where torch differs: into float8_e4m3fn
    a magnitude above 464 (infinities included) becomes a NaN of its sign,
    where torch saturates to +-448; into float8_e5m2 a NaN becomes JAX's
    code (from fp32: 0x7e of its sign; from bf16: 0x7f; torch keeps 0x7f of
    its sign).  Bit for bit equal to JAX's cast elsewhere (the port's CPU
    tests hold it to ``jnp.astype``)."""
    y = x.to(dtype)
    if dtype == torch.float8_e4m3fn:
        bad, sign, nan = x.abs() > _E4M3_OVERFLOW, 0x80, 0x7F
    elif dtype == torch.float8_e5m2:
        bad = torch.isnan(x)
        sign, nan = (0x80, 0x7E) if x.dtype == torch.float32 else (0, 0x7F)
    else:
        return y
    code = y.view(torch.uint8)
    return torch.where(bad, (code & sign) | nan, code).view(dtype)


def cache_bytes(t: torch.Tensor) -> torch.Tensor:
    """An 8-bit cache tensor as its ``uint8`` codes (a view; other dtypes as
    they are): index writes, selects and collectives move the codes bit for
    bit where a float8 kernel is missing (gloo has none, for one)."""
    return t.view(torch.uint8) if t.dtype in FP8_DTYPES else t


def dense_kv_write_clamped(
    cache: torch.Tensor, new: torch.Tensor, starts: torch.Tensor
) -> torch.Tensor:
    """Write T consecutive K/V rows per slot into a dense cache, in place,
    with JAX's ``dynamic_update_slice`` rule: the start clamps into
    [0, S - T], so a write that would run past the end lands shifted back,
    on the last T rows.  cache: [B, S, kvH, hd]; new: [B, T, kvH, hd];
    starts: [B].  The rows are cast by ``to_cache``."""
    b, t = new.shape[:2]
    s = cache.shape[1]
    start = starts.long().clamp(0, s - t)
    rows = torch.arange(b, device=cache.device)[:, None]
    pos = start[:, None] + torch.arange(t, device=cache.device)[None, :]
    cache_bytes(cache)[rows, pos] = cache_bytes(to_cache(new, cache.dtype))
    return cache


def dense_kv_write_dropped(
    cache: torch.Tensor, new: torch.Tensor, positions: torch.Tensor,
    valid: torch.Tensor,
) -> torch.Tensor:
    """Scatter chunk K/V rows into a dense cache, in place, with JAX's
    ``mode="drop"`` rule: a negative position counts from the end, and rows
    not ``valid`` or still outside [0, S) are dropped, never clamped onto
    live entries.  cache: [B, S, kvH, hd]; new: [B, C, kvH, hd]; positions /
    valid: [B, C].

    No host sync and no data-dependent shape (a captured graph holds it):
    every row is written, a dropped one as a copy of a kept write of its
    slot (its first: the same row, the same value), or, in a slot with no
    kept row, as the entry's own value written back (no other row of the
    batch writes there).  Colliding writes then carry one value, so which
    lands does not matter."""
    b, c = positions.shape
    s = cache.shape[1]
    pos = positions.long()
    pos = torch.where(pos < 0, pos + s, pos)
    keep = valid & (pos >= 0) & (pos < s)
    rows = torch.arange(b, device=cache.device)[:, None]
    new = new.to(cache.dtype)
    first = torch.argmax(keep.to(torch.int32), dim=1, keepdim=True)  # [B, 1]
    any_keep = keep.any(dim=1, keepdim=True)
    spare = torch.where(any_keep, torch.gather(pos, 1, first), pos[:, :1].clamp(0, s - 1))
    first_row = torch.gather(new, 1, first[..., None, None].expand(b, 1, *new.shape[2:]))
    spare_row = torch.where(any_keep[..., None, None], first_row, cache[rows, spare])
    dest = torch.where(keep, pos, spare)
    cache[rows.expand(b, c), dest] = torch.where(keep[..., None, None], new, spare_row)
    return cache


def device_scalar(v, device) -> torch.Tensor:
    """``v`` (a Python number or a tensor) as a tensor on ``device``: a
    number is filled in on the device, not made on the host and copied
    over (a copy a CUDA graph cannot capture)."""
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.full((), v, device=device)


def last_writers(dest: torch.Tensor, rows: int) -> torch.Tensor:
    """dest: [N] flat destination rows in ``0 .. rows - 1``.  For each entry,
    the index of the last entry bound for the same row: gathering the
    values through it before a scatter makes every colliding write carry
    the value the reference's scatter keeps on the CPU.  O(N + rows), no
    host sync."""
    order = torch.arange(dest.numel(), device=dest.device)
    last = torch.full((rows,), -1, dtype=torch.long, device=dest.device)
    return last.scatter_reduce_(0, dest, order, "amax")[dest]


def paged_kv_write(
    pools: tuple[torch.Tensor, ...],
    news: tuple[torch.Tensor, ...],
    block_tables: torch.Tensor,
    positions: torch.Tensor,
    plan: Optional[dict] = None,
) -> tuple[torch.Tensor, ...]:
    """Scatter new K/V rows into the paged pools through the block table, in
    place: ``news[i]`` into ``pools[i]`` (a layer's K and V share one set of
    destinations).

    pools: each [P, page, kvH, hd]; news: each [B, T, kvH, hd];
    block_tables: [B, W] int32; positions: [B, T] logical positions.
    Positions whose logical page falls past the table width clamp onto the
    last column, which the engine keeps at the sentinel page: overflow
    writes land there instead of on live pages.

    Rows can land on one pool row: idle slots on the sentinel page, a
    chunk's rows past the slot's pages.  Which of them a plain scatter keeps
    is unspecified, so every row first takes the value of the last row (in
    row-major order) bound for its pool row, as the reference's scatter
    keeps on the CPU: whichever write lands, the result is the same.  The
    MoE family needs that, since the rows that read such a pool row (an
    idle slot's decode, a verify chunk's padding) share expert capacity
    with live rows.  O(B T) work and no host sync, so a captured decode
    graph holds it.

    ``plan``, a dict shared by the layers of one model step (they write the
    same positions through the same table), keeps the destinations and
    their resolution from the first layer's write for the others."""
    if plan is None:
        plan = {}
    if not plan:
        page = pools[0].shape[1]
        w = block_tables.shape[1]
        positions = positions.long()
        cols = torch.clamp(positions // page, max=w - 1)
        pages = torch.gather(block_tables.long(), 1, cols)  # [B, T]
        offs = positions % page
        plan.update(pages=pages, offs=offs, src=last_writers(
            (pages * page + offs).reshape(-1), pools[0].shape[0] * page))
    pages, offs, src = plan["pages"], plan["offs"], plan["src"]
    for pool, new in zip(pools, news):
        rows = new.reshape(src.numel(), *new.shape[2:])[src]
        pool[pages, offs] = rows.reshape(new.shape).to(pool.dtype)
    return pools


def attention_decode_paged(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,
    kv_pool: tuple[torch.Tensor, torch.Tensor],
    block_tables: torch.Tensor,
    cache_index: torch.Tensor,
    *,
    impl: str = "auto",
    plan: Optional[dict] = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """One-token decode against the paged KV pool.

    x: [B, 1, d]; pool k/v: [P, page, kvH, hd]; block_tables: [B, W] int32;
    cache_index: [B] int32 per-slot lengths.  The new token's K/V is written
    in place at ``index``, then the attention core reads the slot's pages
    through the block table (``ops.paged_decode_attention``).  ``plan``:
    as ``paged_kv_write``."""
    b = x.shape[0]
    idx = cache_index.to(torch.int32).expand(b)
    positions = idx[:, None]
    q, k_new, v_new = _project_qkv(cfg, p, x, positions)
    k_pool, v_pool = kv_pool
    paged_kv_write((k_pool, v_pool), (k_new, v_new), block_tables, positions, plan)
    out = ops.paged_decode_attention(
        q[:, 0].contiguous(), k_pool, v_pool, block_tables, idx + 1, impl=impl
    )[:, None]
    return _out_proj(cfg, p, out), (k_pool, v_pool)


def attention_prefill_chunk_paged(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,
    kv_pool: tuple[torch.Tensor, torch.Tensor],
    block_tables: torch.Tensor,
    cache_index: torch.Tensor,
    chunk_lens: torch.Tensor,
    *,
    impl: str = "auto",
    plan: Optional[dict] = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Chunked-prefill step against the paged KV pool.

    x: [B, C, d] chunk embeddings.  The chunk's real K/V is written in place
    at logical positions ``index .. index + chunk_lens - 1``; pad rows go to
    position ``W * page``, which clamps onto the sentinel column (a write
    sink nobody attends to).  Then each real row attends the slot's earlier
    pages (radix-shared ones included) plus the chunk's causal triangle
    (``ops.paged_prefill_chunk_attention``).  ``plan``: as
    ``paged_kv_write``."""
    b, c, _ = x.shape
    idx = cache_index.to(torch.int32).expand(b)
    steps = torch.arange(c, dtype=torch.int32, device=x.device)
    positions = idx[:, None] + steps[None, :]  # [B, C]
    q, k_new, v_new = _project_qkv(cfg, p, x, positions)
    k_pool, v_pool = kv_pool
    page = k_pool.shape[1]
    w = block_tables.shape[1]
    valid = steps[None, :] < chunk_lens[:, None]
    pos_w = torch.where(valid, positions, torch.full_like(positions, w * page))
    paged_kv_write((k_pool, v_pool), (k_new, v_new), block_tables, pos_w, plan)
    out = ops.paged_prefill_chunk_attention(
        q.contiguous(), k_pool, v_pool, block_tables, idx, chunk_lens,
        impl=impl,
    )
    return _out_proj(cfg, p, out), (k_pool, v_pool)


def attention_decode(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,
    kv_cache: tuple[torch.Tensor, torch.Tensor],
    cache_index: torch.Tensor,
    *,
    impl: str = "auto",
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """One-token decode against a dense cache.  x: [B, 1, d]; cache k/v:
    [B, S, kvH, hd]; cache_index: [B] int32 per-slot lengths.  The token's
    K/V is written in place at ``index`` clamped into [0, S - 1] (the
    reference's ``dynamic_update_slice``), then ``ops.decode_attention``
    attends ``index + 1`` keys (clamped to S by the kernel)."""
    b = x.shape[0]
    idx = cache_index.to(torch.int32).expand(b)
    q, k_new, v_new = _project_qkv(cfg, p, tp_entry(x, "bthd"), idx[:, None])
    k_cache, v_cache = kv_cache
    if AS.seq_parallel():
        out = _decode_seq_parallel(cfg, p, q[:, 0], k_new, v_new, k_cache, v_cache, idx,
                                   impl)
        return _out_proj(cfg, p, out[:, None]), (k_cache, v_cache)
    dense_kv_write_clamped(k_cache, k_new, idx)
    dense_kv_write_clamped(v_cache, v_new, idx)
    out = ops.decode_attention(
        q[:, 0].contiguous(), k_cache, v_cache, idx + 1, impl=impl
    )[:, None]
    return _out_proj(cfg, p, out), (k_cache, v_cache)


def _decode_seq_parallel(cfg, p, q, k_new, v_new, k_cache, v_cache, idx, impl):
    """The dense decode on a cache whose sequence dim splits over the
    context's sequence axes (the reference's ``cache_specs`` when the KV
    heads do not divide ``model``): this rank holds rows r * S/n .. of every
    slot.  The token's K/V lands on the rank that owns its position (the
    reference's clamp into [0, S - 1]); the others write the entry's own
    value back (no host sync, no live entry changed).  The q heads (tiny)
    are all-gathered over ``model`` when they split and the cache holds
    every KV head; each rank runs #3's partial form over its block (a row's
    length ``clamp(idx + 1 - r * S/n, 0, S/n)``), the blocks' partials are
    all-gathered and merged (``paged::combine_splits``), and the rank keeps
    its q heads.  q: [B, h, hd] -> [B, h, hd]."""
    r, n = AS.seq_block()
    b, s_loc = k_cache.shape[:2]
    pos = idx.long().clamp(0, n * s_loc - 1) - r * s_loc
    own = ((pos >= 0) & (pos < s_loc))[:, None, None]
    pos = pos.clamp(0, s_loc - 1)
    rows = torch.arange(b, device=k_cache.device)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        codes = cache_bytes(cache)
        codes[rows, pos] = torch.where(own, cache_bytes(to_cache(new[:, 0], cache.dtype)),
                                       codes[rows, pos])
    h0, h = local_heads(cfg, p)
    if h < cfg.num_heads_physical and k_cache.shape[2] == cfg.num_kv_heads:
        q = AS.all_gather_model(q, 1)
    else:
        h0 = 0
    lengths = (idx + 1 - r * s_loc).clamp(0, s_loc).to(torch.int32)
    acc, ml = ops.decode_attention_partial(q.contiguous(), k_cache, v_cache, lengths,
                                           impl=impl)
    out = ops.combine_decode_partials(AS.gather_seq(acc), AS.gather_seq(ml), q.dtype,
                                      impl=impl)
    return out[:, h0:h0 + h]


def attention_prefill_chunk(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,
    kv_cache: tuple[torch.Tensor, torch.Tensor],
    cache_index: torch.Tensor,
    chunk_lens: torch.Tensor,
    *,
    impl: str = "auto",
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Chunked-prefill step against a dense cache.  x: [B, C, d]; cache
    k/v: [B, S, kvH, hd].  The chunk's real K/V is written in place at
    ``index .. index + chunk_lens - 1``; pad rows and rows past S are
    dropped (the reference's ``mode="drop"``).  Then each real row attends
    the prefix plus the chunk's causal triangle
    (``ops.prefill_chunk_attention``)."""
    b, c, _ = x.shape
    idx = cache_index.to(torch.int32).expand(b)
    steps = torch.arange(c, dtype=torch.int32, device=x.device)
    positions = idx[:, None] + steps[None, :]  # [B, C]
    q, k_new, v_new = _project_qkv(cfg, p, x, positions)
    k_cache, v_cache = kv_cache
    valid = steps[None, :] < chunk_lens[:, None]
    dense_kv_write_dropped(k_cache, k_new, positions, valid)
    dense_kv_write_dropped(v_cache, v_new, positions, valid)
    out = ops.prefill_chunk_attention(
        q.contiguous(), k_cache, v_cache, idx, chunk_lens, impl=impl
    )
    return _out_proj(cfg, p, out), (k_cache, v_cache)


def attention_verify(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,
    kv_cache: tuple[torch.Tensor, torch.Tensor],
    cache_index: torch.Tensor,
    *,
    impl: str = "auto",
    anc: Optional[torch.Tensor] = None,
    depths: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Chunk-verify decode against a dense cache: T tokens in one pass.

    x: [B, T, d] chunk embeddings; cache k/v: [B, S, kvH, hd]; cache_index:
    [B] int32 per-slot prefix lengths.  The chunk's K/V is written in place
    at rows ``index .. index + T - 1`` with the start clamped into [0, S - T]
    (the reference's ``dynamic_update_slice``), then each row attends the
    prefix plus the chunk's causal triangle (``ops.verify_attention``, at
    ``lengths = index + T``).  Rollback after acceptance only rewinds
    ``index``.

    Tree mode (``anc`` [B, T] int32 + ``depths`` [T] int32): node j's RoPE
    position is ``index + depths[j]``, its K/V still lands at row
    ``index + j``, and the ancestor bitmasks select what each node sees
    (``ops.tree_verify_attention``)."""
    b, t, _ = x.shape
    idx = cache_index.to(torch.int32).expand(b)
    offs = (torch.arange(t, dtype=torch.int32, device=x.device) if depths is None
            else depths.to(torch.int32))
    q, k_new, v_new = _project_qkv(cfg, p, x, idx[:, None] + offs[None, :])
    k_cache, v_cache = kv_cache
    dense_kv_write_clamped(k_cache, k_new, idx)
    dense_kv_write_clamped(v_cache, v_new, idx)
    q = q.contiguous()
    if anc is None:
        out = ops.verify_attention(q, k_cache, v_cache, idx + t, impl=impl)
    else:
        out = ops.tree_verify_attention(q, k_cache, v_cache, idx + t, anc, impl=impl)
    return _out_proj(cfg, p, out), (k_cache, v_cache)


def attention_verify_paged(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,
    kv_pool: tuple[torch.Tensor, torch.Tensor],
    block_tables: torch.Tensor,
    cache_index: torch.Tensor,
    *,
    impl: str = "auto",
    plan: Optional[dict] = None,
    anc: Optional[torch.Tensor] = None,
    depths: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Chunk-verify decode against the paged KV pool: T tokens in one pass.

    x: [B, T, d] chunk embeddings.  The chunk's K/V is written in place at
    logical positions ``index .. index + T - 1`` (past the table width they
    clamp onto the sentinel column), then each row attends the prefix plus
    the chunk's causal triangle (``ops.paged_verify_attention``).  Rollback
    after acceptance only rewinds ``index``.

    Tree mode (``anc`` [B, T] int32 + ``depths`` [T] int32): node j's RoPE
    position is ``index + depths[j]`` so siblings rotate alike, its K/V
    still lands at node-index position ``index + j``, and the ancestor
    bitmasks select what each node sees
    (``ops.paged_tree_verify_attention``).  ``plan``: as
    ``paged_kv_write``."""
    b, t, _ = x.shape
    idx = cache_index.to(torch.int32).expand(b)
    pos_w = idx[:, None] + torch.arange(t, dtype=torch.int32, device=x.device)[None, :]
    if depths is None:
        positions = pos_w
    else:
        positions = idx[:, None] + depths.to(torch.int32)[None, :]
    q, k_new, v_new = _project_qkv(cfg, p, x, positions)
    k_pool, v_pool = kv_pool
    paged_kv_write((k_pool, v_pool), (k_new, v_new), block_tables, pos_w, plan)
    q = q.contiguous()
    if anc is None:
        out = ops.paged_verify_attention(
            q, k_pool, v_pool, block_tables, idx + t, impl=impl
        )
    else:
        out = ops.paged_tree_verify_attention(
            q, k_pool, v_pool, block_tables, idx + t, anc, impl=impl
        )
    return _out_proj(cfg, p, out), (k_pool, v_pool)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(
    gen: torch.Generator, d_model: int, d_ff: int, dtype: torch.dtype
) -> Params:
    dev = gen.device

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    return {
        "wg": normal(d_model, d_ff) * d_model**-0.5,
        "wu": normal(d_model, d_ff) * d_model**-0.5,
        "wd": normal(d_ff, d_model) * d_ff**-0.5,
    }


def mlp_block(p: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU; column-parallel ``wg`` / ``wu`` and row-parallel ``wd`` when
    the hidden dim splits over ``model`` (one all-reduce each way)."""
    tp = AS.split("btf")
    x = AS.copy_to_model(x) if tp else x
    g = x @ p["wg"]
    u = x @ p["wu"]
    y = (F.silu(g) * u) @ p["wd"]
    return AS.reduce_from_model(y) if tp else y
