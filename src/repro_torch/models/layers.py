"""Shared layers: norms, RoPE, GQA projections, the full-sequence attention
block of the training forward, the dense and paged KV writes, the dense and
paged decode / chunked-prefill attention blocks, the paged chunk-verify and
tree-verify block of speculative decoding, SwiGLU MLP.

Counterpart of ``repro.models.layers``: plain functions over explicit
parameter dicts that keep the reference's names and layouts.  Where the
reference returns a new KV pool or cache, these functions update its
tensors IN PLACE (the reference's jit donates them) and return them.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

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
    cfg: ModelConfig, dtype: torch.dtype, device: torch.device
) -> Optional[torch.Tensor]:
    """[H_phys] 1/0 mask selecting real q-head slots (None when unpadded).
    Slot ``s`` is real iff ``s % group_phys`` is below the logical group
    size, keeping GQA's head -> kv mapping exact."""
    if not cfg.padded_heads:
        return None
    kv = max(cfg.num_kv_heads, 1)
    group_phys = cfg.num_heads_physical // kv
    group_log = cfg.num_heads // kv
    m = (torch.arange(cfg.num_heads_physical, device=device) % group_phys) < group_log
    return m.to(dtype)


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
    """Mask padded head slots, then einsum("bshk,hkd->bsd")."""
    mask = head_mask(cfg, out.dtype, out.device)
    if mask is not None:
        out = out * mask[None, None, :, None]
    h, k, d = p["wo"].shape
    return out.reshape(*out.shape[:-2], h * k) @ p["wo"].reshape(h * k, d)


def attention_block(
    cfg: ModelConfig, p: Params, x: torch.Tensor, *, impl: str = "auto"
) -> torch.Tensor:
    """Full-sequence causal attention (train).  x: [B, S, d] at positions
    0 .. S-1; the core is ``ops.attention`` (the flash kernel on CUDA);
    padded head slots are zeroed (and so are their gradients)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(cfg, p, x, positions)
    out = ops.attention(q, k, v, causal=True, impl=impl)
    return _out_proj(cfg, p, out)


def dense_kv_write_clamped(
    cache: torch.Tensor, new: torch.Tensor, positions: torch.Tensor
) -> torch.Tensor:
    """Write one K/V row per slot into a dense cache, in place, with JAX's
    ``dynamic_update_slice`` rule: the start clamps into [0, S - 1], so a
    write past the end lands on the last row.  cache: [B, S, kvH, hd]; new:
    [B, 1, kvH, hd]; positions: [B]."""
    s = cache.shape[1]
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, positions.long().clamp(0, s - 1)] = new[:, 0].to(cache.dtype)
    return cache


def dense_kv_write_dropped(
    cache: torch.Tensor, new: torch.Tensor, positions: torch.Tensor,
    valid: torch.Tensor,
) -> torch.Tensor:
    """Scatter chunk K/V rows into a dense cache, in place, with JAX's
    ``mode="drop"`` rule: rows not ``valid`` and rows at positions past the
    end are dropped, never clamped onto live entries.  cache: [B, S, kvH,
    hd]; new: [B, C, kvH, hd]; positions / valid: [B, C].  The boolean
    selection costs one device -> host sync."""
    keep = valid & (positions < cache.shape[1])
    rows = torch.arange(cache.shape[0], device=cache.device)[:, None].expand_as(keep)
    cache[rows[keep], positions.long()[keep]] = new[keep].to(cache.dtype)
    return cache


def paged_kv_write(
    pool: torch.Tensor,
    new: torch.Tensor,
    block_tables: torch.Tensor,
    positions: torch.Tensor,
) -> torch.Tensor:
    """Scatter new K/V rows into the paged pool through the block table, in
    place.

    pool: [P, page, kvH, hd]; new: [B, T, kvH, hd]; block_tables: [B, W]
    int32; positions: [B, T] logical positions.  Positions whose logical page
    falls past the table width clamp onto the last column, which the engine
    keeps at the sentinel page: overflow writes land there instead of on
    live pages."""
    page = pool.shape[1]
    w = block_tables.shape[1]
    positions = positions.long()
    cols = torch.clamp(positions // page, max=w - 1)
    pages = torch.gather(block_tables.long(), 1, cols)  # [B, T]
    pool[pages, positions % page] = new.to(pool.dtype)
    return pool


def attention_decode_paged(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,
    kv_pool: tuple[torch.Tensor, torch.Tensor],
    block_tables: torch.Tensor,
    cache_index: torch.Tensor,
    *,
    impl: str = "auto",
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """One-token decode against the paged KV pool.

    x: [B, 1, d]; pool k/v: [P, page, kvH, hd]; block_tables: [B, W] int32;
    cache_index: [B] int32 per-slot lengths.  The new token's K/V is written
    in place at ``index``, then the attention core reads the slot's pages
    through the block table (``ops.paged_decode_attention``)."""
    b = x.shape[0]
    idx = cache_index.to(torch.int32).expand(b)
    positions = idx[:, None]
    q, k_new, v_new = _project_qkv(cfg, p, x, positions)
    k_pool, v_pool = kv_pool
    paged_kv_write(k_pool, k_new, block_tables, positions)
    paged_kv_write(v_pool, v_new, block_tables, positions)
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
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Chunked-prefill step against the paged KV pool.

    x: [B, C, d] chunk embeddings.  The chunk's real K/V is written in place
    at logical positions ``index .. index + chunk_lens - 1``; pad rows go to
    position ``W * page``, which clamps onto the sentinel column (a write
    sink nobody attends to).  Then each real row attends the slot's earlier
    pages (radix-shared ones included) plus the chunk's causal triangle
    (``ops.paged_prefill_chunk_attention``)."""
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
    paged_kv_write(k_pool, k_new, block_tables, pos_w)
    paged_kv_write(v_pool, v_new, block_tables, pos_w)
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
    q, k_new, v_new = _project_qkv(cfg, p, x, idx[:, None])
    k_cache, v_cache = kv_cache
    dense_kv_write_clamped(k_cache, k_new, idx)
    dense_kv_write_clamped(v_cache, v_new, idx)
    out = ops.decode_attention(
        q[:, 0].contiguous(), k_cache, v_cache, idx + 1, impl=impl
    )[:, None]
    return _out_proj(cfg, p, out), (k_cache, v_cache)


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


def attention_verify_paged(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,
    kv_pool: tuple[torch.Tensor, torch.Tensor],
    block_tables: torch.Tensor,
    cache_index: torch.Tensor,
    *,
    impl: str = "auto",
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
    (``ops.paged_tree_verify_attention``)."""
    b, t, _ = x.shape
    idx = cache_index.to(torch.int32).expand(b)
    pos_w = idx[:, None] + torch.arange(t, dtype=torch.int32, device=x.device)[None, :]
    if depths is None:
        positions = pos_w
    else:
        positions = idx[:, None] + depths.to(torch.int32)[None, :]
    q, k_new, v_new = _project_qkv(cfg, p, x, positions)
    k_pool, v_pool = kv_pool
    paged_kv_write(k_pool, k_new, block_tables, pos_w)
    paged_kv_write(v_pool, v_new, block_tables, pos_w)
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
    g = x @ p["wg"]
    u = x @ p["wu"]
    return (F.silu(g) * u) @ p["wd"]
