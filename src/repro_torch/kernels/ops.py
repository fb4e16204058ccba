"""Dispatch over the kernels: full-sequence (training and monolithic
prefill) attention, the dense and paged decode / chunked-prefill cores, the
dense and paged chunk-verify / tree-verify cores of speculative decoding,
and the Mamba1 selective scan (forward and backward).

Same signatures and defined outputs as ``repro.kernels.ops``'s entry
points.  ``impl``:

  * "auto"  -- the CUDA kernel for CUDA tensors, the plain PyTorch version
               for CPU tensors (the only reason the plain version runs);
  * "torch" -- force the plain version (the reference the kernel is held to);
  * "cuda"  -- force the kernel; raises on CPU tensors.

A CUDA tensor never falls back to the plain version: a kernel that fails to
build or launch raises.

While a counting mode is active (``launch.cost.CountingMode``, which pushes
itself on ``COUNTING``), an entry point under "auto" or "cuda" records its
kernels' cost as the card launches them (``kernels/cost.py``) and returns
outputs of the right shape, allocated but not computed: no kernel and no
plain version runs.  "torch" (the caller's or the mode's) still runs the
plain version, whose ops the mode counts one by one.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cost as _cost
from repro_torch.kernels import decode_attention as _dense_decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import paged_decode_attention as _decode
from repro_torch.kernels import paged_prefill_attention as _prefill
from repro_torch.kernels import paged_tree_verify_attention as _tree
from repro_torch.kernels import paged_verify_attention as _verify
from repro_torch.kernels import prefill_attention as _dense_prefill
from repro_torch.kernels import ssm_scan as _ssm
from repro_torch.kernels import tree_verify_attention as _dense_tree
from repro_torch.kernels import verify_attention as _dense_verify

IMPLS = ("auto", "torch", "cuda")

#: the active counting modes, innermost last (``launch.cost``)
COUNTING: list = []


def _resolve(impl: str, q: torch.Tensor) -> str:
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; known: {IMPLS}")
    if impl == "auto":
        return "cuda" if q.is_cuda else "torch"
    return impl


def _counting(impl: str):
    """The counting mode that takes this call's kernels, or None (none is
    active, or the caller or the mode asks for the plain version)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; known: {IMPLS}")
    if not COUNTING or impl == "torch" or COUNTING[-1].impl == "torch":
        return None
    return COUNTING[-1]


class _CountedFlash(torch.autograd.Function):
    """``flash_attention.FlashAttention`` under a counting mode: records
    the forward's and the backward's launches and allocates what they do
    (out and the log-sum-exp, saved for the backward; D, dq, dk, dv
    there), computing nothing."""

    @staticmethod
    def forward(ctx, q, k, v, causal, counter):
        out = counter.launch(_cost.flash_fwd(q, k, v, causal), torch.empty_like(q))
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.counter = causal, counter
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, _, lse = ctx.saved_tensors
        dout.contiguous()  # the kernels' copy of a strided gradient
        delta = torch.empty_like(lse)  # their scratch, alive while they run
        grads = ctx.counter.launch(_cost.flash_bwd(q, k, v, ctx.causal), (
            torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)))
        del delta
        return (*grads, None, None)


class _CountedScan(torch.autograd.Function):
    """``ssm_scan.SelectiveScan`` under a counting mode: the forward with
    its checkpoints (saved), the backward's two launches and their
    outputs and partials, computing nothing."""

    @staticmethod
    def forward(ctx, xi, dt, B_, C_, A, h0, counter):
        b, q, di = xi.shape
        hs = torch.empty((b, -(-q // _ssm.CHECKPOINT_STEPS), di, B_.shape[-1]),
                         dtype=torch.float32, device=xi.device)
        y, h = counter.launch(_cost.ssm_scan(xi, dt, B_, C_, A, h0),
                              (torch.empty_like(xi), torch.empty_like(h0)))
        ctx.save_for_backward(xi, dt, B_, C_, A, hs)
        ctx.counter = counter
        return y, h

    @staticmethod
    def backward(ctx, gy, gh):
        xi, dt, B_, C_, A, hs = ctx.saved_tensors
        b, q, di = xi.shape
        ds = B_.shape[-1]
        for g in (gy, gh):  # the kernel's fp32 copies of the gradients
            if g is not None:
                g.float().contiguous()
        grads = (torch.empty_like(xi), torch.empty_like(dt), torch.empty_like(B_),
                 torch.empty_like(C_), torch.empty_like(A), hs.new_empty((b, di, ds)))
        # the partial gB / gC rows and gA the two kernels sum, alive while they run
        partials = [torch.empty((_ssm.bwd_partials(di), b, q, ds), dtype=torch.float32,
                                device=xi.device) for _ in range(2)]
        partials.append(torch.empty((b, di, ds), dtype=torch.float32, device=xi.device))
        grads = ctx.counter.launch(_cost.ssm_scan_bwd(xi, dt, B_, C_, A, hs[:, 0]), grads)
        del partials
        return (*grads, None)


def _repeat_kv(k: torch.Tensor, q_heads: int) -> torch.Tensor:
    """[B, S, kvH, hd] -> [B, S, qH, hd] by group broadcast (autograd of the
    expand sums each group's gradients back onto its kv head)."""
    b, s, kvh, hd = k.shape
    if kvh == q_heads:
        return k
    return k[:, :, :, None, :].expand(b, s, kvh, q_heads // kvh, hd).reshape(
        b, s, q_heads, hd
    )


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    impl: str = "auto",
) -> torch.Tensor:
    """Full-sequence attention.  q: [B, Sq, H, hd]; k/v: [B, Sk, kvH, hd].
    Returns [B, Sq, H, hd].  K/V are expanded to H heads first (as the
    reference does before its flash kernel); under ``causal`` query t sees
    ``kpos <= t`` and Sq must equal Sk.  Differentiable either way: the
    kernel through its backward kernels, the plain version by autograd."""
    h = q.shape[2]
    qt = q.transpose(1, 2).contiguous()
    kt = _repeat_kv(k, h).transpose(1, 2).contiguous()
    vt = _repeat_kv(v, h).transpose(1, 2).contiguous()
    counter = _counting(impl)
    if counter is not None:
        out = _CountedFlash.apply(qt, kt, vt, causal, counter)
    elif _resolve(impl, q) == "cuda":
        out = _flash.flash_attention(qt, kt, vt, causal=causal)
    else:
        out = _flash.flash_attention_torch(qt, kt, vt, causal=causal)
    return out.transpose(1, 2)


def paged_decode_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """Single-token decode attention over the paged KV pool.

    q: [B, H, hd]; k/v_pool: [P, page, kvH, hd] of q's dtype; block_tables:
    [B, W] int32 whose last column is the sentinel (never live KV); lengths:
    [B] int32 valid-KV counts (0 == empty slot -> zero output).  Returns
    [B, H, hd]."""
    counter = _counting(impl)
    if counter is not None:
        return counter.launch(_cost.paged_decode(q, k_pool, v_pool, block_tables, lengths),
                              torch.empty_like(q))
    if _resolve(impl, q) == "cuda":
        return _decode.paged_decode_attention(
            q, k_pool, v_pool, block_tables, lengths
        )
    return _decode.paged_decode_attention_torch(
        q, k_pool, v_pool, block_tables, lengths
    )


def paged_prefill_chunk_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    starts: torch.Tensor,
    chunk_lens: torch.Tensor,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """Ragged chunked-prefill attention over the paged KV pool.

    q: [B, C, H, hd]; k/v_pool of q's dtype, the chunk's real K/V already in
    the slot's pages at ``starts .. starts + chunk_lens - 1``; query t attends
    ``kpos <= starts + t``.  Returns [B, C, H, hd]; rows ``t >= chunk_lens``
    are zeros."""
    counter = _counting(impl)
    if counter is not None:
        return counter.launch(_cost.paged_prefill(q, k_pool, v_pool, block_tables, starts,
                                                  chunk_lens),
                              torch.empty_like(q))
    if _resolve(impl, q) == "cuda":
        return _prefill.paged_prefill_attention(
            q, k_pool, v_pool, block_tables, starts, chunk_lens
        )
    return _prefill.paged_prefill_attention_torch(
        q, k_pool, v_pool, block_tables, starts, chunk_lens
    )


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """Single-token decode attention over a dense KV cache.

    q: [B, H, hd]; k/v_cache: [B, S, kvH, hd] of q's dtype or an 8-bit
    float type (the fp8 cache, widened as it is read); lengths: [B] int32
    valid-KV counts (clamped to S; 0 == empty slot -> zero output).
    Returns [B, H, hd]."""
    counter = _counting(impl)
    if counter is not None:
        return counter.launch(_cost.decode(q, k_cache, v_cache, lengths), torch.empty_like(q))
    if _resolve(impl, q) == "cuda":
        return _dense_decode.decode_attention(q, k_cache, v_cache, lengths)
    return _dense_decode.decode_attention_torch(q, k_cache, v_cache, lengths)


def decode_attention_partial(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    impl: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """``decode_attention``'s unnormalised state over one block of a
    sequence-split dense cache: ``(acc [B, H, hd], ml [B, H, 2])`` fp32, ``ml``
    holding (m, l) in natural-log units, ``l = 0`` for a row no key
    reached.  Arguments as ``decode_attention`` (``lengths``: the block's
    live keys)."""
    counter = _counting(impl)
    if counter is not None:
        f32 = dict(dtype=torch.float32)
        return counter.launch(_cost.decode_partial(q, k_cache, v_cache, lengths), (
            q.new_empty(q.shape, **f32), q.new_empty((*q.shape[:2], 2), **f32)))
    if _resolve(impl, q) == "cuda":
        return _dense_decode.decode_attention_partial(q, k_cache, v_cache, lengths)
    return _dense_decode.decode_attention_partial_torch(q, k_cache, v_cache, lengths)


def combine_decode_partials(
    acc: torch.Tensor, ml: torch.Tensor, dtype: torch.dtype, *, impl: str = "auto"
) -> torch.Tensor:
    """Merge n blocks' ``decode_attention_partial`` states, gathered as
    ``acc [B, n, H, hd]`` / ``ml [B, n, H, 2]``, into the attention output
    [B, H, hd] of ``dtype`` (``paged::combine_splits`` on CUDA)."""
    counter = _counting(impl)
    if counter is not None:
        return counter.launch(_cost.combine(acc, ml, dtype),
                              acc.new_empty((acc.shape[0], *acc.shape[2:]), dtype=dtype))
    if _resolve(impl, acc) == "cuda":
        return _dense_decode.combine_splits(acc, ml, dtype)
    return _dense_decode.combine_splits_torch(acc, ml, dtype)


def prefill_chunk_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    starts: torch.Tensor,
    chunk_lens: torch.Tensor,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """Ragged chunked-prefill attention over a dense KV cache.

    q: [B, C, H, hd]; k/v_cache: [B, S, kvH, hd] of q's dtype with the
    chunk's real K/V already at ``starts .. starts + chunk_lens - 1``; query
    t attends ``kpos <= starts + t``.  Returns [B, C, H, hd]; rows
    ``t >= chunk_lens`` are zeros."""
    counter = _counting(impl)
    if counter is not None:
        return counter.launch(_cost.prefill(q, k_cache, v_cache, starts, chunk_lens),
                              torch.empty_like(q))
    if _resolve(impl, q) == "cuda":
        return _dense_prefill.prefill_attention(
            q, k_cache, v_cache, starts, chunk_lens
        )
    return _dense_prefill.prefill_attention_torch(
        q, k_cache, v_cache, starts, chunk_lens
    )


def paged_verify_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """Chunk-verify attention over the paged KV pool (speculative decoding).

    q: [B, T, H, hd], the T = gamma + 1 chunk queries whose K/V is already
    in the slot's pages at ``lengths - T .. lengths - 1``; lengths: [B]
    int32 including the chunk (not clamped).  Query t attends
    ``kpos <= lengths - T + t``; rows with an empty causal window are
    zeros.  Returns [B, T, H, hd]."""
    counter = _counting(impl)
    if counter is not None:
        return counter.launch(_cost.paged_verify(q, k_pool, v_pool, block_tables, lengths),
                              torch.empty_like(q))
    if _resolve(impl, q) == "cuda":
        return _verify.paged_verify_attention(
            q, k_pool, v_pool, block_tables, lengths
        )
    return _verify.paged_verify_attention_torch(
        q, k_pool, v_pool, block_tables, lengths
    )


def paged_tree_verify_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
    anc: torch.Tensor,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """Tree-verify attention over the paged KV pool.

    q: [B, N, H, hd], one query per packed-tree node, node j's K/V already at
    ``lengths - N + j``; anc: [B, N] int32 ancestor bitmasks (N <= 31).
    Node t attends ``kpos < lengths - N`` plus the nodes whose bit is set in
    ``anc[b, t]``; rows with an empty visibility set are zeros.  Returns
    [B, N, H, hd]."""
    counter = _counting(impl)
    if counter is not None:
        return counter.launch(_cost.paged_verify(q, k_pool, v_pool, block_tables, lengths, anc),
                              torch.empty_like(q))
    if _resolve(impl, q) == "cuda":
        return _tree.paged_tree_verify_attention(
            q, k_pool, v_pool, block_tables, lengths, anc
        )
    return _tree.paged_tree_verify_attention_torch(
        q, k_pool, v_pool, block_tables, lengths, anc
    )


def verify_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """Chunk-verify attention over a dense KV cache (speculative decoding).

    q: [B, T, H, hd], the T = gamma + 1 chunk queries whose K/V is already at
    rows ``lengths - T .. lengths - 1``; k/v_cache: [B, S, kvH, hd] of q's
    dtype; lengths: [B] int32 including the chunk (not clamped).  Query t
    attends ``kpos <= lengths - T + t``; rows with an empty causal window
    (``lengths == 0`` included) are zeros.  Returns [B, T, H, hd]."""
    counter = _counting(impl)
    if counter is not None:
        return counter.launch(_cost.verify(q, k_cache, v_cache, lengths), torch.empty_like(q))
    if _resolve(impl, q) == "cuda":
        return _dense_verify.verify_attention(q, k_cache, v_cache, lengths)
    return _dense_verify.verify_attention_torch(q, k_cache, v_cache, lengths)


def tree_verify_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    anc: torch.Tensor,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """Tree-verify attention over a dense KV cache.

    q: [B, N, H, hd], one query per packed-tree node, node j's K/V already at
    row ``lengths - N + j``; anc: [B, N] int32 ancestor bitmasks (N <= 31).
    Node t attends ``kpos < lengths - N`` plus the nodes whose bit is set in
    ``anc[b, t]``; rows with an empty visibility set are zeros.  A linear
    chain's masks give ``verify_attention``.  Returns [B, N, H, hd]."""
    counter = _counting(impl)
    if counter is not None:
        return counter.launch(_cost.verify(q, k_cache, v_cache, lengths, anc),
                              torch.empty_like(q))
    if _resolve(impl, q) == "cuda":
        return _dense_tree.tree_verify_attention(q, k_cache, v_cache, lengths, anc)
    return _dense_tree.tree_verify_attention_torch(q, k_cache, v_cache, lengths, anc)


def ssm_scan_chunk(xi, dt, B_, C_, A, h0, *, impl: str = "auto"):
    """Q steps of the Mamba1 selective scan (any Q: the engine passes a whole
    prefill bucket, the trainer a whole sequence), fp32 in and out (inputs
    are cast): ``h_t = exp(dt_t * A) * h_{t-1} + (dt_t * xi_t) * B_t``,
    ``y_t = h_t . C_t``.  xi/dt: [B, Q, di]; B_/C_: [B, Q, ds]; A: [di, ds];
    h0: [B, di, ds].  Returns ``(y [B, Q, di], h [B, di, ds])``.
    Differentiable either way: the kernel through its backward kernel (when
    autograd needs it; the serving launch otherwise), the plain version by
    autograd."""
    args = [t.float().contiguous() for t in (xi, dt, B_, C_, A, h0)]
    counter = _counting(impl)
    if counter is not None:
        if torch.is_grad_enabled() and any(t.requires_grad for t in args):
            return _CountedScan.apply(*args, counter)
        return counter.launch(_cost.ssm_scan(*args),
                              (torch.empty_like(args[0]), torch.empty_like(args[5])))
    if _resolve(impl, args[0]) == "cuda":
        return _ssm.selective_scan(*args)
    return _ssm.ssm_scan_chunk_torch(*args)


#: launch counters by kernel name
_COUNTS = {
    "paged_decode_attention": _decode.COUNTS,
    "paged_prefill_attention": _prefill.COUNTS,
    "decode_attention": _dense_decode.COUNTS,
    "decode_attention_partial": _dense_decode.PARTIAL_COUNTS,
    "decode_attention_fp8": _dense_decode.FP8_COUNTS,
    "decode_attention_partial_fp8": _dense_decode.PARTIAL_FP8_COUNTS,
    "combine_splits": _dense_decode.COMBINE_COUNTS,
    "prefill_attention": _dense_prefill.COUNTS,
    "paged_verify_attention": _verify.COUNTS,
    "paged_tree_verify_attention": _tree.COUNTS,
    "verify_attention": _dense_verify.COUNTS,
    "tree_verify_attention": _dense_tree.COUNTS,
    "ssm_scan": _ssm.COUNTS,
    "ssm_scan_bwd": _ssm.BWD_COUNTS,
    "flash_attention_fwd": _flash.FWD_COUNTS,
    "flash_attention_bwd": _flash.BWD_COUNTS,
}


#: launch counters by kernel body, for the kernels with more than one
_BODY_COUNTS = {
    "paged_prefill_attention": _prefill.BODY_COUNTS,
    "prefill_attention": _dense_prefill.BODY_COUNTS,
    "paged_verify_attention": _verify.BODY_COUNTS,
    "paged_tree_verify_attention": _tree.BODY_COUNTS,
    "verify_attention": _dense_verify.BODY_COUNTS,
    "tree_verify_attention": _dense_tree.BODY_COUNTS,
}


def launch_counts() -> dict:
    """Kernel launches and plain-version calls since the last reset, by
    kernel name."""
    return {name: dict(counts) for name, counts in _COUNTS.items()}


def body_counts() -> dict:
    """Kernel launches since the last reset by kernel name and body
    (``"tc"``: tensor cores, ``"fma"``: CUDA cores), for the kernels that
    pick their body from dtype and head dim: the chunked prefill, the verify
    and the tree verify, each paged and dense."""
    return {name: dict(counts) for name, counts in _BODY_COUNTS.items()}


def add_launch_counts(launches: dict, bodies: dict | None = None) -> None:
    """Add kernel launches made without a wrapper call, by kernel name (and
    ``bodies``: by kernel name and body, as ``body_counts``): a CUDA graph's
    replay launches again what its capture recorded."""
    for name, n in launches.items():
        _COUNTS[name]["cuda"] += n
    for name, by in (bodies or {}).items():
        for body, n in by.items():
            _BODY_COUNTS[name][body] += n


def reset_launch_counts() -> None:
    for counts in (*_COUNTS.values(), *_BODY_COUNTS.values()):
        for key in counts:
            counts[key] = 0
