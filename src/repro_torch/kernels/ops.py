"""Dispatch over the attention kernels: full-sequence (training) attention
and the paged decode / chunked-prefill cores.

Same signatures and defined outputs as ``repro.kernels.ops``'s entry
points.  ``impl``:

  * "auto"  -- the CUDA kernel for CUDA tensors, the plain PyTorch version
               for CPU tensors (the only reason the plain version runs);
  * "torch" -- force the plain version (the reference the kernel is held to);
  * "cuda"  -- force the kernel; raises on CPU tensors.

A CUDA tensor never falls back to the plain version: a kernel that fails to
build or launch raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import paged_decode_attention as _decode
from repro_torch.kernels import paged_prefill_attention as _prefill

IMPLS = ("auto", "torch", "cuda")


def _resolve(impl: str, q: torch.Tensor) -> str:
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; known: {IMPLS}")
    if impl == "auto":
        return "cuda" if q.is_cuda else "torch"
    return impl


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
    if _resolve(impl, q) == "cuda":
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
    if _resolve(impl, q) == "cuda":
        return _prefill.paged_prefill_attention(
            q, k_pool, v_pool, block_tables, starts, chunk_lens
        )
    return _prefill.paged_prefill_attention_torch(
        q, k_pool, v_pool, block_tables, starts, chunk_lens
    )


def launch_counts() -> dict:
    """Kernel launches and plain-version calls since the last reset, by
    kernel name."""
    return {
        "paged_decode_attention": dict(_decode.COUNTS),
        "paged_prefill_attention": dict(_prefill.COUNTS),
        "flash_attention_fwd": dict(_flash.FWD_COUNTS),
        "flash_attention_bwd": dict(_flash.BWD_COUNTS),
    }


def reset_launch_counts() -> None:
    for counts in (_decode.COUNTS, _prefill.COUNTS, _flash.FWD_COUNTS,
                   _flash.BWD_COUNTS):
        for key in counts:
            counts[key] = 0
