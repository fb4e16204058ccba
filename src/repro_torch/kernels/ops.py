"""Dispatch over the paged attention kernels.

Same signatures and defined outputs as ``repro.kernels.ops``'s paged entry
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

from repro_torch.kernels import paged_decode_attention as _decode
from repro_torch.kernels import paged_prefill_attention as _prefill

IMPLS = ("auto", "torch", "cuda")


def _resolve(impl: str, q: torch.Tensor) -> str:
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; known: {IMPLS}")
    if impl == "auto":
        return "cuda" if q.is_cuda else "torch"
    return impl


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
    }


def reset_launch_counts() -> None:
    for counts in (_decode.COUNTS, _prefill.COUNTS):
        for key in counts:
            counts[key] = 0
