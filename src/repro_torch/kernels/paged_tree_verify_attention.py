"""Paged tree-verify attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the TPU kernel ``repro/kernels/paged_tree_verify_attention.py``
(``paged_tree_verify_attention``; body ``_tree_verify_kernel``).  The kernel
is ``csrc/paged_tree_verify_attention.cu``: the paged verify kernel with the
causal triangle replaced by int32 ancestor bitmasks -- node t of a packed
tree of N <= 31 nodes sees the committed prefix ``kpos < lengths - N`` and
the nodes ``j`` whose bit is set in ``anc[b, t]``.  Same template, split and
accumulation order as the paged verify kernel, so a linear chain's masks
give its output bit for bit.  On the serving path it is the target's verify
pass of an n-gram / suffix-proposed tree.  On the card it is bound by the
bytes of the K/V pages it must read.

``COUNTS["cuda"]`` counts kernel launches, ``COUNTS["torch"]`` calls of the
plain version; ``repro_torch.kernels.ops`` reads and resets them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_decode_attention import gather_pages
from repro_torch.kernels.paged_verify_attention import (
    check_verify,
    launch_verify,
    masked_core,
)

COUNTS = {"cuda": 0, "torch": 0}
#: int32 ancestor bitmasks bound the packed tree size
MAX_TREE_NODES = 31


def tree_core(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    anc: torch.Tensor,
) -> torch.Tensor:
    """Ancestor-masked attention over a dense layout: node t sees
    ``kpos < lengths - N`` and node ``j = kpos - (lengths - N)``,
    ``0 <= j < N``, when bit j of ``anc[b, t]`` is set (shift clamped into
    [0, 31]).  q: [B, N, H, hd]; k/v: [B, S, kvH, hd]; anc: [B, N] int32."""
    n = q.shape[1]
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]  # [1, S]
    base = (lengths - n)[:, None]  # [B, 1]
    jpos = kpos - base  # [B, S]
    in_chunk = (jpos >= 0) & (jpos < n)
    bits = (anc.to(torch.int32)[:, :, None] >> jpos.clamp(0, 31)[:, None, :]) & 1
    seen = (kpos < base)[:, None, :] | (in_chunk[:, None, :] & (bits == 1))
    return masked_core(q, k, v, seen)


def paged_tree_verify_attention_torch(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
    anc: torch.Tensor,
) -> torch.Tensor:
    """Plain version: gather the pages dense, then ``tree_core``.
    q: [B, N, H, hd] -> [B, N, H, hd]."""
    COUNTS["torch"] += 1
    _check_nodes(q)
    return tree_core(
        q, gather_pages(k_pool, block_tables), gather_pages(v_pool, block_tables),
        lengths, anc,
    )


def paged_tree_verify_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
    anc: torch.Tensor,
) -> torch.Tensor:
    """Launch the CUDA kernels.  q: [B, N, H, hd] one query per tree node,
    node j's K/V already at position ``lengths - N + j``; k/v_pool: [P,
    page, kvH, hd] of q's dtype; block_tables: [B, W] int32; lengths: [B]
    int32 including the N nodes; anc: [B, N] int32.  Returns a new
    [B, N, H, hd] tensor.  Raises for N > 31, on CPU tensors, or on
    arguments the kernel does not take."""
    _check_nodes(q)
    check_verify(q, k_pool, v_pool, block_tables, lengths,
                 "paged_tree_verify_attention")
    req = build.require
    req(anc.is_cuda and anc.device == q.device, "anc must be on q's device")
    req(anc.dtype == torch.int32 and anc.shape == q.shape[:2] and anc.is_contiguous(),
        "anc must be a contiguous [B, N] int32 tensor")
    out = launch_verify("paged_tree_verify_attention", q, k_pool, v_pool,
                        block_tables, lengths, anc)
    COUNTS["cuda"] += 1
    return out


def _check_nodes(q: torch.Tensor) -> None:
    n = q.shape[1]
    build.require(1 <= n <= MAX_TREE_NODES,
                  f"tree has {n} nodes (1..{MAX_TREE_NODES} allowed)")
