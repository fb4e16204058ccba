"""Dense tree-verify attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the TPU kernel ``repro/kernels/tree_verify_attention.py:118``
(``tree_verify_attention``, ``pallas_call`` at ``:180``; body
``_tree_verify_kernel``).  The kernel is ``tree_verify_attention_launch``
in ``csrc/verify_attention.cu``, the library of the dense verify kernel:
that kernel with the causal triangle replaced by int32 ancestor bitmasks --
node t of a packed tree of N <= 31 nodes sees the committed prefix ``kpos <
lengths - N`` and the nodes ``j`` whose bit is set in ``anc[b, t]``.  On the
serving path it is a dense-layout target's verify pass of an n-gram /
suffix-proposed tree.  On the card it is bound by the bytes of the K/V rows
it must read, and at serving sizes by the latency and fixed costs of a
short walk.  It takes the dense verify's two bodies by the same rule
(``verify_body``): in bfloat16 at hd 64 / 128 the tensor-core kernel whose
thread-block cluster splits the slot's 64-key tiles and merges the splits
in distributed shared memory in the same launch (``dense_verify_plan``),
else the FMA split pass and its combine.  Each body runs the dense verify's
plan, tile order, merge order and arithmetic, so a linear chain's masks
give its output bit for bit.

The plain version is ``tree_core`` (the reference's XLA
``tree_verify_attention``).  ``COUNTS["cuda"]`` counts kernel launches,
``COUNTS["torch"]`` calls of the plain version; ``repro_torch.kernels.ops``
reads and resets them.  ``BODY_COUNTS`` splits the launches by body.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_tree_verify_attention import check_nodes, tree_core
from repro_torch.kernels.verify_attention import check_dense_verify, launch_dense_verify

COUNTS = {"cuda": 0, "torch": 0}
#: kernel launches by body ("tc": tensor cores, "fma": CUDA cores)
BODY_COUNTS = {"tc": 0, "fma": 0}


def tree_verify_attention_torch(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    anc: torch.Tensor,
) -> torch.Tensor:
    """Plain version: ``tree_core``.  q: [B, N, H, hd]; k/v: [B, S, kvH,
    hd]; anc: [B, N] int32 -> [B, N, H, hd]."""
    COUNTS["torch"] += 1
    check_nodes(q)
    return tree_core(q, k, v, lengths, anc)


def tree_verify_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    anc: torch.Tensor,
) -> torch.Tensor:
    """Launch the CUDA kernel(s).  q: [B, N, H, hd] one query per tree node,
    node j's K/V already at row ``lengths - N + j``; k/v: [B, S, kvH, hd] of
    q's dtype; lengths: [B] int32 including the N nodes; anc: [B, N] int32.
    Returns a new [B, N, H, hd] tensor.  Raises for N > 31, on CPU tensors,
    or on arguments the kernel does not take."""
    check_nodes(q)
    check_dense_verify(q, k, v, lengths, "tree_verify_attention")
    req = build.require
    req(anc.is_cuda and anc.device == q.device, "anc must be on q's device")
    req(anc.dtype == torch.int32 and anc.shape == q.shape[:2] and anc.is_contiguous(),
        "anc must be a contiguous [B, N] int32 tensor")
    out, body = launch_dense_verify("tree_verify_attention", q, k, v, lengths, anc)
    COUNTS["cuda"] += 1
    BODY_COUNTS[body] += 1
    return out
