"""Dense chunk-verify attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the TPU kernel ``repro/kernels/verify_attention.py``
(``verify_attention``; body ``_verify_kernel``).  The kernel is
``verify_attention_launch`` in ``csrc/verify_attention.cu`` (the library
also holds the dense tree verify): the paged verify kernel's body over a dense
``[B, S, kvH, hd]`` cache -- one block per (slot, kv head, split of 16-row
tiles) holds the T = gamma + 1 chunk rows of the GQA group, query t sees
``kpos <= lengths - T + t``, and the combine kernel of dense decode merges
the splits.  ``lengths`` is not clamped (keys stop at S); rows whose causal
window is empty give zeros.  On the serving path it is a dense-layout
target's verify pass of a draft-model round.  On the card it is bound by
the bytes of the K/V rows it must read.

The plain version is ``verify_core``, the reference's XLA
``verify_attention``.  ``COUNTS["cuda"]`` counts kernel launches,
``COUNTS["torch"]`` calls of the plain version; ``repro_torch.kernels.ops``
reads and resets them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import TILE, split_plan
from repro_torch.kernels.paged_verify_attention import (
    MAX_SMEM,
    VERIFY_ROWS,
    smem_bytes,
    verify_core,
)

COUNTS = {"cuda": 0, "torch": 0}


def verify_attention_torch(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    """Plain version: ``verify_core``.  q: [B, T, H, hd]; k/v: [B, S, kvH,
    hd] -> [B, T, H, hd]."""
    COUNTS["torch"] += 1
    return verify_core(q, k, v, lengths)


def launch_dense_verify(name, q, k, v, lengths, anc=None) -> torch.Tensor:
    """Launch entry point ``<name>_launch`` (the dense verify or tree
    verify) of the ``verify_attention`` library on the current stream:
    partial splits over 16-row tiles, then their combine.  Scratch and
    output are allocated here."""
    b, t, h, hd = q.shape
    _, s, kvh, _ = k.shape
    pps, splits = split_plan(-(-s // TILE))
    out = torch.empty_like(q)
    part_acc = torch.empty((b, splits, kvh, t * (h // kvh), hd),
                           dtype=torch.float32, device=q.device)
    part_ml = torch.empty((b, splits, kvh, t * (h // kvh), 2),
                          dtype=torch.float32, device=q.device)
    lib = build.load("verify_attention")
    fn = getattr(lib, f"{name}_launch")
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr()]
    if anc is not None:
        ptrs.append(anc.data_ptr())
    err = fn(
        *ptrs, out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
        b, t, h, kvh, hd, s, TILE, pps, splits,
        build.DTYPE_CODES[q.dtype], q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check_launch(lib, err, name)
    return out


def check_dense_verify(q, k, v, lengths, name) -> None:
    req = build.require
    tensors = (q, k, v, lengths)
    req(all(t.is_cuda for t in tensors), f"{name} kernel needs CUDA tensors")
    req(all(t.device == q.device for t in tensors), "tensors on different devices")
    req(q.dtype in build.DTYPE_CODES, f"unsupported dtype {q.dtype}")
    req(k.dtype == q.dtype and v.dtype == q.dtype, "q, k and v must share one dtype")
    req(lengths.dtype == torch.int32, "lengths must be int32")
    req(q.ndim == 4 and k.ndim == 4 and lengths.ndim == 1, "bad ranks")
    b, t, h, hd = q.shape
    kb, _, kvh, khd = k.shape
    req(v.shape == k.shape, "k and v shapes differ")
    req(khd == hd and hd % 8 == 0, f"head_dim {hd} must match and be a multiple of 8")
    req(kvh > 0 and h % kvh == 0, f"q heads {h} not a multiple of kv heads {kvh}")
    req(kb == b and lengths.shape[0] == b, "batch mismatch")
    req(smem_bytes(min(t, VERIFY_ROWS) * (h // kvh), hd, TILE) <= MAX_SMEM,
        f"group {h // kvh} exceeds one verify block's shared memory")
    req(all(x.is_contiguous() for x in tensors), "tensors must be contiguous")
    req(all(x.data_ptr() % 16 == 0 for x in (q, k, v)),
        "q, k and v must be 16-byte aligned")


def verify_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    """Launch the CUDA kernels.  q: [B, T, H, hd]; k/v: [B, S, kvH, hd] of
    q's dtype (float32 or bfloat16), the chunk's K/V already at rows
    ``lengths - T .. lengths - 1``; lengths: [B] int32 including the chunk.
    Returns a new [B, T, H, hd] tensor.  Raises on CPU tensors or arguments
    the kernel does not take."""
    check_dense_verify(q, k, v, lengths, "verify_attention")
    out = launch_dense_verify("verify_attention", q, k, v, lengths)
    COUNTS["cuda"] += 1
    return out
