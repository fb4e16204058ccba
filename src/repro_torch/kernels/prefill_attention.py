"""Dense ragged chunked-prefill attention: the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/prefill_attention.py``
(``prefill_attention``; body ``_prefill_kernel``).  The kernel is
``csrc/prefill_attention.cu``: the paged chunked-prefill kernel's body over a
dense ``[B, S, kvH, hd]`` cache -- one block per (slot, kv head, block of
``BLOCK_Q`` chunk rows) walks the slot's 16-row tiles up to the block's
causal bound ``starts + min((qi + 1) * BLOCK_Q, chunk_lens)``, with the fp32
online-softmax state of its ``BLOCK_Q * group`` rows in shared memory.  On
the serving path it is the draft model's chunk prefill.  On the card it is
bound by the bytes of the K/V rows it must read.

``prefill_core`` is the plain math, shared with the paged prefill's plain
version.  ``COUNTS["cuda"]`` counts kernel launches, ``COUNTS["torch"]``
calls of the plain version; ``repro_torch.kernels.ops`` reads and resets
them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import NEG_INF, TILE

COUNTS = {"cuda": 0, "torch": 0}
#: chunk rows per block (the TPU kernel's ``block_q`` is 32)
BLOCK_Q = 8


def prefill_core(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    starts: torch.Tensor,
    chunk_lens: torch.Tensor,
) -> torch.Tensor:
    """Chunk-causal masked softmax in fp32 over a dense cache: row t sees
    ``kpos <= starts + t``; rows ``t >= chunk_lens`` are zeros.
    q: [B, C, H, hd]; k/v: [B, S, kvH, hd] -> [B, C, H, hd]."""
    b, c, h, hd = q.shape
    kvh = k.shape[2]
    qf = q.float().reshape(b, c, kvh, h // kvh, hd)
    s = torch.einsum("bckgd,bskd->bkgcs", qf, k.float()) * hd**-0.5
    kpos = torch.arange(k.shape[1], device=q.device)
    t = torch.arange(c, device=q.device)
    bound = starts[:, None] + t[None, :]  # [B, C]
    valid = t[None, :] < chunk_lens[:, None]  # [B, C]
    seen = (kpos[None, None, :] <= bound[:, :, None]) & valid[:, :, None]
    s = torch.where(seen[:, None, None], s, torch.full_like(s, NEG_INF))
    out = torch.einsum("bkgcs,bskd->bckgd", torch.softmax(s, dim=-1), v.float())
    out = torch.where(valid[:, :, None, None, None], out, torch.zeros_like(out))
    return out.reshape(b, c, h, hd).to(q.dtype)


def prefill_attention_torch(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    starts: torch.Tensor,
    chunk_lens: torch.Tensor,
) -> torch.Tensor:
    """Plain version: ``prefill_core``.  q: [B, C, H, hd] -> [B, C, H, hd]."""
    COUNTS["torch"] += 1
    return prefill_core(q, k, v, starts, chunk_lens)


def prefill_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    starts: torch.Tensor,
    chunk_lens: torch.Tensor,
) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream.  q: [B, C, H, hd]; k/v:
    [B, S, kvH, hd] of q's dtype (float32 or bfloat16); starts / chunk_lens:
    [B] int32.  Returns a new [B, C, H, hd] tensor.  Raises on CPU tensors
    or arguments the kernel does not take."""
    _check(q, k, v, starts, chunk_lens)
    b, c, h, hd = q.shape
    _, s, kvh, _ = k.shape
    out = torch.empty_like(q)
    lib = build.load("prefill_attention")
    err = lib.prefill_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), starts.data_ptr(),
        chunk_lens.data_ptr(), out.data_ptr(), b, c, h, kvh, hd, s, TILE,
        min(BLOCK_Q, c), build.DTYPE_CODES[q.dtype], q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check_launch(lib, err, "prefill_attention")
    COUNTS["cuda"] += 1
    return out


def _check(q, k, v, starts, chunk_lens) -> None:
    req = build.require
    tensors = (q, k, v, starts, chunk_lens)
    req(all(t.is_cuda for t in tensors), "prefill_attention kernel needs CUDA tensors")
    req(all(t.device == q.device for t in tensors), "tensors on different devices")
    req(q.dtype in build.DTYPE_CODES, f"unsupported dtype {q.dtype}")
    req(k.dtype == q.dtype and v.dtype == q.dtype, "q, k and v must share one dtype")
    req(starts.dtype == torch.int32 and chunk_lens.dtype == torch.int32,
        "starts and chunk_lens must be int32")
    req(q.ndim == 4 and k.ndim == 4 and starts.ndim == 1 and chunk_lens.ndim == 1,
        "bad ranks")
    b, c, h, hd = q.shape
    kb, _, kvh, khd = k.shape
    req(v.shape == k.shape, "k and v shapes differ")
    req(khd == hd and hd % 8 == 0, f"head_dim {hd} must match and be a multiple of 8")
    req(kvh > 0 and h % kvh == 0, f"q heads {h} not a multiple of kv heads {kvh}")
    req(kb == b and starts.shape[0] == b and chunk_lens.shape[0] == b, "batch mismatch")
    req(all(t.is_contiguous() for t in tensors), "tensors must be contiguous")
    req(all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
        "q, k and v must be 16-byte aligned")
