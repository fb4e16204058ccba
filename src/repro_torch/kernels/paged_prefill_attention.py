"""Paged ragged chunked-prefill attention: the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/paged_prefill_attention.py``
(``paged_prefill_attention``; body ``_prefill_kernel``).  The kernel is
``csrc/paged_prefill_attention.cu``: the slot's pages are read through its
block-table row up to a q tile's causal bound
``starts + min(last row + 1, chunk_lens)``.  On the card it is bound by
the bytes of the K/V pages it must read and by the latency of walking the
longest slot's pages.  The body comes from dtype and head dim alone
(``prefill_attention.prefill_body``): bfloat16 at hd 64 or 128 runs the
tensor-core body (one warpgroup per 64 query rows of a kv head, ``wgmma``
products, 64-key tiles of four 16-row pages gathered by ``cp.async`` into
a 2-stage ring); float32 and other head dims run the FMA body (``BLOCK_Q``
chunk rows per block, fp32 state in shared memory), which the fp32 parity
checks hold to 1e-4.

``COUNTS["cuda"]`` counts kernel launches, ``COUNTS["torch"]`` calls of the
plain version; ``repro_torch.kernels.ops`` reads and resets them.
``BODY_COUNTS`` splits the launches by body.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_decode_attention import gather_pages
from repro_torch.kernels.prefill_attention import BODY_CODES, prefill_body, prefill_core

COUNTS = {"cuda": 0, "torch": 0}
#: kernel launches by body ("tc": tensor cores, "fma": CUDA cores)
BODY_COUNTS = {"tc": 0, "fma": 0}
#: chunk rows per block of the FMA body (the TPU kernel's ``block_q`` is 32)
BLOCK_Q = 8


def paged_prefill_attention_torch(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    starts: torch.Tensor,
    chunk_lens: torch.Tensor,
) -> torch.Tensor:
    """Plain version: gather the pages dense, then the dense prefill's plain
    math (chunk-causal masked softmax in fp32, row t sees ``kpos <= starts +
    t``, zeros for rows ``t >= chunk_lens``).  q: [B, C, H, hd] ->
    [B, C, H, hd]."""
    COUNTS["torch"] += 1
    return prefill_core(
        q, gather_pages(k_pool, block_tables), gather_pages(v_pool, block_tables),
        starts, chunk_lens,
    )


def paged_prefill_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    starts: torch.Tensor,
    chunk_lens: torch.Tensor,
) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream.  q: [B, C, H, hd];
    k/v_pool: [P, page, kvH, hd] of q's dtype (float32 or bfloat16);
    block_tables: [B, W] int32; starts / chunk_lens: [B] int32.  Returns a
    new [B, C, H, hd] tensor.  Raises on CPU tensors or arguments the kernel
    does not take."""
    _check(q, k_pool, v_pool, block_tables, starts, chunk_lens)
    b, c, h, hd = q.shape
    _, page, kvh, _ = k_pool.shape
    body = prefill_body(q.dtype, hd)
    out = torch.empty_like(q)
    lib = build.load("paged_prefill_attention")
    err = lib.paged_prefill_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), starts.data_ptr(), chunk_lens.data_ptr(),
        out.data_ptr(), b, c, h, kvh, hd, page, block_tables.shape[1],
        min(BLOCK_Q, c), build.DTYPE_CODES[q.dtype], BODY_CODES[body],
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check_launch(lib, err, "paged_prefill_attention")
    COUNTS["cuda"] += 1
    BODY_COUNTS[body] += 1
    return out


def _check(q, k_pool, v_pool, block_tables, starts, chunk_lens) -> None:
    req = build.require
    tensors = (q, k_pool, v_pool, block_tables, starts, chunk_lens)
    req(all(t.is_cuda for t in tensors),
        "paged_prefill_attention kernel needs CUDA tensors")
    req(all(t.device == q.device for t in tensors), "tensors on different devices")
    req(q.dtype in build.DTYPE_CODES, f"unsupported dtype {q.dtype}")
    req(k_pool.dtype == q.dtype and v_pool.dtype == q.dtype,
        "q, k_pool and v_pool must share one dtype")
    req(all(t.dtype == torch.int32 for t in (block_tables, starts, chunk_lens)),
        "block_tables, starts and chunk_lens must be int32")
    req(q.ndim == 4 and k_pool.ndim == 4 and block_tables.ndim == 2
        and starts.ndim == 1 and chunk_lens.ndim == 1, "bad ranks")
    b, c, h, hd = q.shape
    _, _, kvh, khd = k_pool.shape
    req(v_pool.shape == k_pool.shape, "k_pool and v_pool shapes differ")
    req(khd == hd and hd % 8 == 0, f"head_dim {hd} must match and be a multiple of 8")
    req(kvh > 0 and h % kvh == 0, f"q heads {h} not a multiple of kv heads {kvh}")
    req(block_tables.shape[0] == b and starts.shape[0] == b
        and chunk_lens.shape[0] == b, "batch mismatch")
    req(block_tables.shape[1] >= 2, "block table needs a sentinel column")
    req(k_pool.shape[1] % 4 == 0, f"page size {k_pool.shape[1]} must be a multiple of 4")
    req(all(t.is_contiguous() for t in tensors), "tensors must be contiguous")
    req(all(t.data_ptr() % 16 == 0 for t in (q, k_pool, v_pool)),
        "q and the pools must be 16-byte aligned")
