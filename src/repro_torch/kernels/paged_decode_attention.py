"""Paged flash-decode attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the TPU kernel ``repro/kernels/paged_decode_attention.py``
(``paged_decode_attention``; body ``_decode_kernel``).  The kernel is
``csrc/paged_decode_attention.cu``: split-K over the slot's pages -- one
block per (slot, kv head, split of ``pps`` pages) walks its pages through
the block table up to ``ceil(length / page)`` (at most W - 1; the last table
column is the sentinel) with the GQA group's fp32 online-softmax state in
shared memory, and a second kernel combines the splits.  On the card it is
bound by the bytes of the K/V pages it must read.

``COUNTS["cuda"]`` counts kernel launches, ``COUNTS["torch"]`` calls of the
plain version; ``repro_torch.kernels.ops`` reads and resets them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

COUNTS = {"cuda": 0, "torch": 0}
NEG_INF = -1e30
#: pages per split (at least; raised so a slot never has more than
#: MAX_SPLITS splits, which bounds the scratch).  2 pages give a 32-page
#: slot 16 splits: 8 slots x 8 kv heads x 16 = 1024 blocks on 132 SMs
PAGES_PER_SPLIT = 2
MAX_SPLITS = 16


def gather_pages(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """[P, page, kvH, hd] pool -> [B, (W - 1) * page, kvH, hd] per-slot dense
    layout through the W - 1 real table columns (``ops._gather_pages`` of
    the reference); positions past a slot's length hold garbage the caller
    masks."""
    b, w = block_tables.shape
    page, kvh, hd = pool.shape[1:]
    return pool[block_tables[:, :-1].long()].reshape(b, (w - 1) * page, kvh, hd)


def paged_decode_attention_torch(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
) -> torch.Tensor:
    """Plain version: gather the pages dense, length-masked softmax in fp32,
    zeros for ``lengths == 0``.  q: [B, H, hd] -> [B, H, hd]."""
    COUNTS["torch"] += 1
    b, h, hd = q.shape
    k = gather_pages(k_pool, block_tables).float()
    v = gather_pages(v_pool, block_tables).float()
    kvh = k.shape[2]
    qf = q.float().reshape(b, kvh, h // kvh, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k) * hd**-0.5
    kpos = torch.arange(k.shape[1], device=q.device)
    live = kpos[None, :] < lengths[:, None]  # [B, S]
    s = torch.where(live[:, None, None, :], s, torch.full_like(s, NEG_INF))
    out = torch.einsum("bkgs,bskd->bkgd", torch.softmax(s, dim=-1), v)
    out = torch.where((lengths > 0)[:, None, None, None], out, torch.zeros_like(out))
    return out.reshape(b, h, hd).to(q.dtype)


def paged_decode_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
) -> torch.Tensor:
    """Launch the CUDA kernels (partial splits, then their combine) on the
    current stream; scratch and output are allocated here.  q: [B, H, hd];
    k/v_pool: [P, page, kvH, hd] of q's dtype (float32 or bfloat16);
    block_tables: [B, W] int32; lengths: [B] int32.  Returns a new
    [B, H, hd] tensor.  Raises on CPU tensors or arguments the kernel does
    not take."""
    _check(q, k_pool, v_pool, block_tables, lengths)
    b, h, hd = q.shape
    _, page, kvh, _ = k_pool.shape
    ncols = block_tables.shape[1] - 1
    pps = max(PAGES_PER_SPLIT, -(-ncols // MAX_SPLITS))
    splits = -(-ncols // pps)
    out = torch.empty_like(q)
    part_acc = torch.empty((b, splits, h, hd), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((b, splits, h, 2), dtype=torch.float32, device=q.device)
    lib = build.load("paged_decode_attention")
    err = lib.paged_decode_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(),
        b, h, kvh, hd, page, ncols + 1, pps, splits,
        build.DTYPE_CODES[q.dtype], q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check_launch(lib, err, "paged_decode_attention")
    COUNTS["cuda"] += 1
    return out


def _check(q, k_pool, v_pool, block_tables, lengths) -> None:
    req = build.require
    tensors = (q, k_pool, v_pool, block_tables, lengths)
    req(all(t.is_cuda for t in tensors),
        "paged_decode_attention kernel needs CUDA tensors")
    req(all(t.device == q.device for t in tensors), "tensors on different devices")
    req(q.dtype in build.DTYPE_CODES, f"unsupported dtype {q.dtype}")
    req(k_pool.dtype == q.dtype and v_pool.dtype == q.dtype,
        "q, k_pool and v_pool must share one dtype")
    req(block_tables.dtype == torch.int32 and lengths.dtype == torch.int32,
        "block_tables and lengths must be int32")
    req(q.ndim == 3 and k_pool.ndim == 4 and block_tables.ndim == 2
        and lengths.ndim == 1, "bad ranks")
    b, h, hd = q.shape
    _, _, kvh, khd = k_pool.shape
    req(v_pool.shape == k_pool.shape, "k_pool and v_pool shapes differ")
    req(khd == hd and hd % 8 == 0, f"head_dim {hd} must match and be a multiple of 8")
    req(kvh > 0 and h % kvh == 0, f"q heads {h} not a multiple of kv heads {kvh}")
    req(block_tables.shape[0] == b and lengths.shape[0] == b, "batch mismatch")
    req(block_tables.shape[1] >= 2, "block table needs a sentinel column")
    req(all(t.is_contiguous() for t in tensors), "tensors must be contiguous")
    req(all(t.data_ptr() % 16 == 0 for t in (q, k_pool, v_pool)),
        "q and the pools must be 16-byte aligned")
