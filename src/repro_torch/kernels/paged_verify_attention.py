"""Paged chunk-verify attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the TPU kernel ``repro/kernels/paged_verify_attention.py``
(``paged_verify_attention``; body ``_verify_kernel``).  The kernel is
``csrc/paged_verify_attention.cu``: the chunked-prefill body with
``start = lengths - T`` and all ``T`` chunk rows in one block, split-K over
the slot's pages with a combine kernel, as decode does (a chunk of more
than ``VERIFY_ROWS`` rows, a suffix prefill's, spreads its rows over
blocks).  ``lengths`` is NOT
clamped (suffix prefill relies on an unshifted causal bound); the tile walk
stops at the W - 1 real table columns.  Rows whose causal window is empty
give zeros.  On the serving path it is the target's verify pass of a
draft-model round.  On the card it is bound by the bytes of the K/V pages
it must read.

``verify_core`` is the plain math over a dense layout (the reference's XLA
``verify_attention``).  ``COUNTS["cuda"]`` counts kernel launches,
``COUNTS["torch"]`` calls of the plain version; ``repro_torch.kernels.ops``
reads and resets them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import NEG_INF, split_plan
from repro_torch.kernels.paged_decode_attention import gather_pages

COUNTS = {"cuda": 0, "torch": 0}


def masked_core(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seen: torch.Tensor
) -> torch.Tensor:
    """Softmax attention in fp32 under an explicit visibility mask, zeros for
    rows that see no key.  q: [B, T, H, hd]; k/v: [B, S, kvH, hd]; seen:
    [B, T, S] bool -> [B, T, H, hd]."""
    b, t, h, hd = q.shape
    kvh = k.shape[2]
    qf = q.float().reshape(b, t, kvh, h // kvh, hd)
    s = torch.einsum("btkgd,bskd->bkgts", qf, k.float()) * hd**-0.5
    s = torch.where(seen[:, None, None], s, torch.full_like(s, NEG_INF))
    out = torch.einsum("bkgts,bskd->btkgd", torch.softmax(s, dim=-1), v.float())
    any_seen = seen.any(dim=-1)[:, :, None, None, None]
    out = torch.where(any_seen, out, torch.zeros_like(out))
    return out.reshape(b, t, h, hd).to(q.dtype)


def verify_core(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    """Chunk query t sees ``kpos <= lengths - T + t`` over a dense layout.
    q: [B, T, H, hd]; k/v: [B, S, kvH, hd] -> [B, T, H, hd]."""
    t = q.shape[1]
    kpos = torch.arange(k.shape[1], device=q.device)
    bound = (lengths - t)[:, None] + torch.arange(t, device=q.device)[None, :]
    return masked_core(q, k, v, kpos[None, None, :] <= bound[:, :, None])


def paged_verify_attention_torch(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
) -> torch.Tensor:
    """Plain version: gather the pages dense, then ``verify_core``.
    q: [B, T, H, hd] -> [B, T, H, hd]."""
    COUNTS["torch"] += 1
    return verify_core(
        q, gather_pages(k_pool, block_tables), gather_pages(v_pool, block_tables),
        lengths,
    )


def launch_verify(name, q, k_pool, v_pool, block_tables, lengths, anc=None):
    """Launch ``name`` (the paged verify or tree-verify library) on the
    current stream: partial splits, then their combine.  Scratch and output
    are allocated here."""
    b, t, h, hd = q.shape
    _, page, kvh, _ = k_pool.shape
    ncols = block_tables.shape[1] - 1
    pps, splits = split_plan(ncols)
    out = torch.empty_like(q)
    part_acc = torch.empty((b, splits, kvh, t * (h // kvh), hd),
                           dtype=torch.float32, device=q.device)
    part_ml = torch.empty((b, splits, kvh, t * (h // kvh), 2),
                          dtype=torch.float32, device=q.device)
    lib = build.load(name)
    fn = getattr(lib, f"{name}_launch")
    ptrs = [q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr()]
    if anc is not None:
        ptrs.append(anc.data_ptr())
    err = fn(
        *ptrs, out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
        b, t, h, kvh, hd, page, ncols + 1, pps, splits,
        build.DTYPE_CODES[q.dtype], q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check_launch(lib, err, name)
    return out


def paged_verify_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
) -> torch.Tensor:
    """Launch the CUDA kernels.  q: [B, T, H, hd]; k/v_pool: [P, page, kvH,
    hd] of q's dtype (float32 or bfloat16), the chunk's K/V already at
    positions ``lengths - T .. lengths - 1``; block_tables: [B, W] int32;
    lengths: [B] int32 including the chunk.  Returns a new [B, T, H, hd]
    tensor.  Raises on CPU tensors or arguments the kernel does not take."""
    check_verify(q, k_pool, v_pool, block_tables, lengths, "paged_verify_attention")
    out = launch_verify("paged_verify_attention", q, k_pool, v_pool,
                        block_tables, lengths)
    COUNTS["cuda"] += 1
    return out


#: largest dynamic shared memory of one block on the H100 (bytes)
MAX_SMEM = 232_448
#: chunk rows of one verify block (``paged::kVerifyRows``)
VERIFY_ROWS = 32


def smem_bytes(rows: int, hd: int, page: int) -> int:
    """``paged::smem_bytes`` of ``csrc/paged_attention.cuh``."""
    ldk = hd + 1
    return 4 * (rows * ldk + page * ldk + page * hd + rows * page + rows * hd + 3 * rows)


def check_verify(q, k_pool, v_pool, block_tables, lengths, name) -> None:
    req = build.require
    tensors = (q, k_pool, v_pool, block_tables, lengths)
    req(all(t.is_cuda for t in tensors), f"{name} kernel needs CUDA tensors")
    req(all(t.device == q.device for t in tensors), "tensors on different devices")
    req(q.dtype in build.DTYPE_CODES, f"unsupported dtype {q.dtype}")
    req(k_pool.dtype == q.dtype and v_pool.dtype == q.dtype,
        "q, k_pool and v_pool must share one dtype")
    req(block_tables.dtype == torch.int32 and lengths.dtype == torch.int32,
        "block_tables and lengths must be int32")
    req(q.ndim == 4 and k_pool.ndim == 4 and block_tables.ndim == 2
        and lengths.ndim == 1, "bad ranks")
    b, t, h, hd = q.shape
    _, page, kvh, khd = k_pool.shape
    req(v_pool.shape == k_pool.shape, "k_pool and v_pool shapes differ")
    req(khd == hd and hd % 8 == 0, f"head_dim {hd} must match and be a multiple of 8")
    req(kvh > 0 and h % kvh == 0, f"q heads {h} not a multiple of kv heads {kvh}")
    req(block_tables.shape[0] == b and lengths.shape[0] == b, "batch mismatch")
    req(block_tables.shape[1] >= 2, "block table needs a sentinel column")
    req(smem_bytes(min(t, VERIFY_ROWS) * (h // kvh), hd, page) <= MAX_SMEM,
        f"group {h // kvh} exceeds one verify block's shared memory")
    req(all(x.is_contiguous() for x in tensors), "tensors must be contiguous")
    req(all(x.data_ptr() % 16 == 0 for x in (q, k_pool, v_pool)),
        "q and the pools must be 16-byte aligned")
