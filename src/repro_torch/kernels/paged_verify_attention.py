"""Paged chunk-verify attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the TPU kernel ``repro/kernels/paged_verify_attention.py:45``
(``paged_verify_attention``, ``pallas_call`` at ``:106``; body
``_verify_kernel``).  The kernel is ``csrc/paged_verify_attention.cu``: the
``T`` chunk rows of a slot sit at ``start = lengths - T`` and row t sees
``kpos <= start + t``; a split pass over the slot's KV tiles writes each
split's unnormalised state and ``paged::combine_splits`` merges them, as
decode does.  ``lengths`` is NOT clamped (suffix prefill relies on an
unshifted causal bound); the tile walk stops at the W - 1 real table
columns.  Rows whose causal window is empty give zeros.  On the serving
path it is the target's verify pass of a draft-model round.  On the card
it is bound by the bytes of the K/V pages it must read, and at serving
sizes by the latency and fixed costs of short walks.  ``verify_body``
picks one of two bodies from dtype and head dim alone:

* ``"tc"`` (bfloat16 at hd 64 or 128; ``csrc/verify_tc.cuh`` over the
  chunked prefill's ``csrc/prefill_tc.cuh``): one warpgroup per (64 rows of
  a kv head, slot, split of ``TC_TILES_PER_SPLIT`` 64-key tiles) runs
  S = Q K^T and P V on the tensor cores (``wgmma``) with the softmax in
  registers; a CTA past its rows' last visible key writes only its
  ``(m, l)``.  ``verify_split_plan`` sets the split;
* ``"fma"`` (float32, or another head dim): one block per (kv head, slot,
  ``VERIFY_ROWS`` chunk rows, split of ``split_plan`` pages) with the fp32
  online-softmax state in shared memory and fp32 FMAs on the CUDA cores,
  which the fp32 parity checks hold to 1e-4.

``verify_core`` is the plain math over a dense layout (the reference's XLA
``verify_attention``).  ``COUNTS["cuda"]`` counts kernel launches,
``COUNTS["torch"]`` calls of the plain version; ``repro_torch.kernels.ops``
reads and resets them.  ``BODY_COUNTS`` splits the launches by body.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import MAX_SMEM, NEG_INF, split_plan
from repro_torch.kernels.paged_decode_attention import gather_pages
from repro_torch.kernels.prefill_attention import BODY_CODES, prefill_body

COUNTS = {"cuda": 0, "torch": 0}
#: kernel launches by body ("tc": tensor cores, "fma": CUDA cores)
BODY_COUNTS = {"tc": 0, "fma": 0}
#: keys per KV tile of the tensor-core body (``prefill_tc::kKeys``)
TC_KEYS = 64
#: 64-key tiles per split of the tensor-core body (at least; raised so a
#: slot never has more than TC_MAX_SPLITS splits, which bounds the scratch).
#: Two give a slot of 32 pages of 16 4 splits: 8 slots x 8 kv heads x 4 =
#: 256 CTAs, one wave on 132 SMs; the second tile's fetch overlaps the
#: first's math, and the combine reads half the splits of one tile a split
TC_TILES_PER_SPLIT = 2
TC_MAX_SPLITS = 16


def verify_body(dtype: torch.dtype, head_dim: int) -> str:
    """The body a launch of the paged verify or tree-verify kernel takes,
    from dtype and head dim alone: ``"tc"`` for bfloat16 at hd 64 or 128,
    else ``"fma"`` (the chunked prefill's rule, ``prefill_body``)."""
    return prefill_body(dtype, head_dim)


def verify_split_plan(n_cols: int, page: int) -> tuple[int, int]:
    """(64-key tiles per split, splits) of the tensor-core body's split pass
    over a slot of ``n_cols`` pages of ``page`` keys."""
    n_tiles = -(-n_cols * page // TC_KEYS)
    per = max(TC_TILES_PER_SPLIT, -(-n_tiles // TC_MAX_SPLITS))
    return per, -(-n_tiles // per)


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
    current stream in the body ``verify_body`` picks: partial splits, then
    their combine.  Scratch and output are allocated here.  Returns the
    output and the body."""
    b, t, h, hd = q.shape
    _, page, kvh, _ = k_pool.shape
    ncols = block_tables.shape[1] - 1
    body = verify_body(q.dtype, hd)
    per, splits = verify_split_plan(ncols, page) if body == "tc" else split_plan(ncols)
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
        b, t, h, kvh, hd, page, ncols + 1, per, splits,
        build.DTYPE_CODES[q.dtype], BODY_CODES[body], q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check_launch(lib, err, name)
    return out, body


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
    out, body = launch_verify("paged_verify_attention", q, k_pool, v_pool,
                              block_tables, lengths)
    COUNTS["cuda"] += 1
    BODY_COUNTS[body] += 1
    return out


#: chunk rows of one verify block (``paged::kVerifyRows``)
VERIFY_ROWS = 32


def smem_bytes(rows: int, hd: int, page: int) -> int:
    """``paged::smem_bytes`` of ``csrc/paged_attention.cuh`` (the FMA body)."""
    ldk = hd + 1
    return 4 * (rows * ldk + page * ldk + page * hd + rows * page + rows * hd + 3 * rows)


def tc_smem_bytes(hd: int, per: int, page: int, n_cols: int) -> int:
    """``prefill_tc::smem_bytes<hd>`` of the tensor-core body with
    ``verify_tc::table_cols`` table entries: the Q tile, a K and a V tile per
    stage of the 2-stage ring, the split's block-table entries and 1024
    bytes of alignment slack."""
    table_cols = min(n_cols, -(-per * TC_KEYS // page) + 1)
    return 5 * (64 * hd * 2) + 4 * table_cols + 1024


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
    ncols = block_tables.shape[1] - 1
    if verify_body(q.dtype, hd) == "tc":
        need = tc_smem_bytes(hd, verify_split_plan(ncols, page)[0], page, ncols)
    else:
        need = smem_bytes(min(t, VERIFY_ROWS) * (h // kvh), hd, page)
    req(need <= MAX_SMEM, f"a verify block needs {need} bytes of shared memory "
        f"(group {h // kvh}, hd {hd}, page {page}); at most {MAX_SMEM}")
    req(all(x.is_contiguous() for x in tensors), "tensors must be contiguous")
    req(all(x.data_ptr() % 16 == 0 for x in (q, k_pool, v_pool)),
        "q and the pools must be 16-byte aligned")
