"""Dense flash-decode attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the TPU kernel ``repro/kernels/decode_attention.py:92``
(``decode_attention``, ``pallas_call`` at ``:146``; body
``_decode_kernel``).  The kernel is ``csrc/decode_attention.cu``: one
launch per call, in both dtypes and every head dim the wrapper takes.  The
slot's 64-row tiles up to ``min(lengths, S)`` are split across the CTAs of
one thread-block cluster by ``decode_plan`` (from S alone); each CTA walks
its tiles through a ``cp.async`` ring with the GQA group's q rows in
registers and an fp32 online softmax, and the cluster merges its splits in
distributed shared memory (``csrc/decode_cluster.cuh``).  On the serving
path it is the draft model's proposal step and the dense target layout's
decode step.  On the card it is bound by the bytes of the K/V rows it must
read, and at serving sizes by the fixed cost of a short walk.

K and V may also be an 8-bit cache (``float8_e4m3fn`` / ``float8_e5m2``,
the serve steps' ``cache_dtype``: a plain cast, no scale, as the
reference's) under fp32 or bf16 q: the same kernels, instantiated in a
library of their own (``csrc/decode_attention_fp8.cu``), widen each pair of
values to fp32 as they read them, rows of hd bytes (hd a multiple of 16).  Its plain
versions widen with ``.float()``, as the reference's XLA path widens to q's
dtype (exact either way).

``decode_core`` is the plain math, shared with the paged decode's plain
version.  ``TILE`` and ``split_plan`` are the split of the FMA verify and
prefill bodies (16-row tiles).  ``COUNTS["cuda"]`` counts kernel launches,
``COUNTS["torch"]`` calls of the plain version; ``repro_torch.kernels.ops``
reads and resets them.

The partial form (``decode_attention_partial``, the same library) runs the
same cluster kernel over one rank's block of a sequence-split cache and
stores each row's unnormalised state: ``acc`` [B, H, hd] and ``ml`` [B, H,
2] = (m, l) in fp32, natural-log units, ``l = 0`` for a row no key
reached.  ``combine_splits`` merges the blocks' partials, gathered as
[B, n, H, hd] / [B, n, H, 2], with ``paged::combine_splits`` (the paged
verify's merge, at C = 1).  Their plain versions are
``decode_partial_core`` and ``combine_partials_core``; ``PARTIAL_COUNTS``
and ``COMBINE_COUNTS`` count them as ``COUNTS`` does.  A call over 8-bit
K / V counts in ``FP8_COUNTS`` / ``PARTIAL_FP8_COUNTS`` instead (its own
instantiations of the kernel).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

COUNTS = {"cuda": 0, "torch": 0}
PARTIAL_COUNTS = {"cuda": 0, "torch": 0}
COMBINE_COUNTS = {"cuda": 0, "torch": 0}
FP8_COUNTS = {"cuda": 0, "torch": 0}
PARTIAL_FP8_COUNTS = {"cuda": 0, "torch": 0}
NEG_INF = -1e30
#: cache rows per KV tile of the FMA verify and prefill bodies
TILE = 16
#: tiles per split of those bodies (at least; raised so a slot never has
#: more than MAX_SPLITS splits, which bounds their scratch)
TILES_PER_SPLIT = 2
MAX_SPLITS = 16

#: keys per KV tile of the decode kernels (``decode::kKeys``)
DECODE_KEYS = 64
#: fewest tiles a decode CTA walks: the second tile's copies are in flight
#: under the first one's math
DECODE_TILES_PER_CTA = 2
#: most CTAs of one thread-block cluster (the portable limit;
#: ``decode::kMaxCluster``)
MAX_CLUSTER = 8
#: largest K/V row of the decode kernels, hd * itemsize (bytes):
#: float8 up to hd 512, bfloat16 up to hd 256, float32 up to hd 128
MAX_ROW_BYTES = 512
#: largest dynamic shared memory of one block on the H100 (bytes)
MAX_SMEM = 232_448


def split_plan(n_tiles: int) -> tuple[int, int]:
    """(tiles per split, splits) of a split-K pass over ``n_tiles`` tiles."""
    per = max(TILES_PER_SPLIT, -(-n_tiles // MAX_SPLITS))
    return per, -(-n_tiles // per)


def decode_plan(n_keys: int) -> tuple[int, int]:
    """(64-key tiles per CTA, CTAs per cluster) of the decode kernels over a
    slot of ``n_keys`` key positions (paged: (W - 1) * page; dense: S):
    rank r walks tiles r * per .. r * per + per - 1.  At least
    ``DECODE_TILES_PER_CTA`` tiles a CTA, raised so a cluster never has
    more than ``MAX_CLUSTER`` CTAs.  It reads no length, so a captured CUDA
    graph stays valid at every replay.  At 512 keys: (2, 4); at 4096:
    (8, 8)."""
    n_tiles = max(1, -(-n_keys // DECODE_KEYS))
    per = max(DECODE_TILES_PER_CTA, -(-n_tiles // MAX_CLUSTER))
    return per, -(-n_tiles // per)


def rows_per_cta(group: int) -> int:
    """q rows of a GQA group one decode CTA holds (``decode::rows_per_cta``):
    the next power of two, at most 4; a wider group takes several CTAs."""
    g = 1
    while g < min(group, 4):
        g *= 2
    return g


def decode_smem_bytes(group: int, hd: int, itemsize: int, table_ints: int = 0) -> int:
    """``decode::smem_bytes``: a 2-stage ring of 64-key K and V tiles in the
    cache's dtype, the warps' (m, l), and ``table_ints`` block-table
    entries (paged)."""
    return 2 * 2 * DECODE_KEYS * hd * itemsize + 4 * 4 * 2 * rows_per_cta(group) + 4 * table_ints


def decode_core(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    """Length-masked softmax attention in fp32 over a dense cache, zeros for
    ``lengths <= 0``.  q: [B, H, hd]; k/v: [B, S, kvH, hd] -> [B, H, hd]."""
    b, h, hd = q.shape
    kvh = k.shape[2]
    qf = q.float().reshape(b, kvh, h // kvh, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k.float()) * hd**-0.5
    kpos = torch.arange(k.shape[1], device=q.device)
    live = kpos[None, :] < lengths[:, None]  # [B, S]
    s = torch.where(live[:, None, None, :], s, torch.full_like(s, NEG_INF))
    out = torch.einsum("bkgs,bskd->bkgd", torch.softmax(s, dim=-1), v.float())
    out = torch.where((lengths > 0)[:, None, None, None], out, torch.zeros_like(out))
    return out.reshape(b, h, hd).to(q.dtype)


def decode_attention_torch(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    """Plain version: ``decode_core``.  q: [B, H, hd]; k/v: [B, S, kvH, hd]
    -> [B, H, hd]."""
    (FP8_COUNTS if k.element_size() == 1 else COUNTS)["torch"] += 1
    return decode_core(q, k, v, lengths)


def decode_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    """Launch the CUDA kernel (one launch, no scratch) on the current
    stream; the output is allocated here.  q: [B, H, hd]; k/v: [B, S, kvH,
    hd] of q's dtype (float32 or bfloat16); lengths: [B] int32 (clamped to
    S by the kernel).  k/v may instead be float8 (``KV_DTYPE_CODES``).
    Returns a new [B, H, hd] tensor.  Raises on CPU tensors or arguments
    the kernel does not take."""
    _check(q, k, v, lengths)
    b, h, hd = q.shape
    _, s, kvh, _ = k.shape
    per, cluster = decode_plan(s)
    out = torch.empty_like(q)
    lib = build.load(_library(k))
    err = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, h, kvh, hd, s, per, cluster, build.DTYPE_CODES[q.dtype],
        build.KV_DTYPE_CODES[k.dtype], q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check_launch(lib, err, "decode_attention")
    (FP8_COUNTS if k.element_size() == 1 else COUNTS)["cuda"] += 1
    return out


def decode_partial_core(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The unnormalised state of ``decode_core`` over a dense cache block:
    ``(acc [B, H, hd], ml [B, H, 2])`` in fp32 with ``m`` the largest live
    score, ``l`` the sum of ``exp(s - m)`` and ``acc`` the same weights
    times V; a row with no live key has ``l = 0`` and ``acc = 0``."""
    b, h, hd = q.shape
    kvh = k.shape[2]
    qf = q.float().reshape(b, kvh, h // kvh, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k.float()) * hd**-0.5
    kpos = torch.arange(k.shape[1], device=q.device)
    live = (kpos[None, :] < lengths[:, None])[:, None, None, :]  # [B, 1, 1, S]
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(s - m), torch.zeros_like(s))
    acc = torch.einsum("bkgs,bskd->bkgd", p, v.float()).reshape(b, h, hd)
    ml = torch.stack([m[..., 0], p.sum(-1)], dim=-1).reshape(b, h, 2)
    return acc, ml


def combine_partials_core(acc: torch.Tensor, ml: torch.Tensor,
                          dtype: torch.dtype) -> torch.Tensor:
    """Merge n blocks' partials ``acc [B, n, H, hd]`` / ``ml [B, n, H, 2]``:
    ``sum e^(m - M) acc / sum e^(m - M) l`` over the blocks that saw a key
    (``l != 0``, a NaN included), zeros where none did.  -> [B, H, hd] in
    ``dtype``."""
    m, l = ml[..., 0], ml[..., 1]
    seen = l != 0
    big = torch.where(seen, m, torch.full_like(m, -torch.inf)).amax(dim=1, keepdim=True)
    w = torch.where(seen, torch.exp(m - big), torch.zeros_like(m))
    den = (w * l).sum(1)[..., None]
    num = (w[..., None] * acc).sum(1)
    return torch.where(den == 0, torch.zeros_like(num), num / den).to(dtype)


def decode_attention_partial_torch(q, k, v, lengths):
    """Plain version of the partial form: ``decode_partial_core``."""
    (PARTIAL_FP8_COUNTS if k.element_size() == 1 else PARTIAL_COUNTS)["torch"] += 1
    return decode_partial_core(q, k, v, lengths)


def combine_splits_torch(acc, ml, dtype):
    """Plain version of the merge: ``combine_partials_core``."""
    COMBINE_COUNTS["torch"] += 1
    return combine_partials_core(acc, ml, dtype)


def decode_attention_partial(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the partial form (one launch, the decode kernel's plan from
    S) on the current stream.  Arguments as ``decode_attention``; returns
    new fp32 tensors ``(acc [B, H, hd], ml [B, H, 2])``.  Raises on CPU
    tensors or arguments the kernel does not take."""
    _check(q, k, v, lengths)
    b, h, hd = q.shape
    _, s, kvh, _ = k.shape
    per, cluster = decode_plan(s)
    acc = torch.empty((b, h, hd), dtype=torch.float32, device=q.device)
    ml = torch.empty((b, h, 2), dtype=torch.float32, device=q.device)
    lib = build.load(_library(k))
    err = lib.decode_attention_partial_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), acc.data_ptr(),
        ml.data_ptr(), b, h, kvh, hd, s, per, cluster, build.DTYPE_CODES[q.dtype],
        build.KV_DTYPE_CODES[k.dtype], q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check_launch(lib, err, "decode_attention_partial")
    (PARTIAL_FP8_COUNTS if k.element_size() == 1 else PARTIAL_COUNTS)["cuda"] += 1
    return acc, ml


def combine_splits(acc: torch.Tensor, ml: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Launch ``paged::combine_splits`` over n blocks' partials (fp32,
    contiguous ``[B, n, H, hd]`` / ``[B, n, H, 2]``) on the current stream;
    returns a new [B, H, hd] tensor of ``dtype``.  Raises on CPU tensors or
    arguments the kernel does not take."""
    req = build.require
    req(acc.is_cuda and ml.device == acc.device, "combine_splits needs CUDA tensors on one "
        "device")
    req(acc.dtype == torch.float32 and ml.dtype == torch.float32, "partials must be float32")
    req(dtype in build.DTYPE_CODES, f"unsupported dtype {dtype}")
    req(acc.ndim == 4 and ml.shape == (*acc.shape[:3], 2), "partials must be [B, n, H, hd] "
        "and [B, n, H, 2]")
    req(acc.is_contiguous() and ml.is_contiguous(), "partials must be contiguous")
    b, n, h, hd = acc.shape
    out = torch.empty((b, h, hd), dtype=dtype, device=acc.device)
    lib = build.load("decode_attention")
    err = lib.combine_splits_launch(
        acc.data_ptr(), ml.data_ptr(), out.data_ptr(), b, h, hd, n, build.DTYPE_CODES[dtype],
        acc.device.index, torch.cuda.current_stream(acc.device).cuda_stream,
    )
    build.check_launch(lib, err, "combine_splits")
    COMBINE_COUNTS["cuda"] += 1
    return out


def _library(k: torch.Tensor) -> str:
    """The kernel library of K / V rows like ``k``: 8-bit rows' own
    instantiations (``csrc/decode_attention_fp8.cu``) or q's type's."""
    return "decode_attention_fp8" if k.element_size() == 1 else "decode_attention"


def check_head_dim(hd: int, dtype: torch.dtype) -> None:
    """The decode kernels' rows: hd a multiple of 8 (of 16 for an 8-bit
    type: whole 16-byte chunks), at most ``MAX_ROW_BYTES`` bytes."""
    isz = torch.empty((), dtype=dtype).element_size()
    mult = 16 if isz == 1 else 8
    build.require(hd % mult == 0 and hd * isz <= MAX_ROW_BYTES,
                  f"head_dim {hd} must be a multiple of {mult} with rows of at most "
                  f"{MAX_ROW_BYTES} bytes ({MAX_ROW_BYTES // isz} in {dtype})")


def _check(q, k, v, lengths) -> None:
    req = build.require
    tensors = (q, k, v, lengths)
    req(all(t.is_cuda for t in tensors), "decode_attention kernel needs CUDA tensors")
    req(all(t.device == q.device for t in tensors), "tensors on different devices")
    req(q.dtype in build.DTYPE_CODES, f"unsupported dtype {q.dtype}")
    req(v.dtype == k.dtype and (k.dtype == q.dtype or k.dtype in build.KV_DTYPE_CODES
                                and k.element_size() == 1),
        "k and v must share q's dtype or one float8 type")
    req(lengths.dtype == torch.int32, "lengths must be int32")
    req(q.ndim == 3 and k.ndim == 4 and lengths.ndim == 1, "bad ranks")
    b, h, hd = q.shape
    kb, _, kvh, khd = k.shape
    req(v.shape == k.shape, "k and v shapes differ")
    req(khd == hd, f"head_dim {khd} of k does not match q's {hd}")
    check_head_dim(hd, k.dtype)
    req(kvh > 0 and h % kvh == 0, f"q heads {h} not a multiple of kv heads {kvh}")
    req(kb == b and lengths.shape[0] == b, "batch mismatch")
    req(all(t.is_contiguous() for t in tensors), "tensors must be contiguous")
    req(all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
        "q, k and v must be 16-byte aligned")
