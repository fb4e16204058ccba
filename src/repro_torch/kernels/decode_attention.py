"""Dense flash-decode attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the TPU kernel ``repro/kernels/decode_attention.py``
(``decode_attention``; body ``_decode_kernel``).  The kernel is
``csrc/decode_attention.cu``: the paged decode kernel's body over a dense
``[B, S, kvH, hd]`` cache -- one block per (slot, kv head, split of 16-row
tiles) walks the slot's rows up to ``min(lengths, S)`` with the GQA group's
fp32 online-softmax state in shared memory, and a second kernel combines
the splits.  On the serving path it is the draft model's proposal step.
On the card it is bound by the bytes of the K/V rows it must read.

``decode_core`` is the plain math, shared with the paged decode's plain
version.  ``COUNTS["cuda"]`` counts kernel launches, ``COUNTS["torch"]``
calls of the plain version; ``repro_torch.kernels.ops`` reads and resets
them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

COUNTS = {"cuda": 0, "torch": 0}
NEG_INF = -1e30
#: cache rows per KV tile
TILE = 16
#: tiles per split (at least; raised so a slot never has more than
#: MAX_SPLITS splits, which bounds the scratch).  2 tiles give a 32-tile
#: slot 16 splits: 8 slots x 8 kv heads x 16 = 1024 blocks on 132 SMs
TILES_PER_SPLIT = 2
MAX_SPLITS = 16


def split_plan(n_tiles: int) -> tuple[int, int]:
    """(tiles per split, splits) of a split-K pass over ``n_tiles`` tiles."""
    per = max(TILES_PER_SPLIT, -(-n_tiles // MAX_SPLITS))
    return per, -(-n_tiles // per)


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
    COUNTS["torch"] += 1
    return decode_core(q, k, v, lengths)


def decode_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    """Launch the CUDA kernels (partial splits, then their combine) on the
    current stream; scratch and output are allocated here.  q: [B, H, hd];
    k/v: [B, S, kvH, hd] of q's dtype (float32 or bfloat16); lengths: [B]
    int32 (clamped to S by the kernel).  Returns a new [B, H, hd] tensor.
    Raises on CPU tensors or arguments the kernel does not take."""
    _check(q, k, v, lengths)
    b, h, hd = q.shape
    _, s, kvh, _ = k.shape
    pps, splits = split_plan(-(-s // TILE))
    out = torch.empty_like(q)
    part_acc = torch.empty((b, splits, h, hd), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((b, splits, h, 2), dtype=torch.float32, device=q.device)
    lib = build.load("decode_attention")
    err = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
        b, h, kvh, hd, s, TILE, pps, splits,
        build.DTYPE_CODES[q.dtype], q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check_launch(lib, err, "decode_attention")
    COUNTS["cuda"] += 1
    return out


def _check(q, k, v, lengths) -> None:
    req = build.require
    tensors = (q, k, v, lengths)
    req(all(t.is_cuda for t in tensors), "decode_attention kernel needs CUDA tensors")
    req(all(t.device == q.device for t in tensors), "tensors on different devices")
    req(q.dtype in build.DTYPE_CODES, f"unsupported dtype {q.dtype}")
    req(k.dtype == q.dtype and v.dtype == q.dtype, "q, k and v must share one dtype")
    req(lengths.dtype == torch.int32, "lengths must be int32")
    req(q.ndim == 3 and k.ndim == 4 and lengths.ndim == 1, "bad ranks")
    b, h, hd = q.shape
    kb, _, kvh, khd = k.shape
    req(v.shape == k.shape, "k and v shapes differ")
    req(khd == hd and hd % 8 == 0, f"head_dim {hd} must match and be a multiple of 8")
    req(kvh > 0 and h % kvh == 0, f"q heads {h} not a multiple of kv heads {kvh}")
    req(kb == b and lengths.shape[0] == b, "batch mismatch")
    req(all(t.is_contiguous() for t in tensors), "tensors must be contiguous")
    req(all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
        "q, k and v must be 16-byte aligned")
