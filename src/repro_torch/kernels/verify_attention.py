"""Dense chunk-verify attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the TPU kernel ``repro/kernels/verify_attention.py:110``
(``verify_attention``, ``pallas_call`` at ``:169``; body
``_verify_kernel``).  The kernel is ``verify_attention_launch`` in
``csrc/verify_attention.cu`` (the library also holds the dense tree
verify): the T = gamma + 1 chunk rows of a slot sit at ``start = lengths -
T`` of a dense ``[B, S, kvH, hd]`` cache and row t sees ``kpos <= start +
t``.  ``lengths`` is not clamped (keys stop at S); rows whose causal window
is empty give zeros.  On the serving path it is a dense-layout target's
verify pass of a draft-model round.  On the card it is bound by the bytes
of the K/V rows it must read, and at serving sizes by the latency and fixed
costs of a short walk.  ``verify_body`` (the paged verify's rule) picks one
of two bodies from dtype and head dim alone:

* ``"tc"`` (bfloat16 at hd 64 or 128; ``csrc/prefill_tc.cuh``): one
  launch.  The slot's 64-key tiles are split across the CTAs of one
  thread-block cluster by ``dense_verify_plan`` (``tiles_per_cta`` tiles
  each, at least two); every CTA runs S = Q K^T and P V on the tensor
  cores (``wgmma``) with the softmax in registers over its tiles, then the
  cluster merges the splits' (m, l, O) through distributed shared memory
  and writes the normalised rows -- no second launch and no fp32 scratch
  in device memory, which the paged verify's two-launch split pays;
* ``"fma"`` (float32, or another head dim): the paged verify's FMA body over
  the dense rows -- one block per (kv head, slot, chunk rows, split of
  16-row tiles) with the fp32 online-softmax state in shared memory, then
  its combine kernel (``paged::combine_splits``) -- which the fp32 parity
  checks hold to 1e-4.

The plain version is ``verify_core``, the reference's XLA
``verify_attention``.  ``COUNTS["cuda"]`` counts kernel launches,
``COUNTS["torch"]`` calls of the plain version; ``repro_torch.kernels.ops``
reads and resets them.  ``BODY_COUNTS`` splits the launches by body.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import TILE, split_plan
from repro_torch.kernels.paged_verify_attention import (
    MAX_SMEM,
    TC_KEYS,
    TC_TILES_PER_SPLIT,
    VERIFY_ROWS,
    smem_bytes,
    verify_body,
    verify_core,
)
from repro_torch.kernels.prefill_attention import BODY_CODES

COUNTS = {"cuda": 0, "torch": 0}
#: kernel launches by body ("tc": tensor cores, "fma": CUDA cores)
BODY_COUNTS = {"tc": 0, "fma": 0}
#: most CTAs of one thread-block cluster (the portable limit;
#: ``prefill_tc::kMaxCluster``)
MAX_CLUSTER = 8


def dense_verify_plan(s: int) -> tuple[int, int]:
    """(64-key tiles per CTA, CTAs per cluster) of the tensor-core body over
    a dense cache of ``s`` rows: at least ``TC_TILES_PER_SPLIT`` tiles a CTA
    (the second tile's fetch runs under the first one's math), raised so a
    cluster never has more than ``MAX_CLUSTER`` CTAs.  At the serving
    S = 512: 8 tiles, (2, 4)."""
    n_tiles = -(-s // TC_KEYS)
    per = max(TC_TILES_PER_SPLIT, -(-n_tiles // MAX_CLUSTER))
    return per, max(1, -(-n_tiles // per))


def tc_smem_bytes(hd: int) -> int:
    """``prefill_tc::smem_bytes<hd>(0)`` of the tensor-core body: the Q tile,
    a K and a V tile per stage of the 2-stage ring and 1024 bytes of
    alignment slack; the merge reuses the ring."""
    return 5 * (64 * hd * 2) + 1024


def verify_attention_torch(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    """Plain version: ``verify_core``.  q: [B, T, H, hd]; k/v: [B, S, kvH,
    hd] -> [B, T, H, hd]."""
    COUNTS["torch"] += 1
    return verify_core(q, k, v, lengths)


def launch_dense_verify(name, q, k, v, lengths, anc=None):
    """Launch entry point ``<name>_launch`` (the dense verify or tree
    verify) of the ``verify_attention`` library on the current stream in
    the body ``verify_body`` picks: the tensor-core cluster kernel (one
    launch, no scratch), or the FMA split pass over 16-row tiles and its
    combine.  Scratch and output are allocated here.  Returns the output
    and the body."""
    b, t, h, hd = q.shape
    _, s, kvh, _ = k.shape
    body = verify_body(q.dtype, hd)
    out = torch.empty_like(q)
    scratch = [None, None]  # the FMA body's fp32 partial state
    if body == "tc":
        per, splits = dense_verify_plan(s)
    else:
        per, splits = split_plan(-(-s // TILE))
        scratch = [torch.empty((b, splits, kvh, t * (h // kvh), n), dtype=torch.float32,
                               device=q.device) for n in (hd, 2)]
    lib = build.load("verify_attention")
    fn = getattr(lib, f"{name}_launch")
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr()]
    if anc is not None:
        ptrs.append(anc.data_ptr())
    err = fn(
        *ptrs, out.data_ptr(), *[x if x is None else x.data_ptr() for x in scratch],
        b, t, h, kvh, hd, s, TILE, per, splits,
        build.DTYPE_CODES[q.dtype], BODY_CODES[body], q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check_launch(lib, err, name)
    return out, body


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
    if verify_body(q.dtype, hd) == "tc":
        need = tc_smem_bytes(hd)
    else:
        need = smem_bytes(min(t, VERIFY_ROWS) * (h // kvh), hd, TILE)
    req(need <= MAX_SMEM, f"a verify block needs {need} bytes of shared memory "
        f"(group {h // kvh}, hd {hd}); at most {MAX_SMEM}")
    req(all(x.is_contiguous() for x in tensors), "tensors must be contiguous")
    req(all(x.data_ptr() % 16 == 0 for x in (q, k, v)),
        "q, k and v must be 16-byte aligned")


def verify_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    """Launch the CUDA kernel(s).  q: [B, T, H, hd]; k/v: [B, S, kvH, hd] of
    q's dtype (float32 or bfloat16), the chunk's K/V already at rows
    ``lengths - T .. lengths - 1``; lengths: [B] int32 including the chunk.
    Returns a new [B, T, H, hd] tensor.  Raises on CPU tensors or arguments
    the kernel does not take."""
    check_dense_verify(q, k, v, lengths, "verify_attention")
    out, body = launch_dense_verify("verify_attention", q, k, v, lengths)
    COUNTS["cuda"] += 1
    BODY_COUNTS[body] += 1
    return out
