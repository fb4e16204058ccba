"""int8 error-feedback gradient compression (counterpart of
``repro.optim.compression``: ``_quantize``, ``ef_int8_compress_decompress``
and ``compressed_psum``).

Each gradient leaf, plus the residual carried from the last step, is
quantized to int8 with one per-leaf scale and dequantized at once; the
quantization error goes back into the error-feedback buffer for the next
step (Karimireddy et al., EF-SGD).  Every operation is the reference's, in
fp32 and in its order: ``torch.round`` rounds half to even as ``jnp.round``
does, so on the CPU the results are bit-equal to the reference's.
``compressed_psum`` exchanges the int8 payload and the scales over a
process group instead of the fp32 gradient.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.device import check_backend

#: the all-gather of one flat tensor (``all_gather_into_tensor`` is
#: deprecated where ``all_gather_single`` exists)
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _quantize(
    g: torch.Tensor, amax: Optional[torch.Tensor] = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)``: ``g / scale`` rounded to int8 in [-127, 127], scale
    the largest |g| over 127 (at least 1e-12 / 127).  ``amax`` replaces
    that largest |g| when ``g`` is one shard of the leaf (the largest over
    every shard)."""
    if amax is None:
        amax = torch.max(torch.abs(g))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def ef_int8_compress_decompress(
    g: torch.Tensor, err: torch.Tensor, *, amax: Optional[torch.Tensor] = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Local quantize / dequantize with error feedback (no collective):
    ``(dequantized gradient, new error buffer)``, both fp32, with
    ``deq + new_err == g + err`` up to the rounding of that sum.  A sharded
    leaf passes the largest ``|g + err|`` over its shards as ``amax``."""
    g32 = g.float() + err
    q, scale = _quantize(g32, amax)
    deq = q.float() * scale
    return deq, g32 - deq


def compressed_psum(
    g: torch.Tensor, err: torch.Tensor, group=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 EF exchange over ``group`` (a process group; the default one
    when None): ``(sum over ranks of scale_r * q_r, new error buffer)``.

    Each rank quantizes its ``g + err`` with its own scale, all-gathers the
    int8 payload and the scales, and sums the dequantized payloads locally
    in rank order: link bytes ~= size/4 * (n-1)/n against fp32 all-reduce's
    ~2*size*(n-1)/n."""
    check_backend(g.device, group)
    g32 = g.float() + err
    q, scale = _quantize(g32)
    new_err = g32 - q.float() * scale
    n = dist.get_world_size(group)
    qs = torch.empty((n, *q.shape), dtype=torch.int8, device=q.device)
    scales = torch.empty((n,), dtype=torch.float32, device=q.device)
    _all_gather(qs.view(-1), q.reshape(-1), group=group)
    _all_gather(scales, scale.reshape(1), group=group)
    summed = scales[0] * qs[0].float()
    for r in range(1, n):
        summed = summed + scales[r] * qs[r].float()
    return summed, new_err
