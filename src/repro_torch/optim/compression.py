"""int8 error-feedback gradient compression (counterpart of
``repro.optim.compression``'s ``_quantize`` and
``ef_int8_compress_decompress``).

Each gradient leaf, plus the residual carried from the last step, is
quantized to int8 with one per-leaf scale and dequantized at once; the
quantization error goes back into the error-feedback buffer for the next
step (Karimireddy et al., EF-SGD).  Every operation is the reference's, in
fp32 and in its order: ``torch.round`` rounds half to even as ``jnp.round``
does, so on the CPU the results are bit-equal to the reference's.  The
exchange of the int8 payload across devices (``compressed_psum``) needs a
collective and comes with scale-out.
"""
from __future__ import annotations

import torch


def _quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)``: ``g / scale`` rounded to int8 in [-127, 127], scale
    the largest |g| over 127 (at least 1e-12 / 127)."""
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def ef_int8_compress_decompress(
    g: torch.Tensor, err: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Local quantize / dequantize with error feedback (no collective):
    ``(dequantized gradient, new error buffer)``, both fp32, with
    ``deq + new_err == g + err`` up to the rounding of that sum."""
    g32 = g.float() + err
    q, scale = _quantize(g32)
    deq = q.float() * scale
    return deq, g32 - deq
