"""Mamba1 state-space block (falcon-mamba): the serving half.

Counterpart of the Mamba1 part of ``repro.models.ssm``: ``causal_conv`` /
``causal_conv_step`` (the depthwise causal convolution over a sequence and
one decode step), ``init_mamba1``, ``selective_scan_chunked`` (the whole
sequence in one ``ops.ssm_scan_chunk`` -- one kernel launch on CUDA
tensors, where the reference scans 64-step chunks), and the decode state
(``mamba1_init_state``, ``mamba1_step``).
Plain functions on tensors with an explicit device; the training block
(``mamba1_block``, which needs a backward of the scan) is not ported yet.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

Params = Any


# ---------------------------------------------------------------------------
# Depthwise causal conv
# ---------------------------------------------------------------------------


def causal_conv(
    x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]
) -> torch.Tensor:
    """x: [B, S, C]; w: [K, C] depthwise kernel; left-padded causal conv:
    ``out[t] = sum_j x[t - K + 1 + j] * w[j] (+ b)``."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for j in range(k):
        out = out + xp[:, j: j + s, :] * w[j]
    if b is not None:
        out = out + b
    return out


def causal_conv_step(
    x_t: torch.Tensor,
    conv_state: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor],
) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step.  x_t: [B, C]; conv_state: [B, K - 1, C] (the past
    inputs).  Returns ``(out [B, C], new conv_state)``."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)
    out = torch.einsum("bkc,kc->bc", window, w)
    if b is not None:
        out = out + b
    return out, window[:, 1:, :]


# ---------------------------------------------------------------------------
# Mamba1 (falcon-mamba)
# ---------------------------------------------------------------------------


def init_mamba1(cfg: ModelConfig, gen: torch.Generator, dtype: torch.dtype) -> Params:
    """The reference's names, shapes, dtypes and scales
    (``repro.models.ssm.init_mamba1``): ``A_log`` and ``D`` are fp32 whatever
    ``dtype`` is.  The numbers come from ``gen``."""
    d, di, ds = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dtr, k = cfg.resolved_dt_rank, cfg.ssm_conv
    dev = gen.device

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    arange = torch.arange(1, ds + 1, dtype=torch.float32, device=dev)
    return {
        "in_proj": normal(d, 2 * di) * d**-0.5,
        "conv_w": normal(k, di) * k**-0.5,
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": normal(di, dtr + 2 * ds) * di**-0.5,
        "dt_proj": normal(dtr, di) * dtr**-0.5,
        "dt_bias": torch.full((di,), -2.0, dtype=dtype, device=dev),
        "A_log": torch.log(arange).expand(di, ds).contiguous(),
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": normal(di, d) * di**-0.5,
    }


def selective_scan_chunked(
    xi: torch.Tensor,
    dt: torch.Tensor,
    B_: torch.Tensor,
    C_: torch.Tensor,
    A: torch.Tensor,
    h0: torch.Tensor,
    impl: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Selective scan ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t``,
    ``y_t = h_t . C_t``.  xi/dt: [B, S, di]; B_/C_: [B, S, ds]; A: [di, ds];
    h0: [B, di, ds].  Returns ``(y [B, S, di], h_final)``, fp32.  The whole
    sequence is one ``ops.ssm_scan_chunk``: the kernel keeps h in registers
    and the plain version steps one t at a time, so neither needs the
    reference's 64-step chunks (they bound its XLA path's [B, chunk, di,
    ds] state tensor)."""
    return ops.ssm_scan_chunk(xi, dt, B_, C_, A, h0, impl=impl)


def mamba1_init_state(
    cfg: ModelConfig, batch: int, dtype: torch.dtype, device: str | torch.device
) -> Params:
    """conv: [B, K - 1, di] in ``dtype``; h: [B, di, ds] fp32."""
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state), dtype=torch.float32,
                         device=device),
    }


def mamba1_step(
    cfg: ModelConfig, p: Params, x_t: torch.Tensor, state: Params
) -> tuple[torch.Tensor, Params]:
    """One decode step.  x_t: [B, d]; state: conv [B, K - 1, di], h [B, di,
    ds].  Returns ``(y [B, d], new state)``."""
    ds, dtr = cfg.ssm_state, cfg.resolved_dt_rank
    xz = x_t @ p["in_proj"]
    xi, z = xz.chunk(2, dim=-1)
    xi, conv_state = causal_conv_step(xi, state["conv"], p["conv_w"], p["conv_b"])
    xi = F.silu(xi)
    dbc = xi @ p["x_proj"]
    dt_r, B_, C_ = torch.split(dbc, [dtr, ds, ds], dim=-1)
    dt = F.softplus(dt_r @ p["dt_proj"] + p["dt_bias"]).float()
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt[..., None] * A)  # [B, di, ds]
    h = a * state["h"] + (dt * xi.float())[..., None] * B_.float()[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, C_.float()).to(x_t.dtype)
    y = y + p["D"].to(x_t.dtype) * xi
    y = y * F.silu(z)
    return y @ p["out_proj"], {"conv": conv_state, "h": h}
