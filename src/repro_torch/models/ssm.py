"""Mamba1 (falcon-mamba) and Mamba2 (zamba2) state-space blocks.

Counterpart of ``repro.models.ssm``: ``causal_conv`` / ``causal_conv_step``
(the depthwise causal convolution over a sequence and one decode step);
Mamba1, serving and training -- ``init_mamba1``, ``selective_scan_chunked``
(the whole sequence in one ``ops.ssm_scan_chunk``: one kernel launch on
CUDA tensors, where the reference scans 64-step chunks; differentiable,
through the scan's backward kernel), the full-sequence block
(``mamba1_block``, the reference's training block; ``mamba1_with_state``
also returns the decode state a prefill leaves) and the decode state
(``mamba1_init_state``, ``mamba1_step``).  Mamba2, serving and training:
``init_mamba2``, the SSD in its chunked matmul form (``_segsum``,
``ssd_chunked``), the full-sequence block
(``mamba2_block``; ``mamba2_with_state`` also returns the decode state a
prefill leaves) and the decode state (``mamba2_init_state``,
``mamba2_step``).  ``tail_state`` / ``dt_mask`` make a bucket-padded
prompt's state equal the unpadded one's, for both versions.  The reference computes the SSD with XLA einsums and no
Pallas kernel, so it is plain PyTorch here (on the card too), with the
reference's 64-step chunks and einsum order; autograd differentiates it.
Plain functions on tensors with an explicit device.

Under an ``act_sharding`` context whose ``d_inner`` splits over ``model``
(``split("bti")``) both versions run on this rank's blocks, as the
reference's specs place them (``runtime.sharding``): the input enters
through ``copy_to_model`` (``layers.tp_entry``); the ``in_proj`` /
``in_proj_zx`` halves, the conv, ``dt_proj``, A, D, the scan or the SSD,
the gate and the decode state are the rank's ``d_inner / m`` columns (Mamba2: its ``nh / m`` heads, whose
dt, ``A_log``, D and ``dt_bias`` entries it reads from the replicated
leaves); Mamba1's ``x_proj`` product (dt_r, B, C) and Mamba2's gated norm's
sum of squares are partial sums over ``model`` (``all_reduce_model``);
``out_proj`` is row-parallel (``reduce_from_model``).
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import act_sharding as AS
from repro_torch.models import layers as L

Params = Any
#: steps per SSD chunk (the reference's ``DEFAULT_CHUNK``)
DEFAULT_CHUNK = 64


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
# Bucket padding: the decode state of a zero-padded prompt
# ---------------------------------------------------------------------------


def tail_state(x: torch.Tensor, length, n: int) -> torch.Tensor:
    """The last ``n`` steps before ``length``, left zero-padded: the decode
    conv state of a bucket-padded prompt of true ``length`` (an int or a 0-d
    integer tensor: a gather, so a device length costs no host sync)."""
    if length is None:
        return x[:, -n:, :]
    xp = F.pad(x, (0, 0, n, 0))
    steps = L.device_scalar(length, x.device).long() + torch.arange(n, device=x.device)
    return xp.index_select(1, steps)


def dt_mask(dt: torch.Tensor, length) -> torch.Tensor:
    """Zero the SSM step size at pad positions (>= ``length``, an int or a
    0-d integer tensor): dt = 0 makes the recurrence a no-op (decay exp(0) =
    1, input term 0)."""
    if length is None:
        return dt
    valid = torch.arange(dt.shape[1], device=dt.device) < length
    return dt * valid[None, :, None]


# ---------------------------------------------------------------------------
# d_inner over the model axis
# ---------------------------------------------------------------------------


def _tp_out(y: torch.Tensor) -> torch.Tensor:
    """``out_proj``'s product: summed over ``model`` when ``d_inner``
    splits (row-parallel)."""
    return AS.reduce_from_model(y) if AS.split("bti") else y


def check_head_split(cfg: ModelConfig, model: int) -> None:
    """Raise ``ValueError`` where a Mamba2 ``d_inner`` split over ``model``
    ranks does not fall on whole SSM heads (no reference config does)."""
    if cfg.ssm_version != 2 or model == 1 or cfg.d_inner % model:
        return
    if cfg.ssm_num_heads % model:
        raise ValueError(
            f"{cfg.name}: d_inner {cfg.d_inner} split {model} ways gives "
            f"{cfg.d_inner // model} columns a rank, not whole SSM heads of "
            f"{cfg.ssm_head_dim} ({cfg.ssm_num_heads} heads over {model} ranks)")


def _local_heads(cfg: ModelConfig, width: int) -> slice:
    """The SSM heads of this rank's ``width`` columns of ``d_inner`` (all
    of them unless ``d_inner`` splits)."""
    if not AS.split("bti"):
        return slice(0, cfg.ssm_num_heads)
    check_head_split(cfg, AS.model_size())
    n = width // cfg.ssm_head_dim
    return slice(AS.model_rank() * n, (AS.model_rank() + 1) * n)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, weight: torch.Tensor,
                d_inner: int, eps: float = 1e-6) -> torch.Tensor:
    """Mamba2's gated RMSNorm ``rms_norm(y * silu(z), weight)`` over the
    whole ``d_inner``, in ``layers.rms_norm``'s order; on a split
    ``d_inner`` the sum of squares of this rank's columns is summed over
    ``model`` (``all_reduce_model``) and divided by the whole width."""
    v = y * F.silu(z)
    if not AS.split("bti"):
        return L.rms_norm(v, weight, eps)
    v32 = v.float()
    ss = AS.all_reduce_model((v32 * v32).sum(dim=-1, keepdim=True))
    return (v32 * torch.rsqrt(ss / d_inner + eps) * weight.float()).to(v.dtype)


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


def mamba1_block(
    cfg: ModelConfig, p: Params, x: torch.Tensor, impl: str = "auto"
) -> torch.Tensor:
    """Full-sequence Mamba1 block from a zero state (the reference's
    training block).  x: [B, S, d]."""
    return mamba1_with_state(cfg, p, x, impl)[0]


def mamba1_with_state(
    cfg: ModelConfig, p: Params, x: torch.Tensor, impl: str = "auto",
    length=None,
) -> tuple[torch.Tensor, Params]:
    """The Mamba1 block over a sequence (x: [B, S, d]) from a zero state,
    also returning the decode state after it: the conv window (the last
    ``conv - 1`` raw inputs before ``length``) and the SSM state.
    ``length`` marks a bucket-padded prompt's true length: pad steps get
    dt = 0, so the state is exactly the unpadded prompt's.  The scan runs
    under ``impl`` (``ops.ssm_scan_chunk``)."""
    b = x.shape[0]
    ds, dtr = cfg.ssm_state, cfg.resolved_dt_rank
    xi_raw, z = (L.tp_entry(x, "bti") @ p["in_proj"]).chunk(2, dim=-1)
    di = xi_raw.shape[-1]  # this rank's d_inner columns
    conv_state = tail_state(xi_raw, length, cfg.ssm_conv - 1)
    xi = F.silu(causal_conv(xi_raw, p["conv_w"], p["conv_b"]))
    dbc = xi @ p["x_proj"]
    if AS.split("bti"):
        dbc = AS.all_reduce_model(dbc)
    dt_r, B_, C_ = torch.split(dbc, [dtr, ds, ds], dim=-1)
    dt = dt_mask(F.softplus(dt_r @ p["dt_proj"] + p["dt_bias"]).float(), length)
    A = -torch.exp(p["A_log"])
    h0 = torch.zeros((b, di, ds), dtype=torch.float32, device=x.device)
    y, h_fin = selective_scan_chunked(
        xi.float(), dt, B_.float(), C_.float(), A, h0, impl=impl,
    )
    y = y.to(x.dtype) + p["D"].to(x.dtype) * xi
    y = y * F.silu(z)
    return _tp_out(y @ p["out_proj"]), {"conv": conv_state, "h": h_fin}


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
    xz = L.tp_entry(x_t, "bti") @ p["in_proj"]
    xi, z = xz.chunk(2, dim=-1)
    xi, conv_state = causal_conv_step(xi, state["conv"], p["conv_w"], p["conv_b"])
    xi = F.silu(xi)
    dbc = xi @ p["x_proj"]
    if AS.split("bti"):
        dbc = AS.all_reduce_model(dbc)
    dt_r, B_, C_ = torch.split(dbc, [dtr, ds, ds], dim=-1)
    dt = F.softplus(dt_r @ p["dt_proj"] + p["dt_bias"]).float()
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt[..., None] * A)  # [B, di, ds]
    h = a * state["h"] + (dt * xi.float())[..., None] * B_.float()[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, C_.float()).to(x_t.dtype)
    y = y + p["D"].to(x_t.dtype) * xi
    y = y * F.silu(z)
    return _tp_out(y @ p["out_proj"]), {"conv": conv_state, "h": h}


# ---------------------------------------------------------------------------
# Mamba2 (zamba2): the SSD in its chunked matmul form
# ---------------------------------------------------------------------------


def init_mamba2(cfg: ModelConfig, gen: torch.Generator, dtype: torch.dtype) -> Params:
    """The reference's names, shapes, dtypes and scales
    (``repro.models.ssm.init_mamba2``): the projections unpacked (z / x
    apart from B / C / dt, conv_x apart from conv_bc); ``A_log``, ``D`` and
    ``dt_bias`` are fp32 whatever ``dtype`` is.  The numbers come from
    ``gen``."""
    d, di, ds = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh, k = cfg.ssm_num_heads, cfg.ssm_conv
    dev = gen.device

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    def full(n, value, dt):
        return torch.full((n,), value, dtype=dt, device=dev)

    return {
        "in_proj_zx": normal(d, 2 * di) * d**-0.5,
        "in_proj_bcdt": normal(d, 2 * ds + nh) * d**-0.5,
        "conv_x_w": normal(k, di) * k**-0.5,
        "conv_x_b": full(di, 0.0, dtype),
        "conv_bc_w": normal(k, 2 * ds) * k**-0.5,
        "conv_bc_b": full(2 * ds, 0.0, dtype),
        "A_log": full(nh, 0.0, torch.float32),
        "D": full(nh, 1.0, torch.float32),
        "dt_bias": full(nh, -2.0, torch.float32),
        "gate_norm": full(di, 1.0, dtype),
        "out_proj": normal(di, d) * di**-0.5,
    }


def _segsum(logd: torch.Tensor) -> torch.Tensor:
    """logd: [..., Q] -> [..., Q, Q] lower-triangular cumulative log decay:
    ``out[i, j] = sum_{t = j + 1 .. i} logd[t]``, -inf above the diagonal."""
    q = logd.shape[-1]
    cs = torch.cumsum(logd, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=logd.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(
    x: torch.Tensor,
    dt: torch.Tensor,
    B_: torch.Tensor,
    C_: torch.Tensor,
    A: torch.Tensor,
    h0: torch.Tensor,
    chunk: int = DEFAULT_CHUNK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD: ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t``, ``y_t = h_t
    C_t`` per head, over ``chunk``-step chunks (the sequence zero-padded to
    whole chunks, which adds nothing: dt = 0 there).  x: [B, S, nh, hp];
    dt: [B, S, nh]; B_ / C_: [B, S, ds]; A: [nh] (negative); h0: [B, nh, hp,
    ds].  Returns ``(y [B, S, nh, hp], h_final)``, fp32.

    The reference's chunk body and einsums: inside a chunk the intra-chunk
    part is a masked product of decays (``_segsum``) and scores, the state
    carried in enters through ``C``, and the chunk's inputs update it.  The
    reference scans the chunks one by one; here every chunk's products run
    at once (one launch each, whatever S) and only the state hand-off,
    ``h' = exp(cum[-1]) h + the chunk's input``, walks the chunks."""
    b, s, nh, hp = x.shape
    nc = max(1, -(-s // chunk))
    pad = nc * chunk - s
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, pad))
    x = x.reshape(b, nc, chunk, nh, hp)
    dt = dt.reshape(b, nc, chunk, nh)
    B_ = B_.reshape(b, nc, chunk, -1)
    C_ = C_.reshape(b, nc, chunk, -1)
    logd = dt * A  # [B, nc, Q, nh] log decay per step
    L = torch.exp(_segsum(logd.movedim(-1, 2)))  # [B, nc, nh, Q, Q]
    # intra-chunk: scores[q, p] = C_q . B_p, weighted by decay and dt_p
    scores = torch.einsum("bcqn,bcpn->bcqp", C_, B_)
    M = L * scores[:, :, None] * dt.movedim(-1, 2)[:, :, :, None, :]
    y = torch.einsum("bchqp,bcphx->bcqhx", M, x)
    # each chunk's own input to the state: sum_p exp(cum[-1] - cum[p]) dt_p x_p B_p
    cum = torch.cumsum(logd, dim=2)  # [B, nc, Q, nh]
    decay_out = torch.exp(cum[:, :, -1:] - cum)
    dx = (dt * decay_out)[..., None] * x  # [B, nc, Q, nh, hp]
    inputs = torch.einsum("bcqnx,bcqs->bcnxs", dx, B_)
    # the hand-off: the state entering each chunk, h' = exp(cum[-1]) h + input
    decay_chunk = torch.exp(cum[:, :, -1])[..., None, None]  # [B, nc, nh, 1, 1]
    h, h_in = h0, []
    for c in range(nc):
        h_in.append(h)
        h = decay_chunk[:, c] * h + inputs[:, c]
    # inter-chunk: the carried state's contribution, the reference's
    # einsum("bqn,bnxs,bqs->bqnx") with h . C contracted first (left to
    # right, torch would form a [B, Q, nh, hp, ds] product)
    y_inter = torch.einsum("bcnxs,bcqs->bcqnx", torch.stack(h_in, 1), C_)
    y = y + y_inter * torch.exp(cum)[..., None]
    return y.reshape(b, nc * chunk, nh, hp)[:, :s], h


def mamba2_block(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence Mamba2 block from a zero state.  x: [B, S, d]."""
    return mamba2_with_state(cfg, p, x)[0]


def mamba2_with_state(
    cfg: ModelConfig, p: Params, x: torch.Tensor, length=None
) -> tuple[torch.Tensor, Params]:
    """The Mamba2 block over a sequence (x: [B, S, d]) from a zero state,
    also returning the decode state after it: the conv windows (the last
    ``conv - 1`` raw inputs before ``length``) and the SSM state.
    ``length`` marks a bucket-padded prompt's true length: pad steps get
    dt = 0, so the state is exactly the unpadded prompt's.  The output is
    the gated RMSNorm ``rms_norm(y * silu(z), gate_norm)`` projected back
    to d."""
    b, s, _ = x.shape
    ds, nh, hp = cfg.ssm_state, cfg.ssm_num_heads, cfg.ssm_head_dim
    x = L.tp_entry(x, "bti")
    z, xr = (x @ p["in_proj_zx"]).chunk(2, dim=-1)
    di = xr.shape[-1]  # this rank's d_inner columns
    heads = _local_heads(cfg, di)
    bc_raw, dt = torch.split(x @ p["in_proj_bcdt"], [2 * ds, nh], dim=-1)
    conv_x = tail_state(xr, length, cfg.ssm_conv - 1)
    conv_bc = tail_state(bc_raw, length, cfg.ssm_conv - 1)
    xi = F.silu(causal_conv(xr, p["conv_x_w"], p["conv_x_b"]))
    bc = F.silu(causal_conv(bc_raw, p["conv_bc_w"], p["conv_bc_b"]))
    B_, C_ = bc.chunk(2, dim=-1)
    dt = dt_mask(F.softplus(dt[..., heads].float() + p["dt_bias"][heads]), length)
    A = -torch.exp(p["A_log"][heads])
    xh = xi.reshape(b, s, di // hp, hp).float()
    h0 = torch.zeros((b, di // hp, hp, ds), dtype=torch.float32, device=x.device)
    y, h_fin = ssd_chunked(xh, dt, B_.float(), C_.float(), A, h0)
    y = y + p["D"][heads, None] * xh
    y = y.reshape(b, s, di).to(x.dtype)
    y = _gated_norm(y, z, p["gate_norm"], cfg.d_inner)
    return _tp_out(y @ p["out_proj"]), {"conv_x": conv_x, "conv_bc": conv_bc, "h": h_fin}


def mamba2_init_state(
    cfg: ModelConfig, batch: int, dtype: torch.dtype, device: str | torch.device
) -> Params:
    """conv_x: [B, K - 1, d_inner] and conv_bc: [B, K - 1, 2 ssm_state] in
    ``dtype``; h: [B, nh, head_dim, ssm_state] fp32."""
    k = cfg.ssm_conv - 1
    return {
        "conv_x": torch.zeros((batch, k, cfg.d_inner), dtype=dtype, device=device),
        "conv_bc": torch.zeros((batch, k, 2 * cfg.ssm_state), dtype=dtype, device=device),
        "h": torch.zeros((batch, cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state),
                         dtype=torch.float32, device=device),
    }


def mamba2_step(
    cfg: ModelConfig, p: Params, x_t: torch.Tensor, state: Params
) -> tuple[torch.Tensor, Params]:
    """One decode step.  x_t: [B, d]; state as ``mamba2_init_state``.
    Returns ``(y [B, d], new state)``."""
    b = x_t.shape[0]
    ds, nh, hp = cfg.ssm_state, cfg.ssm_num_heads, cfg.ssm_head_dim
    x_t = L.tp_entry(x_t, "bti")
    z, xr = (x_t @ p["in_proj_zx"]).chunk(2, dim=-1)
    di = xr.shape[-1]  # this rank's d_inner columns
    heads = _local_heads(cfg, di)
    bc, dt = torch.split(x_t @ p["in_proj_bcdt"], [2 * ds, nh], dim=-1)
    xi, conv_x = causal_conv_step(xr, state["conv_x"], p["conv_x_w"], p["conv_x_b"])
    xi = F.silu(xi)
    bc, conv_bc = causal_conv_step(bc, state["conv_bc"], p["conv_bc_w"], p["conv_bc_b"])
    B_, C_ = F.silu(bc).chunk(2, dim=-1)
    dt = F.softplus(dt[:, heads].float() + p["dt_bias"][heads])  # [B, heads]
    A = -torch.exp(p["A_log"][heads])
    a = torch.exp(dt * A)  # [B, heads]
    xh = xi.reshape(b, di // hp, hp).float()
    h = a[..., None, None] * state["h"] + (dt[..., None] * xh)[..., None] * (
        B_.float()[:, None, None, :]
    )
    y = torch.einsum("bnxs,bs->bnx", h, C_.float())
    y = y + p["D"][heads, None] * xh
    y = y.reshape(b, di).to(x_t.dtype)
    y = _gated_norm(y, z, p["gate_norm"], cfg.d_inner)
    return _tp_out(y @ p["out_proj"]), {"conv_x": conv_x, "conv_bc": conv_bc, "h": h}
