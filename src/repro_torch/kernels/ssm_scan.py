"""Mamba1 selective scan, forward and backward: the CUDA kernels' wrappers,
their ``torch.autograd.Function`` and the plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/ssm_scan.py`` (``ssm_scan_chunk``;
body ``_ssm_kernel``).  The kernel is ``csrc/ssm_scan.cu``: the Q serial
steps ``h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t``, ``y_t = h_t .
C_t`` in one launch for any Q.  A CTA owns 32 d_inner rows of one batch
row, 4 lanes a row (each lane 4 of falcon-mamba's 16 states, in registers
for the whole sequence); it copies each 16-step tile of dt / xi / B / C by
``cp.async`` into a ring of 4 tiles in shared memory, issued 3 tiles ahead
of the scan, so only the one dependent FMA a step is on the serial chain;
each step's y is summed over the row's lanes by a butterfly after the tile
and stored in coalesced rows.
On the serving path it is the falcon-mamba prefill's scan, one launch per
layer over the whole bucket.  On the card it is bound by the bytes of its
inputs and outputs, with the exponentials close behind.

The TPU kernel has no backward (the reference differentiates its XLA
chunk).  Training runs ``SelectiveScan``: its forward launches the same
kernel, which also writes the state entering every 8th step
(``ssm_scan_fwd``; the serving launch writes none), and its backward
launches ``ssm_scan_bwd``, which walks 16-step tiles in reverse, each as
two 8-step parts recomputed from their checkpoints with the forward's own
arithmetic, keeping their decays for the walk back (a lane holds 2 states
of 2 rows: 8 lanes a row pair at ds 16).  The d_inner-wide gradients of B
and C sum over a lane's rows in registers, over a warp's row pairs by
shuffles, over a CTA's warps in shared memory and over a thread-block
cluster of 8 CTAs (256 rows) in distributed shared memory, one partial row
per cluster; a second kernel sums those partials (and A's over the batch)
in a fixed order, so the gradients are deterministic.

The plain version is the naive sequential scan of the reference's
``kernels/ref.py`` ``ssm_scan_chunk_ref``, differentiable by autograd (on
the CPU and in the tests only).  All fp32 in and out.  ``COUNTS`` /
``BWD_COUNTS``: ``"cuda"`` counts kernel launches (the backward's one
call, its reduce kernel included), ``"torch"`` calls of the plain version
and of its backward (an autograd hook); ``repro_torch.kernels.ops`` reads
and resets them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

COUNTS = {"cuda": 0, "torch": 0}
BWD_COUNTS = {"cuda": 0, "torch": 0}
#: state widths the kernel is built for (lanes of one d_inner row)
STATE_WIDTHS = (4, 8, 16, 32)
#: steps between the forward's state checkpoints (the backward's parts)
CHECKPOINT_STEPS = 8
#: d_inner rows a CTA
ROWS_PER_CTA = 32
#: CTAs of a thread-block cluster in the backward (one partial gB / gC row each)
CLUSTER_CTAS = 8


def bwd_partials(di: int) -> int:
    """Partial gB / gC rows the backward sums: one per cluster of
    ``CLUSTER_CTAS`` CTAs of ``ROWS_PER_CTA`` rows (the last cluster padded
    with CTAs past d_inner)."""
    return -(-(-(-di // ROWS_PER_CTA)) // CLUSTER_CTAS)


def ssm_scan_chunk_torch(xi, dt, B_, C_, A, h0):
    """Plain version: the sequential scan, step by step.  xi/dt: [B, Q, di];
    B_/C_: [B, Q, ds]; A: [di, ds]; h0: [B, di, ds]; all fp32.  Returns
    ``(y [B, Q, di], h [B, di, ds])``, differentiable by autograd."""
    COUNTS["torch"] += 1
    h = h0
    ys = []
    for t in range(xi.shape[1]):
        a = torch.exp(dt[:, t, :, None] * A)  # [B, di, ds]
        h = a * h + (dt[:, t] * xi[:, t])[..., None] * B_[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, C_[:, t]))
    y = torch.stack(ys, dim=1) if ys else xi.new_zeros(xi.shape)
    if y.requires_grad:
        y.register_hook(_count_plain_backward)
    return y, h


def _count_plain_backward(grad: torch.Tensor) -> None:
    BWD_COUNTS["torch"] += 1


def _launch_fwd(xi, dt, B_, C_, A, h0, hs):
    _check(xi, dt, B_, C_, A, h0)
    b, q, di = xi.shape
    y = torch.empty_like(xi)
    h = torch.empty_like(h0)
    lib = build.load("ssm_scan")
    err = lib.ssm_scan_chunk_launch(
        xi.data_ptr(), dt.data_ptr(), B_.data_ptr(), C_.data_ptr(), A.data_ptr(),
        h0.data_ptr(), y.data_ptr(), h.data_ptr(), None if hs is None else hs.data_ptr(),
        b, q, di, B_.shape[-1], xi.device.index,
        torch.cuda.current_stream(xi.device).cuda_stream,
    )
    build.check_launch(lib, err, "ssm_scan")
    COUNTS["cuda"] += 1
    return y, h


def ssm_scan_chunk(xi, dt, B_, C_, A, h0):
    """Launch the CUDA kernel on the current stream; outputs are allocated
    here.  Shapes as ``ssm_scan_chunk_torch``, all contiguous fp32 CUDA
    tensors, ``ds`` in ``STATE_WIDTHS``.  Returns ``(y, h)``.  Raises on CPU
    tensors or arguments the kernel does not take."""
    return _launch_fwd(xi, dt, B_, C_, A, h0, None)


def ssm_scan_fwd(xi, dt, B_, C_, A, h0):
    """The kernel with checkpoints: ``(y, h, hs)``, ``hs [B, ceil(Q / 8),
    di, ds]`` the state entering every 8th step (``hs[:, 0] == h0``).
    y and h are bit-equal to ``ssm_scan_chunk``'s."""
    b, q, di = xi.shape
    n = -(-q // CHECKPOINT_STEPS)
    hs = torch.empty((b, n, di, B_.shape[-1]), dtype=torch.float32, device=xi.device)
    y, h = _launch_fwd(xi, dt, B_, C_, A, h0, hs)
    return y, h, hs


def ssm_scan_bwd(xi, dt, B_, C_, A, hs, gy, gh=None):
    """Launch the backward on the current stream: the gradients of a loss
    with respect to ``(xi, dt, B_, C_, A, h0)`` from ``gy`` [B, Q, di] (the
    gradient of y) and ``gh`` [B, di, ds] (of the final h; None: zero),
    recomputing the states from ``ssm_scan_fwd``'s checkpoints ``hs``."""
    b, q, di = xi.shape
    ds = B_.shape[-1]
    h0_like = hs.new_empty((b, di, ds))
    _check(xi, dt, B_, C_, A, h0_like)
    req = build.require
    req(hs.shape == (b, -(-q // CHECKPOINT_STEPS), di, ds) and hs.is_cuda
        and hs.dtype == torch.float32 and hs.is_contiguous(), "bad checkpoints")
    req(gy.shape == xi.shape and gy.dtype == torch.float32 and gy.is_contiguous()
        and gy.device == xi.device, "gy must be contiguous fp32 like xi")
    req(gh is None or (gh.shape == (b, di, ds) and gh.dtype == torch.float32
                       and gh.is_contiguous() and gh.device == xi.device),
        "gh must be None or contiguous fp32 [B, di, ds]")
    gxi, gdt = torch.empty_like(xi), torch.empty_like(dt)
    gB, gC = torch.empty_like(B_), torch.empty_like(C_)
    gA, gh0 = torch.empty_like(A), h0_like
    gBp = torch.empty((bwd_partials(di), b, q, ds), dtype=torch.float32, device=xi.device)
    gCp = torch.empty_like(gBp)
    gAp = torch.empty((b, di, ds), dtype=torch.float32, device=xi.device)
    lib = build.load("ssm_scan")
    err = lib.ssm_scan_bwd_launch(
        *(t.data_ptr() for t in (xi, dt, B_, C_, A, hs, gy)),
        None if gh is None else gh.data_ptr(),
        *(t.data_ptr() for t in (gxi, gdt, gB, gC, gA, gh0, gBp, gCp, gAp)),
        b, q, di, ds, xi.device.index, torch.cuda.current_stream(xi.device).cuda_stream,
    )
    build.check_launch(lib, err, "ssm_scan_bwd")
    BWD_COUNTS["cuda"] += 1
    return gxi, gdt, gB, gC, gA, gh0


class SelectiveScan(torch.autograd.Function):
    """The kernel pair as one differentiable op: the forward launches the
    scan with checkpoints and saves (xi, dt, B, C, A, hs); the backward
    launches ``ssm_scan_bwd``."""

    @staticmethod
    def forward(ctx, xi, dt, B_, C_, A, h0):
        y, h, hs = ssm_scan_fwd(xi, dt, B_, C_, A, h0)
        ctx.save_for_backward(xi, dt, B_, C_, A, hs)
        return y, h

    @staticmethod
    def backward(ctx, gy, gh):
        xi, dt, B_, C_, A, hs = ctx.saved_tensors
        gy = torch.zeros_like(xi) if gy is None else gy.float().contiguous()
        gh = None if gh is None else gh.float().contiguous()
        return ssm_scan_bwd(xi, dt, B_, C_, A, hs, gy, gh)


def selective_scan(xi, dt, B_, C_, A, h0):
    """The kernel, differentiable where autograd needs it: ``SelectiveScan``
    when grad is enabled and an input requires it, else the serving
    launch (no checkpoints).  Shapes as ``ssm_scan_chunk``.  Returns
    ``(y, h)``."""
    tensors = (xi, dt, B_, C_, A, h0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return SelectiveScan.apply(*tensors)
    return ssm_scan_chunk(*tensors)


def _check(xi, dt, B_, C_, A, h0) -> None:
    req = build.require
    tensors = (xi, dt, B_, C_, A, h0)
    req(all(t.is_cuda for t in tensors), "ssm_scan kernel needs CUDA tensors")
    req(all(t.device == xi.device for t in tensors), "tensors on different devices")
    req(all(t.dtype == torch.float32 for t in tensors), "ssm_scan takes float32 tensors")
    req(xi.ndim == 3 and B_.ndim == 3 and A.ndim == 2 and h0.ndim == 3, "bad ranks")
    b, q, di = xi.shape
    ds = B_.shape[-1]
    req(dt.shape == xi.shape, "xi and dt shapes differ")
    req(B_.shape == (b, q, ds) and C_.shape == (b, q, ds), "B / C shapes")
    req(A.shape == (di, ds) and h0.shape == (b, di, ds), "A / h0 shapes")
    req(ds in STATE_WIDTHS, f"state width {ds} not in {STATE_WIDTHS}")
    req(all(t.is_contiguous() for t in tensors), "tensors must be contiguous")
