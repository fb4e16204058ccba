"""Mamba1 selective scan: the CUDA kernel's wrapper and its plain PyTorch
version.

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

The plain version is the naive sequential scan of the reference's
``kernels/ref.py`` ``ssm_scan_chunk_ref``.  Both are fp32 in and out.
``COUNTS["cuda"]`` counts kernel launches, ``COUNTS["torch"]`` calls of the
plain version; ``repro_torch.kernels.ops`` reads and resets them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

COUNTS = {"cuda": 0, "torch": 0}
#: state widths the kernel is built for (lanes of one d_inner row)
STATE_WIDTHS = (4, 8, 16, 32)


def ssm_scan_chunk_torch(xi, dt, B_, C_, A, h0):
    """Plain version: the sequential scan, step by step.  xi/dt: [B, Q, di];
    B_/C_: [B, Q, ds]; A: [di, ds]; h0: [B, di, ds]; all fp32.  Returns
    ``(y [B, Q, di], h [B, di, ds])``."""
    COUNTS["torch"] += 1
    h = h0
    ys = []
    for t in range(xi.shape[1]):
        a = torch.exp(dt[:, t, :, None] * A)  # [B, di, ds]
        h = a * h + (dt[:, t] * xi[:, t])[..., None] * B_[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, C_[:, t]))
    return torch.stack(ys, dim=1), h


def ssm_scan_chunk(xi, dt, B_, C_, A, h0):
    """Launch the CUDA kernel on the current stream; outputs are allocated
    here.  Shapes as ``ssm_scan_chunk_torch``, all contiguous fp32 CUDA
    tensors, ``ds`` in ``STATE_WIDTHS``.  Returns ``(y, h)``.  Raises on CPU
    tensors or arguments the kernel does not take."""
    _check(xi, dt, B_, C_, A, h0)
    b, q, di = xi.shape
    ds = B_.shape[-1]
    y = torch.empty_like(xi)
    h = torch.empty_like(h0)
    lib = build.load("ssm_scan")
    err = lib.ssm_scan_chunk_launch(
        xi.data_ptr(), dt.data_ptr(), B_.data_ptr(), C_.data_ptr(), A.data_ptr(),
        h0.data_ptr(), y.data_ptr(), h.data_ptr(), b, q, di, ds, xi.device.index,
        torch.cuda.current_stream(xi.device).cuda_stream,
    )
    build.check_launch(lib, err, "ssm_scan")
    COUNTS["cuda"] += 1
    return y, h


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
