#!/usr/bin/env python3
"""Where the Mamba1 selective-scan kernel's time goes, on one GPU.

    python3 scripts/torch_scan_breakdown.py

Builds patched copies of ``src/repro_torch/kernels/csrc`` into
``build/scan_breakdown/<variant>/`` (one ``nvcc`` each, all started
together) and times each variant of ``ssm_scan.cu`` in turns (two rounds,
the second in reverse order) at falcon-mamba's widths (fp32, d_inner 8192,
ssm_state 16) for B = 1 and 8 and Q = 64 and 256, with CUDA events after an
L2-flushing write (``chip_smoke._time_ms``).  A variant removes or changes
one part of the kernel; those marked "wrong on purpose" give wrong results
and only their time is read, the others are first held to the plain
version (``chip_smoke.SSM_RTOL``):

* ``kernel``          -- the kernel as it is;
* ``per_step_loads``  -- the earlier design: one thread per (row, state), 16
                         lanes a row, every step's dt / xi / B / C loaded from
                         device memory inside the step loop, ``expf``; also
                         timed over 64-step chunks, one launch each (its
                         route at Q = 256);
* ``y_per_step``      -- each step's y summed by shuffles inside the step loop
                         and written to shared memory there, by the row's
                         first lane (the butterfly after the tile's steps
                         dropped);
* ``exp2f`` / ``expf`` -- ``exp2f`` (subnormal results kept), or ``expf`` of
                         dt * A, in place of ``ex2.approx.ftz`` of A
                         pre-scaled by log2 e;
* ``no_exp``          -- decay 1 (no exponential; wrong on purpose);
* ``no_copy``         -- no ``cp.async``: the tiles are read as shared memory
                         holds them (wrong on purpose);
* ``no_y_store``      -- y is not stored to device memory (wrong on purpose);
* ``bc_const``        -- B and C not read from shared memory (constants;
                         wrong on purpose);
* ``empty``           -- the kernel returns at once (the launch alone);
* ``lanes16`` / ``lanes8`` / ``lanes2`` / ``lanes1`` -- 16, 8, 2 or 1 lanes a
                         row (1, 2, 8 or 16 states a lane; 512, 256, 64 or 32
                         threads a CTA); ``lanes2_rows64``, ``lanes1_rows128``:
                         the same with 64 or 128 rows a CTA (128 threads);
* ``rows8`` / ``rows16`` -- 8 or 16 d_inner rows a CTA (32 or 64 threads);
* ``tile32`` / ``tile64`` -- 32-step tiles in a ring of 3, 64-step tiles in a
                         ring of 2.

Also prints the compiler's register and spill lines for the kernel.  Needs
a CUDA device and ``nvcc``; it imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

SRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
OUT = os.path.join(ROOT, "build", "scan_breakdown")
LIB = "ssm_scan"
SHAPES = ((1, 64), (1, 256), (8, 64), (8, 256))  # (B, Q)

# The earlier design, kept here to be timed beside the kernel (ds = 16 only).
PER_STEP_LOADS = r"""
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <int NS>
__global__ void __launch_bounds__(kThreads)
    ssm_scan_kernel(const float* __restrict__ xi, const float* __restrict__ dt,
                    const float* __restrict__ Bm, const float* __restrict__ Cm,
                    const float* __restrict__ A, const float* __restrict__ h0,
                    float* __restrict__ y, float* __restrict__ h_out, int Q, int di) {
  constexpr int kRows = kThreads / NS;
  const int b = blockIdx.y;
  const int lane = threadIdx.x % NS;
  const int d = blockIdx.x * kRows + threadIdx.x / NS;
  const bool live = d < di;
  const int dd = live ? d : di - 1;
  const float a = __ldg(A + (size_t)dd * NS + lane);
  const size_t hrow = ((size_t)b * di + dd) * NS + lane;
  float h = __ldg(h0 + hrow);
  const size_t seq = (size_t)b * Q;
  for (int t = 0; t < Q; ++t) {
    const size_t xt = (seq + t) * di + dd;
    const float dtv = __ldg(dt + xt);
    const float u = dtv * __ldg(xi + xt);
    const size_t nt = (seq + t) * NS + lane;
    h = expf(dtv * a) * h + u * __ldg(Bm + nt);
    float part = h * __ldg(Cm + nt);
#pragma unroll
    for (int off = NS / 2; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off, NS);
    if (live && lane == 0) y[xt] = part;
  }
  if (live) h_out[hrow] = h;
}

}  // namespace

extern "C" int ssm_scan_chunk_launch(const void* xi, const void* dt, const void* Bm,
                                     const void* Cm, const void* A, const void* h0, void* y,
                                     void* h_out, void* hs, int B, int Q, int di, int ds,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (ds != 16 || hs != nullptr) return cudaErrorInvalidValue;
  constexpr int kRows = kThreads / 16;
  return kern::launch(ssm_scan_kernel<16>, dim3((di + kRows - 1) / kRows, B), kThreads, 0,
                      stream, static_cast<const float*>(xi), static_cast<const float*>(dt),
                      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
                      static_cast<const float*>(A), static_cast<const float*>(h0),
                      static_cast<float*>(y), static_cast<float*>(h_out), Q, di);
}
"""

ROWS = "constexpr int kRows = 32;"
LANES = "constexpr int kLaneCap = 4;"
TILE = "constexpr int kTile = 16;"
STAGES = "constexpr int kStages = 4;"
EXP = "ex2(dtv * a2[j])"
REDUCE = """    reduce_scatter<LPR>(yv, lane);
#pragma unroll
    for (int g = 0; g < kTile / LPR; ++g) ys[(g * LPR + lane) * kRows + r] = yv[g * LPR];
"""
STEP_END = """        yv[t] = fmaf(h[j], cv[j], yv[t]);
      }
"""
Y_PER_STEP = STEP_END + """#pragma unroll
      for (int off = LPR / 2; off > 0; off /= 2)
        yv[t] += __shfl_xor_sync(0xffffffffu, yv[t], off);
      if (lane == 0) ys[t * kRows + r] = yv[t];
"""
BC_LOADS = """      load_n<SPT, 4>(s_b + t * NS, bv);
      load_n<SPT, 4>(s_c + t * NS, cv);
"""


def _const(old, value):
    return (old, old.rsplit("=", 1)[0] + f"= {value};")


#: variant -> (whether its results are right, [(text in ssm_scan.cu, replacement)])
VARIANTS = {
    "kernel": (True, []),
    "per_step_loads": (True, None),
    "y_per_step": (True, [(STEP_END, Y_PER_STEP), (REDUCE, "")]),
    "exp2f": (True, [(EXP, "exp2f(dtv * a2[j])")]),
    "expf": (True, [(EXP, "expf(dtv * a2[j])"), ("a2[j] *= kLog2e;", "a2[j] *= 1.f;")]),
    "no_exp": (False, [(EXP, "1.f")]),
    "no_copy": (False, [("auto load_tile = [&](int k) {", "auto load_tile = [&](int k) {\n    return;")]),
    "no_y_store": (False, [("if (i < kTile * RC && t0 + t < Q && d0 + c < di) {", "if (false) {")]),
    "bc_const": (False, [(BC_LOADS, "      for (int j = 0; j < SPT; ++j) bv[j] = cv[j] = 0.5f;\n")]),
    "empty": (False, [("  using P = Plan<NS>;\n  constexpr int LPR", "  if (Q >= 0) return;\n  using P = Plan<NS>;\n  constexpr int LPR")]),
    "lanes16": (True, [_const(LANES, 16)]),
    "lanes8": (True, [_const(LANES, 8)]),
    "lanes2": (True, [_const(LANES, 2)]),
    "lanes2_rows64": (True, [_const(LANES, 2), _const(ROWS, 64)]),
    "lanes1": (True, [_const(LANES, 1)]),
    "lanes1_rows128": (True, [_const(LANES, 1), _const(ROWS, 128)]),
    "rows8": (True, [_const(ROWS, 8)]),
    "rows16": (True, [_const(ROWS, 16)]),
    "tile32": (True, [_const(TILE, 32), _const(STAGES, 3)]),
    "tile64": (True, [_const(TILE, 64), _const(STAGES, 2)]),
}


def build_variants():
    from repro_torch.kernels import build

    nvcc, procs = build._nvcc(), {}
    for name, (_, patches) in VARIANTS.items():
        d = os.path.join(OUT, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(SRC, d)
        path = os.path.join(d, f"{LIB}.cu")
        if patches is None:
            text = PER_STEP_LOADS
        else:
            text = open(path).read()
            for old, new in patches:
                if old not in text:
                    raise SystemExit(f"{name}: the kernel source no longer holds {old!r}")
                text = text.replace(old, new)
        open(path, "w").write(text)
        so = os.path.join(d, f"lib{LIB}.so")
        cmd = [nvcc, *build.NVCC_FLAGS, "-o", so, path]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    fns = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        if name == "kernel":
            for line in log.splitlines():
                if "Used" in line or "spill" in line or "Compiling entry" in line:
                    print(f"ptxas {line.strip()}")
        fn = getattr(ctypes.CDLL(so), f"{LIB}_chunk_launch")
        fn.argtypes = build.SIGNATURES[LIB][0][1]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    import chip_smoke as cs
    from repro_torch.kernels import ssm_scan as ss

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    fns = build_variants()

    def scan(fn, xi, dt, bm, cm, a, h0):
        y, h = torch.empty_like(xi), torch.empty_like(h0)
        b, q, di = xi.shape
        err = fn(xi.data_ptr(), dt.data_ptr(), bm.data_ptr(), cm.data_ptr(), a.data_ptr(),
                 h0.data_ptr(), y.data_ptr(), h.data_ptr(), None, b, q, di, bm.shape[-1], 0,
                 torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return y, h

    def chained(fn, xi, dt, bm, cm, a, h):
        for c in range(0, xi.shape[1], cs.SSM_Q):
            _, h = scan(fn, *(t[:, c: c + cs.SSM_Q].contiguous() for t in (xi, dt, bm, cm)),
                        a, h)

    rel = lambda a, r: ((a - r).abs().max() / r.abs().max()).item()
    check = cs._ssm_inputs(2, 65, seed=8)
    ry, rh = ss.ssm_scan_chunk_torch(*check)
    for name, (right, _) in VARIANTS.items():
        if right:
            y, h = scan(fns[name], *check)
            errs = (rel(y, ry), rel(h, rh))
            print(f"{name:15s} B=2 Q=65: max err / max|ref| y {errs[0]:.2e}, h {errs[1]:.2e}")
            if not max(errs) <= cs.SSM_RTOL:
                raise SystemExit(f"{name}: errors {errs} > {cs.SSM_RTOL}")
    inputs = {s: cs._ssm_inputs(*s, seed=7) for s in SHAPES}
    names = list(VARIANTS)
    for rnd, order in enumerate((names, names[::-1])):  # in turns
        for name in order:
            for b, q in SHAPES:
                args = inputs[(b, q)]
                ms = cs._time_ms(lambda: scan(fns[name], *args))
                line = f"round {rnd} {name:15s} B={b} Q={q:3d} {ms:.4f} ms"
                if name == "per_step_loads" and q > cs.SSM_Q:
                    ms = cs._time_ms(lambda: chained(fns[name], *args))
                    line += f"; {q // cs.SSM_Q} launches of {cs.SSM_Q} steps {ms:.4f} ms"
                print(line, flush=True)
    for q in (cs.SSM_Q, 256):
        bound, by = cs._ssm_bound(q)
        print(f"bound B=1 Q={q}: {bound:.4f} ms ({by})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
