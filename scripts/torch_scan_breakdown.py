#!/usr/bin/env python3
"""Where the Mamba1 selective-scan kernels' time goes, on one GPU.

    python3 scripts/torch_scan_breakdown.py             # the forward
    python3 scripts/torch_scan_breakdown.py --backward  # the backward

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

With ``--backward`` it builds patched copies of the backward into
``build/scan_breakdown/bwd_<variant>/`` the same way and times each
variant's ``ssm_scan_bwd_launch`` (its main kernel and the partials' sum)
in turns at the training shape (B = 4, Q = 1024, d_inner 8192, ssm_state
16, from the forward's checkpoints); the variants that are right are first
held to autograd of the plain scan (``chip_smoke.SSM_GRAD_RTOL``, B = 2,
Q = 65, d_inner 100):

* ``kernel``       -- the backward as it is;
* ``terms``        -- the first design (``scripts/ssm_scan_bwd_terms.cu``: 4
                      lanes of 4 states a row, each exponential taken twice,
                      the gB / gC terms summed through shared-memory buffers,
                      one partial row per CTA);
* ``no_exp``       -- decay 1 in the recompute (wrong on purpose);
* ``no_partials``  -- the cluster's gB / gC partial rows not stored, so no
                      DSMEM load either (wrong on purpose);
* ``no_cluster``   -- no cluster barrier and no DSMEM sum (wrong on purpose);
* ``no_row_sum``   -- gB / gC not summed over a warp's row pairs by shuffles
                      (wrong on purpose);
* ``no_gu_sum``    -- gu / gdt not summed over a row pair's lanes (wrong on
                      purpose);
* ``no_stores``    -- gxi / gdt not stored (wrong on purpose);
* ``clocks``       -- thread 0 of each CTA sums ``clock64()`` cycles by phase
                      of the tile loop (copies, barriers, recompute, walk
                      back, cluster exchange, warp sums, arrive, stores),
                      printed as cycles a tile (its time is not the kernel's);
* ``arrive_relaxed`` -- the cluster arrive without release semantics (wrong
                      on purpose: the cost of the release);
* ``no_copy_wait`` -- no wait for a tile's copies (wrong on purpose: whether
                      the copies arrive late);
* ``no_copies``    -- no copies at all: the tiles are walked as shared memory
                      holds them (wrong on purpose: the copies' issue and
                      their device-memory reads);
* ``hoisted``      -- the copies' addresses hoisted out of the tile loop by
                      the compiler (the kernel makes them opaque);
* ``group4_ring2`` -- the cluster exchange every 4 tiles, a 2-tile ring;
* ``cluster4``     -- clusters of 4 CTAs (64 partial rows at d_inner 8192);
* ``empty``        -- the main kernel returns at once (its launch and the
                      partials' sum).

Also prints the compiler's register and spill lines for the kernel (and,
with ``--backward``, for the first design and ``hoisted``).  Needs a CUDA
device and ``nvcc``; it imports nothing of JAX.
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


# The backward's variants: text in ssm_scan.cu and its replacement.
TERMS = os.path.join(ROOT, "scripts", "ssm_scan_bwd_terms.cu")
BWD_EXP = """              dec[t][w][s] = ex2(dtw[w] * a2[w][s]);
"""
BWD_ROW_SUM = """              rv[q] = tv[q] + __shfl_xor_sync(0xffffffffu, tv[q + N / 2], 16);
            reduce_scatter_lanes<LPR, RPW / 2>(rv, lane);
"""
BWD_TAIL = "#pragma unroll\n  for (int w = 0; w < 2; ++w) {\n    if (d + w < di) {"
BWD_CLUSTER = (("      hop::cluster_wait();\n      part_at = cluster_sum(gs, part);\n", ""),
               ("      if (group_end) hop::cluster_arrive();\n", ""),
               ("  hop::cluster_arrive();  // no CTA exits", "  // no CTA exits"),
               ("  hop::cluster_wait();\n" + BWD_TAIL, BWD_TAIL))
# clock64() at the tile loop's phase boundaries, summed by thread 0 of each
# CTA and written past the partial rows the kernel uses
CLOCK_PHASES = ("copy wait", "barrier", "recompute", "walk back", "barrier", "cluster wait",
                "cluster sum", "warp sums", "arrive", "stores")
BWD_CLOCKS = (
    ("template <int NS, int V>\n__global__ void __launch_bounds__(BwdPlan<NS>",
     "#define CLK(p) if (tid == 0) { const long long c_ = clock64(); s_clk[p] += c_ - c_last; "
     "c_last = c_; }\ntemplate <int NS, int V>\n__global__ void __launch_bounds__(BwdPlan<NS>"),
    ("  const int rank = (int)hop::cluster_ctarank();\n",
     "  const int rank = (int)hop::cluster_ctarank();\n  __shared__ long long s_clk[10];\n"
     "  if (tid < 10) s_clk[tid] = 0;\n  long long c_last = clock64();\n"),
    ("      hop::cp_async_wait<kBwdStages - 1>();  // tile k landed for this thread\n"
     "      __syncthreads();                       // ... and for every thread\n",
     "      hop::cp_async_wait<kBwdStages - 1>();\n      CLK(0)\n      __syncthreads();\n"
     "      CLK(1)\n"),
    ("        const int pos0 = j * kCkpt;\n", "        CLK(3)\n        const int pos0 = j * kCkpt;\n"),
    ("        // back through the part\n", "        CLK(2)\n        // back through the part\n"),
    ("      __syncthreads();  // the gxi / gdt tiles and the warps' sums are whole; the stage is free\n",
     "      CLK(3)\n      __syncthreads();\n      CLK(4)\n"),
    ("      hop::cluster_wait();\n      part_at = cluster_sum(gs, part);\n",
     "      hop::cluster_wait();\n      CLK(5)\n      part_at = cluster_sum(gs, part);\n      CLK(6)\n"),
    ("      if (group_end) hop::cluster_arrive();\n",
     "      CLK(7)\n      if (group_end) hop::cluster_arrive();\n      CLK(8)\n"),
    ("          gdt[o] = s_od[pos * kBwdRows + c];\n        }\n      }\n    }\n  }\n",
     "          gdt[o] = s_od[pos * kBwdRows + c];\n        }\n      }\n    }\n    CLK(9)\n  }\n"),
    (BWD_TAIL,
     "  if (tid == 0) {\n    long long* out = reinterpret_cast<long long*>(\n"
     "        gBp + (size_t)gridDim.z / kCluster * nb * Q * NS) + ((size_t)cta * nb + b) * 10;\n"
     "    for (int p = 0; p < 10; ++p) out[p] = s_clk[p];\n  }\n" + BWD_TAIL),
)
BWD_VARIANTS = {
    "kernel": (True, []),
    "terms": (True, None),
    "no_exp": (False, [(BWD_EXP, "              dec[t][w][s] = 1.f;\n")]),
    "no_partials": (False, [("    if (part_at != nullptr) *reinterpret_cast<float4*>(part_at) = part;\n", "")]),
    "no_cluster": (False, list(BWD_CLUSTER)),
    "no_row_sum": (False, [(BWD_ROW_SUM, "              rv[q] = tv[q] + tv[q + N / 2];\n")]),
    "no_gu_sum": (False, [("            reduce_scatter_lanes<1, LPR>(gv, lane);\n", "")]),
    "no_stores": (False, [("      if (i2 < kBwdTile * RC && t >= pj && d0 + c < di) {", "      if (false) {")]),
    "clocks": (False, list(BWD_CLOCKS)),
    "arrive_relaxed": (False, [("      if (group_end) hop::cluster_arrive();\n",
                                "      if (group_end) asm volatile(\"barrier.cluster.arrive.relaxed;\\n\" ::: \"memory\");\n")]),
    "no_copy_wait": (False, [("      hop::cp_async_wait<kBwdStages - 1>();  // tile k landed for this thread\n", "")]),
    "no_copies": (False, [("    int tid = threadIdx.x;\n    asm(\"\" : \"+r\"(tid));\n", "    return;\n    int tid = threadIdx.x;\n")]),
    "hoisted": (True, [("    int tid = threadIdx.x;\n    asm(\"\" : \"+r\"(tid));\n", "")]),
    "group4_ring2": (True, [("constexpr int kGroup = 2;", "constexpr int kGroup = 4;"),
                            ("constexpr int kBwdStages = 3;", "constexpr int kBwdStages = 2;")]),
    "cluster4": (True, [("constexpr int kCluster = 8;", "constexpr int kCluster = 4;")]),
    "empty": (False, [("  using P = BwdPlan<NS>;\n  constexpr int LPR", "  if (Q >= 0) return;\n  using P = BwdPlan<NS>;\n  constexpr int LPR")]),
}


def build_variants(variants, prefix="", show=("kernel",)):
    """Build each variant's library (one ``nvcc`` each, all started
    together); returns {name: ctypes.CDLL}.  A variant whose patches are
    None is a whole other source: ``per_step_loads`` or ``terms``."""
    from repro_torch.kernels import build

    nvcc, procs = build._nvcc(), {}
    for name, (_, patches) in variants.items():
        d = os.path.join(OUT, prefix + name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(SRC, d)
        path = os.path.join(d, f"{LIB}.cu")
        if patches is None:
            text = PER_STEP_LOADS if name == "per_step_loads" else open(TERMS).read()
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
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        if name in show:
            for line in log.splitlines():
                if "Used" in line or "spill" in line or "Compiling entry" in line:
                    print(f"ptxas {name}: {line.strip()}")
        lib = ctypes.CDLL(so)
        for fn_name, argtypes in build.SIGNATURES[LIB]:
            if hasattr(lib, fn_name):
                getattr(lib, fn_name).argtypes = argtypes
                getattr(lib, fn_name).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main_backward(cs, ss) -> int:
    """Times the backward's variants at the training shape (module doc)."""
    import torch

    libs = build_variants(BWD_VARIANTS, prefix="bwd_", show=("kernel", "terms", "hoisted"))

    def bwd(lib, args, hs, gy, gh):
        xi, dt, bm, cm, a, _ = args
        b, q, di = xi.shape
        ds = bm.shape[-1]
        outs = [torch.empty_like(t) for t in args]
        parts = -(-di // ss.ROWS_PER_CTA)  # the first design's count, the most either needs
        gbp = torch.empty((parts, b, q, ds), device="cuda")
        gcp, gap = torch.empty_like(gbp), torch.empty((b, di, ds), device="cuda")
        err = lib.ssm_scan_bwd_launch(
            *(t.data_ptr() for t in (xi, dt, bm, cm, a, hs, gy, gh, *outs, gbp, gcp, gap)),
            b, q, di, ds, 0, torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return outs

    def case(b, q, di, seed):
        args = cs._ssm_inputs(b, q, seed=seed, di=di)
        g = torch.Generator(device="cuda").manual_seed(seed + 1)
        gy = torch.randn((b, q, di), generator=g, device="cuda")
        gh = torch.randn((b, di, cs.SSM_DS), generator=g, device="cuda")
        return args, ss.ssm_scan_fwd(*args)[2], gy, gh

    args, hs, gy, gh = case(2, 65, 100, seed=15)
    leaves = [t.detach().clone().requires_grad_() for t in args]
    ref = torch.autograd.grad(ss.ssm_scan_chunk_torch(*leaves), leaves, (gy, gh))
    for name, (right, _) in BWD_VARIANTS.items():
        if right:
            errs = [((k - p).abs().max() / p.abs().max()).item()
                    for k, p in zip(bwd(libs[name], args, hs, gy, gh), ref)]
            print(f"{name:12s} B=2 Q=65 di=100: max err / max|g| {max(errs):.2e}")
            if not max(errs) <= cs.SSM_GRAD_RTOL:
                raise SystemExit(f"{name}: errors {errs} > {cs.SSM_GRAD_RTOL}")
    b, q = 4, 1024
    args, hs, gy, gh = case(b, q, cs.SSM_DI, seed=13)
    names = list(BWD_VARIANTS)
    for rnd, order in enumerate((names, names[::-1])):  # in turns
        for name in order:
            ms = cs._time_ms(lambda: bwd(libs[name], args, hs, gy, gh))
            print(f"round {rnd} bwd {name:12s} B={b} Q={q} {ms:.4f} ms", flush=True)
    bound, by = cs._ssm_bwd_bound(b, q)
    print(f"bound B={b} Q={q}: {bound:.4f} ms ({by})")
    # the clocks variant's cycles a tile by phase, thread 0 of each CTA
    xi, dt, bm, cm, a, _ = args
    ncta = ss.bwd_partials(cs.SSM_DI) * ss.CLUSTER_CTAS
    outs = [torch.empty_like(t) for t in args]
    gbp = torch.zeros(((cs.SSM_DI // ss.ROWS_PER_CTA), b, q, cs.SSM_DS), device="cuda")
    gcp, gap = torch.empty_like(gbp), torch.empty((b, cs.SSM_DI, cs.SSM_DS), device="cuda")
    assert libs["clocks"].ssm_scan_bwd_launch(
        *(t.data_ptr() for t in (xi, dt, bm, cm, a, hs, gy, gh, *outs, gbp, gcp, gap)),
        b, q, cs.SSM_DI, cs.SSM_DS, 0, torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    off = ss.bwd_partials(cs.SSM_DI) * b * q * cs.SSM_DS
    clk = gbp.flatten()[off: off + 2 * ncta * b * 10].view(torch.int64).view(ncta * b, 10)
    mean = (clk.double() / -(-q // 16)).mean(0).tolist()  # the backward's 16-step tiles
    print("clock64 cycles a tile (thread 0, mean over CTAs): " + ", ".join(
        f"{n} {c:.0f}" for n, c in zip(CLOCK_PHASES, mean)) + f"; sum {sum(mean):.0f}")
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    import chip_smoke as cs
    from repro_torch.kernels import ssm_scan as ss

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    if "--backward" in sys.argv[1:]:
        return main_backward(cs, ss)
    fns = {name: lib.ssm_scan_chunk_launch for name, lib in build_variants(VARIANTS).items()}

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
