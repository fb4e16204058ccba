#!/usr/bin/env python3
"""Where the paged and dense decode kernels' time goes, on one GPU.

    python3 scripts/torch_decode_breakdown.py

Builds patched copies of ``src/repro_torch/kernels/csrc`` into
``build/decode_breakdown/<variant>/`` (one ``nvcc`` each, all started
together) and times each variant of the paged decode kernel (and, for the
dense-only variant, the dense one) in turns against the unpatched kernel,
at the serving shapes of ``chip_smoke.py`` (bf16, B=8, H=16, kvH=8, hd 128,
512 keys), with CUDA events after an L2-flushing write (``chip_smoke._time_ms``)
and four length sets: the table's, every slot empty, every slot one 64-key
tile, every slot full.  A variant removes or changes one part of the kernel,
so its results are wrong on purpose; only its time is read:

* ``no_math``           -- the tile loop waits for its copies but does no math;
* ``math_twice``        -- every tile's math runs twice (a loop, not unrolled);
* ``no_dram``           -- every K / V copy is zero-filled (no device-memory read);
* ``no_cluster_merge``  -- no cluster barrier and no DSMEM load (rank 0's state);
* ``warps8``            -- 8 warps a CTA (8 keys of a tile each);
* ``dense_eager``       -- (dense) a CTA's first tile is issued with the
                           length, up to its range's end, not the length.

Also prints the bytes the eager variant copies past the lengths.  Needs a
CUDA device and ``nvcc``; it imports nothing of JAX.
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
OUT = os.path.join(ROOT, "build", "decode_breakdown")
LAUNCH = "\n  __syncthreads();  // the table entries\n"
PROLOGUE = "  if (ntiles > 0) load_tile(0);\n  hop::cp_async_commit();\n"
EAGER = """
  // the first tile with the length, up to the range's end
  if (k_hi > k_lo && has_chunk) {
    constexpr int R = kKeys * LPR / kThreads;
#pragma unroll
    for (int n = 0; n < R; ++n) {
      const int r = tid / LPR + n * (kThreads / LPR);
      const size_t off = kv.row(min(k_lo + r, k_hi - 1), page, row_stride) + (size_t)head * hd
                         + c * VN;
      const uint32_t dk = hop::smem_addr(ring) + r * row_bytes + c * 16;
      hop::cp_async16(dk, k_pool + off, k_lo + r < k_hi ? 16 : 0);
      hop::cp_async16(dk + kKeys * row_bytes, v_pool + off, k_lo + r < k_hi ? 16 : 0);
    }
  }
  hop::cp_async_commit();
  __syncthreads();  // the table entries
"""
#: variant -> (library, [(text in decode_cluster.cuh or the library's .cu,
#: replacement)])
VARIANTS = {
    "base": ("paged_decode_attention", []),
    "no_math": ("paged_decode_attention", [("    if (nvw > 0) {", "    if (nvw > 0 && false) {")]),
    "math_twice": ("paged_decode_attention", [
        ("    if (nvw > 0) {",
         "#pragma unroll 1\n    for (int twice = 0; twice < 2; ++twice) if (nvw > 0) {")]),
    "no_dram": ("paged_decode_attention", [
        ("const int bytes = k0 + r < kend ? 16 : 0;", "const int bytes = 0;")]),
    "no_cluster_merge": ("paged_decode_attention", [
        ("  hop::cluster_sync();\n", "\n"), ("  hop::cluster_sync_relaxed();", ""),
        ("s < cluster ? hop::ld_dsmem_f2", "false ? hop::ld_dsmem_f2"),
        ("s < cluster ? hop::ld_dsmem_f4", "false ? hop::ld_dsmem_f4")]),
    "warps8": ("paged_decode_attention", [
        ("constexpr int kThreads = 128;", "constexpr int kThreads = 256;"),
        ("  int lpr = 2;\n  while", "  int lpr = 4;\n  while"),
        ("    case 2: return by_g(integral_constant<int, 2>{});\n", ""),
        ("__launch_bounds__(decode::kThreads)", "__launch_bounds__(decode::kThreads, 2)")]),
    "dense_base": ("decode_attention", []),
    "dense_eager": ("decode_attention", [(LAUNCH, EAGER), (PROLOGUE, "")]),
}


def build_variants():
    from repro_torch.kernels import build

    nvcc, procs = build._nvcc(), {}
    for name, (lib, patches) in VARIANTS.items():
        d = os.path.join(OUT, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(SRC, d)
        paths = [os.path.join(d, f) for f in ("decode_cluster.cuh", f"{lib}.cu")]
        texts = [open(p).read() for p in paths]
        for old, new in patches:
            if not any(old in t for t in texts):
                raise SystemExit(f"{name}: the kernel source no longer holds {old!r}")
            texts = [t.replace(old, new) for t in texts]
        for p, t in zip(paths, texts):
            open(p, "w").write(t)
        so = os.path.join(d, f"lib{lib}.so")
        cmd = [nvcc, *build.NVCC_FLAGS, "-o", so, os.path.join(d, f"{lib}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib, so)
    fns = {}
    for name, (proc, lib, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        fn = getattr(ctypes.CDLL(so), f"{lib}_launch")
        fn.argtypes = build.SIGNATURES[lib][0][1]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    import chip_smoke as cs
    from repro_torch.kernels import decode_attention as dd

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    fns = build_variants()
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def paged(fn, q, kp, vp, bt, lens):
        per, cluster = dd.decode_plan((bt.shape[1] - 1) * kp.shape[1])
        out = torch.empty_like(q)
        err = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), bt.data_ptr(), lens.data_ptr(),
                 out.data_ptr(), q.shape[0], q.shape[1], kp.shape[2], q.shape[2], kp.shape[1],
                 bt.shape[1], per, cluster, 1, 0, stream())
        assert err == 0, err

    def dense(fn, q, k, v, lens):
        per, cluster = dd.decode_plan(k.shape[1])
        out = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(),
                 q.shape[0], q.shape[1], k.shape[2], q.shape[2], k.shape[1], per, cluster, 1, 0,
                 stream())
        assert err == 0, err

    i32 = lambda xs: torch.tensor(xs, dtype=torch.int32, device="cuda")
    g, kp, vp, bt = cs._pool_inputs(torch.bfloat16)
    q = torch.randn((cs.B, cs.H, cs.HD), generator=g, device="cuda").to(torch.bfloat16)
    g, k, v = cs._dense_inputs(torch.bfloat16, seed=2)
    qd = torch.randn((cs.B, cs.DRAFT_H, cs.HD), generator=g, device="cuda").to(torch.bfloat16)
    sets = {"table": (cs.DECODE_LENGTHS, cs.DENSE_LENGTHS), "empty": ([0] * 8,) * 2,
            "one tile": ([64] * 8,) * 2, "full": ([512] * 8,) * 2}
    names = list(VARIANTS)
    for rnd, order in enumerate((names, names[::-1])):  # in turns
        for name in order:
            dense_lib = VARIANTS[name][0] == "decode_attention"
            for label, (pl, dl) in sets.items():
                if dense_lib:
                    lens = i32(dl)
                    ms = cs._time_ms(lambda: dense(fns[name], qd, k, v, lens))
                else:
                    lens = i32(pl)
                    ms = cs._time_ms(lambda: paged(fns[name], q, kp, vp, bt, lens))
                print(f"round {rnd} {name:17s} lengths {label:8s} {ms:.4f} ms", flush=True)
    per, _ = dd.decode_plan(cs.DENSE_S)
    span = per * dd.DECODE_KEYS
    wasted = sum(dd.DECODE_KEYS - max(0, min(n - r * span, dd.DECODE_KEYS))
                 for n in cs.DENSE_LENGTHS for r in range(-(-cs.DENSE_S // span)))
    needed = sum(min(max(n, 0), cs.DENSE_S) for n in cs.DENSE_LENGTHS)
    row = 2 * cs.KVH * cs.HD * 2  # K and V of all kv heads, bf16
    print(f"dense_eager at the table's lengths copies {wasted} rows ({wasted * row} bytes) past "
          f"the lengths beside the {needed} rows ({needed * row} bytes) they need")
    return 0


if __name__ == "__main__":
    sys.exit(main())
