#!/usr/bin/env python3
"""Chip smoke of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing a line before the last:

1. device  -- ``nvidia-smi`` name and power limit, torch / CUDA versions;
              fails without a CUDA device.
2. build   -- compiles every kernel source in ``repro_torch/kernels/csrc``
              (one ``nvcc`` each, in parallel) into ``build/kernels/``.
3. kernels -- each kernel against its plain PyTorch version on the card at
              the serving path's shapes, in bf16 and fp32, with times
              (CUDA events, L2 flushed before every launch) beside the plain
              version's, ``scaled_dot_product_attention``'s (a yardstick the
              port never calls) and the bound the card's memory rate and
              peak give for the same work.
4. parity  -- a 2-layer, full-width qwen3-1.7b in fp32 runs the same work
              with ``impl="cuda"`` and ``impl="torch"`` on the card: model
              steps (K/V pools, decode logits, tokens) and EngineCore token
              streams must agree.
5. serve   -- qwen3-1.7b at full depth and width, bf16, serves 16 requests
              through ``EngineCore.step()``; every request must finish and
              both kernels must have launched (the plain versions never).

Then one ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line.  Any failed phase raises and the script exits non-zero.  It imports
nothing of JAX or of the ``repro`` package.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
#: H100 SXM device-memory rate and dense peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS_BF16 = 989e12
PEAK_FLOPS_FP32 = 67e12
#: bf16 kernel vs the fp32 plain version on the same bf16 inputs: the kernel
#: rounds its output to bf16 (relative 2^-8 on |out| <~ 3)
BF16_ATOL = 2e-2
#: fp32 kernel vs fp32 plain version: same math, sums in another order
FP32_ATOL = 1e-4
#: fp32 model logits, impl="cuda" vs impl="torch": attention differences of
#: ~1e-6 carried through 2 layers and a 151936-way unembedding
LOGITS_ATOL = 1e-3

# kernel-phase shapes: the serving path's (qwen3-1.7b attention, 16-token
# pages, 32 table columns + sentinel = max_seq 512, 8 slots, 32-token chunks)
B, H, KVH, HD, PAGE, NCOLS, CHUNK = 8, 16, 8, 128, 16, 32, 32
DECODE_LENGTHS = [512, 300, 0, 17, 1, 256, 511, 100]
PREFILL_STARTS = [0, 64, 100, 480, 0, 33, 256, 16]
PREFILL_LENS = [32, 0, 17, 32, 1, 5, 32, 20]
SHARED_PAGES = 4  # slot 1's first pages are slot 0's (a radix-shared prefix)


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("[smoke] FAIL: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------


def phase_build():
    from repro_torch.kernels import build

    t0 = time.monotonic()
    built = build.build()
    for name, (secs, out) in built.items():
        usage = [ln.strip() for ln in out.splitlines() if "registers" in ln or "spill" in ln]
        log(f"build {name}: {secs:.1f}s; ptxas: {' | '.join(usage)}")
    log(f"build: {len(built)} libraries in {time.monotonic() - t0:.1f}s "
        f"into {build.BUILD_DIR}")


# ---------------------------------------------------------------------------
# 3. kernels
# ---------------------------------------------------------------------------


def _time_ms(fn, reps: int = 30) -> float:
    """Median device time of ``fn`` over ``reps`` launches, each after a
    1 GiB write that evicts the 50 MB L2 and keeps the card busy (~0.3 ms)
    while the host enqueues the timed launch, so host-side wrapper work does
    not show up as device time."""
    import torch

    flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def _pool_inputs(dtype, seed: int = 0):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    pool_n = 1 + B * NCOLS
    k_pool = torch.randn((pool_n, PAGE, KVH, HD), generator=g, device="cuda").to(dtype)
    v_pool = torch.randn((pool_n, PAGE, KVH, HD), generator=g, device="cuda").to(dtype)
    perm = torch.randperm(pool_n - 1, generator=g, device="cuda") + 1
    bt = perm.reshape(B, NCOLS).to(torch.int32)
    bt[1, :SHARED_PAGES] = bt[0, :SHARED_PAGES]
    bt = torch.cat([bt, torch.zeros((B, 1), dtype=torch.int32, device="cuda")], 1)
    return g, k_pool, v_pool, bt.contiguous()


def _unique_kv_rows(bt, needed):
    """Distinct (physical page, offset) K/V rows the slots' needed key
    positions name: what a perfect kernel reads once."""
    rows = set()
    tables = bt.tolist()
    for b, n in enumerate(needed):
        for pos in range(min(n, NCOLS * PAGE)):
            rows.add((tables[b][pos // PAGE], pos % PAGE))
    return len(rows)


def _bound_ms(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    import torch

    peak = PEAK_FLOPS_BF16 if dtype == torch.bfloat16 else PEAK_FLOPS_FP32
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _check_kernel(name, kernel, plain, make_inputs):
    """The kernel against its plain version on the same inputs, in bf16 (the
    plain version computing in fp32) and in fp32; returns the errors."""
    import torch

    errs = {}
    for dtype, tol in ((torch.bfloat16, BF16_ATOL), (torch.float32, FP32_ATOL)):
        args = make_inputs(dtype)
        out = kernel(*args)
        torch.cuda.synchronize()
        ref = plain(*[a.float() if a.is_floating_point() else a for a in args])
        if out.shape != ref.shape:
            raise AssertionError(f"{name}: shape {tuple(out.shape)} != {tuple(ref.shape)}")
        if not torch.isfinite(out).all():
            raise AssertionError(f"{name} {dtype}: non-finite output")
        err = (out.float() - ref).abs().max().item()
        errs[str(dtype).split(".")[-1]] = err
        log(f"kernel {name} {dtype}: max_abs_err {err:.3e} (tol {tol:g})")
        if not err <= tol:
            raise AssertionError(f"{name} {dtype}: max_abs_err {err} > {tol}")
    return errs


def phase_kernels():
    """Returns the kernel rows of the final ``kernels`` line (launches are
    filled in by the serve phase)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import paged_decode_attention as dec
    from repro_torch.kernels import paged_prefill_attention as pre

    rows = []
    isz = 2  # bf16 timing runs

    # ---- paged decode ----------------------------------------------------
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device="cuda")

    def decode_inputs(dtype):
        g, k_pool, v_pool, bt = _pool_inputs(dtype)
        q = torch.randn((B, H, HD), generator=g, device="cuda").to(dtype)
        return q, k_pool, v_pool, bt, lengths

    errs = _check_kernel(
        "paged_decode_attention", dec.paged_decode_attention,
        dec.paged_decode_attention_torch, decode_inputs,
    )
    q, k_pool, v_pool, bt, _ = decode_inputs(torch.bfloat16)
    k_ms = _time_ms(lambda: dec.paged_decode_attention(q, k_pool, v_pool, bt, lengths))
    p_ms = _time_ms(lambda: dec.paged_decode_attention_torch(q, k_pool, v_pool, bt, lengths))
    # yardstick: SDPA over the pre-gathered pages (gather not timed)
    S = NCOLS * PAGE
    kd = dec.gather_pages(k_pool, bt).transpose(1, 2).repeat_interleave(H // KVH, 1)
    vd = dec.gather_pages(v_pool, bt).transpose(1, 2).repeat_interleave(H // KVH, 1)
    mask = (torch.arange(S, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    l_ms = _time_ms(lambda: F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask))
    needed = [min(n, S) for n in DECODE_LENGTHS]
    kv_rows = _unique_kv_rows(bt, needed)
    nbytes = (2 * B * H * HD * isz + 2 * kv_rows * KVH * HD * isz
              + bt.numel() * 4 + B * 4)
    flops = 4 * HD * H * sum(needed)
    bound, by = _bound_ms(nbytes, flops, torch.bfloat16)
    rows.append({
        "name": "paged_decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
        "replaces": "src/repro/kernels/paged_decode_attention.py:53",
        "launches": 0, "max_abs_err": errs["bfloat16"],
        "max_abs_err_fp32": errs["float32"],
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": l_ms,
    })
    log(f"kernel paged_decode_attention: {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
        f"sdpa {l_ms:.4f} ms, bound {bound:.4f} ms ({by})")

    # ---- paged chunked prefill ---------------------------------------------
    starts = torch.tensor(PREFILL_STARTS, dtype=torch.int32, device="cuda")
    clens = torch.tensor(PREFILL_LENS, dtype=torch.int32, device="cuda")

    def prefill_inputs(dtype):
        g, k_pool, v_pool, bt = _pool_inputs(dtype, seed=1)
        q = torch.randn((B, CHUNK, H, HD), generator=g, device="cuda").to(dtype)
        return q, k_pool, v_pool, bt, starts, clens

    errs = _check_kernel(
        "paged_prefill_attention", pre.paged_prefill_attention,
        pre.paged_prefill_attention_torch, prefill_inputs,
    )
    q, k_pool, v_pool, bt, _, _ = prefill_inputs(torch.bfloat16)
    k_ms = _time_ms(lambda: pre.paged_prefill_attention(q, k_pool, v_pool, bt, starts, clens))
    p_ms = _time_ms(
        lambda: pre.paged_prefill_attention_torch(q, k_pool, v_pool, bt, starts, clens)
    )
    kd = dec.gather_pages(k_pool, bt).transpose(1, 2).repeat_interleave(H // KVH, 1)
    vd = dec.gather_pages(v_pool, bt).transpose(1, 2).repeat_interleave(H // KVH, 1)
    t = torch.arange(CHUNK, device="cuda")
    bound_pos = starts[:, None] + t[None, :]
    mask = (torch.arange(S, device="cuda")[None, None, :] <= bound_pos[:, :, None]) & (
        t[None, :, None] < clens[:, None, None])
    q4 = q.transpose(1, 2)
    l_ms = _time_ms(
        lambda: F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask[:, None])
    )
    needed = [s + c if c else 0 for s, c in zip(PREFILL_STARTS, PREFILL_LENS)]
    kv_rows = _unique_kv_rows(bt, needed)
    real_rows = sum(PREFILL_LENS)
    nbytes = (real_rows * H * HD * isz + B * CHUNK * H * HD * isz
              + 2 * kv_rows * KVH * HD * isz + bt.numel() * 4 + 2 * B * 4)
    flops = sum(4 * HD * H * (s + j + 1)
                for s, c in zip(PREFILL_STARTS, PREFILL_LENS) for j in range(c))
    bound, by = _bound_ms(nbytes, flops, torch.bfloat16)
    rows.append({
        "name": "paged_prefill_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_prefill_attention.cu",
        "replaces": "src/repro/kernels/paged_prefill_attention.py:50",
        "launches": 0, "max_abs_err": errs["bfloat16"],
        "max_abs_err_fp32": errs["float32"],
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": l_ms,
    })
    log(f"kernel paged_prefill_attention: {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
        f"sdpa {l_ms:.4f} ms, bound {bound:.4f} ms ({by})")
    return rows


# ---------------------------------------------------------------------------
# 4. parity
# ---------------------------------------------------------------------------


def _prompts(rng, n, lo, hi, vocab, shared_prefix, shared_idx):
    """``n`` random prompts of ``lo``..``hi`` tokens; those at ``shared_idx``
    start with one common ``shared_prefix``-token prefix.  The first of them
    is admitted in the first wave and the rest after slots free, so the
    later ones hit the radix cache."""
    import numpy as np

    prefix = rng.integers(0, vocab, shared_prefix)
    out = []
    for i in range(n):
        p = rng.integers(0, vocab, int(rng.integers(lo, hi + 1)))
        if i in shared_idx:
            p = np.concatenate([prefix, p])
        out.append(p.astype(np.int32))
    return out


def _serve(engine, prompts, max_new):
    """Submit every prompt (ONLINE, arrival now) and step the core until all
    finish; returns the requests and the wall seconds."""
    import torch

    from repro_torch.serving.core import Priority, SamplingParams

    core = engine.core
    reqs = [core.submit(p, SamplingParams(max_new_tokens=max_new),
                        priority=Priority.ONLINE) for p in prompts]
    t0 = time.monotonic()
    guard = 0
    while core.has_unfinished:
        core.step()
        guard += 1
        if guard > 10_000:
            raise AssertionError("serve loop made no progress")
    torch.cuda.synchronize()
    return reqs, time.monotonic() - t0


def phase_parity():
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import InferenceEngine

    cfg = dataclasses.replace(configs.get_config("qwen3-1.7b"), num_layers=2)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))

    # model steps: two chunk waves (ragged, a frozen slot, starts > 0), one
    # decode step, one fused loop with per-slot freeze
    b, per_slot = 4, 8
    bt = torch.zeros((b, per_slot + 1), dtype=torch.int32)
    bt[:, :per_slot] = torch.randperm(b * per_slot, generator=torch.Generator().manual_seed(0)
                                      ).reshape(b, per_slot) + 1
    rng = np.random.default_rng(0)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, b, CHUNK)), dtype=torch.int32,
                        device="cuda")
    waves = [torch.tensor(w, dtype=torch.int32, device="cuda")
             for w in ([32, 32, 7, 0], [8, 0, 0, 25])]
    results = {}
    for impl in ("cuda", "torch"):
        cache = T.init_paged_cache(cfg, b, b * per_slot + 1, PAGE, per_slot, torch.float32)
        cache["block_tables"] = bt.to("cuda")
        firsts = []
        for w, lens in enumerate(waves):
            nt, cache = T.prefill_chunks_into_slots(
                cfg, params, toks[w], lens, cache, compute_dtype=torch.float32,
                attn_impl=impl,
            )
            firsts.append(nt)
        first = torch.where(waves[1] > 0, firsts[1], firsts[0])
        logits, cache = T.decode_step(cfg, params, first, cache,
                                      compute_dtype=torch.float32, attn_impl=impl)
        out = T.decode_loop(cfg, params, logits.argmax(-1).to(torch.int32), cache,
                            torch.tensor([8, 8, 3, 0], dtype=torch.int32, device="cuda"),
                            k=8, max_seq=per_slot * PAGE, compute_dtype=torch.float32,
                            attn_impl=impl)
        torch.cuda.synchronize()
        results[impl] = (first, logits, out[3], cache["layers"]["k"], cache["layers"]["v"])
    (f_c, l_c, s_c, k_c, v_c), (f_t, l_t, s_t, k_t, v_t) = results["cuda"], results["torch"]
    kv_err = max((k_c[:, 1:] - k_t[:, 1:]).abs().max().item(),
                 (v_c[:, 1:] - v_t[:, 1:]).abs().max().item())
    logit_err = (l_c - l_t).abs().max().item()
    if not torch.equal(f_c, f_t):
        raise AssertionError("parity: prefill next tokens differ (cuda vs torch)")
    if not (kv_err <= FP32_ATOL):
        raise AssertionError(f"parity: prefill K/V differ by {kv_err} > {FP32_ATOL}")
    if not (logit_err <= LOGITS_ATOL and torch.isfinite(l_c).all()):
        raise AssertionError(f"parity: decode logits differ by {logit_err} > {LOGITS_ATOL}")
    if not torch.equal(s_c, s_t):
        raise AssertionError("parity: decode_loop token streams differ")
    log(f"parity model (2 layers, full width, fp32): prefill K/V max err {kv_err:.2e}, "
        f"decode logits max err {logit_err:.2e} (tol {LOGITS_ATOL:g}), tokens equal")

    # the engine: same requests through EngineCore with either impl
    streams = {}
    for impl in ("cuda", "torch"):
        eng = InferenceEngine(cfg, params, max_slots=4, max_seq=256,
                              compute_dtype=torch.float32, decode_impl=impl)
        prompts = _prompts(np.random.default_rng(1), 6, 24, 80, cfg.vocab_size,
                           shared_prefix=32, shared_idx=(0, 5))
        reqs, _ = _serve(eng, prompts, max_new=8)
        streams[impl] = [list(r.output_tokens) for r in reqs]
    if streams["cuda"] != streams["torch"]:
        raise AssertionError("parity: EngineCore token streams differ (cuda vs torch)")
    log(f"parity engine: {len(streams['cuda'])} requests, token streams equal")
    del params


# ---------------------------------------------------------------------------
# 5. serve
# ---------------------------------------------------------------------------


def phase_serve():
    """qwen3-1.7b at full depth, bf16, 16 requests through EngineCore.
    Returns the kernel launch counts of the serving run."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import InferenceEngine

    cfg = configs.get_config("qwen3-1.7b")
    t0 = time.monotonic()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           dtype=torch.bfloat16)
    t_start = time.monotonic()
    engine = InferenceEngine(cfg, params, max_slots=8, max_seq=512,
                             clock=lambda: time.monotonic() - t_start)
    torch.cuda.synchronize()
    log(f"serve: weights {sum(p.numel() for p in _leaves(params)) / 1e9:.3f} B params bf16, "
        f"KV pool {engine.kv_cache_bytes() / 1e9:.3f} GB, set-up {time.monotonic() - t0:.1f}s")
    prompts = _prompts(np.random.default_rng(2), 16, 24, 136, cfg.vocab_size,
                       shared_prefix=64, shared_idx=(0, 13, 14, 15))
    max_new = 32
    ops.reset_launch_counts()
    reqs, secs = _serve(engine, prompts, max_new)
    counts = ops.launch_counts()
    m = engine.obs.metrics
    for r in reqs:
        if r.finish_reason != "length" or len(r.output_tokens) != max_new:
            raise AssertionError(f"serve: request {r.request_id} ended "
                                 f"{r.finish_reason} with {len(r.output_tokens)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.output_tokens):
            raise AssertionError("serve: token id out of the vocabulary")
    for name, c in counts.items():
        if c["cuda"] <= 0 or c["torch"] != 0:
            raise AssertionError(f"serve: {name} launches {c} (kernel must run, "
                                 f"plain version never)")
    tokens = sum(len(r.output_tokens) for r in reqs)
    ttft = m.histogram("core/online_ttft_s")
    lat = m.histogram("core/online_latency_s")
    log(f"serve: {len(reqs)} requests, prompts {min(map(len, prompts))}-"
        f"{max(map(len, prompts))} tokens ({sum(map(len, prompts))} total), "
        f"{tokens} new tokens in {secs:.3f}s = {tokens / secs:.1f} tok/s; "
        f"TTFT p50 {ttft.percentile(50) * 1e3:.1f} ms p95 {ttft.percentile(95) * 1e3:.1f} ms; "
        f"latency p50 {lat.percentile(50) * 1e3:.1f} ms p95 {lat.percentile(95) * 1e3:.1f} ms; "
        f"prefix-skipped {engine.prefill_skipped_tokens} tokens; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    log(f"serve launches: {json.dumps(counts)} "
        f"(per generated token: " + ", ".join(
            f"{k} {v['cuda'] / tokens:.2f}" for k, v in counts.items()) + ")")
    _profile_serve(engine, cfg)
    return {name: c["cuda"] for name, c in counts.items()}


def _profile_serve(engine, cfg):
    """Where the time goes: a second, smaller serving round under
    ``torch.profiler`` -- the device's busy share of the wall time (union of
    kernel intervals) and the kernels that took it.  The profiler slows the
    host, so the share is a lower bound for the unprofiled run."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    prompts = _prompts(np.random.default_rng(3), 8, 48, 96, cfg.vocab_size, 0, ())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        reqs, secs = _serve(engine, prompts, 16)
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t0, t1 = e.time_range.start, e.time_range.end
            spans.append((t0, t1))
            by_name[e.name] = by_name.get(e.name, 0.0) + (t1 - t0)
    if not spans:
        log("serve profile: the profiler saw no device time (not measured)")
        return
    spans.sort()
    busy, end = 0.0, -math.inf
    for t0, t1 in spans:
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    busy_s = busy / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"serve profile ({len(reqs)} requests, {sum(len(r.output_tokens) for r in reqs)} "
        f"tokens, profiler on): wall {secs:.3f}s, device busy {busy_s:.3f}s "
        f"({100 * busy_s / secs:.1f}%), {len(spans)} kernels; top: " + "; ".join(
            f"{name[:60]} {ms / 1e3:.1f}ms" for name, ms in top))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def main() -> int:
    try:
        import torch  # noqa: F401
    except ImportError:
        raise SystemExit("[smoke] FAIL: torch is not installed")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        raise SystemExit(
            "[smoke] FAIL: src/repro_torch not found beside chip_smoke.py "
            "(run it from a checkout of the repository)"
        )
    phase_device()
    phase_build()
    rows = phase_kernels()
    phase_parity()
    launches = phase_serve()
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    import torch

    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
