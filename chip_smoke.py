#!/usr/bin/env python3
"""Chip smoke of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing a line before the last:

1. device     -- ``nvidia-smi`` name and power limit, torch / CUDA versions;
                 fails without a CUDA device.
2. build      -- compiles every kernel source in ``repro_torch/kernels/csrc``
                 (one ``nvcc`` each, in parallel) into ``build/kernels/``.
3. kernels    -- each kernel against its plain PyTorch version on the card at
                 its path's shapes, in bf16 and fp32, with times (CUDA events,
                 L2 flushed before every launch) beside the plain version's,
                 ``scaled_dot_product_attention``'s (a yardstick the port never
                 calls) and the bound the card's memory rate and peak give
                 for the same work: the paged decode / chunked-prefill
                 kernels at the serving shapes, flash attention forward and
                 backward at the training shape (plus a ragged and a
                 non-causal case).
4. parity     -- a 2-layer, full-width qwen3-1.7b in fp32 runs the same work
                 with ``impl="cuda"`` and ``impl="torch"`` on the card: model
                 steps (K/V pools, decode logits, tokens), EngineCore token
                 streams, and ``lm_loss`` with its gradients must agree.
5. serve      -- qwen3-1.7b at full depth and width, bf16, serves 16 requests
                 through ``EngineCore.step()``; every request must finish and
                 both paged kernels must have launched (plain versions never).
6. collocated -- qwen3-1.7b at full depth and width trains (fp32 params, bf16
                 compute, batch 4 x seq 1024) under ``SpecInFRuntime``, whose
                 bubbles a bf16 engine on the initial weights fills with an
                 offline backlog and online requests.  The DP profile is sized
                 from the train step's and the engine microstep's times
                 measured here (``measure_dp_profile``); Algorithm 1's cap is
                 one fixed setting, ``COLLOC_UPPER_LIMIT``.  Losses must be finite and
                 fall, offline tokens must be produced, online requests
                 must finish, and all four kernels must have launched
                 (plain versions never).

Then one ``{"kernels": [...]}`` line (launches from the collocated run, the
slice's main path) and, last, the ``{"ok": true, ...}`` line.  Any failed
phase raises and the script exits non-zero.  It imports nothing of JAX or
of the ``repro`` package.
"""
from __future__ import annotations

import dataclasses
import gc
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

#: fp32 gradients, kernel vs plain version: relative to the largest |g|
GRAD_RTOL_FP32 = 1e-4
#: bf16 gradients: each dQ / dK / dV is rounded to bf16 once (relative 2^-9)
#: on top of D = rowsum(dO * O) taken from the bf16 output
GRAD_RTOL_BF16 = 2e-2

# kernel-phase shapes: the serving path's (qwen3-1.7b attention, 16-token
# pages, 32 table columns + sentinel = max_seq 512, 8 slots, 32-token chunks)
B, H, KVH, HD, PAGE, NCOLS, CHUNK = 8, 16, 8, 128, 16, 32, 32
DECODE_LENGTHS = [512, 300, 0, 17, 1, 256, 511, 100]
PREFILL_STARTS = [0, 64, 100, 480, 0, 33, 256, 16]
PREFILL_LENS = [32, 0, 17, 32, 1, 5, 32, 20]
SHARED_PAGES = 4  # slot 1's first pages are slot 0's (a radix-shared prefix)
# flash attention: the training shape (batch 4 x seq 1024, qwen3's 16 heads
# of 128 after the GQA expand), plus a ragged and a non-causal case
TRAIN_B, TRAIN_S = 4, 1024
FLASH_CASES = (  # (B, H, Sq, Sk, causal)
    (TRAIN_B, H, TRAIN_S, TRAIN_S, True),
    (2, H, 1000, 1000, True),
    (2, H, 512, 1000, False),
)
COLLOC_ITERS = 8
#: Algorithm 1's stable-phase token cap for the collocated phase, on every
#: run.  A grant token is 1 ms of microstep; the port's full-depth
#: microstep is host-bound near 60 ms (ROADMAP Queue C), so the default cap
#: of 64 tokens would never cover one.  256 tokens covers up to 4.
COLLOC_UPPER_LIMIT = 256.0


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
    return rows + _flash_rows()


def _flash_inputs(dtype, b, h, sq, sk, seed=0):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, h, sq, HD), generator=g, device="cuda").to(dtype)
    k = torch.randn((b, h, sk, HD), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, h, sk, HD), generator=g, device="cuda").to(dtype)
    do = torch.randn((b, h, sq, HD), generator=g, device="cuda").to(dtype)
    return q, k, v, do


def _check_flash():
    """Forward output and dQ / dK / dV of the kernels against the plain
    version (autograd, fp32, on the same inputs) for every case and dtype;
    returns the worst errors (forward absolute, gradients relative to the
    largest |g|) of the training-shape case."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    worst = {}
    for case in FLASH_CASES:
        b, h, sq, sk, causal = case
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = _flash_inputs(dtype, b, h, sq, sk)
            out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
            grads = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=causal)
            torch.cuda.synchronize()
            leaves = [t.float().requires_grad_() for t in (q, k, v)]
            ref = fa.flash_attention_torch(*leaves, causal=causal)
            rgrads = torch.autograd.grad(ref, leaves, do.float())
            bf16 = dtype == torch.bfloat16
            fwd_tol = BF16_ATOL if bf16 else FP32_ATOL
            grad_tol = GRAD_RTOL_BF16 if bf16 else GRAD_RTOL_FP32
            if not (torch.isfinite(out).all() and all(torch.isfinite(g).all() for g in grads)):
                raise AssertionError(f"flash_attention {case} {dtype}: non-finite output")
            fwd_err = (out.float() - ref).abs().max().item()
            grad_err = max(((g.float() - r).abs().max() / r.abs().max()).item()
                           for g, r in zip(grads, rgrads))
            log(f"kernel flash_attention {case} {dtype}: forward max_abs_err "
                f"{fwd_err:.3e} (tol {fwd_tol:g}); dq/dk/dv max err / max|g| "
                f"{grad_err:.3e} (tol {grad_tol:g})")
            if not (fwd_err <= fwd_tol and grad_err <= grad_tol):
                raise AssertionError(f"flash_attention {case} {dtype}: forward err "
                                     f"{fwd_err}, gradient err {grad_err}")
            if case == FLASH_CASES[0]:
                name = "bfloat16" if bf16 else "float32"
                worst[name] = (fwd_err, grad_err)
    return worst


def _flash_rows():
    """Rows of flash attention forward and backward: checked at every case,
    timed at the training shape in bf16."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    errs = _check_flash()
    b, h, s = TRAIN_B, H, TRAIN_S
    q, k, v, do = _flash_inputs(torch.bfloat16, b, h, s, s, seed=1)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    fwd_ms = _time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True))
    bwd_ms = _time_ms(lambda: fa.flash_attention_bwd(q, k, v, out, do, lse, causal=True))
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    plain_out = fa.flash_attention_torch(*leaves, causal=True)
    plain_fwd_ms = _time_ms(lambda: fa.flash_attention_torch(q, k, v, causal=True))
    plain_bwd_ms = _time_ms(
        lambda: torch.autograd.grad(plain_out, leaves, do, retain_graph=True))
    # yardstick: SDPA on the same bf16 inputs (forward; backward alone)
    sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=True)
    sdpa_fwd_ms = _time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    sdpa_bwd_ms = _time_ms(
        lambda: torch.autograd.grad(sdpa_out, leaves, do, retain_graph=True))
    del plain_out, sdpa_out
    # bounds: each input read once, each output written once; the causal
    # (q, k) pairs this shape has, 2 products forward and 5 backward
    elems, isz = b * h * s * HD, 2
    pairs = b * h * s * (s + 1) // 2
    fwd_bound, fwd_by = _bound_ms(4 * elems * isz + b * h * s * 4, 4 * pairs * HD,
                                  torch.bfloat16)
    bwd_bound, bwd_by = _bound_ms(8 * elems * isz + b * h * s * 4, 10 * pairs * HD,
                                  torch.bfloat16)
    src = "src/repro_torch/kernels/csrc/flash_attention.cu"
    rows = []
    for name, ms, plain_ms, lib_ms, bound, by, i in (
        ("flash_attention_fwd", fwd_ms, plain_fwd_ms, sdpa_fwd_ms, fwd_bound, fwd_by, 0),
        ("flash_attention_bwd", bwd_ms, plain_bwd_ms, sdpa_bwd_ms, bwd_bound, bwd_by, 1),
    ):
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": "src/repro/kernels/flash_attention.py:92",
            "launches": 0, "max_abs_err": errs["bfloat16"][i],
            "max_abs_err_fp32": errs["float32"][i],
            "err_kind": "absolute" if i == 0 else "relative to max|g|",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms,
        })
        log(f"kernel {name} (B={b}, H={h}, S={s}, hd={HD}, causal, bf16): {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound:.4f} ms ({by})")
    log(f"sdpa forward+backward {sdpa_fwd_ms + sdpa_bwd_ms:.4f} ms; flash kernels "
        f"forward+backward {fwd_ms + bwd_ms:.4f} ms")
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

    # training: lm_loss and every gradient, flash kernels vs plain version
    from repro_torch.tree import tree_leaves

    for p in tree_leaves(params):
        p.requires_grad_(True)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 257)), dtype=torch.int32,
                        device="cuda")
    res = {}
    for impl in ("cuda", "torch"):
        loss, _ = T.lm_loss(cfg, params, toks[:, :-1], toks[:, 1:], impl=impl,
                            compute_dtype=torch.float32)
        res[impl] = (loss.detach(), torch.autograd.grad(loss, tree_leaves(params)))
    torch.cuda.synchronize()
    loss_err = (res["cuda"][0] - res["torch"][0]).abs().item()
    grad_err = max(((a - b).abs().max() / b.abs().max()).item()
                   for a, b in zip(res["cuda"][1], res["torch"][1]))
    if not (torch.isfinite(res["cuda"][0]) and loss_err <= 1e-5 * res["torch"][0].abs().item()):
        raise AssertionError(f"parity: lm_loss differs by {loss_err}")
    if not grad_err <= GRAD_RTOL_FP32:
        raise AssertionError(f"parity: gradients differ by {grad_err} of max|g|")
    log(f"parity train (2 layers, full width, fp32, B=2, S=256): loss "
        f"{res['torch'][0].item():.6f}, |d| {loss_err:.2e} (tol 1e-5 relative); "
        f"gradients max err / max|g| {grad_err:.2e} (tol {GRAD_RTOL_FP32:g})")
    del params, res


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
    from repro_torch.tree import tree_leaves

    cfg = configs.get_config("qwen3-1.7b")
    t0 = time.monotonic()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           dtype=torch.bfloat16)
    t_start = time.monotonic()
    engine = InferenceEngine(cfg, params, max_slots=8, max_seq=512,
                             clock=lambda: time.monotonic() - t_start)
    torch.cuda.synchronize()
    log(f"serve: weights {sum(p.numel() for p in tree_leaves(params)) / 1e9:.3f} B params bf16, "
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
        runs = name.startswith("paged_")  # the serving path's kernels
        if (c["cuda"] > 0) != runs or c["torch"] != 0:
            raise AssertionError(f"serve: {name} launches {c} (the paged kernels "
                                 f"must run, no plain version ever)")
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


def _busy_and_top(prof):
    """Device busy seconds (union of kernel intervals), kernel count and
    device seconds by kernel name, from a ``torch.profiler`` run; None
    when the profiler saw no device time."""
    import torch

    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t0, t1 = e.time_range.start, e.time_range.end
            spans.append((t0, t1))
            by_name[e.name] = by_name.get(e.name, 0.0) + (t1 - t0) / 1e6
    if not spans:
        return None
    spans.sort()
    busy, end = 0.0, -math.inf
    for t0, t1 in spans:
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    return busy / 1e6, len(spans), by_name


def _profile_serve(engine, cfg):
    """Where the time goes: a second, smaller serving round under
    ``torch.profiler`` -- the device's busy share of the wall time (union of
    kernel intervals) and the kernels that took it.  The profiler slows the
    host, so the share is a lower bound for the unprofiled run."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    prompts = _prompts(np.random.default_rng(3), 8, 48, 96, cfg.vocab_size, 0, ())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        reqs, secs = _serve(engine, prompts, 16)
    got = _busy_and_top(prof)
    if got is None:
        log("serve profile: the profiler saw no device time (not measured)")
        return
    busy_s, n, by_name = got
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"serve profile ({len(reqs)} requests, {sum(len(r.output_tokens) for r in reqs)} "
        f"tokens, profiler on): wall {secs:.3f}s, device busy {busy_s:.3f}s "
        f"({100 * busy_s / secs:.1f}%), {n} kernels; top: " + "; ".join(
            f"{name[:60]} {sec * 1e3:.1f}ms" for name, sec in top))


# ---------------------------------------------------------------------------
# 6. collocated
# ---------------------------------------------------------------------------


def phase_collocated():
    """qwen3-1.7b at full depth and width trains under SpecInFRuntime while
    a bf16 engine on the initial weights fills its bubbles.  Returns the
    kernel launch counts of the runtime's run."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.configs import SpecInFConfig, TrainConfig
    from repro_torch.core import SpecInFRuntime, measure_dp_profile
    from repro_torch.data import SyntheticDataset
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.runtime import init_train_state, make_train_step
    from repro_torch.serving.core import Priority, SamplingParams
    from repro_torch.serving.engine import InferenceEngine, Request

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get_config("qwen3-1.7b")
    # optimiser defaults; the warmup and horizon fit a short run
    tcfg = TrainConfig(warmup_steps=2, total_steps=COLLOC_ITERS + 2)
    t0 = time.monotonic()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           dtype=getattr(torch, tcfg.param_dtype))
    engine = InferenceEngine(cfg, params, max_slots=8, max_seq=512)
    state = init_train_state(params)  # a copy: the engine serves the initial weights
    del params
    step = make_train_step(cfg, tcfg)
    ds = SyntheticDataset(cfg, seq_len=TRAIN_S, global_batch=TRAIN_B, seed=0)
    torch.cuda.synchronize()
    log(f"collocated: set-up {time.monotonic() - t0:.1f}s (fp32 params + AdamW "
        f"state, bf16 engine weights)")

    # the profile's units: the train step and the engine microstep (4 offline
    # slots running, as the backlog below fills them), measured here
    batches = (ds.next_batch() for _ in iter(int, 1))
    profile, microstep_s = measure_dp_profile(cfg.name, step, state, batches, engine)
    compute_s = profile.compute_s
    spec_cfg = SpecInFConfig(upper_limit=COLLOC_UPPER_LIMIT)
    log(f"collocated: train step {compute_s * 1e3:.1f} ms (B={TRAIN_B} x S={TRAIN_S} = "
        f"{TRAIN_B * TRAIN_S / compute_s:.0f} tokens/s), engine microstep "
        f"{microstep_s * 1e3:.1f} ms (4 slots; Algorithm-1 cap {spec_cfg.upper_limit:g} "
        f"tokens = {spec_cfg.upper_limit / (microstep_s * 1e3):.2f} microsteps); dp profile: "
        f"iteration {profile.iteration_s * 1e3:.1f} ms, bubbles "
        f"{profile.bubble_fraction:.1%}, longest {profile.max_bubble_s * 1e3:.1f} ms")

    rng = np.random.default_rng(5)
    for n in (24, 48, 80, 130):  # offline backlog
        engine.core.submit(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                           SamplingParams(max_new_tokens=256), priority=Priority.OFFLINE)
    online = [Request(prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                      max_new_tokens=8, arrival_time=t, online=True)
              for n, t in ((20, 0.0), (40, profile.iteration_s), (64, 2 * profile.iteration_s))]
    train_ms = []

    def timed_step(st, batch):
        t = time.monotonic()
        out = step(st, batch)
        torch.cuda.synchronize()
        train_ms.append((time.monotonic() - t) * 1e3)
        return out

    rt = SpecInFRuntime(train_step=timed_step, train_state=state, batch_iter=batches,
                        profile=profile, engine=engine, online_requests=online,
                        cfg=spec_cfg, decode_microstep_s=microstep_s)
    ops.reset_launch_counts()
    t0 = time.monotonic()
    m = rt.run(COLLOC_ITERS)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = ops.launch_counts()

    losses = m.train_losses
    if not (len(losses) == COLLOC_ITERS and np.isfinite(losses).all()
            and losses[-1] < losses[0]):
        raise AssertionError(f"collocated: losses {losses} (finite and falling expected)")
    if m.offline_tokens_generated <= 0:
        raise AssertionError("collocated: no offline tokens were filled into the bubbles")
    if m.online_served != len(online):
        raise AssertionError(f"collocated: {m.online_served} of {len(online)} online "
                             f"requests finished")
    for name, c in counts.items():
        if c["cuda"] <= 0 or c["torch"] != 0:
            raise AssertionError(f"collocated: {name} launches {c} (kernel must run, "
                                 f"plain version never)")
    online_tokens = m.obs.metrics.counter("core/generated_tokens/online").value
    total = sum(m.phase_counts.values())
    shares = {k: round(v / total, 4) for k, v in sorted(m.phase_counts.items())}
    step_ms = float(np.mean(train_ms))
    log(f"collocated: {COLLOC_ITERS} iterations in {wall:.2f}s wall "
        f"({sum(train_ms) / 1e3:.2f}s training, {wall - sum(train_ms) / 1e3:.2f}s filling "
        f"and control); loss {losses[0]:.4f} -> {losses[-1]:.4f}; train step "
        f"{step_ms:.1f} ms mean = {TRAIN_B * TRAIN_S / step_ms * 1e3:.0f} training tokens/s")
    log(f"collocated: filled {m.offline_tokens_generated} offline tokens in "
        f"{m.offline_microsteps} microsteps and {online_tokens} online tokens "
        f"({m.online_served} requests, TTFT p95 {m.p95_ttft_s() * 1e3:.1f} ms, latency "
        f"p95 {m.p95_latency_s() * 1e3:.1f} ms virtual); {m.preemptions} preemptions; "
        f"virtual time {m.virtual_time_s:.3f}s; Algorithm-1 phase shares {shares}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    log(f"collocated launches: {json.dumps(counts)} (per train step: " + ", ".join(
        f"{k} {counts[k]['cuda'] / COLLOC_ITERS:.1f}"
        for k in ("flash_attention_fwd", "flash_attention_bwd")) + ")")
    _profile_train(step, state, ds)
    return {name: c["cuda"] for name, c in counts.items()}


def _profile_train(step, state, ds):
    """Where the train step's time goes: one more step under
    ``torch.profiler`` -- device busy share of its wall time, the flash
    kernels' share of the device time, and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    batch = ds.next_batch()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step(state, batch)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
    got = _busy_and_top(prof)
    if got is None:
        log("train profile: the profiler saw no device time (not measured)")
        return
    busy, n, by_name = got
    total = sum(by_name.values())
    flash = {k: v for k, v in by_name.items() if "flash_" in k}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"train profile (1 step, profiler on): wall {secs:.3f}s, device busy {busy:.3f}s "
        f"({100 * busy / secs:.1f}%), {n} kernels; flash kernels {sum(flash.values()):.3f}s "
        f"({100 * sum(flash.values()) / total:.1f}% of device time: " + ", ".join(
            f"{k.split('<')[0].split('::')[-1]} {v * 1e3:.1f}ms"
            for k, v in sorted(flash.items())) +
        "); top: " + "; ".join(f"{k[:50]} {v * 1e3:.1f}ms" for k, v in top))


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
    t_start = time.monotonic()
    phase_device()
    phase_build()
    rows = phase_kernels()
    phase_parity()
    serve_launches = phase_serve()
    launches = phase_collocated()
    for row in rows:
        row["launches"] = launches[row["name"]]
        if serve_launches[row["name"]]:
            row["launches_serve"] = serve_launches[row["name"]]
    log(f"all phases passed in {time.monotonic() - t_start:.1f}s")
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
