"""Driver ``collocate``: training with its bubbles filled by offline
inference, as ``SpecInFRuntime`` runs it on one card.

Set-up builds the train state and its graphed step, drives the first three
steps through the window's own call and feed (the checked steps: the first
is the step's eager warm-up, the next two graph replays), lets
``measure_dp_profile`` calibrate the profile and the microstep, builds the
runtime over an inference engine of the initial weights, queues the offline
backlog and runs iterations until no new graph is captured.  The window
runs ``rt.run(1)`` iterations, keeping the backlog topped up, until
``seconds`` have passed; with tracing on, ``trace_seconds`` more of them
follow under the profiler.
"""
from __future__ import annotations

import itertools
import time

import numpy as np
import torch

from harness import check, program, traffic, weights
from repro_torch.configs.base import SpecInFConfig
from repro_torch.core import SpecInFRuntime, measure_dp_profile
from repro_torch.runtime import init_train_state, make_train_step
from repro_torch.serving.core import Priority, RequestState, SamplingParams


def run(ctx) -> dict:
    m, cf, mix, dev, seed = ctx.config["model"], ctx.config, ctx.mix, ctx.device, ctx.seed
    tr = cf["train"]
    cfg, tcfg = program.model_config(cf), program.train_config(cf)
    params = weights.make(m, seed, dev)
    ctx.mark("weights made")
    eng = program.engine(cfg, cf, params, dev)
    state = init_train_state(params)  # a trainable copy; the engine keeps its bf16 one
    del params
    ctx.mark("engine and train state built")
    step = program.TimedStep(make_train_step(cfg, tcfg, device=dev).jitted(), ctx.tracer, dev)
    pool = traffic.train_batches(m["vocab_size"], tr["batch"], tr["seq_len"],
                                 mix["train_batches"], seed)
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in b.items()} for b in pool]
    feed = itertools.cycle(batches)

    # the checked steps, through the window's own call and feed
    prog: dict = {"losses": []}
    for i in range(3):
        state, out = step(state, next(feed))
        prog["losses"].append(float(out["loss"]))
        if i < 2:
            check.read_optimizer(prog, state["opt"], i + 1, tcfg.beta1, tcfg.beta2)
    prog["change"] = check.change_norms(m, seed, weights.flat(state["params"]), dev)
    ctx.mark("three checked steps")

    profile, micro = measure_dp_profile(cfg.name, step, state, feed, eng,
                                        probe_slots=mix["probe_slots"])
    rt = SpecInFRuntime(train_step=step, train_state=state, batch_iter=feed, profile=profile,
                        engine=eng, cfg=SpecInFConfig(), decode_microstep_s=micro)
    ctx.mark("profile measured")
    core = eng.core
    program.StepRecorder(core, ctx.tracer)  # the engine steps' spans
    offline = traffic.RequestStream(mix["offline"], m["vocab_size"], seed, "offline")
    reqs: list = []

    def iteration():
        with ctx.tracer.span("generator"):
            while core.num_waiting < mix["offline"]["waiting"]:
                prompt, n = next(offline)
                reqs.append(core.submit(prompt, SamplingParams(max_new_tokens=n),
                                        priority=Priority.OFFLINE))
        with ctx.tracer.span("control_plane"):
            rt.run(1)

    last, stable = -1, 0
    for it in range(1, mix["warmup_max_iterations"] + 1):
        iteration()
        n = program.captures(eng, step)
        stable = stable + 1 if n == last else 0
        last = n
        if it >= mix["warmup_min_iterations"] and stable >= 2:
            break
    ctx.mark("warmed up")
    ctx.log(f"warm-up: {it} iterations, {last} graphs captured; profile compute "
            f"{profile.compute_s * 1e3:.3f} ms, bubbles {profile.bubble_s * 1e3:.3f} ms, "
            f"microstep {micro * 1e3:.3f} ms")

    # ---- the measured window ------------------------------------------
    counter = eng.obs.metrics.counter("core/generated_tokens/offline")
    tok0, ms0, it0 = counter.value, rt.metrics.offline_microsteps, len(rt.metrics.train_losses)
    done0 = {r.request_id for r in reqs if r.state.finished}
    torch.cuda.synchronize() if dev.type == "cuda" else None
    step.recording = True
    t0 = ctx.window_start = time.perf_counter()
    iters = []
    while True:
        a = time.perf_counter()
        iteration()
        b = time.perf_counter()
        iters.append((a, b))
        if b - t0 >= ctx.seconds:
            break
    torch.cuda.synchronize() if dev.type == "cuda" else None
    window_s = time.perf_counter() - t0
    step.recording = False
    tok1, ms1 = counter.value, rt.metrics.offline_microsteps
    ctx.log(f"window: {len(iters)} iterations in {window_s:.3f} s, "
            f"{program.captures(eng, step) - last} graphs captured inside it")
    # with tracing on, the profiler follows the window for two stretches of
    # ``trace_seconds`` of the same iterations (trace.Tracer), so its cost
    # is in no reading of the window
    if ctx.tracer.enabled:
        rate = [len(iters) / window_s]
        for spans in (False, True):
            ctx.tracer.start(spans)
            n = 0
            while time.perf_counter() - ctx.tracer.t0 < mix["trace_seconds"]:
                iteration()
                n += 1
            ctx.tracer.stop()
            rate.append(n / (ctx.tracer.stretches[-1][2] - ctx.tracer.stretches[-1][1]))
        ctx.log("iterations a second: window {:.3f}, device stretch {:.3f}, "
                "spans stretch {:.3f}".format(*rate))

    losses = rt.metrics.train_losses[it0:]
    finished = [r for r in reqs if r.state.finished and r.request_id not in done0]
    out = {
        "window_s": window_s,
        "iterations": [b - a for a, b in iters],
        "train_ms": step.times_ms(),
        "tokens_per_step": tr["batch"] * tr["seq_len"],
        "bubble_s": profile.bubble_s,
        "microstep_s": micro,
        "offline_tokens": tok1 - tok0,
        "offline_microsteps": ms1 - ms0,
        "attempted": len(losses) + len(finished),
        "failed": sum(not np.isfinite(x) for x in losses)
        + sum(r.state is not RequestState.FINISHED_LENGTH for r in finished),
        "memory_peak_bytes": torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0,
        "trace": ctx.tracer.summary(),
    }
    ctx.mark("window read")
    # what the window served: the requests it finished, and where they hold
    # too few tokens, every request it took tokens from
    served = [(r.prompt, np.asarray(r.output_tokens, np.int64)) for r in finished
              if r.output_tokens]
    if sum(len(s[1]) for s in served) < mix["check_tokens"]:
        served = [(r.prompt, np.asarray(r.output_tokens, np.int64)) for r in reqs
                  if r.output_tokens and r.request_id not in done0]

    # ---- the check, with the program's state freed ---------------------
    del rt, state, eng, core, step, feed, reqs
    program.release()
    check.exact_fp32()
    first3 = batches[:3]
    ref = check.reference_training(m, tr, seed, first3, dev)
    numbers = check.training_gaps(prog, ref)
    picked = check.sample(served, seed, mix["check_tokens"])
    numbers.update(check.served_gaps(m, seed, picked, dev, control=ctx.calibrate))
    if ctx.calibrate:
        low = check.reference_training(m, tr, seed, first3, dev, mode="fp8")
        numbers.update({"control_" + k: v for k, v in check.training_gaps(low, ref).items()})
        half = check.reference_training(m, tr, seed, first3, dev,
                                        rows=slice(0, tr["batch"] // 2))
        numbers.update({"halfbatch_" + k: v for k, v in check.training_gaps(half, ref).items()})
    out["numbers"] = numbers
    ctx.mark("checked against the reference")
    return out
