"""Driver ``serve``: the inference instance alone, driven by
``EngineCore.step()`` with its default priority policy, on the wall clock.

ONLINE requests arrive open-loop on a Poisson schedule at the mix's fixed
rate; each is submitted with ``arrival_time`` equal to its due time and is
timed from that instant to the step that returned its first and its last
token.  An OFFLINE backlog fills the spare slots and is kept topped up.
Set-up warms up on a schedule of its own until no new graph is captured.
After the window the requests it made due are served to their end (no new
arrivals, no new backlog) for at most ``drain_seconds``: a late answer
counts its wait, one that never comes counts as failed.
"""
from __future__ import annotations

import collections
import time

import numpy as np
import torch

from harness import check, program, readers, traffic, weights
from repro_torch.serving.core import Priority, RequestState, SamplingParams


class Loop:
    """The open-loop generator and the stepping of the core."""

    def __init__(self, core, tracer, mix: dict, vocab: int, seed: int):
        self.core, self.tracer, self.mix = core, tracer, mix
        self.offline = traffic.RequestStream(mix["offline"], vocab, seed, "offline")
        self.tracked: dict = {}
        self.lag: list = []

    def schedule(self, stream: str, seconds: float, seed: int, mix_seed: int,
                 until: float | None = None) -> collections.deque:
        """``(due, prompt, max_new)`` of the arrivals of ``seconds``: the
        same arrivals and sizes on every run seed, in the seed's order
        (``traffic.arrivals``), then schedules of the same kind after it
        up to ``until`` (which defaults to ``seconds``)."""
        on = self.mix["online"]
        until = seconds if until is None else until
        due, part = traffic.arrivals(on["rate"], seconds, mix_seed, seed), 0
        reqs = traffic.RequestStream(on, self.core.engine.cfg.vocab_size, seed, stream,
                                     block=max(len(due), 1))
        while (part + 1) * seconds < until:
            part += 1
            more = traffic.arrivals(on["rate"], seconds, mix_seed, seed, part)
            due = np.concatenate([due, part * seconds + more])
        return collections.deque((t, *next(reqs)) for t in due if t < until)

    def online_idle(self) -> bool:
        """No ONLINE request waits or holds a slot."""
        core = self.core
        return not core.waiting[Priority.ONLINE] and all(
            cr.priority is not Priority.ONLINE for cr in core.slot_requests.values())

    def submit_due(self, pending: collections.deque, until: float) -> None:
        """Submit the ONLINE arrivals of ``pending`` due by ``until``, each
        with its due time as its arrival time."""
        while pending and pending[0][0] <= until:
            due, prompt, n = pending.popleft()
            cr = self.core.submit(prompt, SamplingParams(max_new_tokens=n),
                                  priority=Priority.ONLINE, arrival_time=due)
            self.tracked[cr.request_id] = [due, None, None, cr]
            self.lag.append(time.monotonic() - due)

    def drive(self, pending: collections.deque, until: float, *, backlog: bool = True,
              done=None) -> None:
        core, cap = self.core, self.mix["offline"]["waiting"]
        while True:
            now = time.monotonic()
            if now >= until or (done is not None and done()):
                return
            with self.tracer.span("generator"):
                self.submit_due(pending, now)
                while backlog and len(core.waiting[Priority.OFFLINE]) < cap:
                    prompt, n = next(self.offline)
                    core.submit(prompt, SamplingParams(max_new_tokens=n),
                                priority=Priority.OFFLINE)
            if not core.has_unfinished:
                time.sleep(max(min(pending[0][0] if pending else until, until) - now, 0) / 2)
                continue
            out = core.step()
            t = time.monotonic()
            for o in out.outputs:
                e = self.tracked.get(o.request_id)
                if e is not None and o.new_tokens and e[1] is None:
                    e[1] = t
            for cr in out.finished:
                e = self.tracked.get(cr.request_id)
                if e is not None:
                    e[2] = t


def build(ctx):
    """The engine and the loop over it, weights from the seed in the type
    they are served in."""
    m, cf, dev = ctx.config["model"], ctx.config, ctx.device
    params = weights.make(m, ctx.seed, dev, getattr(torch, cf["engine"]["dtype"]))
    eng = program.engine(program.model_config(cf), cf, params, dev)
    del params
    loop = Loop(eng.core, ctx.tracer, ctx.mix, m["vocab_size"], ctx.seed)
    return eng, loop


def warm_up(eng, loop: Loop, mix: dict, seed: int) -> int:
    """Drive a warm-up schedule until no graph was captured for a while,
    then serve its ONLINE requests to their end: they queue while graphs
    are captured, and the window starts from the OFFLINE backlog alone, not
    behind them."""
    pending = loop.schedule("warmup", mix["warmup_max_seconds"], seed, mix["mix_seed"] + 7)
    t0, last = time.monotonic(), -1
    quiet = t0
    pending = collections.deque((t0 + due, *rest) for due, *rest in pending)
    while True:
        now = time.monotonic()
        loop.drive(pending, now + 0.25)
        n = program.captures(eng)
        if n != last:
            last, quiet = n, time.monotonic()
        now = time.monotonic()
        if (now - t0 >= mix["warmup_min_seconds"] and now - quiet >= 1.0) \
                or now - t0 >= mix["warmup_max_seconds"]:
            break
    loop.drive(collections.deque(), time.monotonic() + mix["drain_seconds"],
               done=loop.online_idle)
    return program.captures(eng)


def run(ctx) -> dict:
    mix, dev, seed = ctx.mix, ctx.device, ctx.seed
    eng, loop = build(ctx)
    ctx.mark("weights made, engine built")
    core = eng.core
    rec = program.StepRecorder(core, ctx.tracer)
    graphs = warm_up(eng, loop, mix, seed)
    ctx.mark(f"warmed up ({graphs} graphs captured)")
    loop.tracked.clear()
    loop.lag.clear()

    metrics = eng.obs.metrics
    counters = ("core/generated_tokens/offline", "engine/generated_tokens", "engine/steps_executed")
    c0 = {c: metrics.counter(c).value for c in counters}
    before = set(core.requests)  # the warm-up's requests, checked by no run
    trace_s = mix["trace_seconds"] if ctx.tracer.enabled else 0.0
    # the schedule (its prompts drawn) before the window opens
    pending = loop.schedule("online", ctx.seconds, seed, mix["mix_seed"],
                            ctx.seconds + 2 * trace_s)
    due_in_window = sum(1 for p in pending if p[0] < ctx.seconds)
    torch.cuda.synchronize() if dev.type == "cuda" else None
    rec.recording = True
    t0 = time.monotonic()
    ctx.window_start = time.perf_counter()
    pending = collections.deque((t0 + due, *rest) for due, *rest in pending)
    loop.drive(pending, t0 + ctx.seconds)
    # those due while the window's last step ran are due in the window too
    loop.submit_due(pending, t0 + ctx.seconds)
    torch.cuda.synchronize() if dev.type == "cuda" else None
    window_s = time.monotonic() - t0
    c1 = {c: metrics.counter(c).value - c0[c] for c in counters}
    window = dict(loop.tracked)
    ctx.log(f"window: {due_in_window} online requests due, {len(rec.records)} engine steps "
            f"in {window_s:.3f} s, {program.captures(eng) - graphs} graphs captured inside it")
    if ctx.tracer.enabled:
        # the profiler follows the window for two stretches of
        # ``trace_seconds`` of the same schedule (trace.Tracer), its
        # arrivals put back by the time the profiler took to stop and
        # start, so its cost is in no reading of the window
        end = t0 + ctx.seconds
        for spans in (False, True):
            ctx.tracer.start(spans)
            shift = time.monotonic() - end
            pending = collections.deque((due + shift, *rest) for due, *rest in pending)
            end += shift + trace_s
            loop.drive(pending, end)
            ctx.tracer.stop()
        rate = [sum(1 for r in rec.records if not r["traced"]) / window_s]
        for k, (_, a, b) in enumerate(ctx.tracer.stretches, 1):
            rate.append(sum(1 for r in rec.records if r["traced"] == k) / (b - a))
        ctx.log("engine steps a second: window {:.3f}, device stretch {:.3f}, "
                "spans stretch {:.3f}".format(*rate))
    rec.recording = False
    loop.drive(collections.deque(), time.monotonic() + mix["drain_seconds"], backlog=False,
               done=lambda: all(e[2] is not None for e in window.values()))
    lag = np.asarray(loop.lag)
    ctx.log(f"generator: late by p50 {np.median(lag) * 1e3:.3f} ms, max {lag.max() * 1e3:.3f} ms"
            if len(lag) else "generator: no online request was due")

    # a request still unanswered when the drain ends is timed to that end
    end = time.monotonic()
    online = [(e[0], end if e[1] is None else e[1], end if e[2] is None else e[2],
               e[3].state is RequestState.FINISHED_LENGTH) for e in window.values()]
    if online:
        ttft = sorted(first - due for due, first, _, _ in online)
        ctx.log(f"online: TTFT p50 {ttft[len(ttft) // 2] * 1e3:.3f} ms, "
                f"p95 {readers.p95(ttft) * 1e3:.3f} ms")
    out = {
        "window_s": window_s,
        "online": [(due, first, done) for due, first, done, _ in online],
        "steps": rec.records,
        "offline_tokens": c1["core/generated_tokens/offline"],
        "engine_tokens": c1["engine/generated_tokens"],
        "engine_steps": c1["engine/steps_executed"],
        "attempted": len(online),
        "failed": sum(not ok for *_, ok in online),
        "memory_peak_bytes": torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0,
        "trace": ctx.tracer.summary(),
    }
    served = [(cr.prompt, np.asarray(cr.output_tokens, np.int64))
              for rid, cr in core.requests.items()
              if rid not in before and cr.state.finished and cr.output_tokens]
    ctx.mark("window read, drained")

    del eng, core, rec, loop, window, online
    program.release()
    check.exact_fp32()
    picked = check.sample(served, seed, mix["check_tokens"])
    out["numbers"] = check.served_gaps(ctx.config["model"], seed, picked, dev,
                                       control=ctx.calibrate)
    ctx.mark("checked against the reference")
    return out
