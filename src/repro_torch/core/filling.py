"""Speculative filling: real training and real inference under the paper's
control plane (monitor -> Algorithm 1 -> barrier / pull-and-execute).
Counterpart of ``repro.core.filling``.

``SpecInFRuntime`` is host-interleaved: each training iteration runs the
real train step, then walks the iteration profile's segments on a virtual
clock.  Compute segments feed the monitor active windows; each bubble is
filled with real ``EngineCore.step()`` quanta admitted by Algorithm 1
(``SpecInFPolicy``), and every quantum's cost in microstep-equivalents
advances the clock.  The device runs the train step and the quanta one
after the other, so *timing* flows on the virtual clock, sized by the
profile, while *compute* is real.

Speculating engines (a draft pairing, or host proposers) spend grants in
*verified* tokens: the gamma controller (``spec.controller``) maps the
Algorithm-1 phase and the observed acceptance to a draft length, and the
quantum's k is sized by the expected verified tokens per round and priced
by the routed proposer.

Revocation: with a ``faults`` injector armed at ``runtime/early_resume``,
training resumes at a seeded point inside a bubble and the bubble's
``RevocationSignal`` is armed there; with ``cfg.revocation_check_steps`` > 0
every grant carries a signal and decodes in sub-dispatches of that many
microsteps, so a revoked quantum yields within one sub-dispatch.  A
``journal`` is replayed into the core before fresh submissions and then
attached.

``make_collocated_step`` is the fused alternative: one call runs the train
step and k greedy decode microsteps, the chain on a second CUDA stream so
that it can overlap the step's collectives (``pick_bucket`` sizes k from
an Algorithm-1 grant).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import SpecInFConfig
from repro_torch.core.bubble_monitor import BubbleMonitor
from repro_torch.core.profiles import IterationProfile
from repro_torch.core.scheduler import AdaptiveKernelScheduler, Status
from repro_torch.obs import Observability
from repro_torch.obs.trace import _num
from repro_torch.resilience.faults import FaultInjector
from repro_torch.serving.core import (
    Grant,
    Priority,
    RequestState,
    RevocationSignal,
    SamplingParams,
    SchedulerPolicy,
    StepOutputs,
    StepPlan,
    largest_bucket,
)
from repro_torch.serving.engine import InferenceEngine, Request
from repro_torch.serving.graphs import AddressedGraphs
from repro_torch.spec.controller import AdaptiveGammaController
from repro_torch.tree import tree_leaves


class FillingMetrics:
    """Run-level metrics of one SpecInF filling run.

    Latency / TTFT distributions and lifecycle counters are views over the
    engine's metrics registry, taken from a baseline at construction (so a
    pre-warmed engine never leaks earlier activity into a run).  Run-local
    quantities (train iterations and losses, phase counts, virtual time,
    offline microsteps) are plain attributes."""

    def __init__(self, obs: Optional[Observability] = None):
        #: engine-less runs (bubble accounting only) get a private registry
        self.obs = obs if obs is not None else Observability(tracing=False)
        m = self.obs.metrics
        self._ttft = m.histogram("core/online_ttft_s")
        self._lat = m.histogram("core/online_latency_s")
        self._ttft_base = self._ttft.count
        self._lat_base = self._lat.count
        self._served = m.counter("core/finished/online")
        self._served_base = self._served.value
        self._offline_tok = m.counter("core/generated_tokens/offline")
        self._offline_tok_base = self._offline_tok.value
        self._preempt = m.counter("core/preemptions")
        self._preempt_base = self._preempt.value
        self.train_iterations = 0
        self.train_losses: list = []
        self.offline_microsteps = 0
        self.spec_rounds = 0
        self.virtual_time_s = 0.0
        self.phase_counts: dict = {}

    # -- registry-backed views -----------------------------------------
    @property
    def online_served(self) -> int:
        return self._served.value - self._served_base

    @property
    def offline_tokens_generated(self) -> int:
        return self._offline_tok.value - self._offline_tok_base

    @property
    def preemptions(self) -> int:
        return self._preempt.value - self._preempt_base

    @property
    def online_latencies_s(self) -> list:
        """Online end-to-end latencies of this run (while the histogram
        still holds its samples)."""
        return self._lat.values()[self._lat_base:]

    @property
    def online_ttft_s(self) -> list:
        """Arrival-to-first-token of each online request of this run."""
        return self._ttft.values()[self._ttft_base:]

    def _percentile(self, hist, base: int, q: float) -> float:
        if hist.count - base <= 0:
            return float("nan")
        if hist.exact:
            return float(np.percentile(hist.values()[base:], q))
        return hist.percentile(q)

    def p95_latency_s(self) -> float:
        return self._percentile(self._lat, self._lat_base, 95)

    def ttft_percentile_s(self, q: float) -> float:
        return self._percentile(self._ttft, self._ttft_base, q)

    def p95_ttft_s(self) -> float:
        return self.ttft_percentile_s(95)


class SpecInFPolicy(SchedulerPolicy):
    """Algorithm 1 as a ``SchedulerPolicy`` (paper §3.3).

    * ONLINE admission is the pull-and-execute path: gated on the IDLE
      status and arrival time; when capacity blocks, admission preempts a
      RUNNING OFFLINE slot instead of queueing behind it.
    * OFFLINE quanta spend the Kernel-Barrier token grant, and run only
      when the grant covers one whole quantum (speculating engines spend
      grants in verified tokens, so the bar is the expected yield of one
      round at the phase's draft length).
    * Online execution, once admitted, is never token-metered: only its
      admission is gated.
    """

    def __init__(
        self,
        *,
        microstep_tokens: float = 1.0,
        gamma_ctrl: Optional[AdaptiveGammaController] = None,
        prefill_token_cost_steps: float = 0.0,
    ):
        #: Kernel-Barrier token cost of one microstep (1 token per ms)
        self.microstep_tokens = microstep_tokens
        self.gamma_ctrl = gamma_ctrl
        #: per-prefill-token step cost in microstep-equivalents: converts a
        #: bubble window into a prefill token budget (0 keeps prefill free)
        self.prefill_token_cost_steps = prefill_token_cost_steps

    def _spec(self, core) -> bool:
        return (
            core.engine.spec_enabled or core.engine.host_spec_enabled
        ) and self.gamma_ctrl is not None

    def min_offline_grant(self, core, phase) -> float:
        """Smallest grant that pays for one whole offline quantum."""
        if self._spec(core):
            return self.gamma_ctrl.expected_tokens_per_round(
                self.gamma_ctrl.gamma_for(phase)
            )
        return self.microstep_tokens

    def plan(self, core, grant: Grant) -> StepPlan:
        admit = []
        if grant.online_ok:
            admit += [
                cr for cr in core.waiting[Priority.ONLINE]
                if self.eligible(cr, grant)
            ]
        offline_grant_ok = grant.tokens >= self.min_offline_grant(core, grant.phase)
        if offline_grant_ok:
            admit += [
                cr for cr in core.waiting[Priority.OFFLINE]
                if self.eligible(cr, grant)
            ]
        plan = StepPlan(admit=admit, preempt_to_admit=True)
        online = [
            cr for cr in list(core.slot_requests.values()) + admit
            if cr.priority is Priority.ONLINE
        ]
        room = max(int(grant.max_cost_steps), 1)
        if online:
            # dedicated quantum: sized by the online work's remaining budget
            want = max(max(cr.remaining_budget for cr in online), 1)
            self._size_quantum(plan, core, grant, want)
        elif (core.slot_requests or admit) and offline_grant_ok:
            # offline quantum: the grant must cover it whole
            if self._spec(core):
                self._size_quantum(plan, core, grant, grant.tokens)
            else:
                steps = int(grant.tokens // self.microstep_tokens)
                plan.k = largest_bucket(min(steps, room))
                plan.cost_steps = float(plan.k)
        # clamp decode rounds to the grant's token budget, then spend what
        # remains (of the budget and the bubble room) on prefill chunks
        decode_tokens = self._clamp_k_to_budget(plan, core, grant)
        self.plan_prefill(core, grant, plan, decode_tokens)
        return plan

    def _size_quantum(self, plan, core, grant, want_tokens: float) -> None:
        """Pick k (and gamma) so the quantum's expected token yield stays
        within ``want_tokens`` and its cost within the bubble room."""
        if self._spec(core):
            g = self.gamma_ctrl.gamma_for(grant.phase)
            exp = self.gamma_ctrl.expected_tokens_per_round(g)
            # the routed proposer prices the round: model-free host rounds
            # spend ~1 step, draft rounds 1 + (gamma + 1) * cost ratio
            plan.proposer = core.engine.route_proposer(g)
            rc = (
                core.engine.proposer_round_cost(plan.proposer, g)
                if plan.proposer is not None
                else self.gamma_ctrl.round_cost_steps(g)
            )
            afford = max(int(want_tokens / max(exp, 1e-9)), 1)
            left = max(int(grant.max_cost_steps / rc), 1)
            plan.k = largest_bucket(min(afford, left))
            plan.gamma = g
            plan.cost_steps = plan.k * rc
        else:
            room = max(int(grant.max_cost_steps), 1)
            plan.k = largest_bucket(min(room, int(max(want_tokens, 1))))
            plan.cost_steps = float(plan.k)

    def observe(self, outputs: StepOutputs) -> None:
        if self.gamma_ctrl is not None and outputs.spec_proposed:
            self.gamma_ctrl.observe(outputs.spec_accepted, outputs.spec_proposed)


class SpecInFRuntime:
    """Collocates one training loop with an inference engine on one
    device, running the Algorithm-1 control plane over real compute."""

    def __init__(
        self,
        *,
        train_step: Callable[[Any, Any], tuple[Any, Any]],  # (state, batch) -> (state, metrics)
        train_state: Any,
        batch_iter,
        profile: IterationProfile,
        engine: Optional[InferenceEngine] = None,
        online_requests: Optional[list[Request]] = None,
        cfg: SpecInFConfig = SpecInFConfig(),
        decode_microstep_s: float = 0.005,
        gamma_controller: Optional[AdaptiveGammaController] = None,
        faults: Optional[FaultInjector] = None,
        journal=None,
    ):
        self.train_step = train_step
        self.state = train_state
        self.batch_iter = batch_iter
        self.profile = profile
        self.engine = engine
        self.cfg = cfg
        # one seeded injector for every fault point: the runtime consults
        # ``runtime/early_resume`` per bubble, the engine and its pool the rest
        self.faults = faults
        if faults is not None and engine is not None:
            faults.metrics = engine.obs.metrics
            if engine.fault_injector is None:
                engine.fault_injector = faults
                if engine.pool is not None:
                    engine.pool.fault_injector = faults
        self.monitor = BubbleMonitor(cfg)
        self.scheduler = AdaptiveKernelScheduler(cfg, num_instances=1)
        # the run's metrics are views over the engine's registry
        self.metrics = FillingMetrics(
            obs=engine.obs if engine is not None else None
        )
        self.decode_microstep_s = decode_microstep_s
        # speculating engines spend grants in verified tokens: the gamma
        # controller sizes each round from the phase and the acceptance
        self.gamma_ctrl = gamma_controller
        if (
            self.gamma_ctrl is None
            and engine is not None
            and (engine.spec_enabled or engine.host_spec_enabled)
        ):
            self.gamma_ctrl = AdaptiveGammaController.from_spec(engine.spec_cfg)
        self._window_s = cfg.window_ms / 1e3
        # every request timestamp comes from the runtime's virtual clock
        self._vnow = 0.0
        self.core = None
        self.recovery = None
        if engine is not None:
            engine.clock = lambda: self._vnow
            # Algorithm 1 as the engine core's scheduler policy
            self.core = engine.core
            self.core.policy = SpecInFPolicy(
                microstep_tokens=decode_microstep_s / 1e-3,
                gamma_ctrl=self.gamma_ctrl,
                prefill_token_cost_steps=cfg.prefill_token_cost_steps,
            )
            # requests queued or running before this point were stamped on
            # the engine's old clock: restamp them to the virtual epoch so
            # they are pullable from the first bubble (and re-admittable
            # after a preemption)
            tr = engine.obs.tracer
            for q in self.core.waiting.values():
                for cr in q:
                    cr.arrival_time = 0.0
                    tr.restamp_arrival(cr.request_id, 0.0)
            for cr in self.core.slot_requests.values():
                cr.arrival_time = 0.0
                tr.restamp_arrival(cr.request_id, 0.0)
            # a journal replays the previous incarnation's surviving requests
            # (after the restamp above, so its shifted stamps stay) before
            # fresh submissions, then logs this incarnation's
            if journal is not None:
                self.recovery = journal.recover_into(self.core)
                journal.attach(self.core)
            for r in sorted(online_requests or [], key=lambda r: r.arrival_time):
                self.core.submit(
                    r.prompt,
                    SamplingParams(max_new_tokens=r.max_new_tokens),
                    priority=Priority.ONLINE if r.online else Priority.OFFLINE,
                    arrival_time=r.arrival_time,
                )
        self.journal = journal

    # ------------------------------------------------------------------
    def _observe_windows(self, n: int, activity: int = 0):
        """Feed monitor + Algorithm 1 for ``n`` windows; returns the last
        decision."""
        d = None
        for _ in range(n):
            zc = self.monitor.observe(activity)
            d = self.scheduler.update(zc)
            ph = d.phase.value
            self.metrics.phase_counts[ph] = self.metrics.phase_counts.get(ph, 0) + 1
        return d

    def _advance_windows(self, span_s: float, activity: int) -> None:
        """Feed the monitor / scheduler every window inside a span."""
        self._observe_windows(max(1, int(round(span_s / self._window_s))), activity)

    def _fill_bubble(self, bubble_s: float) -> None:
        """Fill a virtual bubble of ``bubble_s`` with real engine compute,
        one ``EngineCore.step()`` quantum at a time.  Each pass observes one
        monitor window, turns Algorithm 1's decision into a ``Grant``
        (token grant, IDLE gate for online admission, phase for the gamma
        controller, the bubble's room as ``max_cost_steps``) and lets
        ``SpecInFPolicy`` shape the quantum;
        its cost advances the virtual clock and the window count.

        When the bubble's ``RevocationSignal`` trips (early resume) the fill
        ends at once, the overrun past the resume instant is recorded, and
        the rest of the span is fed to the monitor as training activity."""
        if self.engine is None:
            self.metrics.virtual_time_s += bubble_s
            self._advance_windows(bubble_s, activity=0)
            return
        now = self.metrics.virtual_time_s
        tracer = self.engine.obs.tracer
        tracer.span("bubble", "train", now, now + bubble_s, span_s=bubble_s)
        sig, resume_at = self._arm_revocation(now, bubble_s)
        spent = 0.0
        step_cost = self.decode_microstep_s
        revoked = False
        while spent < bubble_s:
            base = now + spent
            if sig is not None and sig.check(base):
                revoked = True  # revoked on a quantum boundary: run nothing
                break
            d = self._observe_windows(1)
            self._vnow = base  # admission / TTFT stamps land at quantum start
            tracer.window_state = {
                **self.monitor.state(),
                "status": d.status.value,
                "phase": d.phase.value,
                "tokens": _num(d.tokens),
            }
            grant = Grant(
                tokens=d.tokens,
                online_ok=d.status is Status.IDLE,
                phase=d.phase,
                now=base,
                max_cost_steps=max((bubble_s - spent) / step_cost, 1.0),
                token_budget=self.cfg.step_token_budget or math.inf,
                # retirement stamps land at quantum END: the core advances
                # the clock once the plan's cost is known
                advance_clock=lambda steps, _b=base: setattr(
                    self, "_vnow", _b + steps * step_cost
                ),
                revocation=sig,
                revoke_check_steps=max(self.cfg.revocation_check_steps, 1),
            )
            out = self.core.step(grant)
            if out.cost_steps <= 0:
                if out.revoked:
                    revoked = True
                    break
                spent += self._window_s
                continue
            dt = out.cost_steps * step_cost
            spent += dt
            self._vnow = base + dt
            # the observe above covered the quantum's first window
            quanta = max(out.k, int(round(out.cost_steps)))
            self._observe_windows(quanta - 1)
            self._record_step(out)
            if out.revoked or (sig is not None and sig.check(self._vnow)):
                # cut mid-plan, or tripped as the quantum completed
                revoked = True
                break
        if not revoked and sig is not None and sig.check(now + bubble_s):
            # armed inside the span with no quantum running to cut
            revoked = True
        if revoked:
            m = self.engine.obs.metrics
            m.counter("fault/early_resume").inc()
            m.histogram("fault/revocation_overrun_s").record(
                max(0.0, self._vnow - resume_at)
            )
            self.monitor.notice_activity()
            remaining = bubble_s - spent
            if remaining > 0:
                # training owns the rest of the span
                self._advance_windows(remaining, activity=1)
        self.metrics.virtual_time_s += bubble_s
        self._vnow = self.metrics.virtual_time_s

    def _arm_revocation(self, now: float, bubble_s: float):
        """This bubble's ``(signal, resume instant)``.  When the injector
        fires ``runtime/early_resume``, training resumes at a seeded 25-75 %
        of the bubble and the signal is armed there; otherwise an unarmed
        signal rides every grant while ``cfg.revocation_check_steps`` > 0
        (the sub-dispatch path runs, nothing fires), and none by default."""
        faults = self.faults
        if faults is not None and faults.should_fire("runtime/early_resume"):
            frac = 0.25 + 0.5 * faults.uniform("runtime/early_resume")
            resume_at = now + frac * bubble_s
            sig = RevocationSignal()
            sig.arm(resume_at, reason="early_resume")
            return sig, resume_at
        if self.cfg.revocation_check_steps > 0:
            return RevocationSignal(), math.inf
        return None, math.inf

    def _record_step(self, out: StepOutputs) -> None:
        """Count a quantum's spec rounds, and its microsteps as offline work
        unless an online request was active in it (engine-level quantities
        are recorded by the core into the shared registry)."""
        online_active = any(
            ro.priority is Priority.ONLINE
            and (ro.new_tokens or ro.state is RequestState.RUNNING)
            for ro in out.outputs
        )
        if out.gamma is not None:
            self.metrics.spec_rounds += out.k
        if not online_active:
            self.metrics.offline_microsteps += out.k

    # ------------------------------------------------------------------
    def run(self, num_iterations: int) -> FillingMetrics:
        for _ in range(num_iterations):
            batch = next(self.batch_iter)
            self.state, step_metrics = self.train_step(self.state, batch)
            loss = step_metrics.get("loss")
            if loss is not None:
                self.metrics.train_losses.append(float(loss))
            for kind, dur in self.profile.segments:
                if kind == "compute":
                    t0 = self.metrics.virtual_time_s
                    self.metrics.virtual_time_s += dur
                    if self.engine is not None:
                        self.engine.obs.tracer.span(
                            "train_compute", "train", t0, t0 + dur
                        )
                    self._advance_windows(dur, activity=1)
                else:
                    self._fill_bubble(dur)
            self.metrics.train_iterations += 1
        return self.metrics


# ---------------------------------------------------------------------------
# Beyond-paper: fused collocated step (bucketed k)
# ---------------------------------------------------------------------------


def make_collocated_step(
    train_step_fn: Callable,
    decode_step_fn: Callable,
    *,
    k_buckets: tuple[int, ...] = (0, 1, 2, 4, 8),
    decode_loop_fn: Optional[Callable] = None,
) -> dict:
    """``{k: fn}`` where ``fn(train_state, batch, infer_params, tokens,
    cache) -> (train_state, metrics, tokens, cache)`` runs the train step
    and a chain of k greedy decode microsteps that has no data dependence
    on it (the reference's fused program).

    On CUDA the chain is one CUDA graph per k and cache shapes
    (``serving.graphs.AddressedGraphs``: the weights read where they live,
    the tokens and the cache index copied in, the cache the graph's own),
    replayed on a second stream ordered after the work queued before the
    call and joined by the current stream before the call returns, so the
    device can overlap it with the train step's kernels and collectives.
    The train step runs on the current stream: eagerly, or the graphed
    step of ``TrainStepArtifacts.jitted()``, whose own capture comes at its
    first call.  A chain graph is captured before the train step is
    launched, so no capture overlaps either program's kernels (the cache
    is put back after the capture's warm-up); k = 0 captures nothing.  As
    the reference donates the cache, the returned cache is the graph's
    buffers, which the caller passes back; a fresh cache of the same
    shapes is copied into them (no new capture), and the graph is dropped
    when the weights it read die.  On the CPU the two run in sequence,
    eagerly.  The train step is untouched by the chain.  Pass
    ``decode_loop_fn(params, tokens, cache, k) -> (tokens, cache)`` to
    supply a custom loop; by default the chain feeds each step's argmax to
    the next ``decode_step_fn(params, tokens, cache) -> (logits, cache)``.
    Each ``fn``'s ``graphs`` attribute holds its chain's graphs (None for
    k = 0)."""
    if decode_loop_fn is None:

        def decode_loop_fn(params, tokens, cache, k):
            for _ in range(k):
                logits, cache = decode_step_fn(params, tokens, cache)
                tokens = torch.argmax(logits, dim=-1).to(torch.int32)
            return tokens, cache

    streams: dict = {}  # device -> the chain's stream, made at the first call
    # the capture's warm-up runs the chain once: every cache leaf it writes
    # (a recurrent state it steps) is put back after
    graphs = {k: AddressedGraphs(
        lambda held, inp, k=k: decode_loop_fn(held[0], inp["tokens"],
                                              dict(held[1], index=inp["index"]), k),
        kept=lambda held: tree_leaves(held[1]), cache=True) for k in k_buckets if k > 0}

    def fused(k):
        def fn(train_state, batch, infer_params, tokens, cache):
            if tokens.device.type != "cuda":
                new_state, metrics = train_step_fn(train_state, batch)
                t, c = decode_loop_fn(infer_params, tokens, cache, k)
                return new_state, metrics, t, c
            if k == 0:
                return (*train_step_fn(train_state, batch), tokens, cache)
            held = (infer_params, {n: v for n, v in cache.items() if n != "index"})
            inputs = {"tokens": tokens, "index": cache["index"]}
            graphs[k].capture(held, inputs)
            main = torch.cuda.current_stream(tokens.device)
            side = streams.setdefault(tokens.device, torch.cuda.Stream(tokens.device))
            side.wait_stream(main)
            new_state, metrics = train_step_fn(train_state, batch)
            with torch.cuda.stream(side):
                t, c = graphs[k](held, inputs)
            main.wait_stream(side)
            # made on the chain's stream, read on the caller's from now on
            for x in (t, *tree_leaves(c)):
                x.record_stream(main)
            return new_state, metrics, t, c

        fn.graphs = graphs.get(k)
        return fn

    return {k: fused(k) for k in k_buckets}


def pick_bucket(tokens: float, microstep_tokens: float, buckets=(0, 1, 2, 4, 8)) -> int:
    """Largest bucket affordable under the current Algorithm-1 token grant.

    Thin wrapper over ``serving.core.largest_bucket`` (one bucket-floor
    implementation); a leading 0 bucket means "grant affords nothing"."""
    return largest_bucket(int(tokens // max(microstep_tokens, 1e-9)), buckets)
