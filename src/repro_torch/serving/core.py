r"""Request-lifecycle engine core (counterpart of ``repro.serving.core``).

``EngineCore.step()`` is ONE scheduling quantum: consult a
``SchedulerPolicy`` (admit / preempt / pick the k bucket, and on a
speculating engine the draft length gamma and the proposer), stream the
planned prefill chunk waves, drive the engine's fused decode or speculative
loop, and return ``StepOutputs`` with per-request token deltas, TTFT stamps
and finish reasons.  An ONLINE arrival may preempt a RUNNING OFFLINE slot.

Lifecycle::

    WAITING --admit--> PREFILLING --> RUNNING --budget--> FINISHED_LENGTH
       ^                    |            |  \--stop-----> FINISHED_STOPPED
       |                    |            |   \--abort()-> FINISHED_ABORTED
       +------<--preempt----+------------+
            (PREEMPTED)        WAITING past its deadline --> FINISHED_EXPIRED

Preemption evicts the slot's pages (the prompt's full pages stay
radix-cached) and re-queues the request at the FRONT of its class; resume
re-prefills ``prompt + generated`` and continues greedy decode, so the
resumed stream is byte-identical to an uninterrupted one.

Fault containment, revocable grants, the overload ladder and the request
journal of the reference core are not in this slice.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
import math
from typing import Any, Callable, Iterator, Optional, Union

import numpy as np

from repro_torch.obs.trace import _num
from repro_torch.serving.engine import DECODE_K_BUCKETS, InferenceEngine, Request
from repro_torch.spec.controller import AdaptiveGammaController

__all__ = [
    "EngineCore",
    "EngineRequest",
    "Grant",
    "Priority",
    "PriorityPolicy",
    "RequestOutput",
    "RequestState",
    "SamplingParams",
    "SchedulerPolicy",
    "StepOutputs",
    "StepPlan",
    "largest_bucket",
]


class Priority(enum.Enum):
    """ONLINE is latency-sensitive (may preempt); OFFLINE soaks up spare
    capacity."""

    ONLINE = "online"
    OFFLINE = "offline"


class RequestState(enum.Enum):
    WAITING = "waiting"
    #: admitted, prompt still streaming in chunk waves
    PREFILLING = "prefilling"
    RUNNING = "running"
    PREEMPTED = "preempted"
    FINISHED_STOPPED = "finished_stopped"
    FINISHED_LENGTH = "finished_length"
    FINISHED_ABORTED = "finished_aborted"
    #: ``SamplingParams.deadline_s`` elapsed while WAITING
    FINISHED_EXPIRED = "finished_expired"

    @property
    def finished(self) -> bool:
        return self.name.startswith("FINISHED")


#: finish_reason strings per terminal state.
FINISH_REASONS = {
    RequestState.FINISHED_STOPPED: "stop",
    RequestState.FINISHED_LENGTH: "length",
    RequestState.FINISHED_ABORTED: "abort",
    RequestState.FINISHED_EXPIRED: "expired",
}


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request generation parameters.  Decoding is greedy; stop tokens
    are checked host-side after each fused loop (surplus tokens past a stop
    are trimmed, never delivered)."""

    max_new_tokens: int = 16
    stop_token_ids: tuple[int, ...] = ()
    #: queue TTL in engine-clock seconds from ``arrival_time``; a WAITING
    #: request past it finishes FINISHED_EXPIRED.  None = no deadline.
    deadline_s: Optional[float] = None


@dataclasses.dataclass(eq=False)
class EngineRequest:
    """One request's lifecycle record.  ``output_tokens`` is the canonical
    stream and survives preemption.  ``eq=False``: requests compare by
    identity (queue membership must not compare ndarray prompts)."""

    prompt: np.ndarray  # [prompt_len] int32
    sampling: SamplingParams
    priority: Priority
    request_id: int
    arrival_time: float
    state: RequestState = RequestState.WAITING
    output_tokens: list = dataclasses.field(default_factory=list)
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    finish_reason: Optional[str] = None
    preemptions: int = 0
    # -- core internals --
    _internal: Optional[Request] = None  # engine-side record while in a slot
    _consumed: int = 0  # tokens of _internal.generated already absorbed
    _ttft_reported: bool = False

    @property
    def remaining_budget(self) -> int:
        return self.sampling.max_new_tokens - len(self.output_tokens)


@dataclasses.dataclass
class Grant:
    """One quantum's scheduling inputs.  ``tokens`` meters OFFLINE admission;
    ``online_ok`` gates ONLINE admission; ``now`` gates arrivals (None reads
    the engine clock); ``max_cost_steps`` caps the quantum in
    microstep-equivalents; ``token_budget`` caps the step's mixed batch
    (prefill chunk tokens plus decode tokens); ``advance_clock`` is called
    with the step's cost right before the device work runs."""

    tokens: float = math.inf
    online_ok: bool = True
    phase: Any = None
    now: Optional[float] = None
    max_cost_steps: float = math.inf
    token_budget: float = math.inf
    advance_clock: Optional[Callable[[float], None]] = None


@dataclasses.dataclass
class StepPlan:
    """A SchedulerPolicy's decision for one quantum."""

    admit: list = dataclasses.field(default_factory=list)  # EngineRequests
    preempt: list = dataclasses.field(default_factory=list)  # slot indices
    preempt_to_admit: bool = False  # may admission evict OFFLINE victims?
    k: int = 0
    gamma: Optional[int] = None  # None -> plain decode loop
    #: routed candidate source of a speculative quantum: None keeps the
    #: draft pairing's fused loop; a name drives ``_drive_proposed_loop``
    proposer: Optional[str] = None
    cost_steps: float = 0.0  # decode cost in microstep-equivalents
    #: prefill-token budget of the quantum (inf = drain all pending)
    prefill_tokens: float = math.inf
    #: microstep-equivalents charged per prefill token
    prefill_token_cost: float = 0.0


@dataclasses.dataclass
class RequestOutput:
    """Per-request delta for one step."""

    request_id: int
    priority: Priority
    new_tokens: list
    state: RequestState
    finish_reason: Optional[str]
    #: arrival-to-first-token seconds, set only on the step that produced
    #: the request's first output token
    ttft_s: Optional[float]


@dataclasses.dataclass
class StepOutputs:
    outputs: list = dataclasses.field(default_factory=list)
    finished: list = dataclasses.field(default_factory=list)  # EngineRequests
    admitted: list = dataclasses.field(default_factory=list)  # request ids
    preempted: list = dataclasses.field(default_factory=list)  # request ids
    k: int = 0
    gamma: Optional[int] = None
    #: the candidate source of a speculative quantum (None for plain decode
    #: or the un-routed draft loop)
    proposer: Optional[str] = None
    cost_steps: float = 0.0
    #: prefill chunk tokens this step computed
    prefill_tokens: int = 0
    #: draft tokens accepted / proposed by this step's speculative rounds
    spec_accepted: int = 0
    spec_proposed: int = 0


def largest_bucket(n: int, buckets: tuple = DECODE_K_BUCKETS) -> int:
    """Largest bucket <= n, floored at the smallest bucket."""
    best = buckets[0]
    for b in buckets:
        if b <= n:
            best = b
    return best


# ---------------------------------------------------------------------------
# Scheduler policies
# ---------------------------------------------------------------------------


class SchedulerPolicy:
    """Scheduling brain ``EngineCore.step()`` consults: admission order,
    preemption appetite and the quantum's k from a ``Grant``.  ``plan``
    must not mutate core state."""

    #: microstep-equivalents charged per prefill token
    prefill_token_cost_steps: float = 0.0

    def plan(self, core: "EngineCore", grant: Grant) -> StepPlan:
        raise NotImplementedError

    @staticmethod
    def eligible(cr: EngineRequest, grant: Grant) -> bool:
        """The request has arrived by the grant's instant."""
        return cr.arrival_time <= grant.now

    def _clamp_k_to_budget(
        self, plan: StepPlan, core: "EngineCore", grant: Grant
    ) -> float:
        """Clamp ``plan.k`` so the quantum's worst-case decode tokens (one
        per slot, or gamma + 1 per slot for spec rounds; PREFILLING slots
        included: any may finish its prompt this step) fit the grant's
        ``token_budget``; returns the decode-token allowance consumed."""
        eng = core.engine
        slots = min(max(eng.num_active + len(plan.admit), 1), eng.max_slots)
        per_k = slots * (1 if plan.gamma is None else plan.gamma + 1)
        if math.isfinite(grant.token_budget) and plan.k > 0:
            max_k = int(grant.token_budget // per_k)
            if max_k < min(DECODE_K_BUCKETS):
                plan.k, plan.cost_steps = 0, 0.0
            elif plan.k > max_k:
                per_cost = plan.cost_steps / plan.k
                plan.k = largest_bucket(max_k)
                plan.cost_steps = plan.k * per_cost
        return plan.k * per_k

    def plan_prefill(
        self,
        core: "EngineCore",
        grant: Grant,
        plan: StepPlan,
        decode_tokens: float = 0.0,
    ) -> None:
        """Budget the quantum's prefill stream: the grant's ``token_budget``
        minus the planned decode tokens and one first-token slack per slot
        that may complete its prompt, and at most what the remaining step
        room pays for at ``prefill_token_cost_steps`` per token."""
        eng = core.engine
        slack = eng.num_prefilling + len(plan.admit)
        budget = grant.token_budget - decode_tokens - slack
        ptc = self.prefill_token_cost_steps
        plan.prefill_token_cost = ptc
        if ptc > 0 and math.isfinite(grant.max_cost_steps):
            room = grant.max_cost_steps - plan.cost_steps
            budget = min(budget, room / ptc)
        plan.prefill_tokens = max(budget, 0.0)

    def pick_victim(
        self, core: "EngineCore", for_request: EngineRequest
    ) -> Optional[int]:
        """Slot to evict so ``for_request`` can be admitted: only an ONLINE
        admission preempts, and the victim is the OFFLINE slot with the
        shortest total sequence (the cheapest resume)."""
        if for_request.priority is not Priority.ONLINE:
            return None
        best = None
        for slot, cr in core.slot_requests.items():
            if cr.priority is not Priority.OFFLINE:
                continue
            cost = len(cr.prompt) + len(cr.output_tokens)
            if best is None or cost < best[0]:
                best = (cost, slot)
        return None if best is None else best[1]

    def observe(self, outputs: StepOutputs) -> None:
        """Post-step feedback (the gamma controller's acceptance EWMA)."""


class PriorityPolicy(SchedulerPolicy):
    """Priority-aware FCFS with preemption, the dedicated-serving default:
    every arrived ONLINE request first (evicting OFFLINE slots when capacity
    blocks), then arrived OFFLINE requests while the grant allows.  A small
    k while requests wait, the largest useful bucket otherwise; on a
    speculating engine k counts rounds of the controller's gamma, sized by
    their expected verified tokens and priced by the routed proposer."""

    def __init__(self):
        #: gamma controller of a speculating engine, built from its
        #: ``spec_cfg`` at the first plan
        self.gamma_ctrl: Optional[AdaptiveGammaController] = None

    def _gamma_ctrl_for(self, engine: InferenceEngine):
        if self.gamma_ctrl is None and (
            engine.spec_enabled or engine.host_spec_enabled
        ):
            self.gamma_ctrl = AdaptiveGammaController.from_spec(engine.spec_cfg)
        return self.gamma_ctrl

    def plan(self, core: "EngineCore", grant: Grant) -> StepPlan:
        admit = []
        if grant.online_ok:
            admit += [
                cr for cr in core.waiting[Priority.ONLINE]
                if self.eligible(cr, grant)
            ]
        if grant.tokens > 0:
            admit += [
                cr for cr in core.waiting[Priority.OFFLINE]
                if self.eligible(cr, grant)
            ]
        plan = StepPlan(admit=admit, preempt_to_admit=True)
        want = 0
        for cr in list(core.slot_requests.values()) + admit:
            want = max(want, cr.remaining_budget)
        if want <= 0:
            self.plan_prefill(core, grant, plan)
            return plan
        leftover = core.num_waiting > len(admit)
        steps = 1 if leftover else min(want, grant.max_cost_steps)
        eng = core.engine
        ctrl = self._gamma_ctrl_for(eng)
        if (eng.spec_enabled or eng.host_spec_enabled) and ctrl is not None:
            g = ctrl.gamma_for(grant.phase if grant.phase is not None else "stable")
            # the routed proposer prices the round: a model-free host round
            # spends ~1 step, a draft-model round 1 + (gamma + 1) * ratio
            plan.proposer = eng.route_proposer(g)
            round_cost = (
                eng.proposer_round_cost(plan.proposer, g)
                if plan.proposer is not None else ctrl.round_cost_steps(g)
            )
            rounds = max(int(steps / ctrl.expected_tokens_per_round(g)), 1)
            plan.k = largest_bucket(rounds)
            plan.gamma = g
            plan.cost_steps = plan.k * round_cost
        else:
            plan.k = largest_bucket(int(steps))
            plan.cost_steps = float(plan.k)
        decode_tokens = self._clamp_k_to_budget(plan, core, grant)
        self.plan_prefill(core, grant, plan, decode_tokens)
        return plan

    def observe(self, outputs: StepOutputs) -> None:
        if self.gamma_ctrl is not None and outputs.spec_proposed:
            self.gamma_ctrl.observe(outputs.spec_accepted, outputs.spec_proposed)


# ---------------------------------------------------------------------------
# EngineCore
# ---------------------------------------------------------------------------


class EngineCore:
    """Iteration-level request-lifecycle core over an ``InferenceEngine``:
    the WAITING queues (one FIFO per class; preempted requests resume from
    the front), the slot -> request map and the canonical output streams.
    Device compute runs through the engine's drive loops."""

    def __init__(
        self,
        engine: InferenceEngine,
        policy: Optional[SchedulerPolicy] = None,
    ):
        self.engine = engine
        # retirements inside the drive loops notify ``engine._core``, so an
        # engine has exactly one core; rebinding with unfinished work would
        # orphan it
        if engine._core is not None and engine._core.has_unfinished:
            raise RuntimeError(
                "engine already has a lifecycle core with unfinished "
                "requests; drain it before attaching a new EngineCore"
            )
        engine._core = self
        self.obs = engine.obs
        self.policy = policy or PriorityPolicy()
        self.waiting: dict = {
            Priority.ONLINE: collections.deque(),
            Priority.OFFLINE: collections.deque(),
        }
        self.requests: dict = {}  # request_id -> EngineRequest
        self.slot_requests: dict = {}  # slot -> EngineRequest (in a slot)
        self._finished_buffer: list = []

    # ------------------------------------------------------------------
    def submit(
        self,
        prompt,
        sampling: Optional[SamplingParams] = None,
        *,
        priority: Priority = Priority.OFFLINE,
        arrival_time: Optional[float] = None,
    ) -> EngineRequest:
        """Queue a request (WAITING).  Raises ``ValueError`` when it could
        NEVER be admitted on this engine."""
        sampling = sampling or SamplingParams()
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        probe = Request(prompt=prompt, max_new_tokens=sampling.max_new_tokens)
        if not self.engine.request_fits(probe):
            raise ValueError(
                f"request can never be admitted on this engine "
                f"(prompt {len(prompt)} tokens, "
                f"max_new={sampling.max_new_tokens}, "
                f"max_seq={self.engine.max_seq})"
            )
        if arrival_time is None:
            arrival_time = self.engine.clock()
        cr = EngineRequest(
            prompt=prompt, sampling=sampling, priority=priority,
            request_id=probe.request_id, arrival_time=arrival_time,
        )
        self.waiting[priority].append(cr)
        self.requests[cr.request_id] = cr
        self.obs.tracer.transition(
            cr.request_id, None, "waiting", arrival_time, priority=priority.value,
        )
        return cr

    def slot_of(self, req: EngineRequest) -> Optional[int]:
        for slot, cr in self.slot_requests.items():
            if cr is req:
                return slot
        return None

    @property
    def num_waiting(self) -> int:
        return sum(len(q) for q in self.waiting.values())

    @property
    def has_unfinished(self) -> bool:
        return bool(self.num_waiting or self.slot_requests)

    @property
    def preemption_count(self) -> int:
        return self.obs.metrics.counter("core/preemptions").value

    # ------------------------------------------------------------------
    def step(self, grant: Optional[Grant] = None) -> StepOutputs:
        """Run ONE scheduling quantum: plan -> preempt -> admit -> prefill
        chunk waves -> fused decode loop -> collect deltas and finishes.

        Admissions only reserve their slot; the plan's ``prefill_tokens``
        budget streams prompt chunks, and a slot whose prompt completes
        mid-step decodes in the same quantum.  The mixed batch is priced
        before any device work runs."""
        g = grant if grant is not None else Grant()
        if g.now is None:
            g = dataclasses.replace(g, now=self.engine.clock())
        eng = self.engine
        self._finished_buffer = []
        active = list(self.slot_requests.values())
        base = {cr.request_id: len(cr.output_tokens) for cr in active}
        touched = {cr.request_id: cr for cr in active}
        m0 = eng.prefill_metered_tokens
        self._expire_deadlines(g.now)
        if g.token_budget <= 0:
            # degenerate grant: an explicit no-op quantum, counted
            self.obs.metrics.counter("core/starved_quanta").inc()
            plan = StepPlan(prefill_tokens=0.0)
        else:
            plan = self.policy.plan(self, g)
        out = StepOutputs()
        for slot in list(plan.preempt):
            cr = self.preempt(slot)
            if cr is not None:
                out.preempted.append(cr.request_id)
        for cr in plan.admit:
            base.setdefault(cr.request_id, len(cr.output_tokens))
            touched.setdefault(cr.request_id, cr)
            if self._try_admit(
                cr,
                allow_preempt=plan.preempt_to_admit,
                on_preempt=lambda victim: (
                    out.preempted.append(victim.request_id),
                    touched.setdefault(victim.request_id, victim),
                ),
            ):
                out.admitted.append(cr.request_id)
        pf_take, completing = 0, []
        if plan.prefill_tokens > 0:
            # deterministic preview: price the chunk waves before driving
            _, pf_take, completing = eng._plan_prefill_waves(plan.prefill_tokens)
        still_prefilling = {
            i for i in range(eng.max_slots) if eng.slot_prefilling(i)
        } - set(completing)
        runnable = sum(
            1 for i, r in enumerate(eng.slots)
            if r is not None and i not in still_prefilling
        )
        k = plan.k if runnable > 0 else 0
        if k == 0 and plan.k > 0:
            # the planned decode can't run (every slot still mid-prefill):
            # release its token reserve to the chunk stream.  plan.admit is
            # cleared first: those requests are admitted already (counted
            # in num_prefilling), so their slack must not count twice
            plan.k, plan.cost_steps = 0, 0.0
            plan.admit = []
            self.policy.plan_prefill(self, g, plan, 0.0)
            if plan.prefill_tokens > 0:
                _, pf_take, completing = eng._plan_prefill_waves(
                    plan.prefill_tokens
                )
        a0, p0 = eng.spec_accepted, eng.spec_drafted
        # prefill runs BEFORE the clock advances: a completing prompt's first
        # token stamps at quantum start (retirements stamp at quantum end)
        if pf_take > 0:
            eng._drive_prefill_chunks(plan.prefill_tokens)
        out.prefill_tokens = eng.prefill_metered_tokens - m0
        pf_cost = out.prefill_tokens * plan.prefill_token_cost
        ran_slots: dict = {}
        if k > 0:
            # the slots the loop decodes (retirements mutate the map)
            ran_slots = {
                slot: cr.request_id
                for slot, cr in self.slot_requests.items()
                if not eng.slot_prefilling(slot)
            }
        cost = (plan.cost_steps if k > 0 else 0.0) + pf_cost
        if (k > 0 or out.prefill_tokens > 0) and g.advance_clock is not None:
            g.advance_clock(cost)
        if k > 0:
            out.k = k
            if plan.gamma is not None and plan.proposer is not None:
                out.gamma, out.proposer = plan.gamma, plan.proposer
                eng._drive_proposed_loop(k, plan.gamma, plan.proposer)
            elif plan.gamma is not None and eng.spec_enabled:
                out.gamma = plan.gamma
                eng._drive_spec_loop(k, plan.gamma)
            else:
                eng._drive_decode_loop(k)
        if out.k > 0 or out.prefill_tokens:
            out.cost_steps = cost
        out.spec_accepted = eng.spec_accepted - a0
        out.spec_proposed = eng.spec_drafted - p0
        for slot, cr in list(self.slot_requests.items()):
            if (cr.state is RequestState.PREFILLING
                    and not eng.slot_prefilling(slot)):
                # the final chunk landed in this step's waves, before the
                # clock advance: the flip stamps at quantum start
                cr.state = RequestState.RUNNING
                self.obs.tracer.transition(
                    cr.request_id, "prefilling", "running", g.now,
                    priority=cr.priority.value,
                )
            self._absorb_running(slot, cr)
        m = self.obs.metrics
        out.finished = list(self._finished_buffer)
        for cr in out.finished:
            touched.setdefault(cr.request_id, cr)
            # queue-side finishes (expiry) produced no tokens this step
            base.setdefault(cr.request_id, len(cr.output_tokens))
            pri = cr.priority.value
            m.counter("core/finished/" + pri).inc()
            if cr.finish_reason != "expired":
                m.histogram(f"core/{pri}_latency_s").record(
                    cr.finish_time - cr.arrival_time
                )
        for rid, cr in touched.items():
            new = cr.output_tokens[base.get(rid, 0):]
            ttft = None
            if cr.first_token_time is not None and not cr._ttft_reported:
                cr._ttft_reported = True
                ttft = cr.first_token_time - cr.arrival_time
                self.obs.tracer.instant(
                    "first_token", cr.first_token_time, request_id=rid,
                    priority=cr.priority.value,
                )
                if cr.priority is Priority.ONLINE:
                    m.histogram("core/online_ttft_s").record(ttft)
            if new:
                m.counter("core/generated_tokens/" + cr.priority.value).inc(len(new))
            out.outputs.append(RequestOutput(
                request_id=rid, priority=cr.priority, new_tokens=list(new),
                state=cr.state, finish_reason=cr.finish_reason, ttft_s=ttft,
            ))
        self._record_quantum(g, plan, out, ran_slots)
        self.policy.observe(out)
        return out

    # ------------------------------------------------------------------
    def stream(
        self, req: EngineRequest, grant: Optional[Grant] = None
    ) -> Iterator[int]:
        """Yield ``req``'s tokens as they are produced, driving ``step()``
        whenever the stream runs dry, until the request finishes."""
        sent = 0
        stalls = 0
        while True:
            while sent < len(req.output_tokens):
                yield req.output_tokens[sent]
                sent += 1
            if req.state.finished:
                return
            out = self.step(grant)
            if (out.k == 0 and not out.admitted and not out.preempted
                    and not out.prefill_tokens):
                stalls += 1
                if stalls > 2:
                    raise RuntimeError(
                        f"stream stalled: request {req.request_id} is "
                        f"{req.state.value} and the policy scheduled no work"
                    )
            else:
                stalls = 0

    def abort(self, req: EngineRequest) -> None:
        """Terminal ABORT from any unfinished state; a request in a slot is
        evicted at once (its pages return to the pool)."""
        if req.state.finished:
            return
        if req.state in (RequestState.RUNNING, RequestState.PREFILLING):
            slot = self.slot_of(req)
            self._collect(req)
            del self.slot_requests[slot]
            self.engine.evict_slot(slot)
            req._internal = None
        else:
            try:
                self.waiting[req.priority].remove(req)
            except ValueError:
                pass
        self._finish(req, RequestState.FINISHED_ABORTED, self.engine.clock())

    def preempt(self, target: Union[int, EngineRequest]) -> Optional[EngineRequest]:
        """Evict a slot and re-queue its request (PREEMPTED) at the front of
        its class.  Returns the preempted request (None for an empty slot)."""
        slot = target if isinstance(target, int) else self.slot_of(target)
        cr = self.slot_requests.pop(slot, None) if slot is not None else None
        if cr is None:
            return None
        frm = cr.state.value
        new = self._collect(cr)
        self.engine.evict_slot(slot)
        cr._internal = None
        if self._apply_stop(cr, new):
            # the salvaged tail already carried a stop token
            self._finish(cr, RequestState.FINISHED_STOPPED, self.engine.clock())
            return cr
        cr.state = RequestState.PREEMPTED
        cr.preemptions += 1
        self.obs.metrics.counter("core/preemptions").inc()
        self.obs.tracer.transition(
            cr.request_id, frm, "preempted", self.engine.clock(),
            priority=cr.priority.value,
        )
        self.waiting[cr.priority].appendleft(cr)
        return cr

    # ------------------------------------------------------------------
    # Internals
    # ------------------------------------------------------------------
    def _record_quantum(
        self, g: Grant, plan: StepPlan, out: StepOutputs, ran_slots: dict
    ) -> None:
        """Sample the per-quantum gauges and emit the quantum's trace
        events (one ``quantum`` record, per-slot prefill / decode spans split
        by the plan's cost model)."""
        eng = self.engine
        m = self.obs.metrics
        m.gauge("core/queue_depth/online").set(len(self.waiting[Priority.ONLINE]))
        m.gauge("core/queue_depth/offline").set(len(self.waiting[Priority.OFFLINE]))
        m.gauge("engine/slots_active").set(eng.num_active)
        m.gauge("engine/slots_prefilling").set(eng.num_prefilling)
        for key, v in eng.pool.occupancy().items():
            m.gauge(f"engine/pool/{key}").set(v)
        tr = self.obs.tracer
        window, tr.window_state = tr.window_state, None
        if not tr.enabled:
            return
        t0, t1 = g.now, eng.clock()
        pf_cost = out.prefill_tokens * plan.prefill_token_cost
        dec_cost = plan.cost_steps if out.k > 0 else 0.0
        total = pf_cost + dec_cost
        t_mid = t0 + (t1 - t0) * (pf_cost / total if total > 0 else 0.0)
        if out.prefill_tokens:
            for slot, ntok in eng.last_prefill_slot_tokens.items():
                cr = self.slot_requests.get(slot)
                tr.span(
                    "prefill_chunk", f"slot{slot}", t0, t_mid, tokens=ntok,
                    request_id=None if cr is None else cr.request_id,
                )
        name = "spec_round" if out.gamma is not None else "decode"
        for slot, rid in ran_slots.items():
            tr.span(
                name, f"slot{slot}", t_mid, t1, k=out.k, gamma=out.gamma,
                proposer=out.proposer, request_id=rid,
            )
        tr.quantum(
            t0, t1,
            grant={
                "tokens": _num(g.tokens), "online_ok": g.online_ok,
                "phase": (
                    None if g.phase is None
                    else str(getattr(g.phase, "value", g.phase))
                ),
                "max_cost_steps": _num(g.max_cost_steps),
                "token_budget": _num(g.token_budget),
            },
            k=out.k, gamma=out.gamma, proposer=out.proposer,
            cost_steps=out.cost_steps,
            prefill_tokens=out.prefill_tokens,
            admitted=list(out.admitted), preempted=list(out.preempted),
            finished=[cr.request_id for cr in out.finished],
            spec_accepted=out.spec_accepted,
            spec_proposed=out.spec_proposed,
            window=window,
        )

    def _collect(self, cr: EngineRequest) -> list:
        """Absorb tokens the engine produced since the last collection into
        the canonical stream (and the engine-side TTFT stamp); returns just
        the new ones."""
        if (cr.first_token_time is None
                and cr._internal.first_token_time is not None):
            cr.first_token_time = cr._internal.first_token_time
        gen = cr._internal.generated
        new = [int(t) for t in gen[cr._consumed:]]
        cr._consumed = len(gen)
        cr.output_tokens.extend(new)
        return new

    def _apply_stop(self, cr: EngineRequest, new: list) -> bool:
        """Host-side stop-token scan over this step's delta; trims the
        stream past the first stop (stop token included)."""
        stops = cr.sampling.stop_token_ids
        if not stops:
            return False
        for j, t in enumerate(new):
            if t in stops:
                cut = len(cr.output_tokens) - len(new) + j + 1
                del cr.output_tokens[cut:]
                return True
        return False

    def _finish(self, cr: EngineRequest, state: RequestState, now: float) -> None:
        frm = cr.state.value
        cr.state = state
        cr.finish_reason = FINISH_REASONS[state]
        cr.finish_time = now
        self._finished_buffer.append(cr)
        self.obs.metrics.counter("core/finish_reason/" + cr.finish_reason).inc()
        self.obs.tracer.transition(
            cr.request_id, frm, state.value, now, priority=cr.priority.value,
        )

    def _absorb_running(self, slot: int, cr: EngineRequest) -> None:
        new = self._collect(cr)
        if self._apply_stop(cr, new):
            del self.slot_requests[slot]
            self.engine.evict_slot(slot)
            cr._internal = None
            self._finish(cr, RequestState.FINISHED_STOPPED, self.engine.clock())

    def _expire_deadlines(self, now: float) -> None:
        """WAITING or PREEMPTED requests whose deadline elapsed finish
        FINISHED_EXPIRED without taking a slot; requests in a slot are never
        expired."""
        for q in self.waiting.values():
            expired = [
                cr for cr in q
                if cr.sampling.deadline_s is not None
                and now >= cr.arrival_time + cr.sampling.deadline_s
            ]
            for cr in expired:
                q.remove(cr)
                self._finish(cr, RequestState.FINISHED_EXPIRED, now)

    def _on_slot_finished(self, slot: int, internal: Request) -> None:
        """Engine retirement callback (budget exhausted or max_seq horizon)."""
        cr = self.slot_requests.pop(slot, None)
        if cr is None:
            return
        new = self._collect(cr)
        cr._internal = None
        state = (
            RequestState.FINISHED_STOPPED
            if self._apply_stop(cr, new) else RequestState.FINISHED_LENGTH
        )
        self._finish(cr, state, internal.finish_time)

    def _try_admit(
        self,
        cr: EngineRequest,
        *,
        allow_preempt: bool = False,
        on_preempt: Optional[Callable[[EngineRequest], Any]] = None,
    ) -> bool:
        """Admit ``cr`` into a slot, evicting policy-chosen OFFLINE victims
        while admission fails and ``allow_preempt``.  On failure the request
        stays where it was in its queue."""
        frm = cr.state.value
        if cr.remaining_budget <= 0:
            # a preempted request whose budget was exactly exhausted
            self.waiting[cr.priority].remove(cr)
            self._finish(cr, RequestState.FINISHED_LENGTH, self.engine.clock())
            return False
        prompt = cr.prompt
        if cr.output_tokens:
            prompt = np.concatenate(
                [prompt, np.asarray(cr.output_tokens, np.int32)]
            )
        internal = Request(prompt=prompt, max_new_tokens=cr.remaining_budget)
        while not self.engine._admit_request(internal):
            victim_slot = (
                self.policy.pick_victim(self, cr) if allow_preempt else None
            )
            if victim_slot is None:
                return False
            victim = self.preempt(victim_slot)
            if victim is not None and on_preempt is not None:
                on_preempt(victim)
        slot = next(i for i, r in enumerate(self.engine.slots) if r is internal)
        self.slot_requests[slot] = cr
        try:
            self.waiting[cr.priority].remove(cr)
        except ValueError:
            pass  # externally managed request, not in a queue
        cr._internal = internal
        cr._consumed = 0
        cr.state = RequestState.PREFILLING
        self.obs.tracer.transition(
            cr.request_id, frm, cr.state.value, self.engine.clock(),
            priority=cr.priority.value,
        )
        return True
