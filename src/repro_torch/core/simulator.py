"""Calibrated discrete-event timeline simulator for GPU sharing policies (own
copy of ``repro.core.simulator``).

Evaluation vehicle for the paper's figures: one representative accelerator
executes a repeating training iteration profile (compute/bubble segments
from ``core.profiles``, analytic or measured on the device by
``measure_dp_profile``), and a sharing *policy* decides when collocated
inference instances may execute.  Its ``SpecInFPolicy`` is the simulator's,
not the runtime's ``core.filling.SpecInFPolicy`` that ``repro_torch.core``
exports.
Time advances in fixed ticks (default 0.5 ms — finer than the paper's 2 ms
monitor window).  SpecInF's policy wraps the *real* ``BubbleMonitor`` and
``AdaptiveKernelScheduler`` classes, so the simulator exercises the exact
deployable Algorithm-1 implementation.

Contention model (fit to the paper's Co-Exec observations, §5.2):
  * inference overlapping a training *compute* span stretches training by
    ``kappa_train`` and itself runs ``1/(1+kappa_inf)`` slower;
  * inference inside a *bubble* is free (idle compute);
  * MPS partitions statically: inference always at ``mps_inf_share`` speed,
    training pays ``mps_train_overhead`` while inference is active;
  * n concurrent inference instances scale sub-linearly
    (``1/(1+(n-1)*multi_instance_drag)``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.configs.base import SpecInFConfig
from repro_torch.core.bubble_monitor import BubbleMonitor
from repro_torch.core.profiles import IterationProfile
from repro_torch.core.queues import RequestQueue, SimRequest
from repro_torch.core.scheduler import AdaptiveKernelScheduler, Status


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Interference constants, fit to the paper's §5.2 magnitudes:
    Co-Exec degrades DP training by up to 28% (-> kappa_train); inference
    sharing a saturated device is *starved* behind long training kernels
    (-> kappa_inf ~ 12, the well-documented order-of-magnitude latency
    inflation of uncontrolled co-location that motivates the paper); MPS's
    static partition serves ~15% of exclusive offline throughput in DP."""

    kappa_train: float = 0.35
    kappa_inf: float = 30.0
    mps_inf_share: float = 0.15
    mps_train_overhead: float = 0.04
    multi_instance_drag: float = 0.15
    # Launch-queue delay: an online request issued while training kernels are
    # queued waits behind them before its first kernel runs (the paper's §3.3
    # synchronous-issue observation).  SpecInF avoids it by pulling only on
    # idle; MPS avoids it via its spatial partition (own queue); Co-Exec and
    # TGS pay it whenever they start during a compute span.
    kernel_queue_delay_s: float = 0.040
    tgs_probe_interval_s: float = 0.100
    tgs_increase_per_probe: float = 0.05  # additive-increase step (rate frac)
    # probe busy-fraction above which TGS halves its rate.  DP/MP training
    # runs 65-85% busy, so 0.85 keeps TGS slowly admitting work (the paper's
    # TGS achieves 1/3 - 1/14 of SpecInF, not zero) while still modelling
    # its conservative coarse-grained probing.
    tgs_busy_threshold: float = 0.85
    monitor_overhead_frac: float = 0.01  # SpecInF bookkeeping (paper Fig. 8)
    token_unit_s: float = 0.001  # 1 token == 1 ms of inference execution
    tick_s: float = 0.0005


@dataclasses.dataclass
class OfflineInstance:
    microstep_s: float
    remaining_s: float = 0.0
    executing: bool = False
    completed: int = 0
    current_request: Optional[SimRequest] = None  # online use
    cooldown_until: float = -1.0  # per-instance post-pull busy hold


# ---------------------------------------------------------------------------
# Policies
# ---------------------------------------------------------------------------


class Policy:
    name = "base"
    uses_monitor = False
    pays_launch_queue_delay = False  # online starts stall behind training queue

    def begin(self, profile: IterationProfile, cal: Calibration, m: int):
        self.profile, self.cal, self.m = profile, cal, m

    def on_window(self, activity: int, now: float) -> None:  # 2 ms cadence
        pass

    def allow_offline_start(self, cost_tokens: float, now: float) -> bool:
        return True

    def offline_may_progress(self, tick_s: float) -> bool:
        """Kernel-stream metering: called every tick an offline instance
        wants to advance; consuming budget 'per kernel' (paper KB: each
        forwarded kernel consumes tokens proportionate to its size).  A
        False return stalls the instance *without* device interference —
        blocked kernels are never issued."""
        return True

    def consume(self, cost_tokens: float) -> None:
        pass

    def allow_online_pull(self, now: float) -> bool:
        return True

    def notify_online_pull(self, now: float) -> None:
        pass

    def inference_speed(self, train_computing: bool, n_active: int) -> float:
        drag = 1.0 + (n_active - 1) * self.cal.multi_instance_drag
        if train_computing:
            return 1.0 / ((1.0 + self.cal.kappa_inf) * drag)
        return 1.0 / drag

    def train_speed(self, n_inf_active: int) -> float:
        if n_inf_active > 0:
            return 1.0 / (1.0 + self.cal.kappa_train)
        return 1.0


class SpecInFPolicy(Policy):
    """Wraps the real monitor + Algorithm-1 scheduler + Kernel Barrier
    token metering + online pull-and-execute (paper §3.3).

    Pull gating implements the paper's preemptive-busy via *profiling
    information*: the CKS knows the training profile's bubble durations, so
    a pull is admitted only while the conservative estimate of the current
    bubble's remainder still fits one service (Principle-II applied per
    pull).  The estimate assumes the current bubble is the SHORTEST
    profiled bubble consistent with the observed idle run — speculation
    never overcommits near a bubble's end."""

    name = "specinf"
    uses_monitor = True

    def __init__(self, cfg: SpecInFConfig):
        self.cfg = cfg

    def begin(self, profile, cal, m):
        super().begin(profile, cal, m)
        self.monitor = BubbleMonitor(self.cfg)
        self.scheduler = AdaptiveKernelScheduler(self.cfg, num_instances=m)
        self.allocation = 0.0  # per-instance tokens for the current window
        self.status = Status.BUSY
        self._idle_run_s = 0.0
        self._window_s = self.cfg.window_ms / 1e3
        self.bubble_durations = sorted(
            d for k, d in profile.segments if k == "bubble"
        )
        self.online_service_s = 0.0  # set by the simulator from the queue
        hold = self.cfg.busy_hold_ms / 1e3
        self.busy_hold_s = hold if hold > 0 else 0.0

    def on_window(self, activity: int, now: float) -> None:
        zc = self.monitor.observe(activity)
        d = self.scheduler.update(zc)
        self.allocation = d.tokens
        self.status = d.status
        if activity > 0:
            self._idle_run_s = 0.0
        else:
            self._idle_run_s += self._window_s

    def allow_offline_start(self, cost_tokens: float, now: float) -> bool:
        # one kernel's worth of budget admits the stream; the per-kernel
        # metering below throttles/stalls it
        return self.allocation >= 1.0

    def offline_may_progress(self, tick_s: float) -> bool:
        need = tick_s / self.cal.token_unit_s
        if self.allocation >= need:
            self.allocation -= need
            return True
        return False

    def allow_online_pull(self, now: float) -> bool:
        if self.status is not Status.IDLE:
            return False
        if not self.online_service_s:
            return True
        # Speculative bubble-remainder estimate: among profiled bubbles that
        # could fit one service at all, assume the shortest consistent with
        # the observed idle run.  Micro-bubbles (fwd gaps) are excluded from
        # the match — being wrong about them costs one bounded spill, while
        # letting them mask the big bubbles would forfeit most capacity.
        # The required span prices in multi-instance drag + a 15% guard —
        # a spilled service crawls at the contended rate AND drags training,
        # the paper's cardinal sin.
        drag = 1.0 + (self.m - 1) * self.cal.multi_instance_drag
        need = 1.15 * drag * self.online_service_s
        cands = [d for d in self.bubble_durations if d >= need]
        if not cands:
            return False
        cur = next((d for d in cands if d >= self._idle_run_s), cands[-1])
        return cur - self._idle_run_s >= need


class CoExecPolicy(Policy):
    name = "co-exec"
    pays_launch_queue_delay = True


class MPSPolicy(Policy):
    """Static spatial partition: inference always runs, at a fixed share."""

    name = "mps"

    def inference_speed(self, train_computing: bool, n_active: int) -> float:
        drag = 1.0 + (n_active - 1) * self.cal.multi_instance_drag
        return self.cal.mps_inf_share / drag

    def train_speed(self, n_inf_active: int) -> float:
        if n_inf_active > 0:
            return 1.0 / (1.0 + self.cal.mps_train_overhead)
        return 1.0


class TGSPolicy(Policy):
    """Transparent GPU sharing: coarse utilization probing (~100 ms) with
    additive-increase / multiplicative-decrease rate control — conservative
    by design, so it misses ms-scale bubbles (paper §5.2)."""

    name = "tgs"
    uses_monitor = True
    pays_launch_queue_delay = True

    def begin(self, profile, cal, m):
        super().begin(profile, cal, m)
        self.rate = 0.0  # fraction of time inference may run
        self.bucket = 0.0  # seconds of allowance
        self._probe_acc = 0
        self._probe_windows = 0
        self._last_probe = 0.0

    def on_window(self, activity: int, now: float) -> None:
        self._probe_acc += 1 if activity > 0 else 0  # busy-window fraction
        self._probe_windows += 1
        if now - self._last_probe >= self.cal.tgs_probe_interval_s:
            busy_frac = self._probe_acc / max(self._probe_windows, 1)
            if busy_frac > self.cal.tgs_busy_threshold:
                self.rate = max(0.0, self.rate * 0.5)  # multiplicative decrease
            else:
                self.rate = min(
                    max(0.0, 1.0 - busy_frac),
                    self.rate + self.cal.tgs_increase_per_probe,
                )
            self._probe_acc = 0
            self._probe_windows = 0
            self._last_probe = now
        self.bucket = min(
            self.bucket + self.rate * 0.002, 0.050
        )  # accrue allowance

    def allow_offline_start(self, cost_tokens: float, now: float) -> bool:
        return self.bucket >= self.cal.token_unit_s

    def offline_may_progress(self, tick_s: float) -> bool:
        if self.bucket >= tick_s:
            self.bucket -= tick_s
            return True
        return False

    def allow_online_pull(self, now: float) -> bool:
        return self.bucket >= 0.005


class ExclusivePolicy(Policy):
    """Inference on its own dedicated device (no training present)."""

    name = "exclusive"

    def inference_speed(self, train_computing: bool, n_active: int) -> float:
        drag = 1.0 + (n_active - 1) * self.cal.multi_instance_drag
        return 1.0 / drag

    def train_speed(self, n_inf_active: int) -> float:
        return 1.0


# ---------------------------------------------------------------------------
# Simulation results
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SimResult:
    policy: str
    duration_s: float
    train_iterations: float
    train_throughput_norm: float  # vs exclusive training (1.0 = no impact)
    offline_completed: int
    offline_throughput_per_s: float
    offline_norm: float  # vs one exclusive instance on a dedicated device
    online_p95_s: float
    online_mean_s: float
    online_served: int
    phase_fractions: dict


# ---------------------------------------------------------------------------
# Core simulation loop
# ---------------------------------------------------------------------------


def simulate(
    profile: IterationProfile,
    policy: Policy,
    *,
    duration_s: float = 60.0,
    offline_instances: int = 0,
    offline_microstep_s: float = 0.010,
    online_queue: Optional[RequestQueue] = None,
    online_instances: int = 0,
    cal: Calibration = Calibration(),
    specinf_cfg: Optional[SpecInFConfig] = None,
    exclusive_training: bool = False,
) -> SimResult:
    """Run one accelerator for ``duration_s`` under ``policy``.

    ``exclusive_training``: drop all inference work (training-only baseline).
    """
    m = offline_instances + online_instances
    policy.begin(profile, cal, max(m, 1))
    if online_queue is not None and online_queue.pending:
        svc = float(np.median([r.service_s for r in online_queue.pending]))
        if hasattr(policy, "online_service_s"):
            policy.online_service_s = svc
    tick = cal.tick_s
    window_s = (specinf_cfg.window_ms if specinf_cfg else 2.0) / 1e3
    ticks_per_window = max(1, int(round(window_s / tick)))

    segments = list(profile.segments)
    seg_idx, seg_done = 0, 0.0
    train_iterations = 0.0
    # SpecInF bookkeeping overhead: stretch compute segments by the monitor
    # cost when the policy uses a monitor (paper Fig. 8: ~1%).
    train_overhead = 1.0 + (cal.monitor_overhead_frac if policy.uses_monitor else 0.0)

    offline = [OfflineInstance(offline_microstep_s) for _ in range(offline_instances)]
    online = [OfflineInstance(0.0) for _ in range(online_instances)]

    now = 0.0
    ntick = 0
    window_activity = 0
    total_ticks = int(round(duration_s / tick))

    for ntick in range(total_ticks):
        now = ntick * tick
        in_compute = segments[seg_idx][0] == "compute"

        # ---- monitor window boundary -----------------------------------
        if ntick % ticks_per_window == 0 and ntick > 0:
            policy.on_window(window_activity, now)
            window_activity = 0
        if in_compute:
            window_activity += 1

        if exclusive_training:
            # training alone: walk segments at full speed, no inference
            n_active = 0
        else:
            # ---- online pulls ------------------------------------------
            if online_queue is not None:
                for inst in online:
                    if inst.executing or now < inst.cooldown_until:
                        continue
                    if not policy.allow_online_pull(now):
                        break
                    req = online_queue.pull(now)
                    if req is None:
                        break
                    req.start_s = now
                    inst.current_request = req
                    inst.remaining_s = req.service_s
                    # bubble-blind sharers launch behind the training kernel
                    # queue on every start (paper §3.3 synchronous-issue)
                    if policy.pays_launch_queue_delay:
                        inst.remaining_s += cal.kernel_queue_delay_s
                    inst.executing = True
                    # CKS preemptively flips this instance busy after its pull
                    # (paper §3.3); other free instances may still pull.
                    inst.cooldown_until = now + getattr(policy, "busy_hold_s", 0.0)

            # ---- offline starts (Kernel Barrier admission) --------------
            for inst in offline:
                if inst.executing:
                    continue
                cost = inst.microstep_s / cal.token_unit_s
                if policy.allow_offline_start(cost, now):
                    inst.remaining_s = inst.microstep_s
                    inst.executing = True

            # ---- advance inference (kernel-stream metering) -------------
            # Offline instances only *issue* while the barrier grants budget;
            # a stalled instance has no kernels on device, so it neither
            # progresses nor interferes.  Online pulled requests always run
            # (pull-and-execute bypasses the token meter; mispredictions are
            # bounded by the per-instance busy hold).
            progressing: list[OfflineInstance] = []
            for inst in offline:
                if inst.executing and policy.offline_may_progress(tick):
                    progressing.append(inst)
            for inst in online:
                if inst.executing:
                    progressing.append(inst)
            n_active = len(progressing)
            if n_active:
                speed = policy.inference_speed(in_compute, n_active)
                for inst in progressing:
                    inst.remaining_s -= tick * speed
                    if inst.remaining_s <= 0:
                        inst.executing = False
                        if inst.current_request is not None:
                            inst.current_request.finish_s = now + tick
                            online_queue.done(inst.current_request)
                            inst.current_request = None
                        else:
                            inst.completed += 1

        # ---- advance training -------------------------------------------
        kind, dur = segments[seg_idx]
        if kind == "compute":
            rate = policy.train_speed(n_active) / train_overhead
        else:
            rate = 1.0  # communication proceeds regardless
        seg_done += tick * rate
        if seg_done >= dur:
            seg_done -= dur
            seg_idx += 1
            if seg_idx == len(segments):
                seg_idx = 0
                train_iterations += 1

    # partial iteration credit
    done_s = sum(d for _, d in segments[:seg_idx]) + seg_done
    train_iterations += done_s / max(profile.iteration_s, 1e-12)

    exclusive_rate = 1.0 / profile.iteration_s
    train_norm = (train_iterations / duration_s) / exclusive_rate
    off_completed = sum(i.completed for i in offline)
    off_rate = off_completed / duration_s
    off_norm = off_rate * offline_microstep_s  # exclusive one-instance == 1.0

    return SimResult(
        policy=policy.name,
        duration_s=duration_s,
        train_iterations=train_iterations,
        train_throughput_norm=train_norm,
        offline_completed=off_completed,
        offline_throughput_per_s=off_rate,
        offline_norm=off_norm,
        online_p95_s=online_queue.p95_latency() if online_queue else float("nan"),
        online_mean_s=online_queue.mean_latency() if online_queue else float("nan"),
        online_served=len(online_queue.completed) if online_queue else 0,
        phase_fractions={},
    )


def make_policy(name: str, specinf_cfg: Optional[SpecInFConfig] = None) -> Policy:
    name = name.lower()
    if name == "specinf":
        return SpecInFPolicy(specinf_cfg or SpecInFConfig())
    if name in ("co-exec", "coexec"):
        return CoExecPolicy()
    if name == "mps":
        return MPSPolicy()
    if name == "tgs":
        return TGSPolicy()
    if name == "exclusive":
        return ExclusivePolicy()
    raise ValueError(name)
