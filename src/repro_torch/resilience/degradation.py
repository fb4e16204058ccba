"""Graceful-degradation ladder (own copy of ``repro.resilience.degradation``).

Overload never fails the engine outright; it walks a ladder of
increasingly aggressive (and increasingly visible) mitigations, driven by
the same registry pressure signals the dashboards read:

====== ============== ====================================================
stage  name           mitigation
====== ============== ====================================================
0      NORMAL         none
1      SPEC_OFF       disable speculative decoding (verify batches are
                      the first thing to go — they multiply tokens/step)
2      K_SHRINK       shrink the decode bucket to the smallest k
                      (quanta stay short; admission latency improves)
3      SHED_OFFLINE   shed queued OFFLINE work beyond a keep-depth
                      (FINISHED_EXPIRED; throughput work is re-submittable)
4      SHED_ONLINE    additionally shed queued ONLINE requests whose
                      deadline can no longer be met (FINISHED_EXPIRED)
====== ============== ====================================================

Each stage includes every mitigation below it.  Transitions are dwelled:
escalation needs ``up_dwell`` consecutive pressured quanta, de-escalation
``down_dwell`` consecutive calm ones, and a quantum that is neither
resets both counters — the hysteresis that keeps the ladder from
flapping when load oscillates around a threshold.

The ladder is consulted by ``EngineCore.step()`` when installed
(``core.ladder = OverloadLadder(...)``): ``update`` before planning
(reads pressure, sheds, records the ``fault/ladder_*`` metrics) and
``apply`` after (downshifts the plan).  It never touches device state.
"""
from __future__ import annotations

import dataclasses
import enum

from repro_torch.serving.core import Priority

__all__ = ["LadderStage", "LadderConfig", "OverloadLadder"]


class LadderStage(enum.IntEnum):
    NORMAL = 0
    SPEC_OFF = 1
    K_SHRINK = 2
    SHED_OFFLINE = 3
    SHED_ONLINE = 4


@dataclasses.dataclass(frozen=True)
class LadderConfig:
    """Pressure thresholds and hysteresis dwells.

    Pressure = queue depth >= ``high_queue_depth`` OR pool occupancy
    fraction >= ``high_pool_frac`` OR any deadline expiry since the last
    quantum.  Calm = depth <= ``low_queue_depth`` AND occupancy <=
    ``low_pool_frac`` AND no expiries.  The low thresholds sit below the
    high ones so recovery needs genuinely lighter load, not one quiet
    quantum at the boundary."""

    high_queue_depth: int = 8
    low_queue_depth: int = 2
    high_pool_frac: float = 0.95
    low_pool_frac: float = 0.75
    up_dwell: int = 3
    down_dwell: int = 8
    #: SHED_OFFLINE keeps this many queued OFFLINE requests and sheds the
    #: rest (newest first — the oldest queued work sheds last)
    offline_keep_depth: int = 4
    #: SHED_ONLINE sheds an ONLINE request once its deadline slack drops
    #: to this margin (engine-clock seconds); deadline-less requests are
    #: never shed
    online_slack_s: float = 0.0


class OverloadLadder:
    """Hysteretic overload controller over an ``EngineCore``."""

    def __init__(self, config: LadderConfig = LadderConfig()):
        self.config = config
        self.stage = LadderStage.NORMAL
        self._up = 0
        self._down = 0
        self._expired_seen = 0

    # -- pressure ------------------------------------------------------
    def _pool_frac(self, core) -> float:
        pool = core.engine.pool
        if pool is None:
            return 0.0
        occ = pool.occupancy()
        total = occ.get("pages_in_use", 0) + occ.get("available", 0)
        return occ.get("pages_in_use", 0) / total if total else 0.0

    def update(self, core, grant) -> None:
        """Pre-plan hook: read pressure, move the stage (with dwell),
        shed queued work the current stage calls for, record metrics."""
        cfg = self.config
        m = core.obs.metrics
        depth = core.num_waiting
        frac = self._pool_frac(core)
        expired = m.counter("core/finish_reason/expired").value
        missed = expired - self._expired_seen
        self._expired_seen = expired
        pressured = (
            depth >= cfg.high_queue_depth
            or frac >= cfg.high_pool_frac
            or missed > 0
        )
        calm = (
            depth <= cfg.low_queue_depth
            and frac <= cfg.low_pool_frac
            and missed == 0
        )
        if pressured:
            self._down = 0
            self._up += 1
            if self._up >= cfg.up_dwell and self.stage < LadderStage.SHED_ONLINE:
                self.stage = LadderStage(self.stage + 1)
                self._up = 0
                m.counter("fault/ladder_escalations").inc()
        elif calm:
            self._up = 0
            self._down += 1
            if self._down >= cfg.down_dwell and self.stage > LadderStage.NORMAL:
                self.stage = LadderStage(self.stage - 1)
                self._down = 0
        else:
            # between the thresholds: hold the stage, restart both dwells
            self._up = 0
            self._down = 0
        if self.stage >= LadderStage.SHED_OFFLINE:
            q = core.waiting[Priority.OFFLINE]
            while len(q) > cfg.offline_keep_depth:
                core.shed(q[-1], grant.now, "offline")
        if self.stage >= LadderStage.SHED_ONLINE:
            doomed = [
                cr for cr in core.waiting[Priority.ONLINE]
                if cr.sampling.deadline_s is not None
                and (cr.arrival_time + cr.sampling.deadline_s - grant.now)
                <= cfg.online_slack_s
            ]
            for cr in doomed:
                core.shed(cr, grant.now, "online")
        m.gauge("fault/ladder_stage").set(int(self.stage))
        m.counter("fault/ladder_steps/" + self.stage.name.lower()).inc()

    # -- plan downshift ------------------------------------------------
    def apply(self, core, grant, plan) -> None:
        """Post-plan hook: downshift the quantum shape for the current
        stage.  Only ever REDUCES tokens/steps, so the policy's budget
        clamp stays valid."""
        if self.stage >= LadderStage.SPEC_OFF and plan.gamma is not None:
            plan.gamma = None
            plan.cost_steps = float(plan.k)
        if self.stage >= LadderStage.K_SHRINK and plan.k > 0:
            buckets = getattr(core.policy, "k_buckets", None) or (1,)
            # smallest RUNNABLE bucket: a 0 bucket means "skip the quantum",
            # which would stall streams rather than degrade them
            k_min = min((b for b in buckets if b > 0), default=1)
            if plan.k > k_min:
                plan.cost_steps *= k_min / plan.k
                plan.k = k_min
