"""Adaptive Kernel Scheduling — Algorithm 1 of the paper, verbatim (own copy
of ``repro.core.scheduler``).

Three phases driven by the Bubble Monitor's consecutive zero-count ``Z_c``:

  conservative (Z_c <  alpha): tokens = 0,                status = busy
  incremental  (Z_c <= beta) : tokens = min(LL, t*gamma)/m, status = busy
  stable       (Z_c >  beta) : tokens = min(UL, t*gamma)/m, status = idle

``tokens`` feeds the offline-inference Kernel Barrier; ``status`` gates the
online pull-and-execute path.  The only deviation from the paper's listing is
``token_seed``: the listing multiplies the previous token count by gamma,
which would pin tokens at 0 forever after a conservative phase — we restart
growth from a small seed, which is the obvious intended behavior.
"""
from __future__ import annotations

import dataclasses
import enum

from repro_torch.configs.base import SpecInFConfig


class Status(enum.Enum):
    BUSY = "busy"
    IDLE = "idle"


class Phase(enum.Enum):
    CONSERVATIVE = "conservative"
    INCREMENTAL = "incremental"
    STABLE = "stable"


@dataclasses.dataclass
class ScheduleDecision:
    tokens: float  # per collocated offline instance
    status: Status
    phase: Phase


class AdaptiveKernelScheduler:
    """Per-accelerator CKS instance (paper §3.3, Algorithm 1)."""

    def __init__(self, cfg: SpecInFConfig, num_instances: int = 1):
        if cfg.alpha > cfg.beta:
            raise ValueError("alpha must not exceed beta")
        if num_instances < 1:
            raise ValueError("num_instances must be >= 1")
        self.cfg = cfg
        self.m = num_instances
        self._tokens = 0.0  # shared pool value before the /m split
        self.last_decision = ScheduleDecision(0.0, Status.BUSY, Phase.CONSERVATIVE)

    def update(self, zero_count: int) -> ScheduleDecision:
        cfg = self.cfg
        if zero_count < cfg.alpha:
            self._tokens = 0.0
            decision = ScheduleDecision(0.0, Status.BUSY, Phase.CONSERVATIVE)
        elif zero_count <= cfg.beta:
            grown = max(self._tokens, cfg.token_seed) * cfg.gamma
            self._tokens = min(cfg.lower_limit, grown)
            decision = ScheduleDecision(
                self._tokens / self.m, Status.BUSY, Phase.INCREMENTAL
            )
        else:
            grown = max(self._tokens, cfg.token_seed) * cfg.gamma
            self._tokens = min(cfg.upper_limit, grown)
            decision = ScheduleDecision(
                self._tokens / self.m, Status.IDLE, Phase.STABLE
            )
        self.last_decision = decision
        return decision

    def reset(self) -> None:
        self._tokens = 0.0
        self.last_decision = ScheduleDecision(0.0, Status.BUSY, Phase.CONSERVATIVE)
