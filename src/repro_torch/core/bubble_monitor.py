"""Bubble Monitor (paper §3.3) — sliding-window activity statistics (own
copy of ``repro.core.bubble_monitor``).

The paper's monitor hijacks CUDA launches and counts kernels per 2 ms
window.  The port's runtime feeds the same statistic from the iteration
profile: per-window activity counts, 1 while training computes and 0 inside
a bubble.  Everything downstream of ``observe()`` is source-agnostic.
"""
from __future__ import annotations

import collections

from repro_torch.configs.base import SpecInFConfig


class BubbleMonitor:
    """Counts per-window activity; reports the trailing run of zero windows."""

    def __init__(self, cfg: SpecInFConfig):
        self.cfg = cfg
        self.window = collections.deque(maxlen=cfg.window_len)
        self._zero_run = 0
        #: out-of-band early-resume notices
        self.interrupts = 0

    def observe(self, activity_count: int) -> int:
        """Record one window's activity count; returns current zero-count Z_c."""
        self.window.append(activity_count)
        if activity_count == 0:
            self._zero_run += 1
        else:
            self._zero_run = 0
        return self._zero_run

    @property
    def zero_count(self) -> int:
        return self._zero_run

    def notice_activity(self) -> None:
        """Training resumed inside a span the profile predicted idle (a
        revoked grant): cut the zero run now, not at the next window, so
        Algorithm 1 sees Z_c = 0 and stops granting."""
        self.interrupts += 1
        self._zero_run = 0

    def utilization(self) -> float:
        """Fraction of recent windows with activity (diagnostics only)."""
        if not self.window:
            return 0.0
        return sum(1 for c in self.window if c > 0) / len(self.window)

    def state(self) -> dict:
        """JSON-able window snapshot for the step trace: the runtime attaches
        it to each quantum event so a trace shows what the monitor believed
        when the scheduling decision was made."""
        return {
            "zero_count": self._zero_run,
            "windows": len(self.window),
            "utilization": self.utilization(),
        }

    def reset(self) -> None:
        self.window.clear()
        self._zero_run = 0
