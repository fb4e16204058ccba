"""Request queues + Poisson arrival generation (paper §5.1 methodology; own
copy of ``repro.core.queues``)."""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class SimRequest:
    arrival_s: float
    service_s: float  # execution time on an otherwise-idle device
    request_id: int
    online: bool
    start_s: Optional[float] = None
    finish_s: Optional[float] = None

    @property
    def latency_s(self) -> Optional[float]:
        if self.finish_s is None:
            return None
        return self.finish_s - self.arrival_s


def poisson_arrivals(
    *,
    mean_interval_s: float,
    num_requests: int,
    service_s: float,
    seed: int = 0,
    online: bool = True,
    start_s: float = 0.0,
) -> list[SimRequest]:
    """Exponential inter-arrival times (Poisson process), as in the paper:
    'Poisson distribution is used for generating online inference workloads'
    with a given mean across N total requests."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(scale=mean_interval_s, size=num_requests)
    t = start_s + np.cumsum(gaps)
    return [
        SimRequest(
            arrival_s=float(t[i]),
            service_s=service_s,
            request_id=i,
            online=online,
        )
        for i in range(num_requests)
    ]


class RequestQueue:
    """Priority-aware FIFO with arrival-time gating (requests become
    visible at their arrival timestamp).

    ``pull`` serves the earliest-arrived ONLINE request first, then falls
    back to offline work: the old strictly-FIFO pull could park an online
    arrival behind an earlier offline queue head for the offline request's
    whole service time — head-of-line blocking the paper's p95 story
    cannot afford.  Within a priority class, order stays FIFO by arrival.
    """

    def __init__(self, requests: list[SimRequest]):
        by_arrival = sorted(requests, key=lambda r: r.arrival_s)
        self._online = collections.deque(r for r in by_arrival if r.online)
        self._offline = collections.deque(
            r for r in by_arrival if not r.online
        )
        self.completed: list[SimRequest] = []

    def available(self, now_s: float) -> int:
        return sum(
            1 for r in (*self._online, *self._offline) if r.arrival_s <= now_s
        )

    def pull(self, now_s: float) -> Optional[SimRequest]:
        for q in (self._online, self._offline):
            if q and q[0].arrival_s <= now_s:
                return q.popleft()
        return None

    def done(self, req: SimRequest) -> None:
        self.completed.append(req)

    @property
    def remaining(self) -> int:
        return len(self._online) + len(self._offline)

    @property
    def pending(self) -> list[SimRequest]:
        """Snapshot of not-yet-pulled requests (online first)."""
        return [*self._online, *self._offline]

    def p95_latency(self) -> float:
        lats = [r.latency_s for r in self.completed if r.latency_s is not None]
        if not lats:
            return float("nan")
        return float(np.percentile(lats, 95))

    def mean_latency(self) -> float:
        lats = [r.latency_s for r in self.completed if r.latency_s is not None]
        if not lats:
            return float("nan")
        return float(np.mean(lats))
