"""SLO attribution (own copy of ``repro.obs.attribution``): decompose each
request's lifetime into queueing / prefill / decode / preempted segments
from trace transitions.

The decomposition is a telescoping sum over the request's state-transition
timeline: the interval between consecutive transitions is charged to the
state the request was IN during it (WAITING -> queueing, PREFILLING ->
prefill, RUNNING -> decode, PREEMPTED -> preempted), so by construction

    queueing + prefill + decode + preempted == finish_time - arrival_time

exactly (float addition of exact interval differences; tests assert it to
1e-9).  On monolithic-prefill engines the admission transition goes
straight to RUNNING with the first token stamped at the same clock instant,
so their prefill segment is the sub-interval of RUNNING before the
``first_token`` instant event — zero on the virtual clock, where monolithic
prefill is charged as part of the quantum's clock advance.  TTFT is the
queueing + prefill prefix (arrival -> first token).

Because every timestamp entering the trace comes from the engine's single
clock, these segments are directly comparable with the registry's
latency/TTFT histograms — ``FillingMetrics`` percentiles and the
attribution view are two projections of the same stamped events, not two
measurement paths.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["RequestAttribution", "attribute"]

#: state (transition ``to`` value) -> attribution bucket charged while the
#: request sits in that state
_BUCKET = {
    "waiting": "queueing",
    "prefilling": "prefill",
    "running": "decode",
    "preempted": "preempted",
}


@dataclasses.dataclass
class RequestAttribution:
    """One request's lifetime decomposition on the engine clock."""

    request_id: int
    priority: Optional[str]
    arrival_time: float
    finish_time: Optional[float]  # None while the request is still live
    finish_state: Optional[str]
    queueing: float = 0.0
    prefill: float = 0.0
    decode: float = 0.0
    preempted: float = 0.0
    first_token_time: Optional[float] = None
    preemptions: int = 0

    @property
    def total(self) -> float:
        return self.queueing + self.prefill + self.decode + self.preempted

    @property
    def latency_s(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival_time

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["total"] = self.total
        d["latency_s"] = self.latency_s
        d["ttft_s"] = self.ttft_s
        return d


def attribute(events: list) -> dict:
    """Build ``{request_id: RequestAttribution}`` from trace events.

    Only ``transition`` events (plus ``first_token`` instants, used to
    split a monolithic admission's RUNNING interval into prefill + decode)
    participate.  Transitions are ordered by ``(t, seq)`` — seq breaks the
    ties a virtual clock produces when several lifecycle edges share one
    quantum-start stamp."""
    trans: dict = {}
    first_tok: dict = {}
    for ev in events:
        if ev["type"] == "transition":
            trans.setdefault(ev["request_id"], []).append(ev)
        elif ev["type"] == "instant" and ev.get("name") == "first_token":
            rid = ev["args"].get("request_id")
            if rid is not None and rid not in first_tok:
                first_tok[rid] = ev["t"]

    out: dict = {}
    for rid, evs in trans.items():
        evs.sort(key=lambda e: (e["t"], e["seq"]))
        priority = next(
            (e["priority"] for e in evs if e.get("priority")), None
        )
        ra = RequestAttribution(
            request_id=rid, priority=priority,
            arrival_time=evs[0]["t"], finish_time=None, finish_state=None,
            first_token_time=first_tok.get(rid),
        )
        for cur, nxt in zip(evs, evs[1:]):
            bucket = _BUCKET.get(cur["to"])
            if bucket is None:
                continue  # terminal state: nothing accrues after it
            a, b = cur["t"], nxt["t"]
            ft = ra.first_token_time
            if (bucket == "decode" and ft is not None and a <= ft <= b
                    and ra.prefill == 0.0 and ra.decode == 0.0):
                # monolithic admission: the first RUNNING interval holds
                # the prefill compute up to the first token
                ra.prefill += ft - a
                ra.decode += b - ft
            else:
                setattr(ra, bucket, getattr(ra, bucket) + (b - a))
            if nxt["to"] == "preempted":
                ra.preemptions += 1
        last = evs[-1]
        if last["to"].startswith("finished"):
            ra.finish_time = last["t"]
            ra.finish_state = last["to"]
        out[rid] = ra
    return out
