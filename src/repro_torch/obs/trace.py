"""Structured step tracer (own copy of ``repro.obs.trace``): one event per
scheduling quantum, request state transitions and per-slot spans, exported
as JSONL and as a Chrome trace (https://ui.perfetto.dev).

Every timestamp comes from the ENGINE's clock (the caller stamps; the tracer
reads no clock of its own).  Memory is bounded: past ``max_events`` the
tracer counts drops instead of growing; a disabled tracer records nothing.
"""
from __future__ import annotations

import json
import math
from typing import Optional

from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["StepTracer", "Observability", "chrome_trace", "TRACE_VERSION"]

TRACE_VERSION = 1


def _num(x):
    """JSON-safe number: infinities (unbounded grants) map to None."""
    if x is None:
        return None
    x = float(x)
    if math.isinf(x) or math.isnan(x):
        return None
    return x


class StepTracer:
    """Append-only structured event log on the engine's clock."""

    def __init__(self, enabled: bool = True, max_events: int = 200_000):
        self.enabled = enabled
        self.max_events = max_events
        self.events: list = []
        self.dropped = 0
        self._seq = 0
        #: bubble-monitor window state for the NEXT quantum event: a SpecInF
        #: runtime sets it right before ``EngineCore.step`` and the core
        #: folds it into the quantum record, then clears it
        self.window_state: Optional[dict] = None

    def _emit(self, ev: dict) -> None:
        if not self.enabled:
            return
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        ev["seq"] = self._seq
        self._seq += 1
        self.events.append(ev)

    def quantum(self, t0: float, t1: float, **args) -> None:
        self._emit({
            "type": "quantum", "t0": float(t0), "t1": float(t1), "args": args,
        })

    def span(self, name: str, track: str, t0: float, t1: float, **args) -> None:
        self._emit({
            "type": "span", "name": name, "track": track,
            "t0": float(t0), "t1": float(t1), "args": args,
        })

    def instant(self, name: str, t: float, track: str = "control", **args) -> None:
        self._emit({
            "type": "instant", "name": name, "t": float(t), "track": track,
            "args": args,
        })

    def transition(self, request_id: int, frm: Optional[str], to: str,
                   t: float, priority: Optional[str] = None) -> None:
        self._emit({
            "type": "transition", "request_id": int(request_id),
            "frm": frm, "to": to, "t": float(t), "priority": priority,
        })

    def restamp_arrival(self, request_id: int, t: float) -> None:
        """Rewrite a request's WAITING (submission) transition timestamp:
        ``SpecInFRuntime`` restamps earlier arrivals onto its virtual epoch,
        and the trace follows, so both stay on one timebase."""
        for ev in self.events:
            if (ev["type"] == "transition"
                    and ev["request_id"] == request_id
                    and ev["to"] == "waiting"):
                ev["t"] = float(t)

    def attribution(self) -> dict:
        """Per-request SLO attribution of this trace's transition events
        (``repro_torch.obs.attribution.attribute``)."""
        from repro_torch.obs.attribution import attribute

        return attribute(self.events)

    def write_jsonl(self, path: str, **meta) -> None:
        head = {
            "type": "meta", "version": TRACE_VERSION,
            "events": len(self.events), "dropped": self.dropped, **meta,
        }
        with open(path, "w") as f:
            for ev in [head, *self.events]:
                f.write(json.dumps(ev) + "\n")

    def write_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(chrome_trace(self.events), f)


def chrome_trace(events: list) -> dict:
    """Render structured events as a Chrome trace: spans and quanta become
    complete ('X') events, instants and transitions instant ('i') events,
    each track a named thread.  Engine-clock seconds convert to µs."""
    tids: dict = {}

    def tid(track: str) -> int:
        if track not in tids:
            tids[track] = len(tids) + 1
        return tids[track]

    tid("control")
    out = []
    for ev in events:
        kind = ev["type"]
        if kind in ("quantum", "span"):
            out.append({
                "ph": "X", "name": ev.get("name", "quantum"), "cat": kind,
                "ts": ev["t0"] * 1e6,
                "dur": max(ev["t1"] - ev["t0"], 0.0) * 1e6,
                "pid": 0, "tid": tid(ev.get("track", "control")),
                "args": ev["args"],
            })
        elif kind == "instant":
            out.append({
                "ph": "i", "s": "t", "name": ev["name"], "cat": "instant",
                "ts": ev["t"] * 1e6, "pid": 0, "tid": tid(ev["track"]),
                "args": ev["args"],
            })
        elif kind == "transition":
            out.append({
                "ph": "i", "s": "t",
                "name": f"req{ev['request_id']}:{ev['to']}",
                "cat": "transition", "ts": ev["t"] * 1e6,
                "pid": 0, "tid": tid("control"),
                "args": {"request_id": ev["request_id"],
                         "from": ev["frm"], "priority": ev["priority"]},
            })
    meta = [{
        "ph": "M", "name": "process_name", "pid": 0,
        "args": {"name": "specinf-engine"},
    }]
    for track, t in tids.items():
        meta.append({
            "ph": "M", "name": "thread_name", "pid": 0, "tid": t,
            "args": {"name": track},
        })
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


class Observability:
    """The per-engine bundle: ONE metrics registry + ONE step tracer, shared
    by the engine, its core, the serve CLI and the SpecInF runtime."""

    def __init__(self, tracing: bool = True):
        self.metrics = MetricsRegistry()
        self.tracer = StepTracer(enabled=tracing)
