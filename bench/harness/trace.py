"""Spans the harness records around its calls into the program, and the
reduction of ``torch.profiler`` traces to busy time, device operations by
name and idle gaps labelled by the span the host was in.

A span is a ``record_function`` range, so it lands in the profiler's own
clock beside the kernels; outside the stretch that labels the gaps ``span``
costs nothing.
"""
from __future__ import annotations

import bisect
import contextlib
import time

import torch

#: span names the harness uses; an idle gap outside all of them is "harness"
LABELS = ("train_step", "engine_step", "control_plane", "generator", "harness")


class Tracer:
    """Runs ``torch.profiler`` over the traced stretches that follow the
    window when ``enabled``.  Stretch 1 traces the device alone: its busy
    time and operations.  Stretch 2 traces the host too, with the harness's
    spans (``span(name)``), only to label the idle gaps by what the host was
    doing; recording every host operation slows the host, so its gaps run
    longer than stretch 1's."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.stretches: list = []  # (profile, t0, t1) of each stretch traced
        self.stretch = 0  # the stretch under way (1 or 2), 0 outside them
        self.prof = self.t0 = None

    def span(self, name: str):
        if self.stretch == 2:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def start(self, spans: bool) -> None:
        if not self.enabled or self.stretch:
            return
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if spans else [ProfilerActivity.CUDA]
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.stretch = 2 if spans else 1
        self.t0 = time.perf_counter()  # the stretch starts once the profiler is up

    def stop(self) -> None:
        if not self.stretch:
            return
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.stretches.append((self.prof, self.t0, t1))
        self.stretch, self.prof = 0, None

    def summary(self) -> dict | None:
        """``{"busy_s", "window_s", "kernels": {name: [seconds, count]}}``
        of stretch 1 and ``"idle": {label: seconds}`` of stretch 2 (with
        its length, ``"idle_window_s"``), or None when stretch 1 saw no
        device time."""
        if not self.stretches:
            return None
        prof, t0, t1 = self.stretches[0]
        kernels, _ = _events(prof)
        if not kernels:
            return None
        by_name: dict = {}
        for a, b, name in kernels:
            s = by_name.setdefault(name, [0.0, 0])
            s[0] += (b - a) / 1e6
            s[1] += 1
        busy, _ = _busy_and_gaps(kernels)
        out = {"busy_s": busy / 1e6, "window_s": t1 - t0, "kernels": by_name, "idle": {}}
        if len(self.stretches) > 1:
            prof, t0, t1 = self.stretches[1]
            out["idle"], out["idle_window_s"] = _labelled_idle(*_events(prof), t1 - t0), t1 - t0
        return out


def _events(prof) -> tuple[list, list]:
    """(kernels, spans) of a profile, each ``(start us, end us, name)``
    sorted by start."""
    kernels, spans = [], []
    for e in prof.events():
        # a span shows on the device's timeline too (a user annotation,
        # not an operation): only the host's copy is kept
        if e.name in LABELS:
            if e.device_type != torch.autograd.DeviceType.CUDA:
                spans.append((e.time_range.start, e.time_range.end, e.name))
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((e.time_range.start, e.time_range.end, e.name))
    return sorted(kernels), sorted(spans)


def _busy_and_gaps(kernels: list) -> tuple[float, list]:
    """(busy microseconds, idle gaps) of sorted kernels."""
    busy, gaps, end = 0.0, [], kernels[0][0]
    for t0, t1, _ in kernels:
        if t0 > end:
            gaps.append((end, t0))
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    return busy, gaps


def _labelled_idle(kernels: list, spans: list, window: float) -> dict:
    """Idle seconds by the innermost span the host was in at each gap's
    start ("harness" outside all of them, and before the first and after
    the last kernel)."""
    if not kernels:
        return {"harness": window}
    _, gaps = _busy_and_gaps(kernels)
    starts = [s[0] for s in spans]
    idle: dict = {}
    for g0, g1 in gaps:
        label = "harness"
        # spans nest: the innermost one open at the gap's start is the
        # latest-starting one that has not ended
        i = bisect.bisect_right(starts, g0) - 1
        for j in range(i, max(i - 256, -1), -1):
            if spans[j][1] >= g0:
                label = spans[j][2]
                break
        idle[label] = idle.get(label, 0.0) + (g1 - g0) / 1e6
    traced = (kernels[-1][1] - kernels[0][0]) / 1e6
    idle["harness"] = idle.get("harness", 0.0) + max(window - traced, 0.0)
    return idle


def breakdown(summary: dict | None) -> dict | None:
    """The result line's ``breakdown``: the ten device operations that took
    most time and the idle seconds by what the host was doing."""
    if summary is None:
        return None
    ops = sorted(((n, s[0]) for n, s in summary["kernels"].items()), key=lambda x: -x[1])
    idle = sorted(summary["idle"].items(), key=lambda x: -x[1])
    return {"device_ops": [[n[:120], s] for n, s in ops[:10]],
            "idle_gaps": [[n, s] for n, s in idle[:10]]}


def kernel_time(summary: dict, *needles: str) -> tuple[float, int]:
    """(seconds, launches) of the kernels whose name holds any needle."""
    secs, n = 0.0, 0
    for name, (s, c) in summary["kernels"].items():
        if any(k in name for k in needles):
            secs += s
            n += c
    return secs, n
