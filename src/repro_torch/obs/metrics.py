"""Metrics registry: counters, gauges and fixed-memory streaming histograms
behind stable names (own copy of ``repro.obs.metrics``).

The engine and core register their instruments under the reference's
stable names (``repro.obs.metrics.STABLE_NAMES``), so the serve CLI's
``summarize`` reads the same counters from either package.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

__all__ = [
    "Counter",
    "Gauge",
    "StreamingHistogram",
    "MetricsRegistry",
]


class Counter:
    """Integer cell; ``value`` is directly readable."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def set(self, v) -> None:
        self.value = v


class Gauge:
    """Last-value cell with run-level min/max/sample-count, ``set`` once per
    scheduling quantum."""

    __slots__ = ("name", "value", "min", "max", "samples")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.samples = 0

    def set(self, v) -> None:
        v = float(v)
        self.value = v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        self.samples += 1


class StreamingHistogram:
    """Fixed-memory histogram with exact percentiles up to ``EXACT_CAP``
    samples (``np.percentile`` of the kept samples); past the cap the
    samples collapse once into ``NUM_BINS`` fixed-width bins and percentiles
    interpolate within a bin (min/max/count/sum stay exact)."""

    EXACT_CAP = 8192
    NUM_BINS = 256
    __slots__ = ("name", "count", "sum", "min", "max", "_samples", "_bins", "_edges")

    def __init__(self, name: str = ""):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._samples: Optional[list] = []
        self._bins: Optional[np.ndarray] = None
        self._edges: Optional[np.ndarray] = None

    @property
    def exact(self) -> bool:
        """True while every recorded sample is still held verbatim."""
        return self._samples is not None

    def record(self, x) -> None:
        x = float(x)
        self.count += 1
        self.sum += x
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x
        if self._samples is not None:
            self._samples.append(x)
            if len(self._samples) > self.EXACT_CAP:
                self._collapse()
        else:
            i = int(np.searchsorted(self._edges, x, side="right")) - 1
            self._bins[min(max(i, 0), self.NUM_BINS - 1)] += 1

    def _collapse(self) -> None:
        lo, hi = self.min, self.max
        if not hi > lo:
            hi = lo + 1.0
        self._edges = np.linspace(lo, hi, self.NUM_BINS + 1)
        self._bins, _ = np.histogram(self._samples, bins=self._edges)
        self._bins = self._bins.astype(np.int64)
        self._samples = None

    def values(self) -> list:
        """The exact samples, while ``exact``; past the cap they no longer
        exist and this raises (query ``percentile`` / ``count`` / ``sum``)."""
        if self._samples is None:
            raise RuntimeError(
                f"histogram {self.name!r} collapsed to bins after "
                f"{self.EXACT_CAP} samples; exact values are gone -- query "
                "percentile()/count/sum instead"
            )
        return list(self._samples)

    def percentile(self, q: float) -> float:
        """q-th percentile (0..100); NaN when empty."""
        if self.count == 0:
            return float("nan")
        if self._samples is not None:
            return float(np.percentile(self._samples, q))
        target = q / 100.0 * self.count
        cum = np.cumsum(self._bins)
        i = min(int(np.searchsorted(cum, target, side="left")), self.NUM_BINS - 1)
        prev = float(cum[i - 1]) if i > 0 else 0.0
        inbin = float(self._bins[i])
        frac = (target - prev) / inbin if inbin > 0 else 0.0
        lo, hi = float(self._edges[i]), float(self._edges[i + 1])
        return float(min(max(lo + frac * (hi - lo), self.min), self.max))


class MetricsRegistry:
    """Name -> instrument map with get-or-create semantics; requesting a
    name as another type raises."""

    def __init__(self):
        self._metrics: dict = {}

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, requested {cls.__name__}"
            )
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> StreamingHistogram:
        return self._get(name, StreamingHistogram)

    def snapshot(self) -> dict:
        """JSON-able dump of every instrument."""
        out = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, Counter):
                out[name] = {"type": "counter", "value": m.value}
            elif isinstance(m, Gauge):
                out[name] = {
                    "type": "gauge", "value": m.value, "samples": m.samples,
                    "min": None if m.samples == 0 else m.min,
                    "max": None if m.samples == 0 else m.max,
                }
            else:
                out[name] = {
                    "type": "histogram", "count": m.count, "sum": m.sum,
                    "min": None if m.count == 0 else m.min,
                    "max": None if m.count == 0 else m.max,
                    "exact": m.exact,
                    "p50": None if m.count == 0 else m.percentile(50),
                    "p95": None if m.count == 0 else m.percentile(95),
                    "p99": None if m.count == 0 else m.percentile(99),
                }
        return out
