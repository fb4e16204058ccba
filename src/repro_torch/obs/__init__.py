"""Engine observability: the metrics registry (``metrics``), the step
tracer with the per-engine ``Observability`` bundle (``trace``), SLO
attribution from trace transitions (``attribution``) and the trace schema
with its validator (``schema``)."""
from repro_torch.obs.attribution import RequestAttribution, attribute
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    MetricsRegistry,
    StreamingHistogram,
)
from repro_torch.obs.schema import validate_events, validate_jsonl
from repro_torch.obs.trace import Observability, StepTracer, chrome_trace

__all__ = [
    "Counter",
    "Gauge",
    "MetricsRegistry",
    "Observability",
    "RequestAttribution",
    "StepTracer",
    "StreamingHistogram",
    "attribute",
    "chrome_trace",
    "validate_events",
    "validate_jsonl",
]
