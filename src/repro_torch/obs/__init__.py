"""Engine observability: the metrics registry (``metrics``) and the step
tracer with the per-engine ``Observability`` bundle (``trace``)."""
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    MetricsRegistry,
    StreamingHistogram,
)
from repro_torch.obs.trace import Observability, StepTracer, chrome_trace

__all__ = [
    "Counter",
    "Gauge",
    "MetricsRegistry",
    "Observability",
    "StepTracer",
    "StreamingHistogram",
    "chrome_trace",
]
