"""Observability plane: metrics, tracing and the lock-order sanitizer
(copies of the reference's framework-free ``obs`` modules)."""

from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    StatsView,
    default_registry,
)
from repro_torch.obs.trace import Tracer, TRACER, span, instant
from repro_torch.obs import lockstat

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "StatsView",
    "default_registry",
    "Tracer", "TRACER", "span", "instant",
    "lockstat",
]
