"""Observability plane: metrics, tracing, the lock-order sanitizer and
the exporters (JSON, Prometheus text, Chrome trace): copies of the
reference's framework-free ``obs`` modules."""

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
from repro_torch.obs.export import (
    chrome_trace,
    op_latency_rows,
    prometheus_text,
    registry_json,
    write_chrome_trace,
    write_json,
    write_prometheus,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "StatsView",
    "default_registry",
    "Tracer", "TRACER", "span", "instant",
    "lockstat",
    "chrome_trace", "op_latency_rows", "prometheus_text", "registry_json",
    "write_chrome_trace", "write_json", "write_prometheus",
]
