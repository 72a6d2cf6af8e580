"""Exporters over the observability plane: JSON snapshots, Prometheus
text exposition, Chrome trace files.

All exporters are pull-style and read-only — they take a point-in-time
snapshot of a `MetricsRegistry` (or the process `TRACER`) and format
it; nothing here mutates metric state, so exporting mid-run is safe
from any thread.
"""

from __future__ import annotations

import json
import re
from typing import Dict, Optional

from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.trace import TRACER, Tracer

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    """Sanitize a dotted metric name into Prometheus's charset."""
    out = _NAME_RE.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def registry_json(registry: MetricsRegistry) -> Dict[str, object]:
    """JSON-serialisable snapshot of one registry."""
    return {"registry": registry.name, **registry.snapshot()}


def write_json(registry: MetricsRegistry, path: str) -> str:
    with open(path, "w") as f:
        json.dump(registry_json(registry), f, indent=2, sort_keys=True)
    return path


def prometheus_text(registry: MetricsRegistry) -> str:
    """Prometheus text exposition (v0.0.4) for one registry.

    Histograms render in the standard cumulative form: one
    ``_bucket{le="..."}`` series per edge plus ``le="+Inf"``, then
    ``_sum`` and ``_count``.
    """
    lines = []
    for name, metric in registry.items():
        pname = _prom_name(name)
        if isinstance(metric, Counter):
            lines.append(f"# TYPE {pname} counter")
            lines.append(f"{pname} {metric.value}")
        elif isinstance(metric, Gauge):
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {metric.value}")
        elif isinstance(metric, Histogram):
            lines.append(f"# TYPE {pname} histogram")
            with metric._lock:
                counts = list(metric._counts)
                total = metric._count
                s = metric._sum
            cum = 0
            for i, edge in enumerate(metric.edges):
                cum += counts[i]
                lines.append(f'{pname}_bucket{{le="{edge:.6g}"}} {cum}')
            lines.append(f'{pname}_bucket{{le="+Inf"}} {total}')
            lines.append(f"{pname}_sum {s}")
            lines.append(f"{pname}_count {total}")
    return "\n".join(lines) + "\n"


def write_prometheus(registry: MetricsRegistry, path: str) -> str:
    with open(path, "w") as f:
        f.write(prometheus_text(registry))
    return path


def chrome_trace(tracer: Optional[Tracer] = None) -> Dict[str, object]:
    """Chrome trace-event JSON object for a tracer (default: the
    process-wide `TRACER`)."""
    return (tracer or TRACER).to_chrome()


def write_chrome_trace(path: str, tracer: Optional[Tracer] = None) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(tracer), f)
    return path


def op_latency_rows(registry: MetricsRegistry,
                    prefix: str = "op.") -> Dict[str, Dict[str, float]]:
    """Per-op latency summary rows for benchmark artifacts: for every
    histogram named ``<prefix><op>.latency_s``, a row of count and
    p50/p90/p99 in microseconds."""
    rows: Dict[str, Dict[str, float]] = {}
    for name, metric in registry.items():
        if not isinstance(metric, Histogram):
            continue
        if not (name.startswith(prefix) and name.endswith(".latency_s")):
            continue
        op = name[len(prefix):-len(".latency_s")]
        if metric.count == 0:
            continue
        ps = metric.percentiles()
        rows[op] = {
            "count": metric.count,
            "p50_us": ps["p50"] * 1e6,
            "p90_us": ps["p90"] * 1e6,
            "p99_us": ps["p99"] * 1e6,
            "mean_us": (metric.sum / metric.count) * 1e6,
        }
    return rows
