"""Thread-safe metrics registry: counters, gauges, log-bucket latency
histograms.

Design constraints, in order:

  1. *Cheap enough for per-op use.*  An observation is two lock-free
     dict reads (caller-side metric handle), one ``bisect`` over ~60
     precomputed edges, and a handful of integer adds under a leaf
     lock — no sampling, no allocation, no string formatting on the
     hot path.
  2. *Percentiles without sample retention.*  Latencies land in FIXED
     log-spaced buckets (5 per decade, 100 ns .. 100 ks), so p50/p90/
     p99 read off the cumulative bucket counts with at most one-bucket
     (~58%) relative error — the resolution SOSD-style latency gates
     need, at O(buckets) memory per metric forever.
  3. *Thread-correct by construction.*  Every mutation happens under a
     per-metric leaf lock (never held while calling out), so service
     threads, the background compactor, and benchmark harnesses can
     record concurrently without torn counts.

`StatsView` re-implements the services' legacy ``stats`` dicts as
backward-compatible mutable views over registry counters: existing
``svc.stats["get"] += n`` call sites and tests keep working while every
value is really registry state exportable via ``obs.export``.
"""

from __future__ import annotations

import bisect
import contextlib
import math
import threading
import time
from collections.abc import MutableMapping
from typing import Dict, Iterable, Iterator, Optional, Tuple

# Fixed log-spaced histogram edges: 5 buckets per decade over 12
# decades, 1e-7 s (100 ns) .. 1e5 s.  Shared by every latency histogram
# so cross-metric and cross-run bucket counts are directly comparable.
BUCKETS_PER_DECADE = 5
_DECADES = 12
DEFAULT_LATENCY_EDGES: Tuple[float, ...] = tuple(
    1e-7 * 10.0 ** (i / BUCKETS_PER_DECADE)
    for i in range(_DECADES * BUCKETS_PER_DECADE + 1)
)


class Counter:
    """Monotone-by-convention numeric cell.  ``add`` preserves int-ness
    (int + int stays int) so legacy ``stats`` consumers that compare or
    format counts keep seeing integers; latency accumulators go float
    the moment a float lands."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def add(self, v=1) -> None:
        with self._lock:
            self._value += v

    inc = add

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins numeric cell (fill levels, queue depths)."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    def add(self, v=1) -> None:
        with self._lock:
            self._value += v

    @property
    def value(self):
        with self._lock:
            return self._value


class Histogram:
    """Fixed log-bucket histogram with O(1) observe and O(buckets)
    percentile reads.

    ``counts[0]`` holds observations below the first edge and
    ``counts[-1]`` those at/above the last; true min/max are tracked
    exactly so percentile estimates never leave the observed range.
    """

    __slots__ = ("name", "edges", "_lock", "_counts", "_count", "_sum",
                 "_min", "_max")

    def __init__(self, name: str,
                 edges: Optional[Iterable[float]] = None):
        self.name = name
        self.edges = tuple(edges) if edges is not None else DEFAULT_LATENCY_EDGES
        if not all(b > a for a, b in zip(self.edges, self.edges[1:])):
            raise ValueError("histogram edges must strictly increase")
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.edges) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = 0.0

    def observe(self, v: float) -> None:
        i = bisect.bisect_right(self.edges, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @contextlib.contextmanager
    def time(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(time.perf_counter() - t0)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, q: float) -> float:
        """q-th percentile (q in (0, 100]) estimated at the geometric
        midpoint of the covering bucket, clamped to the exact observed
        [min, max]."""
        with self._lock:
            total = self._count
            if total == 0:
                return 0.0
            target = max(1, math.ceil(q / 100.0 * total))
            cum = 0
            for i, c in enumerate(self._counts):
                cum += c
                if cum >= target:
                    if i == 0:
                        v = self.edges[0]
                    elif i >= len(self.edges):
                        v = self._max
                    else:
                        v = math.sqrt(self.edges[i - 1] * self.edges[i])
                    return float(min(max(v, self._min), self._max))
            return float(self._max)

    def percentiles(self, qs=(50, 90, 99)) -> Dict[str, float]:
        return {f"p{q:g}": self.percentile(q) for q in qs}

    def snapshot(self) -> Dict[str, object]:
        """Point-in-time dict: count/sum/min/max, p50/p90/p99, and the
        non-empty buckets keyed by their upper edge."""
        with self._lock:
            counts = list(self._counts)
            count, s = self._count, self._sum
            mn = 0.0 if math.isinf(self._min) else self._min
            mx = self._max
        buckets = {}
        for i, c in enumerate(counts):
            if c:
                le = self.edges[i] if i < len(self.edges) else math.inf
                buckets[f"{le:.3g}"] = c
        return {
            "count": count,
            "sum": s,
            "min": mn,
            "max": mx,
            **self.percentiles(),
            "buckets": buckets,
        }


class MetricsRegistry:
    """Get-or-create namespace of metrics.  Metric handles are stable
    objects — hot paths fetch once and hold the reference; re-fetching
    by name is just a dict read under the registry lock."""

    def __init__(self, name: str = ""):
        self.name = name
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get_or_create(self, name: str, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, *args)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str,
                  edges: Optional[Iterable[float]] = None) -> Histogram:
        return self._get_or_create(name, Histogram, edges)

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def timer(self, name: str):
        """Context manager timing its body into histogram ``name``."""
        return self.histogram(name).time()

    def items(self) -> Iterator[Tuple[str, object]]:
        with self._lock:
            return iter(sorted(self._metrics.items()))

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """{"counters": {...}, "gauges": {...}, "histograms": {...}}."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, m in self.items():
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            else:
                out["histograms"][name] = m.snapshot()
        return out


# process-wide default registry: cross-cutting planes (kernel dispatch
# attribution, serving engine defaults) record here; index services
# each carry their own registry so shards never alias counters
_DEFAULT = MetricsRegistry("default")


def default_registry() -> MetricsRegistry:
    return _DEFAULT


class StatsView(MutableMapping):
    """Backward-compatible ``stats`` dict facade over registry counters.

    Every key is backed by the counter ``<prefix>.<key>`` in the
    owning registry, so legacy call sites (``stats["get"] += n``,
    ``stats.items()``, cross-object ``svc.stats["x"] += y``) keep
    working unchanged while the values are really registry state —
    one source of truth for the dict view, ``stats_summary()``, and
    every exporter."""

    def __init__(self, registry: MetricsRegistry, prefix: str,
                 keys: Iterable[str] = ()):
        self._registry = registry
        self._prefix = prefix
        self._counters: Dict[str, Counter] = {}
        for k in keys:
            self._ensure(k)

    def _ensure(self, key: str) -> Counter:
        c = self._counters.get(key)
        if c is None:
            c = self._counters[key] = self._registry.counter(
                f"{self._prefix}.{key}"
            )
        return c

    def __getitem__(self, key: str):
        return self._counters[key].value

    def __setitem__(self, key: str, value) -> None:
        self._ensure(key).set(value)

    def __delitem__(self, key: str) -> None:
        del self._counters[key]  # removed from the view, not the registry

    def __iter__(self):
        return iter(self._counters)

    def __len__(self) -> int:
        return len(self._counters)

    def __repr__(self) -> str:
        return f"StatsView({dict(self)!r})"
