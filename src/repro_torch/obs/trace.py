"""Low-overhead op-level tracing: ring-buffer spans, Chrome trace JSON.

A `Tracer` holds a bounded ``deque`` of finished spans (append is
GIL-atomic — no lock on the hot path) and is DISABLED by default: a
disabled ``span()`` costs one attribute read and returns a shared
no-op context manager, so production hot paths pay ~nothing until a
trace is actually wanted.

Spans nest naturally per thread (Chrome's trace viewer nests complete
``"ph": "X"`` events on the same tid by duration containment), so a
mixed-op churn run shows `service.*` spans over `router.route`,
`dispatch.*` kernel entries, and `compactor.*` activity on its worker
thread — open the exported file in ``chrome://tracing`` or Perfetto.

Typical use::

    from repro_torch.obs import trace
    trace.TRACER.enable()
    ... run workload ...
    trace.TRACER.write("trace.json")       # chrome://tracing format
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "cat", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        th = threading.current_thread()
        # deque.append on a bounded deque is thread-safe under the GIL
        self._tracer._events.append(
            (self.name, self.cat, th.ident, th.name, self._t0,
             t1 - self._t0, self.args)
        )
        return False


class Tracer:
    """Ring buffer of spans + Chrome trace-event JSON export."""

    def __init__(self, capacity: int = 131_072):
        self._events = deque(maxlen=capacity)
        self._enabled = False
        self._origin = time.perf_counter()

    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self, capacity: Optional[int] = None) -> None:
        if capacity is not None and capacity != self._events.maxlen:
            self._events = deque(self._events, maxlen=capacity)
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def clear(self) -> None:
        self._events.clear()
        self._origin = time.perf_counter()

    def __len__(self) -> int:
        return len(self._events)

    # ---- recording -------------------------------------------------------
    def span(self, name: str, cat: str = "", **args):
        """Context manager recording a complete ("X") event around its
        body.  No-op (shared null object) while the tracer is disabled."""
        if not self._enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args or None)

    def instant(self, name: str, cat: str = "", **args) -> None:
        """Point event (renders as a vertical tick in the viewer)."""
        if not self._enabled:
            return
        th = threading.current_thread()
        self._events.append(
            (name, cat, th.ident, th.name, time.perf_counter(), None,
             args or None)
        )

    # ---- export ----------------------------------------------------------
    def to_chrome(self) -> Dict[str, object]:
        """Chrome trace-event JSON object (``{"traceEvents": [...]}``)
        for the buffered spans, with thread-name metadata so the
        compactor worker is labelled in the viewer."""
        pid = os.getpid()
        origin = self._origin
        events: List[dict] = []
        tid_names: Dict[int, str] = {}
        for name, cat, tid, tname, t0, dur, args in list(self._events):
            tid_names.setdefault(tid, tname)
            ev = {
                "name": name,
                "cat": cat or "default",
                "ph": "X" if dur is not None else "i",
                "ts": (t0 - origin) * 1e6,  # microseconds
                "pid": pid,
                "tid": tid,
            }
            if dur is not None:
                ev["dur"] = dur * 1e6
            else:
                ev["s"] = "t"  # instant scope: thread
            if args:
                ev["args"] = args
            events.append(ev)
        meta = [
            {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": tname}}
            for tid, tname in sorted(tid_names.items())
        ]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


# the process-wide tracer every instrumented layer records into
TRACER = Tracer()


def span(name: str, cat: str = "", **args):
    return TRACER.span(name, cat, **args)


def instant(name: str, cat: str = "", **args) -> None:
    TRACER.instant(name, cat, **args)
