"""Deterministic fault-injection plane.

Named fault points are woven into the write/restore/compaction/dispatch
paths (``faults.maybe("ckpt.write.torn")``); a seeded `FaultSchedule`
decides — deterministically, per point, by hit count — which calls
actually fire.  With no schedule installed every probe is ONE module
global read and a ``None`` check, so production hot paths (the
one-dispatch read path in particular) pay nothing.

Three ideas keep injections honest:

  1. *Static registry.*  Every fault point is declared here, in
     `FAULT_POINTS`, next to a one-line contract of what firing it
     simulates.  Probing or scheduling an unregistered name raises —
     a renamed weave site cannot silently detach from its tests, and
     the completeness test in ``tests/test_faults.py`` enumerates the
     registry to require every point be fired by at least one test.
  2. *Seeded, counted schedules.*  A `FaultSchedule` maps point names
     to ``(after, times, prob)`` specs.  ``after`` skips the first N
     probes, ``times`` caps total firings, ``prob`` draws from a
     per-point `random.Random(seed)` stream — so a schedule replays
     identically given the same probe order, and chaos sweeps are
     reproducible run to run.
  3. *Every firing observed.*  Firings are counted in the default obs
     metrics registry (``faults.<name>.injected`` + a total) and
     emitted as trace instants, so the bench artifact's
     ``observability.faults`` section can attribute measured
     degradation to the exact injections that caused it.

Typical use::

    from repro_torch import faults

    with faults.inject(faults.FaultSchedule({"compactor.crash": 2})):
        ... exercise the service ...

Scopes nest (the previous schedule is restored on exit).  Schedules are
process-global on purpose: background threads (the compactor worker,
frontend dispatcher) must see the schedule installed by the test
thread.
"""

from __future__ import annotations

import contextlib
import random
import threading
from typing import Dict, Iterator, Mapping, Optional, Union

from .obs import metrics as obs_metrics
from .obs import trace as obs_trace


class InjectedFault(RuntimeError):
    """Raised by `maybe` when a scheduled fault fires.

    Deliberately a `RuntimeError`: fault walls and supervisors must
    treat an injected crash exactly like a real one — nothing in the
    healing paths is allowed to special-case this type.
    """


# ---- the static registry -------------------------------------------------
# name -> one-line contract of the failure the point simulates.  Weave
# sites call maybe()/should() with these exact names; tests enumerate
# this dict to prove completeness.
FAULT_POINTS: Dict[str, str] = {
    "ckpt.write.torn": (
        "checkpoint publishes, then a data file is truncated/corrupted "
        "on disk (torn write / bit rot) — restore must quarantine the "
        "step and fall back to the newest intact one"
    ),
    "ckpt.write.crash": (
        "process dies mid-save, before the atomic publish — only a "
        ".tmp dir remains and restore must ignore it"
    ),
    "compactor.crash": (
        "background compaction worker raises mid-merge — the "
        "supervisor must restart it with backoff and no staged-write "
        "loss"
    ),
    "kernel.dispatch": (
        "a Pallas kernel raises at dispatch — the op must retry once "
        "then stickily fail over to its bit-identical XLA fallback"
    ),
    "router.refit": (
        "router re-fit raises mid-rebalance — the old router must "
        "keep serving and the rebalance abort cleanly"
    ),
    "frontend.queue.delay": (
        "queued requests age past their deadline (scheduling stall) — "
        "dispatch must fail them fast with DeadlineExceeded, not serve "
        "them late"
    ),
}


def register(name: str, description: str) -> str:
    """Declare an extra fault point (extensions / tests).  Idempotent
    only for identical descriptions — two meanings for one name is a
    bug."""
    prev = FAULT_POINTS.get(name)
    if prev is not None and prev != description:
        raise ValueError(f"fault point {name!r} already registered")
    FAULT_POINTS[name] = description
    return name


# ---- schedules -----------------------------------------------------------

class _PointState:
    """Per-point deterministic firing state (guarded by the schedule
    lock)."""

    __slots__ = ("after", "times", "prob", "rng", "probes", "fired")

    def __init__(self, after: int, times: Optional[int], prob: float,
                 seed: int):
        self.after = after
        self.times = times
        self.prob = prob
        self.rng = random.Random(seed)
        self.probes = 0
        self.fired = 0


# spec shorthand: an int N means "fire the first N probes"
Spec = Union[int, Mapping[str, object]]


class FaultSchedule:
    """Seeded, deterministic plan of which probes fire.

    ``plan`` maps fault-point names to either an int (fire that many
    times, starting immediately) or a mapping with any of:

      ``after`` — skip this many probes first (default 0)
      ``times`` — fire at most this many times (default 1; ``None`` =
                  unbounded)
      ``prob``  — fire each eligible probe with this probability,
                  drawn from a per-point seeded stream (default 1.0)

    The same schedule object replays identically for the same probe
    order; `fired` exposes per-point firing counts for assertions.
    """

    def __init__(self, plan: Mapping[str, Spec], seed: int = 0):
        self._lock = threading.Lock()
        self._points: Dict[str, _PointState] = {}
        for i, (name, spec) in enumerate(sorted(plan.items())):
            if name not in FAULT_POINTS:
                raise KeyError(
                    f"unknown fault point {name!r}; register it in "
                    "repro_torch.faults.FAULT_POINTS"
                )
            if isinstance(spec, int):
                spec = {"times": spec}
            self._points[name] = _PointState(
                after=int(spec.get("after", 0)),
                times=(None if spec.get("times", 1) is None
                       else int(spec.get("times", 1))),
                prob=float(spec.get("prob", 1.0)),
                seed=seed * 1_000_003 + i,
            )

    def should(self, name: str) -> bool:
        """One probe of ``name``: True iff this probe fires.  Unknown
        or unscheduled names never fire (but unknown names are rejected
        at the module-level probe, which validates the registry)."""
        st = self._points.get(name)
        if st is None:
            return False
        with self._lock:
            st.probes += 1
            if st.probes <= st.after:
                return False
            if st.times is not None and st.fired >= st.times:
                return False
            if st.prob < 1.0 and st.rng.random() >= st.prob:
                return False
            st.fired += 1
            return True

    @property
    def fired(self) -> Dict[str, int]:
        """Per-point firing counts so far (only scheduled points)."""
        with self._lock:
            return {n: s.fired for n, s in self._points.items()}

    @property
    def probes(self) -> Dict[str, int]:
        with self._lock:
            return {n: s.probes for n, s in self._points.items()}


# ---- the process-global active schedule ----------------------------------
# Deliberately NOT thread-local: the thread installing a schedule (a
# test, the fault sweep) is never the only thread that must see it —
# compactor workers and the frontend dispatcher probe too.
_ACTIVE: Optional[FaultSchedule] = None


def active() -> Optional[FaultSchedule]:
    return _ACTIVE


@contextlib.contextmanager
def inject(schedule: FaultSchedule) -> Iterator[FaultSchedule]:
    """Install ``schedule`` for the dynamic extent of the block.
    Nests; the previous schedule (usually ``None``) is restored on
    exit, even on error — chaos must not leak between tests."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = schedule
    try:
        yield schedule
    finally:
        _ACTIVE = prev


def _record(name: str) -> None:
    reg = obs_metrics.default_registry()
    reg.counter(f"faults.{name}.injected").add(1)
    reg.counter("faults.injected_total").add(1)
    obs_trace.instant(f"fault.{name}", cat="fault")


def should(name: str) -> bool:
    """Probe fault point ``name``; True iff a scheduled fault fires
    now.  For weave sites that simulate the failure themselves (e.g.
    corrupting a file) rather than raising."""
    sched = _ACTIVE
    if sched is None:
        return False
    if name not in FAULT_POINTS:
        raise KeyError(f"unregistered fault point {name!r}")
    if not sched.should(name):
        return False
    _record(name)
    return True


def maybe(name: str, exc: type = InjectedFault) -> None:
    """Probe fault point ``name`` and raise ``exc`` if it fires.  The
    common weave-site form: one line, zero cost when disabled."""
    if _ACTIVE is None:
        return
    if should(name):
        raise exc(f"injected fault: {name}")
