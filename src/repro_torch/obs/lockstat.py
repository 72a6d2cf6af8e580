"""Runtime lock-order sanitizer: instrumented locks + deadlock detection.

The static lock-discipline pass (``tools/lixlint``) proves that guarded
state is only touched under its declared lock; it cannot prove that two
locks are always taken in a consistent *order*.  That is a runtime
property, so this module provides the runtime half of the contract:

  * ``make_lock(name)`` — the factory every service uses to create its
    re-entrant lock.  When the sanitizer is disabled (the default) it
    returns a plain ``threading.RLock`` with zero overhead.  When
    enabled (tests), it returns a :class:`TrackedLock` that records,
    per thread, the stack of held locks and adds a ``held -> acquiring``
    edge to a process-wide acquisition-order graph on every acquire.
  * ``assert_acyclic()`` — fails if the recorded graph contains a cycle
    (two threads that interleave badly could deadlock, even if this
    particular run got lucky).

``TrackedLock`` is a drop-in for ``threading.RLock`` including the
private ``_is_owned`` / ``_release_save`` / ``_acquire_restore`` hooks
``threading.Condition`` needs, so ``Condition(make_lock("q"))`` works
and a ``cond.wait()`` correctly pops the held-stack while sleeping.

Enabled by ``tests/test_frontend.py`` / ``tests/test_lixlint.py`` around
frontend + compaction + rebalance churn; see ``enable`` / ``disable``.
"""

from __future__ import annotations

import threading
from typing import TYPE_CHECKING, Dict, List, Optional, Set, Tuple, Union

if TYPE_CHECKING:  # threading.RLock is a factory fn, not a type
    from _thread import RLock as _NativeRLock

__all__ = [
    "TrackedLock",
    "make_lock",
    "enable",
    "disable",
    "enabled",
    "reset",
    "order_graph",
    "find_cycle",
    "assert_acyclic",
    "LockOrderError",
]


class LockOrderError(AssertionError):
    """Raised by :func:`assert_acyclic` when the order graph has a cycle."""


_ENABLED = False

# Process-wide acquisition-order graph: edge (a, b) means some thread
# acquired lock b while already holding lock a.  Guarded by _GRAPH_LOCK
# (a leaf lock: never held while acquiring a tracked lock).
_GRAPH_LOCK = threading.Lock()
_EDGES: Dict[str, Set[str]] = {}
_EDGE_SITES: Dict[Tuple[str, str], int] = {}

# Per-thread stack of held TrackedLock names (outermost first).  A
# re-entrant re-acquire does not push a second entry.
_TLS = threading.local()


def _held_stack() -> List[str]:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = []
        _TLS.stack = stack
    return stack


class TrackedLock:
    """``threading.RLock`` wrapper that records acquisition order.

    Only the *first* (non-re-entrant) acquire on a thread records edges
    and pushes onto the held-stack; nested re-acquires of the same
    re-entrant lock are order-neutral.
    """

    def __init__(self, name: str) -> None:
        self.name = name
        self._inner = threading.RLock()

    # -- core acquire/release ------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        stack = _held_stack()
        first = self.name not in stack
        if first and stack:
            with _GRAPH_LOCK:
                for held in stack:
                    _EDGES.setdefault(held, set()).add(self.name)
                    key = (held, self.name)
                    _EDGE_SITES[key] = _EDGE_SITES.get(key, 0) + 1
        ok = self._inner.acquire(blocking, timeout)
        if ok and first:
            stack.append(self.name)
        return ok

    def release(self) -> None:
        self._inner.release()
        # Only pop when the lock is fully released by this thread.
        if not self._inner._is_owned():  # type: ignore[attr-defined]
            stack = _held_stack()
            if self.name in stack:
                stack.remove(self.name)

    __enter__ = acquire

    def __exit__(self, *exc: object) -> None:
        self.release()

    # -- threading.Condition compatibility -----------------------------

    def _is_owned(self) -> bool:
        return bool(self._inner._is_owned())  # type: ignore[attr-defined]

    def _release_save(self) -> object:
        # Condition.wait: fully release (even if re-entered) and drop
        # from the held-stack while the thread sleeps.
        state = self._inner._release_save()  # type: ignore[attr-defined]
        stack = _held_stack()
        if self.name in stack:
            stack.remove(self.name)
        return state

    def _acquire_restore(self, state: object) -> None:
        stack = _held_stack()
        if stack:
            with _GRAPH_LOCK:
                for held in stack:
                    _EDGES.setdefault(held, set()).add(self.name)
                    key = (held, self.name)
                    _EDGE_SITES[key] = _EDGE_SITES.get(key, 0) + 1
        self._inner._acquire_restore(state)  # type: ignore[attr-defined]
        if self.name not in stack:
            stack.append(self.name)

    def __repr__(self) -> str:
        return f"TrackedLock({self.name!r})"


LockLike = Union["TrackedLock", "_NativeRLock"]


def make_lock(name: str) -> LockLike:
    """Create a service lock; tracked iff the sanitizer is enabled."""
    if _ENABLED:
        return TrackedLock(name)
    return threading.RLock()


def enable() -> None:
    """Turn the sanitizer on for subsequently created locks."""
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


def reset() -> None:
    """Drop all recorded edges (does not touch live locks)."""
    with _GRAPH_LOCK:
        _EDGES.clear()
        _EDGE_SITES.clear()


def order_graph() -> Dict[str, Set[str]]:
    """Snapshot of the acquisition-order graph (edge a->b: b under a)."""
    with _GRAPH_LOCK:
        return {a: set(bs) for a, bs in _EDGES.items()}


def find_cycle(graph: Optional[Dict[str, Set[str]]] = None) -> Optional[List[str]]:
    """Return one cycle as a node list ``[a, b, ..., a]``, or None."""
    g = order_graph() if graph is None else graph
    WHITE, GREY, BLACK = 0, 1, 2
    color: Dict[str, int] = {}
    parent: Dict[str, str] = {}

    def visit(node: str) -> Optional[List[str]]:
        color[node] = GREY
        for nxt in sorted(g.get(node, ())):
            c = color.get(nxt, WHITE)
            if c == GREY:
                cycle = [nxt, node]
                cur = node
                while cur != nxt:
                    cur = parent[cur]
                    cycle.append(cur)
                cycle.reverse()
                return cycle
            if c == WHITE:
                parent[nxt] = node
                found = visit(nxt)
                if found is not None:
                    return found
        color[node] = BLACK
        return None

    for start in sorted(g):
        if color.get(start, WHITE) == WHITE:
            found = visit(start)
            if found is not None:
                return found
    return None


def assert_acyclic() -> None:
    """Fail with :class:`LockOrderError` if the recorded graph has a cycle."""
    cycle = find_cycle()
    if cycle is not None:
        raise LockOrderError(
            "lock acquisition-order cycle (deadlock potential): "
            + " -> ".join(cycle)
        )
