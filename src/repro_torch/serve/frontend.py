"""Concurrent multi-tenant serving front end over the writable index
(the reference's `repro.serve.frontend`, with the port's services).

Promotes the index from a single-tenant library into a service shape
that could face many concurrent clients: client threads submit
``get`` / ``contains`` / ``insert`` / ``delete`` / ``scan`` /
``range`` requests into a BOUNDED admission queue; one dispatcher loop
drains the queue a round at a time and **coalesces** same-kind
requests from many tenants into the services' existing one-dispatch
batched ops (`IndexService` / `ShardedIndexService.get`, `contains`,
`scan_batch`, vectorized `insert`/`delete`).  N clients' point reads
cost ONE device dispatch per round, not N.

Contracts:

  * **Admission control / backpressure** — `submit` blocks while the
    queue is full and raises `Backpressure` after a timeout instead of
    letting a raw ``MemoryError``/unbounded queue growth reach the
    caller.  Queue depth and rejections are metered.
  * **Read-your-writes** — a round applies its writes (in arrival
    order, adjacent same-kind runs coalesced) BEFORE its reads, and a
    blocking client's next read enters a later round than its
    acknowledged write; both orders land on the service's locked
    capture, so reads observe every acknowledged write across delta
    freezes, snapshot swaps, and compaction stalls.
  * **Graceful degradation** — when the write path degrades (delta
    full with compaction stalled below ``min_keys``, or allocation
    failure), the affected write requests fail with `WriteShed` and
    are counted, while reads keep serving from the pinned merged view;
    the dispatcher never dies with the stall.
  * **Per-tenant observability** — every tenant gets its own
    `MetricsRegistry` with end-to-end (enqueue→result) latency
    histograms per op kind plus request/error/shed counters; the
    frontend aggregates the same per-kind histograms for SLO checks
    (`serving_summary` reports per-tenant p50/p99 rows and a p99-vs-SLO
    pass/fail the benchmark artifact records).

The dispatcher pads coalesced read batches to quarter-pow2 buckets
(`scan._pad_bucket`) before hitting the device path, so varying
coalesced sizes land on a handful of batch shapes instead of a new one
per round.

Threading: the service loop is ONE thread (`start`), so service calls
never race each other; the underlying services stay free to run their
own background compactions.  For deterministic tests the loop can be
driven synchronously instead via `pump()` (one round on the calling
thread — dispatch-count windows wrap it directly, since dispatch
counters are thread-local).
"""

from __future__ import annotations

import collections
import dataclasses
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import faults
from repro_torch.index_service.scan import _pad_bucket
from repro_torch.obs import lockstat
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.export import op_latency_rows
from repro_torch.obs.metrics import MetricsRegistry


class Backpressure(RuntimeError):
    """Admission queue full: the client should back off and retry."""


class WriteShed(RuntimeError):
    """Write shed under degraded conditions (compaction stall /
    allocation failure); reads keep serving.  Retryable."""


class DeadlineExceeded(TimeoutError):
    """The request aged past its deadline while queued: failed fast at
    dispatch instead of being served late (a late answer is a wrong
    answer to an SLO).  Retryable once load drops."""


READ_KINDS = ("get", "contains", "range", "scan")
WRITE_KINDS = ("insert", "delete")
KINDS = WRITE_KINDS + READ_KINDS

# The degradation ladder, healthiest first.  Each state names what the
# frontend still guarantees, and drives admission:
#
#   HEALTHY          — full service.
#   DEGRADED_WRITES  — recent rounds shed writes (compaction stall /
#                      allocation pressure): writes are still ATTEMPTED
#                      (the service decides per batch) but callers
#                      should expect `WriteShed`; reads unaffected.
#   STALE_READS      — a compactor supervisor gave up (escalated):
#                      merges have stopped, so accepted writes could
#                      only pile up against a delta that will not
#                      drain.  Writes fail fast with `WriteShed` at
#                      admission; reads keep serving (growing staler
#                      relative to the un-merged backlog).
#   UNAVAILABLE      — consecutive whole-round read failures: the
#                      service itself is failing.  Everything is
#                      rejected with `Backpressure`; the dispatcher
#                      keeps probing the service and the ladder climbs
#                      back up as soon as a probe succeeds.
HEALTH_STATES = (
    "HEALTHY", "DEGRADED_WRITES", "STALE_READS", "UNAVAILABLE",
)
HEALTHY, DEGRADED_WRITES, STALE_READS, UNAVAILABLE = HEALTH_STATES


def retry_with_backoff(
    fn: Callable,
    *,
    attempts: int = 5,
    base_s: float = 0.01,
    cap_s: float = 1.0,
    retry_on: tuple = (Backpressure,),
    jitter: float = 0.5,
    rng: Optional[random.Random] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> object:
    """Call ``fn`` under bounded exponential backoff with jitter: the
    client-side half of admission control.  Retries only ``retry_on``
    (default `Backpressure` — `WriteShed` and `DeadlineExceeded` are
    for the caller to decide), doubling the delay per attempt up to
    ``cap_s``, with multiplicative jitter so N backing-off clients
    don't re-stampede in phase.  ``rng`` and ``sleep`` are injectable
    for deterministic tests.  Raises the last error after ``attempts``
    tries."""
    if attempts < 1:
        raise ValueError("attempts must be >= 1")
    rng = rng or random.Random()
    last: Optional[BaseException] = None
    for a in range(attempts):
        try:
            return fn()
        except retry_on as e:
            last = e
            if a == attempts - 1:
                break
            delay = min(cap_s, base_s * (2.0 ** a))
            sleep(delay * (1.0 + jitter * rng.random()))
    assert last is not None
    raise last


@dataclasses.dataclass
class FrontendConfig:
    max_queue: int = 1024          # bounded admission queue (requests)
    max_round: int = 256           # requests coalesced per round
    submit_timeout_s: float = 5.0  # block this long for queue room
    scan_page_size: int = 256
    slo_p99_ms: float = 50.0       # read-path p99 target for summaries
    pad_reads: bool = True         # bucket-pad coalesced read batches
    # synchronous-client default: how long get/insert/... block on the
    # pending request before raising TimeoutError (pass timeout=None
    # explicitly to wait forever)
    default_timeout_s: Optional[float] = 60.0
    # queue-age deadline enforced at DISPATCH: a request older than
    # this when the round starts fails fast with `DeadlineExceeded`
    # instead of being served late (None disables)
    request_deadline_s: Optional[float] = 30.0
    # consecutive all-reads-failed rounds before the ladder drops to
    # UNAVAILABLE and admission closes
    unavailable_after: int = 3


@dataclasses.dataclass
class ServeRequest:
    tenant: str
    kind: str
    args: tuple
    enqueued_at: float
    event: threading.Event = dataclasses.field(
        default_factory=threading.Event
    )
    result: object = None
    error: Optional[BaseException] = None

    def wait(self, timeout: Optional[float] = None):
        if not self.event.wait(timeout):
            raise TimeoutError(
                f"{self.kind} request for tenant {self.tenant!r} still "
                f"queued after {timeout}s"
            )
        if self.error is not None:
            raise self.error
        return self.result


class _Tenant:
    """Per-tenant observability: own registry, per-kind end-to-end
    latency histograms, request/error/shed counters."""

    __slots__ = ("name", "registry", "hist", "requests", "errors", "shed")

    def __init__(self, name: str):
        self.name = name
        self.registry = MetricsRegistry(f"tenant.{name}")
        self.hist = {
            k: self.registry.histogram(f"op.{k}.latency_s") for k in KINDS
        }
        self.requests = self.registry.counter("requests")
        self.errors = self.registry.counter("errors")
        self.shed = self.registry.counter("shed_writes")


class IndexFrontend:
    """Coalescing multi-tenant front end over one `IndexService` or
    `ShardedIndexService` (anything with the batched op surface)."""

    def __init__(
        self,
        service,
        config: Optional[FrontendConfig] = None,
        *,
        metrics: Optional[MetricsRegistry] = None,
    ):
        self.service = service
        self.config = config or FrontendConfig()
        self.metrics = metrics if metrics is not None else MetricsRegistry(
            "frontend"
        )
        self._queue: collections.deque = collections.deque()  # guarded-by: _cond
        self._cond = threading.Condition(lockstat.make_lock("frontend._cond"))
        self._tenants: Dict[str, _Tenant] = {}  # guarded-by: _tenants_lock
        self._tenants_lock = lockstat.make_lock("frontend._tenants")
        self._worker: Optional[threading.Thread] = None
        self._stopping = False  # guarded-by: _cond
        self._rounds_ctr = self.metrics.counter("frontend.rounds")
        self._enq_ctr = self.metrics.counter("frontend.enqueued")
        self._rej_ctr = self.metrics.counter("frontend.rejected")
        self._shed_ctr = self.metrics.counter("frontend.shed_writes")
        self._applied_ctr = self.metrics.counter("frontend.writes_applied")
        self._depth_gauge = self.metrics.gauge("frontend.queue_depth")
        self._deadline_ctr = self.metrics.counter("frontend.deadline_exceeded")
        self._probe_fail_ctr = self.metrics.counter("frontend.probe_failures")
        # degradation-ladder evidence.  Written by the single dispatcher
        # thread (pump); racy integer reads from client threads in
        # health() are tolerated — the ladder is advisory admission
        # control, one round of slack is fine.
        # lixlint: unsynchronized(dispatcher writes, racy reads tolerated)
        self._consec_read_fail_rounds = 0
        # lixlint: unsynchronized(dispatcher writes, racy reads tolerated)
        self._consec_shed_rounds = 0
        # lixlint: unsynchronized(dispatcher-only)
        self._last_health = HEALTHY
        self._round_hist = self.metrics.histogram("op.round.latency_s")
        self._coalesce_hist = self.metrics.histogram(
            "frontend.requests_per_round", edges=[1, 2, 4, 8, 16, 32, 64,
                                                  128, 256, 512, 1024]
        )
        # frontend-level end-to-end latency per kind (across tenants):
        # the SLO check and the benchmark artifact read these
        self._hist = {
            k: self.metrics.histogram(f"op.{k}.latency_s") for k in KINDS
        }

    # ---- lifecycle -------------------------------------------------------
    def start(self) -> "IndexFrontend":
        if self._worker is not None:
            raise RuntimeError("frontend already started")
        with self._cond:
            self._stopping = False
        # lixlint: unsynchronized(start/stop run on the owner thread only)
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()
        return self

    def stop(self) -> None:
        """Drain the queue, then stop the dispatcher."""
        w = self._worker
        if w is None:
            return
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        w.join()
        # lixlint: unsynchronized(start/stop run on the owner thread only)
        self._worker = None

    def __enter__(self) -> "IndexFrontend":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---- client surface --------------------------------------------------
    def tenant(self, name: str) -> _Tenant:
        with self._tenants_lock:
            t = self._tenants.get(name)
            if t is None:
                t = self._tenants[name] = _Tenant(name)
            return t

    def submit(self, tenant: str, kind: str, *args,
               timeout: Optional[float] = None) -> ServeRequest:
        """Enqueue one request (admission-controlled); returns the
        pending `ServeRequest` — call ``.wait()`` for the result."""
        if kind not in KINDS:
            raise ValueError(f"unknown op kind {kind!r}")
        t = self.tenant(tenant)  # registries exist from first contact
        state = self.health()
        if state == UNAVAILABLE:
            self._rej_ctr.add(1)
            raise Backpressure(
                "frontend UNAVAILABLE (consecutive read-round failures) "
                "— admission closed until a recovery probe succeeds"
            )
        if state == STALE_READS and kind in WRITE_KINDS:
            # merges have stopped (compactor escalated): a queued write
            # could only pile onto a delta that will not drain.  Fail
            # fast here instead of timing out in the queue.
            self._shed_ctr.add(1)
            t.shed.add(1)
            raise WriteShed(
                "compactor escalated: writes fail fast at admission "
                "while reads keep serving (stale)"
            )
        req = ServeRequest(tenant, kind, args, time.perf_counter())
        deadline = time.perf_counter() + (
            self.config.submit_timeout_s if timeout is None else timeout
        )
        with self._cond:
            while len(self._queue) >= self.config.max_queue:
                remaining = deadline - time.perf_counter()
                if remaining <= 0 or self._stopping:
                    self._rej_ctr.add(1)
                    raise Backpressure(
                        f"admission queue full ({self.config.max_queue} "
                        "requests) — back off and retry"
                    )
                self._cond.wait(remaining)
            self._queue.append(req)
            self._enq_ctr.add(1)
            self._depth_gauge.set(len(self._queue))
            self._cond.notify_all()
        return req

    _UNSET = object()  # distinguishes "use config default" from "wait forever"

    def _call(self, tenant, kind, *args, timeout=_UNSET):
        if timeout is IndexFrontend._UNSET:
            timeout = self.config.default_timeout_s
        return self.submit(tenant, kind, *args).wait(timeout)

    def get(self, tenant: str, keys, **kw) -> Tuple[np.ndarray, np.ndarray]:
        return self._call(tenant, "get",
                          np.atleast_1d(np.asarray(keys, np.float64)), **kw)

    def contains(self, tenant: str, keys, **kw) -> np.ndarray:
        return self._call(tenant, "contains",
                          np.atleast_1d(np.asarray(keys, np.float64)), **kw)

    def range_lookup(self, tenant: str, lo: float, hi: float, **kw):
        return self._call(tenant, "range", float(lo), float(hi), **kw)

    def scan(self, tenant: str, lo: float, hi: float,
             page_size: Optional[int] = None, **kw):
        return self._call(
            tenant, "scan", float(lo), float(hi),
            int(page_size or self.config.scan_page_size), **kw)

    def insert(self, tenant: str, keys, vals=None, **kw) -> int:
        q = np.atleast_1d(np.asarray(keys, np.float64))
        v = (np.zeros(q.shape, np.int64) if vals is None
             else np.atleast_1d(np.asarray(vals, np.int64)))
        return self._call(tenant, "insert", q, v, **kw)

    def delete(self, tenant: str, keys, **kw) -> int:
        return self._call(tenant, "delete",
                          np.atleast_1d(np.asarray(keys, np.float64)), **kw)

    # ---- health ladder ---------------------------------------------------
    def health(self) -> str:
        """Current degradation-ladder state, computed from evidence (not
        stored — no transition can be missed between rounds)."""
        if (self._consec_read_fail_rounds
                >= max(1, self.config.unavailable_after)):
            return UNAVAILABLE
        if bool(getattr(self.service, "compactor_escalated", False)):
            return STALE_READS
        if self._consec_shed_rounds > 0:
            return DEGRADED_WRITES
        return HEALTHY

    def _probe_service(self) -> bool:
        """UNAVAILABLE-state recovery probe: one tiny read against the
        service.  Success climbs the ladder back up immediately."""
        try:
            self.service.contains(np.array([0.0]))
        except BaseException:  # fault-wall: probe failure keeps UNAVAILABLE
            self._probe_fail_ctr.add(1)
            return False
        # lixlint: unsynchronized(dispatcher-only store; racy reads tolerated)
        self._consec_read_fail_rounds = 0
        obs_trace.instant("frontend.recovered", cat="serve")
        return True

    # ---- dispatcher ------------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._cond:
                if not self._queue and not self._stopping:
                    self._cond.wait(0.1)
                if not self._queue and self._stopping:
                    return
                have = bool(self._queue)
            if have:
                self.pump()
            elif self.health() == UNAVAILABLE:
                # idle + UNAVAILABLE: keep probing so the ladder can
                # climb back up even though admission rejects new work
                self._probe_service()

    def pump(self, max_requests: Optional[int] = None) -> int:
        """Process ONE round synchronously on the calling thread:
        drain up to ``max_round`` queued requests, coalesce, serve.
        The dispatcher thread calls this in a loop; tests call it
        directly so dispatch-count windows wrap the device work."""
        batch: List[ServeRequest] = []
        limit = max_requests or self.config.max_round
        with self._cond:
            while self._queue and len(batch) < limit:
                batch.append(self._queue.popleft())
            self._depth_gauge.set(len(self._queue))
            self._cond.notify_all()  # wake submitters blocked on room
        if not batch:
            if self.health() == UNAVAILABLE:
                self._probe_service()
            return 0
        # deadline check at DISPATCH time: requests that aged out while
        # queued fail fast — a late answer is a wrong answer to an SLO.
        # The injected form of a scheduling stall backdates the whole
        # batch past its deadline (deterministic, no sleeping).
        ddl = self.config.request_deadline_s
        now = time.perf_counter()
        if ddl is not None and faults.should("frontend.queue.delay"):
            for r in batch:
                r.enqueued_at = now - ddl - 1.0
        expired: List[ServeRequest] = []
        if ddl is not None:
            live: List[ServeRequest] = []
            for r in batch:
                age = now - r.enqueued_at
                if age > ddl:
                    r.error = DeadlineExceeded(
                        f"{r.kind} request queued {age:.3f}s past its "
                        f"{ddl}s deadline"
                    )
                    expired.append(r)
                else:
                    live.append(r)
            if expired:
                self._deadline_ctr.add(len(expired))
                obs_trace.instant("frontend.deadline_exceeded",
                                  cat="serve", n=len(expired))
            batch = live
        if batch:
            self._rounds_ctr.add(1)
            self._coalesce_hist.observe(len(batch))
            with obs_trace.span("frontend.round", cat="serve",
                                requests=len(batch)), self._round_hist.time():
                self._round(batch)
            self._observe_round(batch)
        now = time.perf_counter()
        for r in batch + expired:
            t = self.tenant(r.tenant)
            dt = now - r.enqueued_at
            t.requests.add(1)
            t.hist[r.kind].observe(dt)
            self._hist[r.kind].observe(dt)
            if r.error is not None:
                (t.shed if isinstance(r.error, WriteShed) else t.errors).add(1)
            r.event.set()
        state = self.health()
        if state != self._last_health:
            obs_trace.instant("frontend.health", cat="serve",
                              state=state, prev=self._last_health)
            self.metrics.counter(f"frontend.health.{state}").add(1)
            # lixlint: unsynchronized(dispatcher-only store)
            self._last_health = state
        return len(batch) + len(expired)

    def _observe_round(self, batch: List[ServeRequest]) -> None:
        """Fold one served round into the degradation-ladder evidence:
        all-reads-failed rounds push toward UNAVAILABLE; shed writes
        mark DEGRADED_WRITES until a write run applies cleanly."""
        reads = [r for r in batch if r.kind in READ_KINDS]
        if reads:
            hard_fail = all(
                r.error is not None and not isinstance(r.error, WriteShed)
                for r in reads
            )
            if hard_fail:
                # lixlint: unsynchronized(dispatcher-only store; racy reads tolerated)
                self._consec_read_fail_rounds += 1
            else:
                # lixlint: unsynchronized(dispatcher-only store; racy reads tolerated)
                self._consec_read_fail_rounds = 0
        writes = [r for r in batch if r.kind in WRITE_KINDS]
        if writes:
            if any(isinstance(r.error, WriteShed) for r in writes):
                # lixlint: unsynchronized(dispatcher-only store; racy reads tolerated)
                self._consec_shed_rounds += 1
            elif all(r.error is None for r in writes):
                # lixlint: unsynchronized(dispatcher-only store; racy reads tolerated)
                self._consec_shed_rounds = 0

    # ---- one coalesced round ---------------------------------------------
    def _round(self, batch: List[ServeRequest]) -> None:
        # writes FIRST (read-your-writes for same-round pipelining),
        # in arrival order with adjacent same-kind runs coalesced so
        # insert→delete→insert interleavings keep their semantics
        writes = [r for r in batch if r.kind in WRITE_KINDS]
        reads = [r for r in batch if r.kind in READ_KINDS]
        i = 0
        while i < len(writes):
            j = i
            while j < len(writes) and writes[j].kind == writes[i].kind:
                j += 1
            self._apply_writes(writes[i].kind, writes[i:j])
            i = j
        by_kind: Dict[str, List[ServeRequest]] = {}
        for r in reads:
            by_kind.setdefault(r.kind, []).append(r)
        if "get" in by_kind:
            self._apply_keyed(by_kind["get"], self.service.get,
                              split=lambda out, sl: (out[0][sl], out[1][sl]))
        if "contains" in by_kind:
            self._apply_keyed(by_kind["contains"], self.service.contains,
                              split=lambda out, sl: out[sl])
        for r in by_kind.get("range", ()):
            try:
                r.result = self.service.range_lookup(*r.args)
            except BaseException as e:  # fault-wall: per-request — error lands on this request, round survives
                r.error = e
        for r in by_kind.get("scan", ()):
            try:
                lo, hi, page = r.args
                r.result = self.service.scan_batch(lo, hi, page)
            except BaseException as e:  # fault-wall: per-request — error lands on this request, round survives
                r.error = e

    def _apply_writes(self, kind: str, run: List[ServeRequest]) -> None:
        """One coalesced service call for a run of same-kind writes.
        `stage_insert_many` is last-write-wins over in-batch duplicate
        keys, so cross-tenant concatenation preserves arrival order."""
        keys = np.concatenate([r.args[0] for r in run])
        try:
            if kind == "insert":
                vals = np.concatenate([r.args[1] for r in run])
                applied = self.service.insert(keys, vals)
            else:
                applied = self.service.delete(keys)
            self._applied_ctr.add(int(applied))
            for r in run:
                # per-request ack: its keys are staged; batch-level
                # applied count lands in frontend.writes_applied
                r.result = int(r.args[0].size)
        except (OverflowError, MemoryError) as e:
            # degraded mode (compaction stalled below min_keys with a
            # full delta, or allocation failure): shed THESE writes,
            # keep the dispatcher alive — reads continue from the
            # pinned merged view
            self._shed_ctr.add(len(run))
            shed = WriteShed(f"write shed: {e}")
            shed.__cause__ = e
            for r in run:
                r.error = shed
        except BaseException as e:  # fault-wall: per-run — the write run fails, the dispatcher survives
            for r in run:
                r.error = e

    def _apply_keyed(self, run: List[ServeRequest], op, split) -> None:
        """Coalesce keyed point reads into ONE batched service call,
        padding to a quarter-pow2 bucket so round-to-round size jitter
        reuses a handful of batch shapes."""
        sizes = [r.args[0].size for r in run]
        q = np.concatenate([r.args[0] for r in run])
        n = q.size
        if self.config.pad_reads and n:
            padded = _pad_bucket(n)
            if padded > n:
                q = np.concatenate([q, np.full(padded - n, q[-1])])
        try:
            out = op(q)
        except BaseException as e:  # fault-wall: per-batch — coalesced reads fail together, dispatcher survives
            for r in run:
                r.error = e
            return
        pos = 0
        for r, size in zip(run, sizes):
            r.result = split(out, slice(pos, pos + size))
            pos += size

    # ---- reporting -------------------------------------------------------
    def tenant_latency_rows(self) -> Dict[str, Dict[str, Dict[str, float]]]:
        with self._tenants_lock:
            tenants = dict(self._tenants)
        return {
            name: op_latency_rows(t.registry) for name, t in tenants.items()
        }

    def serving_summary(
        self, slo_p99_ms: Optional[float] = None
    ) -> Dict[str, object]:
        """Per-tenant p50/p99 rows + the read-path SLO verdict: pass
        iff every read kind's frontend-level p99 is within the SLO."""
        slo = self.config.slo_p99_ms if slo_p99_ms is None else slo_p99_ms
        read_p99 = {
            k: self._hist[k].percentile(99) * 1e3
            for k in READ_KINDS if self._hist[k].count
        }
        worst = max(read_p99.values(), default=0.0)
        with self._tenants_lock:
            tenants = dict(self._tenants)
        return {
            "health": self.health(),
            "slo_p99_ms": slo,
            "slo_pass": bool(worst <= slo),
            "worst_read_p99_ms": round(worst, 3),
            "read_p99_ms": {k: round(v, 3) for k, v in read_p99.items()},
            "rounds": int(self._rounds_ctr.value),
            "requests": int(self._enq_ctr.value),
            "rejected": int(self._rej_ctr.value),
            "shed_writes": int(self._shed_ctr.value),
            "deadline_exceeded": int(self._deadline_ctr.value),
            "probe_failures": int(self._probe_fail_ctr.value),
            "tenants": {
                name: {
                    "requests": int(t.requests.value),
                    "errors": int(t.errors.value),
                    "shed_writes": int(t.shed.value),
                    "ops": op_latency_rows(t.registry),
                }
                for name, t in tenants.items()
            },
        }
