"""Writable learned-index service: batched mixed-op front end.

Composes the subsystem: a versioned base snapshot (RMI + sorted keys),
an active delta buffer absorbing writes, a stack of frozen deltas
mid-compaction, and a compactor that publishes successor snapshots
through the version manager's atomic swap — on a background thread when
configured, so reads and writes keep flowing while the RMI
warm-rebuilds.  The snapshot's tensors live on the service's device
(``device=None`` means "cuda"); with ``strategy="cuda_fused"`` every
read is one launch of the fused CUDA lookup kernel.

Request routing (paper section in parentheses):

  * ``get`` / ``range_lookup``  — RMI bounded search over the base (§3)
    fused with one branchless binary search over the staged delta, then
    an exact host refinement (float32-collision proof);
  * ``contains``                — delta levels are consulted exactly;
    the rest goes through the same exact rank path;
  * ``insert`` / ``delete``     — staged into the active delta (§3.3's
    open problem, LSM-style); compaction merges them into the next
    snapshot version;
  * ``scan`` / ``scan_batch``   — merged range scans: exact float64
    pages from a pinned view on the host, or every page of a range in
    one launch of the fused scan kernel.

Every public op records count/latency; ``stats_summary()`` reports
ns/op, hit rates and compaction telemetry.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.rmi import RMIConfig
from repro_torch.obs import lockstat
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import MetricsRegistry, StatsView
from repro_torch.index_service.compact import (
    CompactionStall,
    CompactionStats,
    Compactor,
)
from repro_torch.index_service.delta import (
    DeltaBuffer,
    collapse_levels,
    count_less,
    iter_levels,
    live_mask,
    member,
)
from repro_torch.index_service.plane import DevicePlane, scan_plane_key
from repro_torch.index_service.scan import (
    PinnedView,
    pin_view,
    scan_page_bound,
    scan_pages,
)
from repro_torch.index_service.snapshot import (
    VersionManager,
    build_snapshot,
    validate_strategy,
)


@dataclasses.dataclass
class ServiceConfig:
    delta_capacity: int = 4096       # staged entries the active delta holds
    compact_fraction: float = 0.75   # delta fill that triggers compaction
    bloom_fpr: Optional[float] = None  # must stay None: not ported yet
    strategy: str = "binary"         # any member of snapshot.MERGED_STRATEGIES
    background: bool = False         # compact on a worker thread
    snapshot_dir: Optional[str] = None
    keep_snapshots: int = 2
    rmi: Optional[RMIConfig] = None  # None = linear stage-0 sized to n
    # write-rate-aware compaction: with gain > 0, the fill-fraction
    # trigger scales DOWN as the write-rate EWMA rises, so hot shards
    # compact earlier (smaller merges, fresher RMIs) while cold shards
    # keep batching up to compact_fraction.  The effective trigger is
    #   compact_fraction * (1 - gain * ewma / (ewma + capacity/8))
    # floored at compact_rate_floor.  gain = 0 keeps the rate-blind
    # behaviour.
    compact_rate_gain: float = 0.0
    compact_rate_floor: float = 0.2
    # leveled compaction: how many frozen delta levels may pile up
    # before a merge into the base is forced.  1 (the default) keeps
    # the historical freeze-then-compact-immediately behaviour; larger
    # values turn most capacity fills into an O(1) freeze (bounded
    # write stall) and amortize the O(n) merge over L fills.
    max_delta_levels: int = 1
    # compactor supervision: a crashed merge attempt is retried with
    # capped exponential backoff; this many CONSECUTIVE failures stop
    # the retries, surface the error to the next writer, and escalate
    # service health (`compactor_escalated`) so the serving tier can
    # shed writes instead of queueing against a dead compactor.
    compact_max_failures: int = 3
    compact_backoff_s: float = 0.05
    compact_backoff_cap_s: float = 2.0


def _default_rmi(n: int) -> RMIConfig:
    return RMIConfig(
        num_leaves=max(16, n // 64), stage0_hidden=(), stage0_train_steps=0
    )


# Every public service op with per-op latency instrumentation: each has
# a counter group in ``stats`` and an ``op.<name>.latency_s`` histogram
# in the service registry.
INSTRUMENTED_OPS: Tuple[str, ...] = (
    "get", "contains", "range", "insert", "delete", "scan",
    "lookup_batch", "scan_batch",
)

_STATS_KEYS: Tuple[str, ...] = (
    "get", "get_s", "get_hits",
    "contains", "contains_s", "contains_hits",
    "range", "range_s",
    "insert", "insert_s", "insert_applied",
    "delete", "delete_s", "delete_applied",
    "scan", "scan_s", "scan_pages", "scan_rows",
    "lookup_batch", "lookup_batch_s",
    "scan_batch", "scan_batch_s",
    "compactions", "compact_s", "compact_stalls",
    "write_stalls", "write_stall_s",
    "leaves_refit", "cold_builds",
)


class IndexService:
    def __init__(
        self,
        raw_keys: np.ndarray,
        config: Optional[ServiceConfig] = None,
        *,
        vals: Optional[np.ndarray] = None,
        metrics: Optional[MetricsRegistry] = None,
        device=None,
        _manager: Optional[VersionManager] = None,
    ):
        self.config = config or ServiceConfig()
        cfg = self.config
        validate_strategy(cfg.strategy)
        if _manager is not None:
            self._mgr = _manager
        else:
            raw = np.asarray(raw_keys, np.float64)
            if vals is None:
                raw = np.unique(raw)
            else:
                vals = np.asarray(vals, np.int64)
                order = np.argsort(raw, kind="stable")
                raw, vals = raw[order], vals[order]
                if raw.size and (np.diff(raw) == 0).any():
                    raise ValueError("duplicate keys with distinct values")
            snap, _ = build_snapshot(
                raw,
                vals=vals,
                config=cfg.rmi or _default_rmi(raw.size),
                version=0,
                bloom_fpr=cfg.bloom_fpr,
                device=device,
            )
            self._mgr = VersionManager(
                snap, directory=cfg.snapshot_dir, keep=cfg.keep_snapshots
            )
            if cfg.snapshot_dir is not None:
                self._mgr.save_current()
        self._compactor = Compactor(
            config=cfg.rmi, bloom_fpr=cfg.bloom_fpr, warm=True
        )
        self._active = DeltaBuffer(cfg.delta_capacity)
        # oldest-first stack of frozen (immutable) delta levels waiting
        # to merge into the base; the historical `_frozen` single slot
        # survives as a read-only property over this list
        self._levels: List[DeltaBuffer] = []
        self._compacting = False  # guarded-by: _lock
        self._lock = lockstat.make_lock("service._lock")
        self._worker: Optional[threading.Thread] = None  # guarded-by: _lock
        self._worker_error: Optional[BaseException] = None  # guarded-by: _lock
        self._compact_failures = 0  # consecutive, guarded-by: _lock
        self._write_ewma = 0.0   # guarded-by: _lock
        # every service gets its OWN registry unless the caller shares
        # one on purpose — K shard services must never alias counters
        self.metrics = metrics if metrics is not None else MetricsRegistry(
            "index_service"
        )
        # every device-resident mirror (lookup slab + scan plane) lives
        # behind this boundary; orchestration only captures state and
        # signals invalidation (see plane.DevicePlane)
        self._plane = DevicePlane(self.metrics)
        # legacy dict surface, now a live view over registry counters
        self.stats = StatsView(self.metrics, "svc", _STATS_KEYS)
        self._op_hist = {
            op: self.metrics.histogram(f"op.{op}.latency_s")
            for op in INSTRUMENTED_OPS
        }
        self._op_hist["scan_page"] = self.metrics.histogram(
            "op.scan_page.latency_s"
        )
        self._op_hist["compact"] = self.metrics.histogram(
            "op.compact.latency_s"
        )
        self._freeze_ctr = self.metrics.counter("delta.freezes")
        self._swap_ctr = self.metrics.counter("snapshot.swaps")
        self._level_gauge = self.metrics.gauge("delta.levels")
        self._op_hist["write_stall"] = self.metrics.histogram(
            "op.write_stall.latency_s"
        )
        self.compaction_log: List[CompactionStats] = []

    def _observe_op(self, op: str, seconds: float) -> None:
        self._op_hist[op].observe(seconds)

    @property
    def device(self) -> torch.device:
        return self._mgr.current().device

    @classmethod
    def load(
        cls, directory: str, config: Optional[ServiceConfig] = None,
        device=None,
    ) -> "IndexService":
        """Restart path: reload the latest on-disk snapshot version."""
        config = config or ServiceConfig(snapshot_dir=directory)
        mgr = VersionManager.load_latest(
            directory, keep=config.keep_snapshots, device=device
        )
        mgr.directory = config.snapshot_dir
        return cls(np.empty(0), config, _manager=mgr)

    # ---- introspection ---------------------------------------------------
    @property
    def version(self) -> int:
        return self._mgr.version

    @property
    def num_keys(self) -> int:
        """Live key count: base minus tombstones plus staged inserts."""
        snap, frozen, active = self._state()
        n = snap.n
        for level in iter_levels(frozen, active):
            n += level.num_inserts - level.num_deletes
        return n

    @property
    def delta_fill(self) -> float:
        return self._active.fill

    @property
    def _frozen(self):
        """Legacy single-frozen view of the level stack: None when
        empty, the lone buffer, or the oldest-first tuple — every delta
        helper (`iter_levels`) accepts any of the three shapes."""
        lv = self._levels
        if not lv:
            return None
        return lv[0] if len(lv) == 1 else tuple(lv)

    @property
    def num_delta_levels(self) -> int:
        return len(self._levels)

    def _state(self):
        with self._lock:
            return self._mgr.current(), self._frozen, self._active

    def _capture(self):
        """One consistent (snapshot, frozen, active, device delta) view.

        Taken under the lock so a compaction commit cannot pair an old
        snapshot with a post-swap delta: either we see (old snapshot,
        frozen delta) or (new snapshot, drained delta) — the same
        logical key set either way.  The returned refs stay valid after
        release because snapshots are immutable and the frozen buffer
        is never mutated once frozen (double buffering keeps the old
        snapshot's arrays alive through the swap)."""
        with self._lock:
            snap, frozen, active = self._mgr.current(), self._frozen, self._active
            dk, dp = self._plane.lookup_slab(snap, frozen, active)
            return snap, frozen, active, dk, dp

    # ---- reads -----------------------------------------------------------
    def get(self, keys) -> Tuple[np.ndarray, np.ndarray]:
        """Exact merged lower-bound ranks + presence mask for raw keys.

        For a present key the rank is its exact position in the live
        sorted key set; for an absent key it is the insertion point."""
        t0 = time.perf_counter()
        with obs_trace.span("service.get", cat="service"):
            q = np.atleast_1d(np.asarray(keys, np.float64))
            rank, live = self._rank_exact(q)
        dt = time.perf_counter() - t0
        self.stats["get"] += q.size
        self.stats["get_hits"] += int(live.sum())
        self.stats["get_s"] += dt
        self._observe_op("get", dt)
        return rank, live

    def lookup_batch(self, keys) -> torch.Tensor:
        """Device fast path: RMI + fused-delta merged ranks in one
        dispatch, no host refinement (exact whenever float32
        normalization is injective over base+delta keys — the benchmark
        hot path).  Returns an int32 tensor on the service's device."""
        t0 = time.perf_counter()
        with obs_trace.span("service.lookup_batch", cat="service"):
            snap, _, _, dk, dp = self._capture()
            q = np.asarray(keys, np.float64)
            qn = torch.as_tensor(snap.keys.normalize(q), device=snap.device)
            _, rank = snap.merged_lookup_fn(self.config.strategy)(qn, dk, dp)
        dt = time.perf_counter() - t0
        self.stats["lookup_batch"] += q.size
        self.stats["lookup_batch_s"] += dt
        self._observe_op("lookup_batch", dt)
        return rank

    def contains(self, keys) -> np.ndarray:
        """Existence check.  Keys mentioned by any delta level resolve
        exactly from the levels (youngest decides); unmentioned keys
        are base-only and resolve through the exact rank path (one
        dispatch).  The reference's Bloom screen in front of that path
        is not ported yet."""
        t0 = time.perf_counter()
        with obs_trace.span("service.contains", cat="service"):
            q = np.atleast_1d(np.asarray(keys, np.float64))
            snap, frozen, active, _, _ = self._capture()
            mentioned = np.zeros(q.shape, bool)
            for level in iter_levels(frozen, active):
                mentioned |= member(level.ins_keys, q)
                mentioned |= member(level.del_keys, q)
            out = np.zeros(q.shape, bool)
            if mentioned.any():
                qm = q[mentioned]
                out[mentioned] = live_mask(
                    member(snap.keys.raw, qm), frozen, active, qm
                )
            rest = np.flatnonzero(~mentioned)
            if rest.size:
                _, live = self._rank_exact(q[rest])
                out[rest] = live
        dt = time.perf_counter() - t0
        self.stats["contains"] += q.size
        self.stats["contains_hits"] += int(out.sum())
        self.stats["contains_s"] += dt
        self._observe_op("contains", dt)
        return out

    def range_lookup(self, lo: float, hi: float) -> Tuple[int, int]:
        """[lo, hi) as merged ranks: (first rank >= lo, first rank >= hi);
        the difference is the number of live keys in the interval.  An
        inverted request (``hi < lo``) clamps to the empty range
        ``(r, r)`` at lo's rank — never an inverted pair whose
        difference would go negative downstream."""
        t0 = time.perf_counter()
        with obs_trace.span("service.range", cat="service"):
            if hi < lo:
                hi = lo
            ranks, _ = self._rank_exact(np.array([lo, hi], np.float64))
        dt = time.perf_counter() - t0
        self.stats["range"] += 1
        self.stats["range_s"] += dt
        self._observe_op("range", dt)
        return int(ranks[0]), int(ranks[1])

    # ---- scans -----------------------------------------------------------
    def _pin(self) -> PinnedView:
        """One immutable capture of the merged read state for an open
        scan: snapshot + delta stack collapsed under the lock, valid
        (and consistent) no matter what churn follows."""
        with self._lock:
            return pin_view(self._mgr.current(), self._frozen, self._active)

    def scan(self, lo: float, hi: float, page_size: int = 256):
        """Stream the live rows with keys in [lo, hi) as fixed-size
        `ScanPage`s — `(keys, vals, live_mask)` in global base+delta
        merge order, tombstones elided, staged inserts woven in with
        their values, exact in float64.

        The view pins at call time: writes, compactions, and snapshot
        swaps between pages never tear an open iterator (it keeps
        answering for the key set as of the call).  Empty or inverted
        ranges yield no pages."""
        t0 = time.perf_counter()
        with obs_trace.span("service.scan", cat="service"):
            view = self._pin()
        setup = time.perf_counter() - t0
        self.stats["scan"] += 1
        self.stats["scan_s"] += setup
        self._observe_op("scan", setup)

        def pages():
            # time the generator STEP: t1 is taken before next() so page
            # production lands in scan_s and the per-page histogram
            it = scan_pages(view, lo, hi, page_size)
            while True:
                t1 = time.perf_counter()
                with obs_trace.span("service.scan_page", cat="service"):
                    page = next(it, None)
                if page is None:
                    return
                dt = time.perf_counter() - t1
                self.stats["scan_pages"] += 1
                self.stats["scan_rows"] += page.count
                self.stats["scan_s"] += dt
                self._observe_op("scan_page", dt)
                yield page

        return pages()

    def _scan_plane_cached(self):
        """The device-resident scan plane for the current (snapshot,
        delta) version: staged-insert arrays plus the prefix-sum page
        index (`scan.device_scan_slab`), packed and uploaded once per
        version and reused by every `scan_batch` until the next write
        or compaction — keyed on (snapshot identity, delta identity +
        mutation version)."""
        with self._lock:
            snap, frozen, active = (
                self._mgr.current(), self._frozen, self._active
            )
            key = scan_plane_key(snap, frozen, active)
            hit = self._plane.cached_scan_slab(key)
            if hit is not None:
                return snap, hit[0], hit[1]
            view = pin_view(snap, frozen, active)
        # the O(n) index build + upload run OUTSIDE the lock (the
        # pinned view is immutable), so writers and compaction commits
        # don't stall behind it
        slab, ins_n = self._plane.build_scan_slab(
            key, view, snap.keys.norm, snap.keys.normalize, snap.device
        )
        return snap, slab, ins_n

    def scan_batch(self, lo: float, hi: float, page_size: int = 256):
        """Device fast path for scans: ONE dispatch — endpoint ranking,
        page starts, and every page gather fused into one launch of the
        scan kernel (`snapshot.scan_range_fn`; its plain twin under the
        non-kernel strategies).  The merged ranks ``(r0, r1)`` of
        [lo, hi) never touch the host; the only host work is a cache
        hit on the scan plane and a conservative page-count bound for
        the output shape.

        Returns ``(keys (G, page_size) f32, vals i32, live_mask bool)``
        tensors on the service's device, in the snapshot's *normalized
        float32 frame* with int32 values; pages past the range come back
        fully masked.  Exact whenever float32 normalization is injective
        over the base+delta keys (the range endpoints included), the
        same caveat as `lookup_batch`; `scan` is the exact float64
        surface."""
        t0 = time.perf_counter()
        with obs_trace.span("service.scan_batch", cat="service"):
            snap, (ins, ivals, ins_rank, lp), ins_n = self._scan_plane_cached()
            lo_hi = snap.keys.normalize(np.array([lo, hi], np.float64))
            # output-shape bound (host metadata sizing the output, not a
            # rank fed to the device), taken in the float32 frame the
            # device ranks in: the reference's float64 window plus one
            # page is too small where a float32 duplicate run widens the
            # range, and the output would drop rows (ROADMAP queue C)
            pages = scan_page_bound(
                [snap.keys.norm], ins_n, *lo_hi, page_size
            )
            fn = snap.scan_range_fn(self.config.strategy, page_size, pages)
            bounds = torch.as_tensor(lo_hi, device=snap.device)
            out = fn(bounds, ins, ivals, ins_rank, lp)
        dt = time.perf_counter() - t0
        self.stats["scan_batch"] += 1
        self.stats["scan_batch_s"] += dt
        self._observe_op("scan_batch", dt)
        return out

    def _rank_exact(self, q: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        snap, frozen, active, dk, dp = self._capture()
        qn = torch.as_tensor(snap.keys.normalize(q), device=snap.device)
        b, _ = snap.merged_lookup_fn(self.config.strategy)(qn, dk, dp)
        # the designed single read-back for the f64 refinement
        base_rank, in_base = snap.refine_base_rank(q, b.cpu().numpy())
        rank = base_rank + count_less(frozen, active, q)
        live = live_mask(in_base, frozen, active, q)
        return rank, live

    # ---- writes ----------------------------------------------------------
    def insert(self, keys, vals=None) -> int:
        """Stage inserts; returns how many changed the live key set.
        Batches stage in one merge per capacity chunk, compacting
        between chunks when the delta fills."""
        t0 = time.perf_counter()
        with obs_trace.span("service.insert", cat="service"):
            q = np.atleast_1d(np.asarray(keys, np.float64))
            v = (np.zeros(q.shape, np.int64) if vals is None
                 else np.atleast_1d(np.asarray(vals, np.int64)))
            self._note_write_rate(q.size)
            applied = self._staged(
                q, lambda c, lb: self._active.stage_insert_many(q[c], lb, v[c])
            )
        dt = time.perf_counter() - t0
        self.stats["insert"] += q.size
        self.stats["insert_applied"] += applied
        self.stats["insert_s"] += dt
        self._observe_op("insert", dt)
        return applied

    def delete(self, keys) -> int:
        """Stage deletes; returns how many keys went from live to dead."""
        t0 = time.perf_counter()
        with obs_trace.span("service.delete", cat="service"):
            q = np.atleast_1d(np.asarray(keys, np.float64))
            self._note_write_rate(q.size)
            applied = self._staged(
                q, lambda c, lb: self._active.stage_delete_many(q[c], lb)
            )
        dt = time.perf_counter() - t0
        self.stats["delete"] += q.size
        self.stats["delete_applied"] += applied
        self.stats["delete_s"] += dt
        self._observe_op("delete", dt)
        return applied

    def _staged(self, q: np.ndarray, stage) -> int:
        """Chunk a write batch by remaining delta room and stage each
        chunk in one vectorized merge.  A compaction stalled below
        ``min_keys`` (all-deleted index) surfaces here — on the write
        that actually needs the room — rather than killing the worker
        thread."""
        applied, pos = 0, 0
        while pos < q.size:
            self._ensure_capacity()
            with self._lock:
                # the buffer's own capacity, not the config's: a
                # stalled fold-back stretches it past the configured
                # size so the writes that cure the stall can land
                room = self._active.capacity - len(self._active)
            if room <= 0:
                stalls = self.stats["compact_stalls"]
                # the write is genuinely blocked until the freeze (O(1)
                # with level headroom) or merge completes — this is THE
                # write-stall window the leveled compactor bounds
                t_stall = time.perf_counter()
                self.maybe_compact(wait=True)
                dt_stall = time.perf_counter() - t_stall
                self.stats["write_stalls"] += 1
                self.stats["write_stall_s"] += dt_stall
                self._observe_op("write_stall", dt_stall)
                if self.stats["compact_stalls"] > stalls:
                    with self._lock:
                        if len(self._active) >= 4 * self.config.delta_capacity:
                            raise OverflowError(
                                "delta buffer full and compaction "
                                "stalled below min_keys (nearly all "
                                "keys deleted); stage at least 2 live "
                                "keys or raise delta_capacity"
                            )
                        # only new keys can make the merge viable
                        # again — grant this batch bounded headroom
                        self._active.capacity = len(self._active) + min(
                            q.size - pos, self.config.delta_capacity
                        )
                continue
            chunk = slice(pos, pos + room)
            with self._lock:
                applied += stage(chunk, self._live_below_many(q[chunk]))
                self._plane.drop_lookup()
            pos += room
        return applied

    def _live_below_many(self, q: np.ndarray) -> np.ndarray:
        """Liveness in base + every frozen level (the levels under the
        active delta).  Callers hold the lock, so (snapshot, levels)
        are coherent."""
        snap = self._mgr.current()
        raw = snap.keys.raw
        i = np.clip(np.searchsorted(raw, q), 0, raw.size - 1)
        in_base = raw[i] == q
        return live_mask(in_base, tuple(self._levels), None, q)

    # ---- mixed batched front end ----------------------------------------
    def execute(self, ops: Sequence[Tuple]) -> List:
        """Run a mixed batch of ("insert", keys[, vals]) / ("delete",
        keys) / ("get", keys) / ("contains", keys) / ("range", lo, hi)
        requests in order; returns one result per op."""
        dispatch = {
            "insert": self.insert,
            "delete": self.delete,
            "get": self.get,
            "contains": self.contains,
            "range": self.range_lookup,
        }
        out = []
        for kind, *args in ops:
            if kind not in dispatch:
                raise ValueError(f"unknown op {kind!r}")
            out.append(dispatch[kind](*args))
        return out

    # ---- compaction ------------------------------------------------------
    @property
    def write_rate_ewma(self) -> float:
        """EWMA of staged entries per recent write call — the hotness
        signal the rate-aware compaction trigger scales by."""
        with self._lock:
            return self._write_ewma

    def _note_write_rate(self, batch: int) -> None:
        # per-call exponential average (deterministic — no wall clock):
        # shards fed large/frequent batches converge to a high EWMA,
        # cold shards decay toward their trickle size
        with self._lock:
            self._write_ewma = 0.7 * self._write_ewma + 0.3 * float(batch)

    def _compact_trigger(self) -> float:
        """Fill level (entries) that arms compaction.  With
        ``compact_rate_gain`` > 0 the fraction scales down as the write
        EWMA rises — hot shards compact earlier (ROADMAP: write-rate-
        aware scheduling), cold shards batch up to compact_fraction."""
        cfg = self.config
        frac = cfg.compact_fraction
        with self._lock:
            ewma = self._write_ewma
        if cfg.compact_rate_gain > 0.0 and ewma > 0.0:
            hot = ewma / (ewma + max(1.0, cfg.delta_capacity / 8.0))
            frac = max(
                cfg.compact_rate_floor,
                frac * (1.0 - cfg.compact_rate_gain * hot),
            )
        return frac * cfg.delta_capacity

    def _ensure_capacity(self) -> None:
        self._raise_worker_error()
        trigger = self._compact_trigger()
        if len(self._active) >= trigger:
            # block only when staging could otherwise overflow
            self.maybe_compact(wait=len(self._active) >= self.config.delta_capacity - 2)

    def maybe_compact(self, wait: bool = False, drain: bool = False) -> bool:
        """Freeze the active delta onto the frozen-level stack, and
        merge the stack into a new snapshot version when it reaches
        ``max_delta_levels`` (or when ``drain`` forces the merge).
        With the default of one level this is the historical
        freeze-then-compact; with more levels most capacity fills cost
        only the O(1) freeze and the O(n) merge happens once per L
        fills.  ``wait`` blocks on an in-flight merge instead of
        returning False.  Returns True if a freeze or merge happened."""
        with self._lock:
            in_flight = self._compacting  # one merge in flight at a time
        if in_flight:
            if not wait and not drain:
                return False
            self._join_worker()
            with self._lock:
                retry = self._compacting
            if retry:  # worker died before commit: retry inline
                self._run_compaction()
        froze = False
        with self._lock:
            if len(self._active):
                self._levels.append(self._active)
                self._active = DeltaBuffer(self.config.delta_capacity)
                self._plane.drop()  # release the retired delta's slab
                self._freeze_ctr.add(1)
                self._level_gauge.set(len(self._levels))
                froze = True
            merge = bool(self._levels) and (
                drain
                or len(self._levels) >= max(1, self.config.max_delta_levels)
            )
            if merge:
                self._compacting = True
        if froze:
            obs_trace.instant("delta.freeze", cat="compaction",
                              levels=len(self._levels))
        if not merge:
            return froze
        if self.config.background and not (wait or drain):
            with self._lock:
                self._worker = threading.Thread(
                    target=self._run_compaction, daemon=True
                )
                self._worker.start()
        else:
            self._run_compaction()
        return True

    def flush(self) -> None:
        """Drain: wait for in-flight compaction, then merge every
        frozen level plus any remaining staged writes synchronously.
        A min_keys stall (nearly all keys deleted) is not an error: the
        staged entries stay in the delta (reads remain exact) and
        ``stats`` records the stall; `save` refuses until it clears."""
        self._join_worker()
        self.maybe_compact(wait=True, drain=True)
        self._raise_worker_error()

    def _run_compaction(self) -> None:
        # The compaction SUPERVISOR: runs inline or on the background
        # worker thread.  A crashed merge attempt leaves the frozen
        # stack untouched (the commit never ran), so the supervisor
        # retries it with capped exponential backoff instead of letting
        # the worker die silently; `compact_max_failures` consecutive
        # crashes stop the retries, park the error for the next caller
        # (`_raise_worker_error`), and flip `compactor_escalated` so
        # the serving tier starts shedding writes.
        cfg = self.config
        limit = max(1, cfg.compact_max_failures)
        attempt = 0
        try:
            while True:
                try:
                    # the span tags whichever thread executes the
                    # attempt; the histogram covers it end to end
                    # (including a stall's fold-back)
                    with obs_trace.span(
                        "service.compaction", cat="compaction",
                    ), self._op_hist["compact"].time():
                        self._run_compaction_inner()
                    with self._lock:
                        self._compact_failures = 0
                    return
                except BaseException as e:  # fault-wall: supervisor — any crash retries with backoff, then surfaces via _worker_error
                    attempt += 1
                    with self._lock:
                        self._compact_failures += 1
                        consec = self._compact_failures
                    self.metrics.counter("compact.worker_crashes").add(1)
                    obs_trace.instant(
                        "compactor.crash", cat="fault",
                        attempt=attempt, error=type(e).__name__,
                    )
                    if consec >= limit:
                        with self._lock:
                            self._worker_error = e
                        self.metrics.counter("compact.escalations").add(1)
                        obs_trace.instant(
                            "compactor.escalated", cat="fault",
                            consecutive=consec,
                        )
                        return
                    self.metrics.counter("compact.worker_restarts").add(1)
                    time.sleep(min(
                        cfg.compact_backoff_cap_s,
                        cfg.compact_backoff_s * (2.0 ** (attempt - 1)),
                    ))
        finally:
            # one owner for the in-flight flag: attempts (and their
            # retries) all run under the same _compacting=True claim,
            # so no second merge can start mid-backoff
            with self._lock:
                self._compacting = False

    @property
    def compactor_escalated(self) -> bool:
        """True while the compactor is in the escalated state: its last
        `compact_max_failures` attempts all crashed and retries have
        stopped.  Clears when a later compaction succeeds."""
        with self._lock:
            return self._compact_failures >= max(
                1, self.config.compact_max_failures
            )

    def _run_compaction_inner(self) -> None:
        try:
            snap = self._mgr.current()
            with self._lock:
                # the merge covers exactly this oldest-first prefix of
                # the stack (frozen levels are immutable, so the refs
                # stay valid outside the lock); the commit removes the
                # prefix so any level frozen mid-merge survives
                work = tuple(self._levels)
            if not work:
                return
            net = sum(lv.num_inserts - lv.num_deletes for lv in work)
            compactor = self._compactor
            if self.config.rmi is None:
                # auto-sized leaves: re-size (cold build) when the live
                # key count drifts past the warm-start regime, else
                # keys-per-leaf — and with it every search window —
                # grows without bound
                est = snap.n + net
                target = max(16, est // 64)
                cur = snap.index.config.num_leaves
                if not (cur // 2 <= target <= cur * 2):
                    compactor = Compactor(
                        config=dataclasses.replace(
                            snap.index.config, num_leaves=target
                        ),
                        bloom_fpr=self.config.bloom_fpr,
                        warm=False,
                    )
            # collapse the whole frozen stack against the base into ONE
            # effective level — the single-level merge then handles any
            # stack depth, and cross-level shadowing (reinserts over
            # older tombstones, value overwrites) resolves here
            eff = (work[0] if len(work) == 1 else DeltaBuffer.from_arrays(
                *collapse_levels(snap.keys.raw, work, None),
                capacity=sum(lv.capacity for lv in work),
            ))
            new, stats = compactor.compact(snap, eff)
            with self._lock:
                self._mgr.swap(new)
                del self._levels[: len(work)]
                self._plane.drop()  # drop the retired snapshot's plane
                self._level_gauge.set(len(self._levels))
            self._swap_ctr.add(1)
            obs_trace.instant("snapshot.swap", cat="compaction",
                              version=new.version)
            self.stats["compactions"] += 1
            self.stats["compact_s"] += stats.seconds
            if stats.leaves_refit < 0:
                self.stats["cold_builds"] += 1
            else:
                self.stats["leaves_refit"] += stats.leaves_refit
            self.compaction_log.append(stats)
        except CompactionStall:
            # nearly all keys deleted: expected, not fatal.  Fold the
            # whole frozen stack back into the active level
            # (collapsed, so layering stays exact), record the stall,
            # and keep serving — the next insert makes the merge
            # viable again; a write that can't find room raises in
            # `_staged` with the stall named.
            with self._lock:
                self._active = DeltaBuffer.from_arrays(
                    *collapse_levels(
                        snap.keys.raw, tuple(self._levels), self._active
                    ),
                    # preserve any stall headroom `_staged` granted
                    # (it may sit on any level after the freeze) —
                    # resetting it would starve the very writes that
                    # make the merge viable again
                    capacity=max(
                        [self.config.delta_capacity, self._active.capacity]
                        + [lv.capacity for lv in self._levels]
                    ),
                )
                self._levels.clear()
                self._plane.drop()
                self._level_gauge.set(0)
            self.stats["compact_stalls"] += 1
            obs_trace.instant("compaction.stall", cat="compaction")

    def _join_worker(self) -> None:
        with self._lock:
            w = self._worker
        if w is not None and w.is_alive():
            w.join()  # never under the lock — the worker takes it to commit
        with self._lock:
            self._worker = None
        self._raise_worker_error()

    def _raise_worker_error(self) -> None:
        with self._lock:
            err, self._worker_error = self._worker_error, None
        if err is not None:
            raise RuntimeError("compaction failed") from err

    # ---- persistence -----------------------------------------------------
    def save(self, directory: Optional[str] = None) -> str:
        """Compact staged writes and persist the resulting snapshot."""
        self.flush()
        if len(self._active):
            # flush could not drain (compaction stalled below
            # min_keys): refuse rather than persist a snapshot that
            # silently resurrects the staged deletes on restart
            raise RuntimeError(
                "cannot persist: compaction stalled with "
                f"{len(self._active)} staged entries (nearly all keys "
                "deleted); insert at least 2 live keys first"
            )
        if directory is not None:
            self._mgr.directory = directory
        return self._mgr.save_current()

    # ---- reporting -------------------------------------------------------
    def stats_summary(self) -> Dict[str, object]:
        s = self.stats
        def per_op(kind):
            n = s[kind]
            return {
                "count": int(n),
                "ns_per_op": (s[f"{kind}_s"] / n * 1e9) if n else 0.0,
            }
        return {
            "version": self.version,
            "base_keys": self._mgr.current().n,
            "live_keys": self.num_keys,
            "delta_fill": round(self.delta_fill, 4),
            "get": {**per_op("get"),
                    "hit_rate": s["get_hits"] / s["get"] if s["get"] else 0.0},
            "contains": {
                **per_op("contains"),
                "hit_rate": (s["contains_hits"] / s["contains"]
                             if s["contains"] else 0.0),
            },
            "range": per_op("range"),
            "scan": {
                "count": int(s["scan"]),
                "pages": int(s["scan_pages"]),
                "rows": int(s["scan_rows"]),
                "total_s": round(s["scan_s"], 4),
            },
            "insert": {**per_op("insert"), "applied": int(s["insert_applied"])},
            "delete": {**per_op("delete"), "applied": int(s["delete_applied"])},
            "lookup_batch": per_op("lookup_batch"),
            "scan_batch": per_op("scan_batch"),
            "compactions": {
                "count": int(s["compactions"]),
                "total_s": round(s["compact_s"], 4),
                "stalls": int(s["compact_stalls"]),
                "leaves_refit": int(s["leaves_refit"]),
                "cold_builds": int(s["cold_builds"]),
                "delta_levels": len(self._levels),
                "write_stalls": int(s["write_stalls"]),
                "write_stall_s": round(s["write_stall_s"], 4),
            },
        }
