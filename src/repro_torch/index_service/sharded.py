"""Sharded writable learned index: K single-shard services behind a
learned router.

`IndexService` solves the paper's §3.3 write problem with one delta
buffer and one fused merged-lookup launch over one base + one delta.
This module scales that the way an LSM shards: the raw key space
partitions into K half-open ranges owned by a `LearnedRouter`
(router.py), each shard runs its *own* snapshot + `DeltaBuffer` +
compaction schedule (a full `IndexService`), and global answers
reassemble from per-shard answers by prefix-summing per-shard live
counts:

    global_rank(q) = sum(live(s) for s < route(q)) + local_rank(q)

    writes ──route──▶ shard 0 [snapshot+delta+compactor]──┐
                      shard 1 [snapshot+delta+compactor]──┼─ prefix-sum
                      ...                                 │  reassembly
    reads  ──route──▶ shard K-1 [...]────────────────────-┘

Correctness never depends on the model: the router is exact (learned
guess + verification + fallback), each shard's `IndexService` is
oracle-exact, and K=1 answers exactly as the unsharded service.

Boundary re-fit: when compactions leave a shard holding more than
``shard_balance_factor`` x the mean live count, `rebalance()` walks the
ring with LOCAL steps — merge one adjacent pair, split one shard, or
shift one boundary to its global live quantile — each step shipping
only the two touched shards' collapsed live slices while every other
shard (and any pinned scan view) keeps serving.  Keys change owners,
never global ranks.

Device path — every hot read is ONE dispatch over an INCREMENTAL
device-plane cache, with every shard stacked on one card (the shard
axis is a grid axis of the kernels):

  * `lookup_batch` stacks the per-shard snapshot/delta arrays
    (zero/+inf padded; true sizes travel as device arrays) and runs
    `rmi_sharded_merged_lookup_cuda` (or its plain twin under the
    non-kernel strategies) WITH the routed prefix-sum reassembly in the
    same dispatch;
  * `get` / `contains` pre-screen whole batches through that same
    stacked dispatch and finish with exact float64 host refinement per
    routed shard;
  * `scan_batch` ranks [lo, hi) on every shard, turns the per-shard
    spans into stream ownership and gathers each shard's rows through
    its prefix-sum page index with `rmi_sharded_scan_page_cuda`; an
    owner-masked reduction emits the global page stream;
  * both plans cache per shard on (snapshot identity, delta version):
    a write re-packs only its own shard's row into persistent host
    mirrors, and the stacked device tensors refresh from COPIES of
    those mirrors (an upload that aliased a mirror would change under a
    plan an earlier call still holds).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import faults
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import index_shard_mesh, place_index_shards
from repro_torch.index_service.delta import (
    count_less,
    iter_levels,
    live_mask,
    member,
)
from repro_torch.index_service.plane import scan_plane_key, scan_plane_key_eq
from repro_torch.index_service.router import LearnedRouter
from repro_torch.index_service.scan import (
    _pad_bucket,
    fit_scan_frame,
    pack_scan_slab,
    repack_pages,
    scan_page_bound,
    scan_pages,
)
from repro_torch.index_service.service import (
    INSTRUMENTED_OPS,
    IndexService,
    ServiceConfig,
)
from repro_torch.index_service.snapshot import KERNEL_STRATEGIES, validate_strategy
from repro_torch.kernels import ops as kernels_ops
from repro_torch.obs import lockstat
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import MetricsRegistry, StatsView

_ROUTER_FILE = "router.npz"
_SHARD_DIR = "shard-{:02d}"


def _merge_level(keys, vals, level):
    """Apply one delta level to sorted (keys, vals): drop tombstoned
    keys, weave staged inserts in (the compactor's merge, without
    publishing a snapshot — so it works for ANY result size, including
    a fully drained shard)."""
    if level is None or len(level) == 0:
        return keys, vals
    keep = np.ones(keys.size, bool)
    if level.del_keys.size:
        i = np.clip(
            np.searchsorted(level.del_keys, keys),
            0, level.del_keys.size - 1,
        )
        keep = level.del_keys[i] != keys
    merged = np.concatenate([keys[keep], level.ins_keys])
    order = np.argsort(merged, kind="stable")
    merged = merged[order]
    if vals is not None:
        vals = np.concatenate([vals[keep], level.ins_vals])[order]
    if merged.size:
        # a staged insert can update a key still live in the base (no
        # tombstone); the stable sort put the base row first, so keeping
        # the LAST of each equal-key run is last-write-wins (same dedupe
        # as compact.merge_delta)
        uniq = np.empty(merged.size, bool)
        uniq[:-1] = merged[1:] != merged[:-1]
        uniq[-1] = True
        if not uniq.all():
            merged = merged[uniq]
            if vals is not None:
                vals = vals[uniq]
    return merged, vals


def _live_arrays(svc: "IndexService"):
    """One shard's exact live (keys, vals) from a consistent
    (snapshot, frozen, active) capture — no compaction, no flush."""
    snap, frozen, active = svc._state()
    keys, vals = snap.keys.raw, snap.vals
    for level in iter_levels(frozen, active):
        keys, vals = _merge_level(keys, vals, level)
    return keys, vals


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A device tensor that never aliases ``a``: the host mirrors mutate
    in place on the next incremental build, and on the CPU
    `torch.from_numpy` / `torch.as_tensor` would share their memory.
    Every shard's rows go to the service's device; where the process
    group holds several ranks, `_shard_mesh` spreads the plain
    strategies' stacked rows over them."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, copy=True)


def _same_objects(a: tuple, b: tuple) -> bool:
    """Identity (not ==) comparison of two capture tuples.  The cache
    keys hold the live snapshot/delta OBJECTS — not their id()s — so a
    freed snapshot can never alias a new one through CPython id reuse,
    and comparison must be `is`, never tensor equality."""
    return len(a) == len(b) and all(
        x is y for pair_a, pair_b in zip(a, b)
        for x, y in zip(pair_a, pair_b)
    )


@dataclasses.dataclass
class _DevicePlan:
    """Stacked per-shard tensors for the one-dispatch sharded lookup,
    plus the host mirrors that make the cache *incremental*: a write to
    one shard re-packs that shard's delta row in the host buffers —
    the other rows (and their live-count bookkeeping) are reused
    byte-for-byte; only the final upload touches the device."""

    key: tuple                 # (snapshot, delta-tensor) object pairs
    caps: list                 # per-shard (snap, frozen, active, dk, dp)
    q_normalizers: list        # per-shard KeySet.normalize callables
    stage0: torch.Tensor       # (S, P) flat stage-0 buffers
    leaf_w: torch.Tensor
    leaf_b: torch.Tensor
    err_lo: torch.Tensor
    err_hi: torch.Tensor
    keys: torch.Tensor         # (S, Nmax) +inf padded
    dkeys: torch.Tensor        # (S, Dmax) +inf padded
    dprefix: torch.Tensor      # (S, Dmax+1) pad tail repeats the last value
    shard_n: torch.Tensor      # (S,) int32
    shard_m: torch.Tensor      # (S,) int32
    shard_ratio: torch.Tensor  # (S,) float32
    base_off: torch.Tensor     # (S,) int32: keys in lower shards' bases
    merged_off: torch.Tensor   # (S,) int32: LIVE keys in lower shards
    hidden: tuple
    max_window: int
    dkeys_np: np.ndarray       # host mirrors for incremental row updates
    dprefix_np: np.ndarray
    live_np: np.ndarray        # (S,) int64 live counts per shard
    base_off_np: np.ndarray    # (S,) int64
    merged_off_np: np.ndarray  # (S,) int64


@dataclasses.dataclass
class _ScanPlane:
    """Stacked per-shard scan slabs (one shared normalized frame) +
    host mirrors and per-shard row cache for incremental re-packs."""

    key: tuple                 # per-shard (snap, frozen, fver, active, aver)
    shards_key: tuple          # the shard service objects themselves
    lo: float                  # shared affine frame (fixed per full build)
    hi: float
    n_pad: int
    d_pad: int
    rows: list                 # per-shard true sizes {"n", "d"}
    raws: list                 # per-shard base raw arrays
    ins_total: int
    base: torch.Tensor         # (S, Npad) f32 +inf padded, shared frame
    bvals: torch.Tensor        # (S, Npad) i32
    live_prefix: torch.Tensor  # (S, Npad+1) i32
    ins: torch.Tensor          # (S, Dpad) f32
    ivals: torch.Tensor        # (S, Dpad) i32
    ins_rank: torch.Tensor     # (S, Dpad) i32
    base_np: np.ndarray        # host mirrors of the six stacks
    bvals_np: np.ndarray
    lp_np: np.ndarray
    ins_np: np.ndarray
    ivals_np: np.ndarray
    irank_np: np.ndarray

    def normalize(self, x) -> np.ndarray:
        """Raw float64 keys -> the plane's shared float32 frame (the
        frame `scan_batch` rows come back in)."""
        return (
            (np.asarray(x, np.float64) - self.lo) / (self.hi - self.lo)
        ).astype(np.float32)


class ShardedIndexService:
    """K-shard writable learned index with a learned router front end.

    Mirrors the `IndexService` surface (get / contains / range_lookup /
    scan / insert / delete / execute / flush / save / load /
    lookup_batch / scan_batch / stats_summary); ``config.num_shards``
    picks K and ``config.delta_capacity`` applies per shard.  Every
    shard lives on ``device`` (None = "cuda").

    Concurrency contract: one re-entrant service lock (``_lock``)
    serializes every mutation of the router / shard list / plane caches
    AND every read that consults them, so a reshape can never publish a
    half-spliced tiling to a concurrent reader.  Shard-internal state is
    each shard `IndexService`'s own problem (its own ``_lock``); lock
    order is strictly sharded -> shard, never the reverse.  Page
    streaming (the `scan` iterator) runs OUTSIDE the lock on pinned
    views.
    """
    # lixlint: thread-shared

    def __init__(
        self,
        raw_keys: np.ndarray,
        config: Optional[ServiceConfig] = None,
        *,
        vals: Optional[np.ndarray] = None,
        device=None,
        _router: Optional[LearnedRouter] = None,
        _shards: Optional[List[IndexService]] = None,
    ):
        self.config = config or ServiceConfig()
        validate_strategy(self.config.strategy)
        if self.config.num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        self.device = resolve_device(device)
        # front-end registry: shard services carry their own registries
        # (never aliased here), so front-end latencies and per-shard
        # counters stay separable
        self.metrics = MetricsRegistry("sharded_index_service")
        self.stats = StatsView(self.metrics, "svc", (
            "rebalances",
            "get", "get_s", "get_hits",
            "contains", "contains_s", "contains_hits",
            "range", "range_s",
            "scan", "scan_s", "scan_pages", "scan_rows",
            "insert", "insert_s",
            "delete", "delete_s",
            "lookup_batch", "lookup_batch_s",
            "scan_batch", "scan_batch_s",
        ))
        self._op_hist = {
            op: self.metrics.histogram(f"op.{op}.latency_s")
            for op in INSTRUMENTED_OPS
        }
        self._op_hist["scan_page"] = self.metrics.histogram(
            "op.scan_page.latency_s"
        )
        self._op_hist["rebalance"] = self.metrics.histogram(
            "op.rebalance.latency_s"
        )
        self._plane_ctr = {
            k: self.metrics.counter(f"plane.{k}")
            for k in ("lookup.hit", "lookup.miss", "scan.hit", "scan.miss")
        }
        self._refit_ctr = self.metrics.counter("router.refits")
        self._reshape_ctr = {
            k: self.metrics.counter(f"rebalance.{k}")
            for k in ("splits", "merges", "shifts")
        }
        # the service lock: serializes router/shard-list/plane-cache
        # mutation and the reads that consult them (see class docstring)
        self._lock = lockstat.make_lock("sharded._lock")
        # counters carried over from shards retired by rebalance(), so
        # aggregate stats and the version property stay monotone
        self._retired: Dict[str, int] = {"versions": 0}  # guarded-by: _lock
        self._plan: Optional[_DevicePlan] = None  # guarded-by: _lock
        self._scan_cache: Optional[_ScanPlane] = None  # guarded-by: _lock
        self._static_plan = None  # guarded-by: _lock
        self._static_rows: Dict[int, tuple] = {}  # guarded-by: _lock
        if _router is not None and _shards is not None:
            self._router, self._shards = _router, _shards  # guarded-by: _lock
            self._router.metrics = self.metrics
            return
        raw = np.asarray(raw_keys, np.float64)
        if vals is None:
            raw = np.unique(raw)
        else:
            vals = np.asarray(vals, np.int64)
            order = np.argsort(raw, kind="stable")
            raw, vals = raw[order], vals[order]
            if raw.size and (np.diff(raw) == 0).any():
                raise ValueError("duplicate keys with distinct values")
        self._router = LearnedRouter.from_keys(raw, self.config.num_shards)
        self._router.metrics = self.metrics
        self._shards = self._build_shards(raw, vals)
        if self.config.snapshot_dir is not None:
            self._save_router()

    def _observe_op(self, op: str, seconds: float) -> None:
        self._op_hist[op].observe(seconds)

    @property
    def _use_kernel(self) -> bool:
        return self.config.strategy in KERNEL_STRATEGIES

    # ---- construction ----------------------------------------------------
    def _shard_config(self, shard: int) -> ServiceConfig:
        sub = None
        if self.config.snapshot_dir is not None:
            sub = os.path.join(
                self.config.snapshot_dir, _SHARD_DIR.format(shard)
            )
        return dataclasses.replace(
            self.config, num_shards=1, snapshot_dir=sub
        )

    def _build_shards(  # lixlint: unsynchronized(constructor-only: runs before the instance is shared)
        self, sorted_keys: np.ndarray, vals: Optional[np.ndarray]
    ) -> List[IndexService]:
        cuts = self._router.split_points(sorted_keys)
        shards = []
        for s in range(self.num_shards):
            a, b = int(cuts[s]), int(cuts[s + 1])
            if b - a < 2:
                raise ValueError(
                    f"shard {s} would hold {b - a} keys (< 2); "
                    f"use fewer shards"
                )
            cfg = self._shard_config(s)
            if cfg.snapshot_dir is not None and os.path.isdir(cfg.snapshot_dir):
                shutil.rmtree(cfg.snapshot_dir)  # drop stale versions
            shards.append(IndexService(
                sorted_keys[a:b], cfg,
                vals=None if vals is None else vals[a:b], device=self.device,
            ))
        return shards

    # ---- introspection ---------------------------------------------------
    @property
    def num_shards(self) -> int:
        with self._lock:
            return self._router.num_shards

    @property
    def router(self) -> LearnedRouter:
        with self._lock:
            return self._router

    @property
    def shards(self) -> Tuple[IndexService, ...]:
        with self._lock:
            return tuple(self._shards)

    @property
    def num_keys(self) -> int:
        with self._lock:
            return sum(s.num_keys for s in self._shards)

    @property
    def version(self) -> int:
        """Aggregate version: total compacted snapshot advances,
        monotone across rebalances (retired shards keep counting)."""
        with self._lock:
            return self._retired["versions"] + sum(
                s.version for s in self._shards
            )

    @property
    def delta_fill(self) -> float:
        with self._lock:
            return max(s.delta_fill for s in self._shards)

    @property
    def compactor_escalated(self) -> bool:
        """True while ANY shard's compactor is in the escalated state
        (its supervisor gave up retrying) — the serving tier's signal
        to stop accepting writes against a merge that will not come."""
        with self._lock:
            shards = tuple(self._shards)
        return any(s.compactor_escalated for s in shards)

    def _live_counts(self) -> np.ndarray:
        with self._lock:
            return np.array([s.num_keys for s in self._shards], np.int64)

    # ---- reads -----------------------------------------------------------
    def _routed_lookup(self, plan: _DevicePlan, q: np.ndarray,
                       shard_of: np.ndarray):
        """ONE dispatch: each shard's float32 frame of ``q`` stacked to
        (S, B), the sharded kernel (or its plain twin) and the routed
        prefix-sum reassembly -> global (base_rank, merged_rank)."""
        qs = np.stack([norm(q) for norm in plan.q_normalizers])
        return kernels_ops.rmi_sharded_routed_lookup_op(
            torch.from_numpy(qs).to(self.device),
            torch.from_numpy(shard_of).to(self.device),
            plan.stage0, plan.leaf_w, plan.leaf_b, plan.err_lo, plan.err_hi,
            plan.keys, plan.dkeys, plan.dprefix, plan.shard_n, plan.shard_m,
            plan.shard_ratio, plan.base_off, plan.merged_off,
            hidden=plan.hidden, max_window=plan.max_window,
            use_kernel=self._use_kernel, strategy=self.config.strategy,
        )

    def _ranks(self, q: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Exact global merged ranks + live mask, pre-screened through
        ONE stacked device dispatch: every query's float32 base lower
        bound comes back from the sharded merged lookup in a single
        launch, and the remaining work — float64 refinement against
        each routed shard's raw keys, delta count, liveness — is host
        NumPy over the same capture the device plan was packed from."""
        with self._lock:
            shard_of = self._router.route(q)
            plan = self._device_plan()
            gbase, _ = self._routed_lookup(plan, q, shard_of)
            # the designed single read-back for the f64 refinement
            gbase = gbase.cpu().numpy().astype(np.int64)
            rank = np.zeros(q.shape, np.int64)
            live = np.zeros(q.shape, bool)
            for s, c in enumerate(plan.caps):
                m = shard_of == s
                if not m.any():
                    continue
                snap, frozen, active = c[0], c[1], c[2]
                qm = q[m]
                lb_local = gbase[m] - int(plan.base_off_np[s])
                base_rank, in_base = snap.refine_base_rank(qm, lb_local)
                rank[m] = (
                    base_rank + count_less(frozen, active, qm)
                    + int(plan.merged_off_np[s])
                )
                live[m] = live_mask(in_base, frozen, active, qm)
            return rank, live

    def get(self, keys) -> Tuple[np.ndarray, np.ndarray]:
        """Exact global lower-bound ranks + presence mask (the K-shard
        mirror of `IndexService.get`)."""
        t0 = time.perf_counter()
        with obs_trace.span("service.get", cat="service", sharded=True):
            q = np.atleast_1d(np.asarray(keys, np.float64))
            rank, live = self._ranks(q)
        dt = time.perf_counter() - t0
        self.stats["get"] += q.size
        self.stats["get_hits"] += int(live.sum())
        self.stats["get_s"] += dt
        self._observe_op("get", dt)
        return rank, live

    def contains(self, keys) -> np.ndarray:
        """Existence check, delta-absorbing like the unsharded service:
        keys MENTIONED by a shard's delta levels resolve exactly on the
        host (the stale-on-delete snapshot Bloom is never consulted for
        them), unmentioned keys screen through the per-shard snapshot
        Bloom — rebuilt over the live set at every compaction — and the
        survivors resolve through ONE `_ranks` device dispatch.
        Accounting matches the unsharded service (count/hits/latency
        here; Bloom screens and genuine false positives credited to the
        owning shard, so aggregate telemetry survives rebalances)."""
        t0 = time.perf_counter()
        q = np.atleast_1d(np.asarray(keys, np.float64))
        with obs_trace.span("service.contains", cat="service",
                            sharded=True):
            out = self._contains_inner(q)
        dt = time.perf_counter() - t0
        self.stats["contains"] += q.size
        self.stats["contains_hits"] += int(out.sum())
        self.stats["contains_s"] += dt
        self._observe_op("contains", dt)
        return out

    def _contains_inner(self, q: np.ndarray) -> np.ndarray:
        with self._lock:
            shard_of = self._router.route(q)
            caps = [s._state() for s in self._shards]
            out = np.zeros(q.shape, bool)
            maybe = np.zeros(q.shape, bool)
            for s, (snap, frozen, active) in enumerate(caps):
                m = shard_of == s
                if not m.any():
                    continue
                idx = np.flatnonzero(m)
                qm = q[idx]
                mentioned = np.zeros(qm.shape, bool)
                for level in iter_levels(frozen, active):
                    mentioned |= member(level.ins_keys, qm)
                    mentioned |= member(level.del_keys, qm)
                if mentioned.any():
                    # delta-absorbed: a mentioned key's liveness is decided
                    # by the youngest level that knows it (plus exact base
                    # membership) — no device dispatch, no Bloom
                    qmm = qm[mentioned]
                    out[idx[mentioned]] = live_mask(
                        member(snap.keys.raw, qmm), frozen, active, qmm
                    )
                rest = ~mentioned
                if snap.bloom is not None:
                    mb = np.zeros(qm.shape, bool)
                    mb[rest] = snap.bloom.contains(qm[rest])
                    self._shards[s].stats["bloom_screened"] += int(
                        (rest & ~mb).sum()
                    )
                    maybe[idx[mb]] = True
                else:
                    maybe[idx[rest]] = True
            if maybe.any():
                _, lv = self._ranks(q[maybe])
                out[maybe] = lv
                if not lv.all():
                    # survivors the filter passed that turned out dead are
                    # its GENUINE false positives (deleted keys no longer
                    # inflate this: they are delta-absorbed until the
                    # compaction boundary rebuilds the filter)
                    fp = np.flatnonzero(maybe)[~lv]
                    for s in np.unique(shard_of[fp]):
                        if caps[int(s)][0].bloom is not None:
                            self._shards[int(s)].stats["bloom_fp"] += int(
                                (shard_of[fp] == s).sum()
                            )
            return out

    def range_lookup(self, lo: float, hi: float) -> Tuple[int, int]:
        """[lo, hi) as global merged ranks — the endpoints may route to
        different shards; the prefix-sum offsets make the two ranks
        comparable anyway.  ``hi < lo`` clamps to the empty range
        ``(r, r)`` at lo's rank."""
        t0 = time.perf_counter()
        with obs_trace.span("service.range", cat="service", sharded=True):
            if hi < lo:
                hi = lo
            ranks, _ = self._ranks(np.array([lo, hi], np.float64))
        dt = time.perf_counter() - t0
        self.stats["range"] += 1
        self.stats["range_s"] += dt
        self._observe_op("range", dt)
        return int(ranks[0]), int(ranks[1])

    # ---- scans -----------------------------------------------------------
    def scan(self, lo: float, hi: float, page_size: int = 256):
        """Stream the live rows in [lo, hi) as fixed-size `ScanPage`s
        in global merge order across every shard the range touches.

        The endpoints route through the learned router; each touched
        shard pins its (snapshot, frozen, active) view *eagerly at
        call time*, so an open iterator survives per-shard
        compactions, router re-fits, and full rebalances mid-scan.
        Per-shard page streams stitch back into full pages in router
        boundary order (shard ranges tile the key space, so
        concatenation IS global merge order)."""
        t0 = time.perf_counter()
        with obs_trace.span("service.scan", cat="service", sharded=True):
            q = np.array([lo, hi], np.float64)
            with self._lock:
                if not (hi > lo):
                    views = []
                else:
                    s0, s1 = (int(s) for s in self._router.route(q))
                    views = [
                        self._shards[s]._pin() for s in range(s0, s1 + 1)
                    ]
        setup = time.perf_counter() - t0
        self.stats["scan"] += 1
        self.stats["scan_s"] += setup
        self._observe_op("scan", setup)

        def pages():
            # time the generator STEP: page production inside
            # repack_pages lands in scan_s and the per-page histogram
            streams = (scan_pages(v, lo, hi, page_size) for v in views)
            it = repack_pages(streams, page_size)
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

    # ---- device fast path ------------------------------------------------
    def lookup_batch(self, keys) -> torch.Tensor:
        """ONE-dispatch sharded merged lookup: route on the host, then
        one launch of the sharded kernel (or its plain twin) AND the
        prefix-sum reassembly.  Same exactness caveat as
        `IndexService.lookup_batch` (float32 frame, no host
        refinement).  Returns int32 global merged ranks on the
        service's device."""
        t0 = time.perf_counter()
        with obs_trace.span("service.lookup_batch", cat="service",
                            sharded=True):
            q = np.atleast_1d(np.asarray(keys, np.float64))
            with self._lock:
                plan = self._device_plan()
                shard_of = self._router.route(q)
            _, merged = self._routed_lookup(plan, q, shard_of)
        dt = time.perf_counter() - t0
        self.stats["lookup_batch"] += q.size
        self.stats["lookup_batch_s"] += dt
        self._observe_op("lookup_batch", dt)
        return merged

    def scan_batch(self, lo: float, hi: float, page_size: int = 256):
        """Device fast path for sharded scans: ONE dispatch ranks
        [lo, hi) on every shard, prefix-sums the per-shard spans into
        stream ownership, and gathers the global page stream through
        `rmi_sharded_scan_page_cuda` (its plain twin under the
        non-kernel strategies).  The stacked slabs come from the
        incremental scan-plane cache: a write re-packs only its own
        shard's slab row.

        Returns ``(keys (G, page_size) f32, vals i32, live_mask)``
        tensors in the plane's SHARED normalized frame (`scan_normalize`
        maps raw keys into it); pages past the range come back fully
        masked.  The output bound counts the rows in the same float32
        frame the device ranks in (ROADMAP queue C entry 7).  Exact
        under the usual float32-injectivity caveat; the host `scan` is
        the exact float64 surface."""
        t0 = time.perf_counter()
        with obs_trace.span("service.scan_batch", cat="service",
                            sharded=True):
            with self._lock:
                plane = self._scan_plane()
                lo_hi = plane.normalize(np.array([lo, hi], np.float64))
                pages = scan_page_bound(
                    [plane.base_np[s, : r["n"]] for s, r in enumerate(plane.rows)],
                    plane.ins_total, *lo_hi, page_size,
                )
            out = kernels_ops.rmi_sharded_scan_page_op(
                torch.from_numpy(lo_hi).to(self.device),
                plane.base, plane.bvals, plane.live_prefix,
                plane.ins, plane.ivals, plane.ins_rank,
                page_size=page_size, max_pages=pages,
                use_kernel=self._use_kernel, strategy=self.config.strategy,
            )
        dt = time.perf_counter() - t0
        self.stats["scan_batch"] += 1
        self.stats["scan_batch_s"] += dt
        self._observe_op("scan_batch", dt)
        return out

    def scan_normalize(self, keys) -> np.ndarray:
        """Raw keys -> the shared float32 frame `scan_batch` rows use
        (per-shard snapshots each carry their own frame, so the stacked
        scan plane fixes one global affine map at plane build)."""
        return self._scan_plane().normalize(keys)

    @staticmethod
    def _scan_key(svc: IndexService) -> tuple:
        return scan_plane_key(*svc._state())

    def _scan_plane(self) -> _ScanPlane:
        """The incremental stacked scan plane: per-shard slabs (base
        keys re-normalized into one shared frame, prefix-sum page
        index, staged-insert arrays) cached per (snapshot, delta
        version) — a write to one shard re-packs ONE slab row; the
        frame and every other row are reused, and a delta-only change
        skips re-uploading the (much larger) base/bvals stacks.  A
        rebalance (new shard services) or a pad-bucket change rebuilds
        from scratch.

        Publication is atomic: each rebuild assembles a NEW plane
        object and installs it with one reference write, so a reader
        racing a rebuild sees either the old fully-consistent plane or
        the new one."""
        with self._lock:
            svcs = self._shards
            keys = [self._scan_key(s) for s in svcs]
            old = self._scan_cache
            same_shards = (
                old is not None
                and len(old.shards_key) == len(svcs)
                and all(a is b for a, b in zip(old.shards_key, svcs))
            )
            if same_shards and all(
                scan_plane_key_eq(a, b) for a, b in zip(old.key, keys)
            ):
                self._plane_ctr["scan.hit"].add(1)
                return old
            self._plane_ctr["scan.miss"].add(1)

            changed = [
                s for s in range(len(svcs))
                if not (same_shards and scan_plane_key_eq(old.key[s], keys[s]))
            ]
            pins = {s: svcs[s]._pin() for s in changed}
            sizes_n = [
                pins[s].base_keys.size if s in pins else old.rows[s]["n"]
                for s in range(len(svcs))
            ]
            sizes_d = [
                pins[s].ins_keys.size if s in pins else old.rows[s]["d"]
                for s in range(len(svcs))
            ]
            n_pad = _pad_bucket(max(sizes_n) + 1)
            d_pad = _pad_bucket(max(sizes_d) + 1)
            if same_shards and old.n_pad == n_pad and old.d_pad == d_pad:
                # incremental: fresh plane object sharing the host mirrors
                # (the published old plane is never mutated — its device
                # tensors are copies); base keys and payloads only change
                # when a shard's SNAPSHOT moved
                plane = dataclasses.replace(
                    old, rows=list(old.rows), raws=list(old.raws)
                )
                snap_dirty = any(
                    old.key[s][0] is not keys[s][0] for s in changed
                )
            else:
                # full rebuild: pin the shards not already pinned, then
                # size pads and frame from the FINAL pin set — a
                # background compaction between the key probe and the pin
                # may have grown a shard past the probed sizes
                changed = list(range(len(svcs)))
                for s in changed:
                    if s not in pins:
                        pins[s] = svcs[s]._pin()
                n_pad = _pad_bucket(
                    max(v.base_keys.size for v in pins.values()) + 1
                )
                d_pad = _pad_bucket(
                    max(v.ins_keys.size for v in pins.values()) + 1
                )
                lo, hi = fit_scan_frame([pins[s] for s in changed])
                s_count = len(svcs)
                plane = _ScanPlane(
                    key=(), shards_key=tuple(svcs),
                    lo=float(lo), hi=float(hi), n_pad=n_pad, d_pad=d_pad,
                    rows=[None] * s_count, raws=[None] * s_count, ins_total=0,
                    base=None, bvals=None, live_prefix=None, ins=None,
                    ivals=None, ins_rank=None,
                    base_np=np.full((s_count, n_pad), np.inf, np.float32),
                    bvals_np=np.zeros((s_count, n_pad), np.int32),
                    lp_np=np.zeros((s_count, n_pad + 1), np.int32),
                    ins_np=np.full((s_count, d_pad), np.inf, np.float32),
                    ivals_np=np.zeros((s_count, d_pad), np.int32),
                    irank_np=np.zeros((s_count, d_pad), np.int32),
                )
                snap_dirty = True
            for s in changed:
                view = pins[s]
                row = pack_scan_slab(view, plane.normalize, n_pad, d_pad)
                # keep only the true sizes — the arrays live in the mirrors
                plane.rows[s] = {
                    "n": view.base_keys.size, "d": view.ins_keys.size,
                }
                plane.raws[s] = view.base_keys
                plane.base_np[s] = row["base"]
                plane.bvals_np[s] = row["bvals"]
                plane.lp_np[s] = row["live_prefix"]
                plane.ins_np[s] = row["ins"]
                plane.ivals_np[s] = row["ivals"]
                plane.irank_np[s] = row["ins_rank"]
            plane.ins_total = int(sum(r["d"] for r in plane.rows))
            # copies of the mirrors (`_upload`); delta-only changes reuse
            # the old base/bvals device tensors outright (the dominant
            # transfer for large indexes)
            if snap_dirty:
                plane.base = _upload(plane.base_np, self.device)
                plane.bvals = _upload(plane.bvals_np, self.device)
            plane.live_prefix = _upload(plane.lp_np, self.device)
            plane.ins = _upload(plane.ins_np, self.device)
            plane.ivals = _upload(plane.ivals_np, self.device)
            plane.ins_rank = _upload(plane.irank_np, self.device)
            plane.key = tuple(keys)
            self._scan_cache = plane  # atomic publish of the finished plane
            return plane

    def _shard_mesh(self):
        """1-D shard mesh for the plain (non-kernel) strategies, or None
        (always None for the kernel strategies, which stay on one card,
        and on one card)."""
        if self.config.strategy in KERNEL_STRATEGIES:
            return None
        return index_shard_mesh(self.num_shards, self.device.type)

    def _static_stack(self, snaps):
        """Snapshot-derived stacks (base keys, leaf SoA, stage-0, base
        offsets) — rebuilt only when a compaction/rebalance publishes a
        new snapshot, NOT on every write, and then only the CHANGED
        shard's row is re-packed: per-shard rows are cached by snapshot
        identity and padded to stable quarter-pow2 buckets, so one
        shard's compaction leaves every other row byte-identical."""
        with self._lock:
            static_key = tuple((sn,) for sn in snaps)
            cached = self._static_plan
            if cached is not None and _same_objects(cached[0], static_key):
                return cached
            n_pad = _pad_bucket(max(sn.n for sn in snaps) + 1)
            m_pad = _pad_bucket(max(sn.index.num_leaves for sn in snaps),
                                min_pad=16)
            rows = []
            new_cache = {}
            for s, sn in enumerate(snaps):
                prev = self._static_rows.get(s)
                if (prev is not None and prev[0] is sn
                        and prev[1]["keys"].shape[0] == n_pad
                        and prev[1]["leaf_w"].shape[0] == m_pad):
                    row = prev[1]
                else:
                    row = kernels_ops.pad_shard_row(
                        sn.index, sn.keys.norm, n_pad, m_pad
                    )
                rows.append(row)
                new_cache[s] = (sn, row)
            self._static_rows = new_cache
            stacked = kernels_ops.stack_rows(rows, self.device)
            hidden = stacked.pop("hidden")
            max_window = stacked.pop("max_window")
            base_n = np.array([sn.n for sn in snaps], np.int64)
            base_off_np = np.zeros(len(snaps), np.int64)
            base_off_np[1:] = np.cumsum(base_n[:-1])
            stacked["base_off"] = _upload(base_off_np.astype(np.int32), self.device)
            mesh = self._shard_mesh()
            if mesh is not None:
                stacked = place_index_shards(stacked, mesh)
            cached = (static_key, stacked, hidden, max_window,
                      [sn.keys.normalize for sn in snaps], base_off_np)
            self._static_plan = cached
            return cached

    def _device_plan(self) -> _DevicePlan:
        """The one-dispatch lookup plan, cached incrementally: keyed
        per shard on (snapshot identity, delta-slab identity) — a
        shard's `_capture` publishes a new delta slab only when that
        shard's state changed, so a write to one shard re-packs exactly
        one row of the host delta mirrors (and its live count) before
        the re-upload."""
        with self._lock:
            caps = [s._capture() for s in self._shards]
            key = tuple((c[0], c[3]) for c in caps)
            plan = self._plan
            if plan is not None and _same_objects(plan.key, key):
                self._plane_ctr["lookup.hit"].add(1)
                return plan
            self._plane_ctr["lookup.miss"].add(1)
            snaps = [c[0] for c in caps]
            (_, stacked, hidden, max_window, normalizers,
             base_off_np) = self._static_stack(snaps)

            d_max = max(int(c[3].shape[0]) for c in caps)
            reuse = (
                plan is not None
                and len(plan.key) == len(key)
                and plan.dkeys_np.shape[1] == d_max
            )
            if reuse:
                dkeys = plan.dkeys_np
                dprefix = plan.dprefix_np
                live = plan.live_np
                changed = [
                    s for s in range(len(caps))
                    if not (plan.key[s][0] is key[s][0]
                            and plan.key[s][1] is key[s][1])
                ]
            else:
                dkeys = np.full((len(caps), d_max), np.inf, np.float32)
                dprefix = np.zeros((len(caps), d_max + 1), np.int32)
                live = np.zeros(len(caps), np.int64)
                changed = list(range(len(caps)))
            for s in changed:
                c = caps[s]
                dk, dp = c[3].cpu().numpy(), c[4].cpu().numpy()
                dkeys[s, :] = np.inf
                dkeys[s, : dk.size] = dk
                dprefix[s, : dp.size] = dp
                dprefix[s, dp.size:] = dp[-1]
                live[s] = snaps[s].n + int(
                    count_less(c[1], c[2], np.array([np.inf]))[0]
                )
            merged_off_np = np.zeros(len(caps), np.int64)
            merged_off_np[1:] = np.cumsum(live[:-1])
            delta = {
                "dkeys": _upload(dkeys, self.device),
                "dprefix": _upload(dprefix, self.device),
                "merged_off": _upload(merged_off_np.astype(np.int32), self.device),
            }
            mesh = self._shard_mesh()
            if mesh is not None:
                delta = place_index_shards(delta, mesh)
            plan = _DevicePlan(
                key=key,
                caps=caps,
                q_normalizers=normalizers,
                **stacked,
                **delta,
                hidden=hidden,
                max_window=max_window,
                dkeys_np=dkeys,
                dprefix_np=dprefix,
                live_np=live,
                base_off_np=base_off_np,
                merged_off_np=merged_off_np,
            )
            self._plan = plan
            return plan

    # ---- writes ----------------------------------------------------------
    def insert(self, keys, vals=None) -> int:
        t0 = time.perf_counter()
        q = np.atleast_1d(np.asarray(keys, np.float64))
        v = None if vals is None else np.atleast_1d(np.asarray(vals, np.int64))
        with obs_trace.span("service.insert", cat="service", sharded=True), \
                self._lock:
            shard_of = self._router.route(q)
            applied = 0
            for s, svc in enumerate(self._shards):
                m = shard_of == s
                if m.any():
                    applied += svc.insert(q[m], None if v is None else v[m])
            # no plan invalidation: the device-plane caches diff per-shard
            # (snapshot, delta version) keys and re-pack only touched rows
            self._maybe_rebalance()
        dt = time.perf_counter() - t0
        self.stats["insert"] += int(q.size)
        self.stats["insert_s"] += dt
        self._observe_op("insert", dt)
        return applied

    def delete(self, keys) -> int:
        t0 = time.perf_counter()
        q = np.atleast_1d(np.asarray(keys, np.float64))
        with obs_trace.span("service.delete", cat="service", sharded=True):
            applied = self._delete_inner(q)
        dt = time.perf_counter() - t0
        self.stats["delete"] += int(q.size)
        self.stats["delete_s"] += dt
        self._observe_op("delete", dt)
        return applied

    def _delete_inner(self, q: np.ndarray) -> int:
        with self._lock:
            # a shard's IndexService cannot compact below 2 keys, so a
            # batch that would drain one shard's whole range (routine at
            # K > 1) first rebalances.  Equalization repopulates the
            # at-risk shards from their neighbors WITHOUT dropping K while
            # the live set has headroom; only when it does not, K steps
            # down ONE shard at a time (local pair merges — not the old
            # stop-the-world halving), bottoming out at the K=1
            # (global-drain) semantics of the unsharded service.  The
            # cheap guard counts requested keys; only when it trips do we
            # pay for an exact per-shard liveness check, so no-op deletes
            # of absent keys (idempotent retries) never cascade
            # rebalances.
            u = np.unique(q)
            while self.num_shards > 1 and self._delete_would_drain(u):
                k = self.num_shards
                self.rebalance(k)
                if self.num_shards >= k and self._delete_would_drain(u):
                    self.rebalance(k - 1)
            shard_of = self._router.route(q)
            applied = 0
            for s, svc in enumerate(self._shards):
                m = shard_of == s
                if m.any():
                    applied += svc.delete(q[m])
            self._maybe_rebalance()
            return applied

    def _delete_would_drain(self, u: np.ndarray) -> bool:  # lixlint: holds(_lock)
        """True when deleting unique keys ``u`` could leave some shard
        below the 2 keys its IndexService needs."""
        shard_u = self._router.route(u)
        counts = self._live_counts()
        per_shard = np.bincount(shard_u, minlength=self.num_shards)
        risky = np.nonzero(counts - per_shard < 2)[0]
        for s in risky:
            _, live = self._shards[s]._rank_exact(u[shard_u == s])
            if counts[s] - int(live.sum()) < 2:
                return True
        return False

    # ---- mixed batched front end ----------------------------------------
    def execute(self, ops: Sequence[Tuple]) -> List:
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

    # ---- compaction / rebalancing ---------------------------------------
    def flush(self) -> None:
        with self._lock:
            if self.num_shards > 1 and (self._live_counts() < 2).any():
                # a drained shard cannot compact; equalization repopulates
                # it from its neighbors (K only shrinks when the whole live
                # set is too small to sustain it)
                self.rebalance(self.num_shards)
            for s in self._shards:
                s.flush()

    def _maybe_rebalance(self) -> bool:
        with self._lock:
            k = self.num_shards
            counts = self._live_counts()
            total = int(counts.sum())
            target = self.config.num_shards
            if k < target and total >= 4 * target:
                # earlier drain-rebalances shrank K; regrow to the intent
                self.rebalance(target)
                return True
            if k == 1:
                return False
            if counts.min() < 2:
                # repopulate the drained shard from its neighbors; the
                # rebalance clamp shrinks K only if the live set demands it
                self.rebalance(k)
                return True
            if total < 4 * k:
                return False
            if counts.max() <= self.config.shard_balance_factor * total / k:
                return False
            self.rebalance()
            return True

    # ---- online rebalance primitives ------------------------------------
    def _retire_stats(self, old: Sequence[IndexService]) -> None:  # lixlint: holds(_lock)
        """Fold retiring shards' lifetime tallies into ``_retired`` so
        aggregate stats and the `version` property stay monotone across
        reshapes."""
        self._retired["versions"] += sum(s.version for s in old)
        for svc in old:
            for stat, v in svc.stats.items():
                self._retired[stat] = self._retired.get(stat, 0) + v

    def _install_router(self, boundaries, sample=None) -> None:  # lixlint: holds(_lock)
        """Retire the current router (folding its lifetime tallies so
        stats_summary stays monotone) and install a freshly fitted one
        over ``boundaries``.  The fit runs BEFORE any mutation: a
        re-fit that crashes (the ``router.refit`` fault point) leaves
        the old router — stats, boundaries, and all — serving exactly
        as before, so the enclosing reshape/rebalance aborts cleanly."""
        faults.maybe("router.refit")
        router = LearnedRouter.fit(
            np.asarray(boundaries, np.float64), sample_keys=sample
        )
        router.metrics = self.metrics
        for stat, v in self._router.stats.items():
            key = f"router_{stat}"
            self._retired[key] = self._retired.get(key, 0) + v
        self._router = router
        self._refit_ctr.add(1)

    def _reshape(self, s0: int, s1: int, cut_counts: Sequence[int]) -> None:  # lixlint: holds(_lock)
        """The one LOCAL rebalance step: rebuild shards [s0, s1) into
        ``len(cut_counts)`` new shards holding exactly those live-key
        counts, shipping the retiring shards' collapsed live slices
        (levels folded by `_live_arrays`) into the new owners.  Shards
        outside [s0, s1) are untouched — their services, snapshots, and
        device-plane rows keep serving, and any pinned scan view stays
        valid because the retired services' arrays are immutable behind
        it.  The spliced router and shard list publish together at the
        end, so reads between steps always see a consistent tiling."""
        old = self._shards[s0:s1]
        parts = [_live_arrays(svc) for svc in old]
        keys = np.concatenate([p[0] for p in parts])
        vals = None
        if all(p[1] is not None for p in parts):
            vals = np.concatenate([p[1] for p in parts])
        pos = np.concatenate([[0], np.cumsum(cut_counts)]).astype(np.int64)
        assert int(pos[-1]) == keys.size, "cut_counts must cover the slice"
        pieces = []
        for i in range(len(cut_counts)):
            a, b = int(pos[i]), int(pos[i + 1])
            if b - a < 2:
                raise ValueError(
                    f"reshape piece {i} would hold {b - a} keys (< 2)"
                )
            # reshaped shards are built dir-less: durability is owned
            # by save()/IndexCheckpointer, never by a transient reshape
            cfg = dataclasses.replace(
                self.config, num_shards=1, snapshot_dir=None
            )
            pieces.append(IndexService(
                keys[a:b], cfg, vals=None if vals is None else vals[a:b],
                device=self.device,
            ))
        bounds = self._router.boundaries
        bounds = np.concatenate(
            [bounds[:s0], keys[pos[1:-1]], bounds[s1 - 1:]]
        )
        shards = list(self._shards)
        shards[s0:s1] = pieces
        # router first: its fit is the only step here that can fail, and
        # it mutates nothing until it succeeds — so a refit crash aborts
        # the reshape with the old router AND the old shards intact
        self._install_router(bounds)
        self._retire_stats(old)
        self._shards = shards

    def _merge_pair(self, s: int) -> None:  # lixlint: holds(_lock)
        """Merge shards s and s+1 into one (a local 2 -> 1 reshape)."""
        c = self._live_counts()
        self._reshape(s, s + 2, [int(c[s] + c[s + 1])])
        self._reshape_ctr["merges"].add(1)

    def _split_shard(self, s: int) -> None:  # lixlint: holds(_lock)
        """Split shard s at its live median (a local 1 -> 2 reshape)."""
        c = int(self._live_counts()[s])
        self._reshape(s, s + 1, [c - c // 2, c // 2])
        self._reshape_ctr["splits"].add(1)

    def _equalize(self) -> None:  # lixlint: holds(_lock)
        """Left-to-right boundary sweeps pinning each boundary to its
        global live quantile: boundary s moves so shards 0..s hold
        (s+1)/K of the live keys.  Each move is one local pair reshape
        (2 -> 2); a pair already on target costs nothing.  Mass travels
        at most one shard per sweep, so K+1 sweeps bound the worst case
        (all mass at one end); in the common mild-skew case the first
        sweep lands every boundary and the second is a no-op."""
        k = self.num_shards
        if k == 1:
            return
        for _ in range(k + 1):
            total = int(self._live_counts().sum())
            moved = False
            for s in range(k - 1):
                counts = self._live_counts()
                left = int(counts[:s].sum())
                pair = int(counts[s] + counts[s + 1])
                want = ((s + 1) * total) // k - left
                want = max(2, min(want, pair - 2))
                if pair < 4 or abs(int(counts[s]) - want) <= 2:
                    continue
                self._reshape(s, s + 2, [want, pair - want])
                self._reshape_ctr["shifts"].add(1)
                moved = True
            if not moved:
                break

    def rebalance(self, num_shards: Optional[int] = None) -> None:
        """Online shard rebalance: a bounded sequence of LOCAL merge /
        split / boundary-shift steps, each shipping only the touched
        neighbors' collapsed live slices while every other shard — and
        any pinned scan view — keeps serving.  (The old implementation
        drained and rebuilt ALL shards behind one global re-cut.)  Keys
        change owners, never global ranks (the oracle tests churn
        straight through this).  The target K clamps to live/2 so every
        shard keeps the >= 2 keys an IndexService needs; a final model
        re-fit installs a fresh router — fresh health stats — over a
        global live sample even when no boundary moved."""
        with self._lock:
            with obs_trace.span("service.rebalance", cat="rebalance"), \
                    self._op_hist["rebalance"].time():
                total = int(self._live_counts().sum())
                k = max(1, min(num_shards or self.num_shards,
                               max(1, total // 2)))
                # 1. drained shards first: merge each into a neighbor (an
                #    IndexService cannot exist below 2 keys)
                while self.num_shards > 1:
                    counts = self._live_counts()
                    low = int(counts.argmin())
                    if counts[low] >= 2:
                        break
                    self._merge_pair(
                        low if low + 1 < self.num_shards else low - 1
                    )
                # 2. walk K to the target: merge the lightest adjacent
                #    pair / split the heaviest shard, one step at a time
                while self.num_shards > k:
                    counts = self._live_counts()
                    self._merge_pair(int((counts[:-1] + counts[1:]).argmin()))
                while self.num_shards < k:
                    counts = self._live_counts()
                    big = int(counts.argmax())
                    if counts[big] < 4:
                        break
                    self._split_shard(big)
                # 3. pin every boundary to its global live quantile
                self._equalize()
                # 4. fresh router over a global base sample
                snaps = [s._state()[0] for s in self._shards]
                sample = np.concatenate([
                    sn.keys.raw[:: max(1, sn.n // 64)] for sn in snaps
                ]) if snaps else np.empty(0, np.float64)
                self._install_router(self._router.boundaries, sample=sample)
                self.stats["rebalances"] += 1
                if self.config.snapshot_dir is not None:
                    self._save_router()

    # ---- persistence -----------------------------------------------------
    def _save_router(self) -> str:
        with self._lock:
            os.makedirs(self.config.snapshot_dir, exist_ok=True)
            return self._router.save(
                os.path.join(self.config.snapshot_dir, _ROUTER_FILE)
            )

    def save(self, directory: Optional[str] = None) -> str:
        """Drain + persist: every shard compacts and writes its latest
        snapshot under ``<dir>/shard-XX/``; the router lands beside
        them."""
        with self._lock:
            if directory is not None:
                self.config = dataclasses.replace(
                    self.config, snapshot_dir=directory
                )
            assert self.config.snapshot_dir is not None, "no snapshot_dir"
            self.flush()
            for s, svc in enumerate(self._shards):
                sub = os.path.join(
                    self.config.snapshot_dir, _SHARD_DIR.format(s)
                )
                if os.path.isdir(sub):
                    # reshapes reassign ranges between shard slots, so a
                    # stale higher-version snapshot here could shadow the
                    # one we are about to write on the next load
                    shutil.rmtree(sub)
                svc.save(sub)
            s = self.num_shards
            while True:  # drop shard dirs beyond the current K
                sub = os.path.join(
                    self.config.snapshot_dir, _SHARD_DIR.format(s)
                )
                if not os.path.isdir(sub):
                    break
                shutil.rmtree(sub)
                s += 1
            return self._save_router()

    @classmethod
    def load(
        cls, directory: str, config: Optional[ServiceConfig] = None,
        device=None,
    ) -> "ShardedIndexService":
        """Restart: reload the router + every shard's latest snapshot
        (the ``router.npz`` + ``shard-NN/`` layout, the reference's as
        well) onto ``device``."""
        router = LearnedRouter.load(os.path.join(directory, _ROUTER_FILE))
        config = config or ServiceConfig()
        config = dataclasses.replace(
            config, snapshot_dir=directory, num_shards=router.num_shards
        )
        svc = cls(np.empty(0), config, device=device, _router=router, _shards=[])
        svc._shards = [
            IndexService.load(
                os.path.join(directory, _SHARD_DIR.format(s)),
                svc._shard_config(s), device=svc.device,
            )
            for s in range(router.num_shards)
        ]
        return svc

    # ---- reporting -------------------------------------------------------
    def stats_summary(self) -> Dict[str, object]:
        with self._lock:
            def agg(key):  # lixlint: holds(_lock)
                return (self._retired.get(key, 0)
                        + sum(s.stats[key] for s in self._shards))
            s = self.stats

            def per_op(kind):
                n = s[kind]
                return {
                    "count": int(n),
                    "ns_per_op": (s[f"{kind}_s"] / n * 1e9) if n else 0.0,
                }
            counts = self._live_counts()
            # router health: hit-rate over the SERVICE lifetime (current
            # router + every router retired by a rebalance re-fit), plus
            # the live-count skew the next re-fit would be judged by
            routed = self._retired.get("router_routed", 0) \
                + self._router.stats["routed"]
            model_hits = self._retired.get("router_model_hits", 0) \
                + self._router.stats["model_hits"]
            mean = counts.mean() if counts.size else 0.0
            router_health = {
                "model_hit_rate": (model_hits / routed) if routed else None,
                "routed": int(routed),
                "refits": int(self._refit_ctr.value),
                "rebalances": int(s["rebalances"]),
                "live_count_skew": (
                    float(counts.max() / mean) if mean > 0 else 0.0
                ),
            }
            return {
                "num_shards": self.num_shards,
                "live_keys": int(counts.sum()),
                "shard_live_keys": counts.tolist(),
                "shard_versions": [sh.version for sh in self._shards],
                "rebalances": int(s["rebalances"]),
                "router_model_hit_rate": self._router.model_hit_rate,
                "router": router_health,
                "get": {
                    **per_op("get"),
                    "hit_rate": s["get_hits"] / s["get"] if s["get"] else 0.0,
                },
                "contains": {
                    **per_op("contains"),
                    "hit_rate": (s["contains_hits"] / s["contains"]
                                 if s["contains"] else 0.0),
                    "bloom_screened": int(agg("bloom_screened")),
                    "bloom_fp": int(agg("bloom_fp")),
                },
                "range": per_op("range"),
                "scan": {
                    "count": int(s["scan"]),
                    "pages": int(s["scan_pages"]),
                    "rows": int(s["scan_rows"]),
                    "total_s": round(s["scan_s"], 4),
                },
                "insert_applied": int(agg("insert_applied")),
                "delete_applied": int(agg("delete_applied")),
                "compactions": int(agg("compactions")),
                "compact_stalls": int(agg("compact_stalls")),
                "write_stalls": int(agg("write_stalls")),
                "write_stall_s": float(agg("write_stall_s")),
                "bloom_screened": int(agg("bloom_screened")),
            }
