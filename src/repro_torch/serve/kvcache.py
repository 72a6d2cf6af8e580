"""Paged KV-cache allocation with a learned (RMI) page table.

Paged attention keeps KV in fixed-size physical pages; each request
owns a scattered list of pages.  The page table maps a *key*
``request_id * MAX_PAGES + logical_page`` to the physical page id.
With thousands of concurrent requests this table is a sorted array
queried every decode step for every (request, attended page) — a
textbook §3 range-index workload, and the serving-side integration of
the paper: the batched RMI kernel replaces binary search over the
allocation table.

The allocator is host-side (allocation is control plane); the *lookup*
is the data-plane hot path and runs on the allocator's device (RMI
predict + bounded search).
Allocations and frees no longer invalidate the whole index: they stage
into an `index_service.DeltaBuffer`, translation consults base + delta
in one merged pass, and the RMI is only rebuilt — warm, via
`refit_rmi`, reusing every leaf whose key range didn't change — when
the delta fills (LSM-style minor compaction).

``num_shards > 1`` splits the page-table key space into quantile
ranges, each with its own snapshot + delta + compaction schedule (the
`ShardedIndexService` layout specialized to value lookups: translation
is a per-shard gather, so reassembly needs no rank offsets).  A hot
tenant's allocation churn then only rebuilds its own shard's RMI.
The port of the reference's `repro/serve/kvcache.py`: the same host
control plane, with the page-table snapshots and the scan plane on
``device`` (None = "cuda").  Strategy names are the port's
(`index_service.REFERENCE_STRATEGY` maps them to the reference's).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.rmi import RMIConfig
from repro_torch.device import resolve_device
from repro_torch.index_service.compact import Compactor
from repro_torch.index_service.delta import DeltaBuffer
from repro_torch.index_service.router import LearnedRouter
from repro_torch.index_service.scan import (
    PinnedView,
    pin_view,
    repack_pages,
    scan_page_bound,
    scan_pages,
    stack_scan_slabs,
)
from repro_torch.index_service.snapshot import (
    IndexSnapshot,
    build_snapshot,
    validate_strategy,
)
from repro_torch.kernels import ops as kernels_ops

MAX_PAGES_PER_REQ = 4096


@dataclasses.dataclass
class _PageShard:
    """One range of the page-table key space: snapshot + staged delta."""

    snap: IndexSnapshot
    delta: DeltaBuffer


@dataclasses.dataclass
class PagedKVAllocator:
    """Free-list page allocator + delta-buffered learned page table.

    ``strategy`` selects the base lookup path for `translate` — any
    name in `index_service.MERGED_STRATEGIES`; the kernel strategies
    (`cuda`, `cuda_fused`, `sharded_fused`) run the CUDA RMI kernels on
    the card and their plain twins on the CPU.  ``num_shards`` > 1
    range-partitions the page table (per-shard snapshot/delta/
    compaction).  ``device`` holds the snapshots and the scan plane."""

    num_pages: int
    page_size: int
    delta_capacity: int = 2048
    strategy: str = "binary"
    num_shards: int = 1
    device: Optional[torch.device] = None   # None = "cuda"

    def __post_init__(self):
        validate_strategy(self.strategy)
        self.device = resolve_device(self.device)
        if self.num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        self._free = list(range(self.num_pages - 1, -1, -1))
        self._table: Dict[int, int] = {}   # key -> physical page
        self._per_req: Dict[int, List[int]] = {}
        self._shards: List[_PageShard] = []
        # shard router over the page-table key space (same learned
        # boundary model + exact fallback the index service uses)
        self._router = LearnedRouter(np.empty(0, np.float64))
        self._binary_cache = None
        self._scan_plane_cache = None  # keyed (snap, delta, delta.version)

    # ---- control plane -------------------------------------------------
    def alloc(self, request_id: int, num_tokens: int) -> List[int]:
        n = -(-num_tokens // self.page_size)
        if n > len(self._free):
            raise MemoryError("out of KV pages")
        pages = [self._free.pop() for _ in range(n)]
        start = len(self._per_req.get(request_id, []))
        keys = [request_id * MAX_PAGES_PER_REQ + start + i
                for i in range(len(pages))]
        for key, pg in zip(keys, pages):
            self._table[key] = pg
        self._per_req.setdefault(request_id, []).extend(pages)
        self._stage_many(keys, pages, insert=True)
        self._binary_cache = None
        return pages

    def free(self, request_id: int) -> None:
        keys = []
        for i, pg in enumerate(self._per_req.pop(request_id, [])):
            key = request_id * MAX_PAGES_PER_REQ + i
            if self._table.pop(key, None) is not None:
                keys.append(key)
            self._free.append(pg)
        self._stage_many(keys, None, insert=False)
        self._binary_cache = None

    def _route(self, q: np.ndarray) -> np.ndarray:
        return self._router.route(q)

    def _stage_many(self, keys, vals, *, insert: bool) -> None:
        """Stage page-table mutations into each routed shard's delta in
        one merge per chunk (once an index exists); compact a shard
        when its buffer fills."""
        if not self._shards or not keys:
            return  # still bootstrapping from the dict table
        q = np.asarray(keys, np.float64)
        v = None if vals is None else np.asarray(vals, np.int64)
        shard_of = self._route(q)
        for s, shard in enumerate(self._shards):
            mask = shard_of == s
            if not mask.any():
                continue
            qs = q[mask]
            vs = None if v is None else v[mask]
            pos = 0
            while pos < qs.size:
                room = shard.delta.capacity - len(shard.delta)
                if room <= 0:
                    if self._compact(s):
                        # full rebuild: the fresh snapshots were cut
                        # from self._table, which already reflects this
                        # whole batch — nothing left to stage
                        return
                    shard = self._shards[s]
                    continue
                c = slice(pos, pos + room)
                raw = shard.snap.keys.raw
                i = np.clip(np.searchsorted(raw, qs[c]), 0, raw.size - 1)
                live_below = raw[i] == qs[c]
                if insert:
                    shard.delta.stage_insert_many(qs[c], live_below, vs[c])
                else:
                    shard.delta.stage_delete_many(qs[c], live_below)
                pos += room

    @property
    def num_allocated(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def num_free(self) -> int:
        return len(self._free)

    def request_capacity(self, request_id: int) -> int:
        """Tokens the request's currently-allocated pages can hold —
        the engine grows an allocation (one `alloc` per crossed page
        boundary) whenever generation is about to exceed this."""
        return len(self._per_req.get(request_id, ())) * self.page_size

    # ---- data plane ------------------------------------------------------
    def rebuild_index(self, *, num_leaves: Optional[int] = None):
        """Publish snapshots of the current table: cold-build (and
        re-cut the shard boundaries) the first time or on explicit
        resize, warm per-shard compaction (stage-0 + unchanged leaves
        reused) afterwards."""
        if not self._shards or num_leaves is not None:
            items = sorted(self._table.items())
            keys = np.array([k for k, _ in items], np.float64)
            vals = np.array([v for _, v in items], np.int64)
            if keys.size < 2:
                # near-empty table: stay in bootstrap (dict) mode —
                # translate falls back to the binary baseline
                self._shards = []
                self._router = LearnedRouter(np.empty(0, np.float64))
                return
            k = max(1, min(self.num_shards, keys.size // 2))
            self._router = LearnedRouter.from_keys(keys, k)
            cuts = self._router.split_points(keys)
            self._shards = []
            for s in range(self._router.num_shards):
                a, b = int(cuts[s]), int(cuts[s + 1])
                cfg = RMIConfig(
                    num_leaves=num_leaves or max(16, (b - a) // 64),
                    stage0_hidden=(),
                    stage0_train_steps=0,
                )
                snap, _ = build_snapshot(
                    keys[a:b], vals=vals[a:b], config=cfg, device=self.device
                )
                self._shards.append(
                    _PageShard(snap, DeltaBuffer(self.delta_capacity))
                )
        else:
            for s, shard in enumerate(self._shards):
                if len(shard.delta) and self._compact(s):
                    break  # full rebuild already folded every delta in

    def _compact(self, s: int) -> bool:
        """Compact shard ``s``; returns True when the drift forced a
        full (all-shard) rebuild instead."""
        shard = self._shards[s]
        old = shard.snap
        est = old.n + shard.delta.num_inserts - shard.delta.num_deletes
        target = max(16, est // 64)
        cfg = old.index.config
        if est < 2 or not (cfg.num_leaves // 2 <= target <= cfg.num_leaves * 2):
            # this shard drained below what an index can hold, or its
            # table size drifted past the warm-start regime: re-cut
            # every shard (boundaries may be stale too)
            self._shards = []
            self.rebuild_index()
            return True
        compactor = Compactor(config=cfg, warm=True)
        new, _ = compactor.compact(old, shard.delta)
        self._shards[s] = _PageShard(new, DeltaBuffer(self.delta_capacity))
        return False

    def translate(self, request_ids: np.ndarray, logical_pages: np.ndarray) -> np.ndarray:
        """Batched (request, logical) -> physical page: per-shard RMI
        over the base snapshot merged with that shard's staged delta.

        The RMI search runs in float32; `refine_base_rank` converts its
        result to the exact integer-key position (bounded advance over
        float32-duplicate runs), so the answer is exact, not heuristic."""
        if not self._shards:
            self.rebuild_index()
        if not self._shards:  # < 2 live entries: no index to learn
            return self.translate_binary(request_ids, logical_pages)
        raw_q = (
            request_ids.astype(np.int64) * MAX_PAGES_PER_REQ
            + logical_pages.astype(np.int64)
        ).astype(np.float64)
        shard_of = self._route(raw_q)
        out = np.zeros(raw_q.shape, np.int64)
        for s, shard in enumerate(self._shards):
            mask = shard_of == s
            if not mask.any():
                continue
            qs = raw_q[mask]
            snap, delta = shard.snap, shard.delta
            # the delta side is resolved host-side (it is a value
            # lookup, not a rank), so only the base RMI search runs on
            # device
            qn = torch.as_tensor(snap.keys.normalize(qs), device=self.device)
            b = snap.base_lookup_fn(self.strategy)(qn)
            idx, in_base = snap.refine_base_rank(qs, b.cpu().numpy())
            vals = snap.vals[np.clip(idx, 0, snap.n - 1)]
            in_ins, ins_vals = delta.lookup_value(qs)
            out[mask] = np.where(in_ins, ins_vals, vals)
        return out

    def scan(self, lo: float, hi: float, page_size: int = 256):
        """Stream live page-table rows with keys in [lo, hi) as
        `ScanPage`s — `(keys, physical_page vals, live_mask)` in global
        merge order across every shard's base snapshot + staged delta,
        without compacting and without materializing the merge (the
        `index_service` scan machinery applied to value rows).

        Views pin per shard at call time, so concurrent alloc/free
        churn (and the compactions it triggers) never tears an open
        iterator.  In bootstrap mode (< 2 entries indexed) the dict
        table serves directly."""
        if not self._shards:
            items = sorted(
                (k, v) for k, v in self._table.items() if lo <= k < hi
            )
            view = PinnedView(
                base_keys=np.array([k for k, _ in items], np.float64),
                base_vals=np.array([v for _, v in items], np.int64),
                ins_keys=np.empty(0, np.float64),
                ins_vals=np.empty(0, np.int64),
                del_pos=np.empty(0, np.int64),
            )
            return scan_pages(view, lo, hi, page_size)
        views = [
            pin_view(shard.snap, None, shard.delta)
            for shard in self._shards
        ]
        return repack_pages(
            (scan_pages(v, lo, hi, page_size) for v in views), page_size
        )

    def _scan_plane(self):
        """Stacked per-shard scan slabs for the one-dispatch device
        scan, cached per (snapshot identity, delta identity + mutation
        version) — alloc/free churn bumps a delta version and the next
        `scan_batch` re-packs; unchanged table states reuse the upload
        outright (no explicit invalidation hooks to keep in sync)."""
        key = tuple(
            (sh.snap, sh.delta, sh.delta.version) for sh in self._shards
        )
        plane = self._scan_plane_cache
        if (
            plane is not None and len(plane["key"]) == len(key)
            and all(a[0] is b[0] and a[1] is b[1] and a[2] == b[2]
                    for a, b in zip(plane["key"], key))
        ):
            return plane
        views = [pin_view(sh.snap, None, sh.delta) for sh in self._shards]
        slabs = stack_scan_slabs(views)
        plane = {
            "key": key,
            "normalize": slabs["normalize"],
            "raws": slabs["raws"],
            "ins_total": slabs["ins_total"],
            # fresh arrays per build: plain as_tensor upload is safe here
            # (no in-place mirror mutation like the sharded plane)
            **{name: torch.as_tensor(slabs[name], device=self.device)
               for name in ("base", "bvals", "live_prefix", "ins", "ivals",
                            "ins_rank")},
        }
        self._scan_plane_cache = plane
        return plane

    def scan_batch(self, lo: float, hi: float, page_size: int = 256):
        """Device fast path over the page table: ONE dispatch ranks
        [lo, hi) on every shard and gathers the global page stream
        (`kernels.ops.rmi_sharded_scan_page_op`) — the device twin of
        `scan` for serializers that want `(keys, physical_page, live)`
        pages as device tensors without the host iterator.  Keys come
        back in the plane's shared float32 frame (`scan_normalize`);
        `scan` remains the exact float64 surface.  Requires an index
        (call `rebuild_index` first); bootstrap (dict) mode has no
        device plane."""
        if not self._shards:
            self.rebuild_index()
        if not self._shards:
            raise RuntimeError(
                "page table still in bootstrap mode (< 2 entries); "
                "use scan() instead"
            )
        plane = self._scan_plane()
        pages = scan_page_bound(
            plane["raws"], plane["ins_total"], lo, hi, page_size
        )
        bounds = torch.as_tensor(
            plane["normalize"](np.array([lo, hi], np.float64)),
            device=self.device,
        )
        use_kernel = self.strategy in ("cuda", "cuda_fused", "sharded_fused")
        return kernels_ops.rmi_sharded_scan_page_op(
            bounds, plane["base"], plane["bvals"], plane["live_prefix"],
            plane["ins"], plane["ivals"], plane["ins_rank"],
            page_size=page_size, max_pages=pages, use_kernel=use_kernel,
        )

    def scan_normalize(self, keys) -> np.ndarray:
        """Raw page-table keys -> the float32 frame `scan_batch` rows
        use."""
        return self._scan_plane()["normalize"](keys)

    def request_pages(self, request_id: int, page_size: int = 256):
        """The physical pages of one request in logical order, streamed
        through `scan` over the request's key range — the consumer a
        cache serializer / defragmenter uses to walk a request's KV
        without touching the dict table."""
        lo = float(request_id * MAX_PAGES_PER_REQ)
        hi = float((request_id + 1) * MAX_PAGES_PER_REQ)
        for page in self.scan(lo, hi, page_size):
            yield from (int(v) for v in page.vals[page.live_mask])

    def translate_binary(self, request_ids, logical_pages) -> np.ndarray:
        """Baseline: numpy searchsorted over the same (live) table."""
        raw = (
            request_ids.astype(np.int64) * MAX_PAGES_PER_REQ
            + logical_pages.astype(np.int64)
        ).astype(np.float64)
        if self._binary_cache is None:
            items = sorted(self._table.items())
            self._binary_cache = (
                np.array([k for k, _ in items], np.float64),
                np.array([v for _, v in items], np.int64),
            )
        keys, vals = self._binary_cache
        idx = np.clip(np.searchsorted(keys, raw), 0, len(vals) - 1)
        return vals[idx]
