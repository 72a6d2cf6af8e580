"""Paged merged range scans over a pinned (snapshot, delta) view (the
reference's `index_service/scan.py`, in NumPy as there).

`range_lookup` answers *how many* live keys a range holds; production
range queries need the rows themselves (the paper's §2/§3.4 case is a
scan workload: rank, then read).  This module streams `(keys, vals,
live_mask)` pages in global merge order across base + frozen + active
delta levels — tombstones elided, staged inserts woven in with their
values — without ever materializing the merged array:

  * `PinnedView` — one immutable capture of a service's read state:
    the base snapshot plus the delta stack collapsed to effective
    insert/tombstone arrays (`delta.collapse_levels`).  Snapshots are
    immutable and delta mutations replace arrays wholesale, so a view
    stays internally consistent no matter how much churn (or how many
    compactions/rebalances) happen while an iterator is open.
  * `scan_pages` — the exact float64 cursor walk: per page, one
    tombstone-filtered base slice and one insert slice merge into the
    next ``page_size`` rows (O(page + tombstones-in-window + log n)
    per page, vs O(n log n) for re-merging the whole key set).
  * `device_scan_slab` / `pack_scan_slab` / `live_prefix_index` — a
    view lowered to the FUSED device scan's inputs
    (`kernels.ops.rmi_scan_range_op`; the stacked `pack_scan_slab` rows
    serve the sharded scan, not ported yet):
    staged-insert arrays plus the prefix-sum page index
    (``live_prefix``, ``ins_rank``) that lets the kernel rank the
    endpoints and resolve rank→row with single-gather fixed-trip
    searches.  Built once per (snapshot, delta) version and cached by
    the services; quarter-pow2 pad buckets (`_pad_bucket`) keep the
    device shapes per capacity bucket, never per write.
  * `device_scan_plan` — the older rank-addressed lowering for
    `kernels.ops.rmi_scan_page_op` (still the building block for
    callers that already hold ranks).
  * `repack_pages` — stitches sub-iterators (per-shard scans, ordered
    by router boundaries) back into full fixed-size pages.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np

from repro_torch.index_service.delta import (
    DeltaBuffer,
    _next_pow2,
    collapse_levels,
)
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass(frozen=True)
class ScanPage:
    """One fixed-size page of merged rows.  Valid rows are the prefix
    flagged by ``live_mask``; pad rows carry (+inf, 0)."""

    keys: np.ndarray       # (page_size,) float64, +inf past count
    vals: np.ndarray       # (page_size,) int64, 0 past count
    live_mask: np.ndarray  # (page_size,) bool, True for the row prefix

    @property
    def count(self) -> int:
        return int(self.live_mask.sum())


@dataclasses.dataclass(frozen=True)
class PinnedView:
    """Immutable capture of one service's merged read state.

    ``ins_keys``/``ins_vals`` are the *effective* staged inserts and
    ``del_pos`` the base positions their tombstones kill (see
    `delta.collapse_levels`) — disjoint sources, so every merged rank
    has exactly one row.
    """

    base_keys: np.ndarray            # (N,) float64 sorted
    base_vals: Optional[np.ndarray]  # (N,) int64 payload, or None
    ins_keys: np.ndarray             # (I,) float64 sorted
    ins_vals: np.ndarray             # (I,) int64
    del_pos: np.ndarray              # (T,) int64 sorted base positions

    @property
    def live_count(self) -> int:
        return (
            self.base_keys.size - self.del_pos.size + self.ins_keys.size
        )

    def rank(self, keys) -> np.ndarray:
        """Exact merged lower-bound rank of raw keys in this view."""
        q = np.asarray(keys, np.float64)
        bl = np.searchsorted(self.base_keys, q, side="left")
        dead = np.searchsorted(self.del_pos, bl, side="left")
        ins = np.searchsorted(self.ins_keys, q, side="left")
        return bl - dead + ins


def pin_view(snap, frozen: Optional[DeltaBuffer],
             active: Optional[DeltaBuffer]) -> PinnedView:
    """Collapse one (snapshot, frozen, active) capture into a
    `PinnedView`.  Call under the service lock so the three refs are
    coherent; the result needs no locking afterwards."""
    ins_keys, ins_vals, del_keys = collapse_levels(
        snap.keys.raw, frozen, active
    )
    del_pos = np.searchsorted(snap.keys.raw, del_keys, side="left")
    return PinnedView(
        base_keys=snap.keys.raw,
        base_vals=snap.vals,
        ins_keys=ins_keys,
        ins_vals=ins_vals,
        del_pos=del_pos.astype(np.int64),
    )


# rows merged per internal cursor pass: the per-pass numpy overhead
# (a dozen small allocations + searchsorted calls) amortizes over many
# output pages, so tiny page sizes don't pay it per page
_CHUNK_ROWS = 8192


def _scan_chunks(
    view: PinnedView, lo: float, hi: float, chunk: int
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Cursor walk yielding exact merged (keys, vals) row chunks: every
    chunk holds exactly ``chunk`` rows except the last.  Per chunk, the
    base window widens until it holds ``chunk`` live (non-tombstoned)
    rows or the range ends, the next ``chunk`` staged inserts slice
    off, and the two merge by `searchsorted` positions — O(chunk +
    tombstones-in-window + log n)."""
    base, bvals = view.base_keys, view.base_vals
    ins, ivals = view.ins_keys, view.ins_vals
    dpos = view.del_pos
    p = int(np.searchsorted(base, lo, side="left"))
    p_end = int(np.searchsorted(base, hi, side="left"))
    j = int(np.searchsorted(ins, lo, side="left"))
    j_end = int(np.searchsorted(ins, hi, side="left"))

    while True:
        # widen the base window until it holds `chunk` live rows
        x = min(p + chunk, p_end)
        while True:
            dead = int(
                np.searchsorted(dpos, x) - np.searchsorted(dpos, p)
            )
            if x - p - dead >= chunk or x >= p_end:
                break
            x = min(p + chunk + dead, p_end)
        if x > p:
            d_lo, d_hi = np.searchsorted(dpos, [p, x])
            bsel = np.arange(p, x)
            if d_hi > d_lo:
                alive = np.ones(bsel.size, bool)
                alive[(dpos[d_lo:d_hi] - p).astype(np.int64)] = False
                bsel = bsel[alive]
            bsel = bsel[:chunk]
        else:
            bsel = np.empty(0, np.int64)
        a_keys = base[bsel]
        c_sl = slice(j, min(j + chunk, j_end))
        c_keys = ins[c_sl]
        la, lc = a_keys.size, c_keys.size
        if la + lc == 0:
            return
        take = min(chunk, la + lc)
        if lc == 0:  # common fast path: nothing staged in this window
            keys, vals = a_keys, (
                bvals[bsel] if bvals is not None
                else np.zeros(la, np.int64)
            )
            ca, cc = la, 0
        else:
            # positions of each source's rows in the merged prefix
            pos_a = np.arange(la) + np.searchsorted(c_keys, a_keys)
            pos_c = np.arange(lc) + np.searchsorted(a_keys, c_keys)
            keys = np.empty(take, np.float64)
            vals = np.zeros(take, np.int64)
            ma, mc = pos_a < take, pos_c < take
            keys[pos_a[ma]] = a_keys[ma]
            keys[pos_c[mc]] = c_keys[mc]
            if bvals is not None:
                vals[pos_a[ma]] = bvals[bsel[ma]]
            vals[pos_c[mc]] = ivals[c_sl][mc]
            ca, cc = int(ma.sum()), int(mc.sum())
        if ca:
            p = int(bsel[ca - 1]) + 1
        j += cc
        yield keys[: ca + cc], vals[: ca + cc]
        if ca + cc < chunk:
            return


def scan_pages(
    view: PinnedView, lo: float, hi: float, page_size: int
) -> Iterator[ScanPage]:
    """Stream the live rows of ``view`` with keys in [lo, hi) as
    fixed-size pages, exact in float64.  Rows come from an internal
    cursor walk in page-multiple chunks (see `_scan_chunks`), so every
    page but the last is full.  Empty and inverted ranges (``hi <=
    lo``, NaNs included) yield no pages.
    """
    if page_size < 1:
        raise ValueError("page_size must be >= 1")
    if not (hi > lo):
        return
    chunk = page_size * max(1, _CHUNK_ROWS // page_size)
    template = np.arange(page_size)
    for keys, vals in _scan_chunks(view, lo, hi, chunk):
        for a in range(0, keys.size, page_size):
            count = min(page_size, keys.size - a)
            pk = np.full(page_size, np.inf, np.float64)
            pv = np.zeros(page_size, np.int64)
            pk[:count] = keys[a : a + count]
            pv[:count] = vals[a : a + count]
            yield ScanPage(
                keys=pk, vals=pv, live_mask=template < count
            )


def repack_pages(
    iterators: Iterable[Iterator[ScanPage]], page_size: int
) -> Iterator[ScanPage]:
    """Chain per-shard page streams (already in global key order) and
    re-emit full ``page_size`` pages — shard-boundary partial pages
    merge into their successors; only the final page may be short."""
    buf_k: list = []
    buf_v: list = []
    held = 0

    def flush(final: bool) -> Iterator[ScanPage]:
        nonlocal buf_k, buf_v, held
        if held == 0:
            return
        k = np.concatenate(buf_k)
        v = np.concatenate(buf_v)
        limit = held if final else (held // page_size) * page_size
        for a in range(0, limit, page_size):
            count = min(page_size, held - a)
            keys = np.full(page_size, np.inf, np.float64)
            vals = np.zeros(page_size, np.int64)
            keys[:count] = k[a : a + count]
            vals[:count] = v[a : a + count]
            yield ScanPage(
                keys=keys, vals=vals,
                live_mask=np.arange(page_size) < count,
            )
        buf_k, buf_v = [k[limit:]], [v[limit:]]
        held -= limit

    for it in iterators:
        for page in it:
            if page.count:
                buf_k.append(page.keys[: page.count])
                buf_v.append(page.vals[: page.count])
                held += page.count
            if held >= page_size:
                yield from flush(final=False)
    yield from flush(final=True)


def _pad_bucket(x: int, *, min_pad: int = 64) -> int:
    """Shape bucket for device arrays: the next value of the form
    ``k * 2^m`` with k in {4..7} at or above ``max(min_pad, x)`` —
    quarter-power-of-two steps, so padded widths stay stable across
    small growth (few retraces) without the up-to-2x wasted lanes a
    pure power-of-two bucket costs on scan grids."""
    x = max(min_pad, x)
    p = _next_pow2(x)
    for k in (4, 5, 6, 7):
        c = k * (p // 8)
        if c >= x:
            return c
    return p


# pad value for `ins_rank` slots past the staged-insert count: larger
# than any reachable merged rank (int32-safe), so the partition search
# never selects a pad
_RANK_PAD = np.int32(1 << 30)


def live_prefix_index(
    del_pos: np.ndarray, n: int, *, n_pad: Optional[int] = None
) -> np.ndarray:
    """The prefix-sum page index over base positions:
    ``live_prefix[p] = p - #tombstoned positions < p`` — i.e. how many
    LIVE base rows sit below position p.  Monotone, so the device scan
    resolves rank -> base row (and base position -> rank) with one
    fixed-trip binary search instead of a nested tombstone search per
    trip.  Padded (when ``n_pad`` is given) by repeating the final
    value, which pins searches past the true size."""
    mark = np.zeros(n + 1, np.int64)
    if del_pos.size:
        mark[np.asarray(del_pos, np.int64) + 1] = 1
    lp = np.arange(n + 1, dtype=np.int64) - np.cumsum(mark)
    if n_pad is None or n_pad == n:
        return lp.astype(np.int32)
    out = np.full(n_pad + 1, lp[-1], np.int32)
    out[: n + 1] = lp
    return out


def device_scan_slab(
    view: PinnedView, base_norm: np.ndarray, normalize, *,
    min_pad: int = 64,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Lower a pinned view's delta side to the fused-endpoint scan
    inputs `kernels.ops.rmi_scan_range_op` consumes:

        (ins_norm f32 (+inf pad), ins_vals i32, ins_rank i32,
         live_prefix i32 (n+1,))

    ``ins_rank[j] = j + live_prefix[lower_bound(base_norm, ins[j])]``
    is staged insert j's merged rank, precomputed in the SAME float32
    frame the kernel searches (``base_norm``), so the device partition
    is internally consistent with the device select even where float32
    normalization collides.  Built once per (snapshot, delta version)
    and cached by the service — the per-scan host cost of the old path
    (collapse + re-pack per call) amortizes to zero on the read path.

    Pads go to quarter-pow2 buckets (`_pad_bucket`), so device shapes
    change per capacity bucket, never per write.
    """
    with obs_trace.span(
        "scan.pack_slab", cat="plane", staged=int(view.ins_keys.size)
    ):
        return _device_scan_slab_inner(view, base_norm, normalize, min_pad)


def _device_scan_slab_inner(view, base_norm, normalize, min_pad):
    k = view.ins_keys.size
    pad_i = _pad_bucket(k + 1, min_pad=min_pad)
    ins = np.full(pad_i, np.inf, np.float32)
    ins[:k] = normalize(view.ins_keys)
    ivals = np.zeros(pad_i, np.int32)
    ivals[:k] = np.clip(
        view.ins_vals, np.iinfo(np.int32).min, np.iinfo(np.int32).max
    )
    lp = live_prefix_index(view.del_pos, view.base_keys.size)
    ins_rank = np.full(pad_i, _RANK_PAD, np.int32)
    if k:
        bl = np.searchsorted(base_norm, ins[:k], side="left")
        ins_rank[:k] = np.arange(k, dtype=np.int32) + lp[bl]
    return ins, ivals, ins_rank, lp


def fit_scan_frame(views) -> Tuple[float, float]:
    """One shared affine frame covering every view's base + staged
    keys: ``(lo, hi)`` with ``hi > lo`` guaranteed (degenerate spans
    widen by 1), THE frame rule for every stacked scan plane — the
    sharded service and the KV page table must agree on it or their
    slabs stop being comparable across shards."""
    lo = min(float(v.base_keys[0]) for v in views if v.base_keys.size)
    hi = max(float(v.base_keys[-1]) for v in views if v.base_keys.size)
    for v in views:
        if v.ins_keys.size:
            lo = min(lo, float(v.ins_keys[0]))
            hi = max(hi, float(v.ins_keys[-1]))
    if not (hi > lo):
        hi = lo + 1.0
    return lo, hi


def scan_page_bound(
    raws, ins_total: int, lo: float, hi: float, page_size: int
) -> int:
    """Conservative static page count for a fused device scan of
    [lo, hi): per-array base windows plus every staged insert can only
    over-count rows (tombstones shrink), bucketed for shape
    stability.  Host metadata sizing the output shape — NOT a rank fed
    to the device program.  One extra page of slack covers the device
    resolving the endpoints in float32 (a bound that rounds onto a
    duplicate run can pull a handful of extra rows into the range that
    the float64 window here would exclude)."""
    span = int(ins_total)
    for raw in raws:
        a, b = np.searchsorted(raw, [lo, hi])
        span += max(0, int(b - a))
    return _pad_bucket(-(-max(1, span) // page_size) + 1, min_pad=1)


def pack_scan_slab(
    view: PinnedView, normalize, n_pad: int, d_pad: int
) -> dict:
    """One shard's stacked-scan slab row for
    `kernels.ops.rmi_sharded_scan_page_op`: the `device_scan_slab`
    layout padded to the fleet-wide ``(n_pad, d_pad)`` bucket, with the
    base keys re-normalized into the SHARED frame ``normalize`` (shard
    ranges tile the key space, so one global affine frame keeps
    cross-shard rows comparable).  Returns a dict of per-row arrays
    plus the shard's live row count."""
    n = view.base_keys.size
    base = np.full(n_pad, np.inf, np.float32)
    base[:n] = normalize(view.base_keys)
    bvals = np.zeros(n_pad, np.int32)
    if view.base_vals is not None:
        bvals[:n] = np.clip(
            view.base_vals, np.iinfo(np.int32).min, np.iinfo(np.int32).max
        )
    lp = live_prefix_index(view.del_pos, n, n_pad=n_pad)
    k = view.ins_keys.size
    ins = np.full(d_pad, np.inf, np.float32)
    ins[:k] = normalize(view.ins_keys)
    ivals = np.zeros(d_pad, np.int32)
    ivals[:k] = np.clip(
        view.ins_vals, np.iinfo(np.int32).min, np.iinfo(np.int32).max
    )
    ins_rank = np.full(d_pad, _RANK_PAD, np.int32)
    if k:
        bl = np.searchsorted(base[:n], ins[:k], side="left")
        ins_rank[:k] = np.arange(k, dtype=np.int32) + lp[bl]
    return {
        "base": base, "bvals": bvals, "live_prefix": lp,
        "ins": ins, "ivals": ivals, "ins_rank": ins_rank,
        "live": view.live_count,
    }


def stack_scan_slabs(views) -> dict:
    """Full (non-incremental) assembly of a stacked scan plane from
    per-shard pinned views: fit the shared frame, size the pad buckets,
    pack each view's slab, and stack — everything
    `kernels.ops.rmi_sharded_scan_page_op` consumes except the device
    upload, plus the ``normalize`` callable and the sizing metadata
    (``raws``, ``ins_total``) `scan_page_bound` needs.  One definition
    of the plane-assembly rule: the KV page table uses this directly;
    `ShardedIndexService` layers its incremental per-row cache on the
    same `pack_scan_slab` rows."""
    lo, hi = fit_scan_frame(views)
    n_pad = _pad_bucket(max(v.base_keys.size for v in views) + 1)
    d_pad = _pad_bucket(max(v.ins_keys.size for v in views) + 1)

    def normalize(x):
        return (
            (np.asarray(x, np.float64) - lo) / (hi - lo)
        ).astype(np.float32)

    rows = [pack_scan_slab(v, normalize, n_pad, d_pad) for v in views]
    return {
        "lo": lo, "hi": hi, "normalize": normalize,
        "raws": [v.base_keys for v in views],
        "ins_total": int(sum(v.ins_keys.size for v in views)),
        "base": np.stack([r["base"] for r in rows]),
        "bvals": np.stack([r["bvals"] for r in rows]),
        "live_prefix": np.stack([r["live_prefix"] for r in rows]),
        "ins": np.stack([r["ins"] for r in rows]),
        "ivals": np.stack([r["ivals"] for r in rows]),
        "ins_rank": np.stack([r["ins_rank"] for r in rows]),
    }


def device_scan_plan(
    view: PinnedView, normalize, *, min_pad: int = 64
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Lower a pinned view's delta side to the padded device arrays
    `rmi_scan_page_op` consumes: ``(ins_norm_f32 (+inf pad),
    ins_vals_i32, del_pos_i32 (n pad))`` — the base arrays come from
    the snapshot's own cached device buffers (`scan_page_fn`).

    Pads go to the next power of two past the true size (always at
    least one sentinel), so device shapes change per capacity
    bucket.  Values clip to int32 — the device plane is 32-bit; the
    host path keeps the exact int64 payload.
    """
    pad_i = _next_pow2(max(min_pad, view.ins_keys.size + 1))
    ins = np.full(pad_i, np.inf, np.float32)
    ins[: view.ins_keys.size] = normalize(view.ins_keys)
    ivals = np.zeros(pad_i, np.int32)
    ivals[: view.ins_keys.size] = np.clip(
        view.ins_vals, np.iinfo(np.int32).min, np.iinfo(np.int32).max
    )
    pad_d = _next_pow2(max(min_pad, view.del_pos.size + 1))
    dpos = np.full(pad_d, view.base_keys.size, np.int32)
    dpos[: view.del_pos.size] = view.del_pos
    return ins, ivals, dpos
