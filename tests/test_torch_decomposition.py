"""The decompositions of the redesigned lookup, range-scan and hash-probe
kernels, emulated in plain PyTorch on the host.

The CUDA kernels of `csrc/rmi_lookup.cu`, `csrc/rmi_scan.cu` and
`csrc/probe.cu` reach their plain twins' answers by another route, and
the card is not here.
So each route is written out below step for step, with its sizes as
parameters small enough for the CPU, and held bit for bit against the
plain twins and the reference:

* the lookup (B1/B2): the packed (M, 4) leaf record
  (`core.rmi.pack_leaves`, the views `RMIndex.as_tree` hands out); the
  merged kernel's delta trips ride along its base trips, but the two
  searches share no state, so the plain twin's order stands for it;
* the range scan (B3): tiles of consecutive ranks, the endpoints and
  each tile's first and last valid rank placed by the warp's 33-ary
  search, the spans of ``ins_rank`` and ``live_prefix`` between them
  staged, or searched in place when longer than their buffers, and
  each rank's search finished inside the span;
* the page scan (B6): the pre-pass (each insert slot's merged rank, each
  tombstone's gap), whose lower bounds are the reference's fixed-trip
  partition and select; tiles of whole pages placed from their least
  and greatest valid rank, then B3's spans over the two arrays;
* the sharded scan (B5): B3's tiles over one shard's slab row, dead
  tiles that search nothing, and tiles whose local ranks wrap int32
  chained lane by lane;
* the sharded lookup (B4): the (S, M, 4) leaf record `stack_rows` hands
  out (or a fresh pack of four arrays), one lane a (shard, query), base
  and delta trips side by side, and a warp's base trips stopped once
  every lane sits at a fixed point;
* the §4 hash probe (B7): the 8-byte (w, b), (key bits, next) records
  `hash_probe_tensors` builds (or fresh packs), read one pair a gather,
  and the chain walk that stops at a hit, at the chain's end or after
  ``trips`` hops;
* the §5 Bloom probe (B8): four queries a thread (keys by one vector
  load, the ragged tail one by one), each step one probe of every live
  query, and the thread's stop once none is live.

B4's and B7's leaf position follows ROADMAP queue C 17's select: +inf
takes f32(n - 1) whatever the leaf's slope.

Buffer sizes are parameters, small enough here to reach every path.
The kernels themselves meet these cases in the `cuda`-marked tests of
`test_torch_kernels.py`, `test_torch_scan.py`, `test_torch_sharded.py`,
`test_torch_probe.py` and `test_torch_card.py`.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import RMIConfig, build_rmi, make_keyset  # noqa: E402
from repro.index_service.delta import DeltaBuffer as RefDelta  # noqa: E402
from repro.index_service.delta import combine_for_device  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.hash_probe import hash_probe_pallas  # noqa: E402
from repro.kernels.rmi_lookup import (  # noqa: E402
    rmi_lookup_pallas,
    rmi_merged_lookup_pallas,
    rmi_scan_page_pallas,
    rmi_sharded_merged_lookup_pallas,
    rmi_sharded_scan_page_pallas,
)
from test_torch_kernels import _case, _jax_args, _port_args, _queries  # noqa: E402
from test_torch_scan import (  # noqa: E402
    CASES,
    _bounds,
    _kernel_case,
    _lowered,
    _xla_page,
    _xla_range,
)
from test_torch_probe import (  # noqa: E402
    _f32_twins,
    _family_words,
    _fma_decides,
    _maps,
    _probe_queries,
)
from test_torch_sharded import (  # noqa: E402
    _lookup_args,
    _lookup_case,
    _nan_position,
    _scan_bounds,
    _scan_slabs,
)

from repro_torch.core import learned_hash  # noqa: E402
from repro_torch.core import search as search_lib  # noqa: E402
from repro_torch.core.models import stage0_apply  # noqa: E402
from repro_torch.data import gen_maps  # noqa: E402
from repro_torch.index_service import scan as port_scan  # noqa: E402
from repro_torch.index_service.delta import DeltaBuffer  # noqa: E402
from repro_torch.core.rmi import LEAF_FIELDS, pack_leaves  # noqa: E402
from repro_torch.kernels import ref as port_ref  # noqa: E402
from repro_torch.kernels import bloom_probe, hash_probe, ops, rmi_lookup, rmi_scan  # noqa: E402

# ---------------------------------------------------------------------------
# B1/B2: the packed leaf record
# ---------------------------------------------------------------------------

def record_columns(leaf_w, leaf_b, err_lo, err_hi):
    """What the kernel reads: one (M, 4) record, seen through the column
    views `RMIndex.as_tree` hands out."""
    return pack_leaves(leaf_w, leaf_b, err_lo, err_hi).unbind(1)


@pytest.mark.parametrize("dist,hidden", [("uniform", ()), ("lognormal", ()),
                                         ("lognormal", (16, 16))])
def test_lookup_through_the_leaf_record_matches_plain_twin_and_reference(dist, hidden):
    """Bit for bit against the plain twin on separate arrays on every
    query; against the reference's Pallas kernels (interpret mode) on
    every query with the linear stage-0, and on the stored keys' exact
    ranks with the (16, 16) MLP, whose sums XLA may order otherwise."""
    ks, idx, deltas, pool, oor = _case(dist, hidden=hidden, steps=40 if hidden else 0)
    jkw = dict(n=idx.n, num_leaves=idx.num_leaves, max_window=idx.max_window)
    for batch in (1, 777):
        q = _queries(pool, oor, batch, batch)
        arrs, kw = _port_args(idx, ks, q)
        rec_arrs = (*arrs[:2], *record_columns(*arrs[2:6]), arrs[6])
        jargs = _jax_args(idx, ks, q)
        stored = np.isin(q, ks.norm)
        for dname, (dk, dp) in deltas.items():
            dkt, dpt = torch.as_tensor(dk), torch.as_tensor(dp)
            plain = port_ref.rmi_merged_lookup_reference(*arrs, dkt, dpt, **kw)
            got = port_ref.rmi_merged_lookup_reference(*rec_arrs, dkt, dpt, **kw)
            assert all(torch.equal(g, p) for g, p in zip(got, plain)), dname
            exact = np.searchsorted(ks.norm, q) + dp[np.searchsorted(dk, q)]
            assert np.array_equal(got[1].numpy()[stored], exact[stored])
            if not hidden:
                want = rmi_merged_lookup_pallas(*jargs, jnp.asarray(dk), jnp.asarray(dp),
                                                hidden=hidden, interpret=True, **jkw)
                assert all(np.array_equal(g.numpy(), np.asarray(w))
                           for g, w in zip(got, want)), dname
        base = port_ref.rmi_lookup_reference(*rec_arrs, **kw)
        assert torch.equal(base, port_ref.rmi_lookup_reference(*arrs, **kw))
        if not hidden:
            want = rmi_lookup_pallas(*jargs, hidden=hidden, interpret=True, **jkw)
            assert np.array_equal(base.numpy(), np.asarray(want))


def test_leaf_record_keeps_c4_and_c5():
    """C4: with exactly 64 staged entries nothing pads the delta, the
    delta search steps to D + 1 above every staged key and the prefix
    gather clamps it.  C5: a query above every key steps the base search
    to n + 1.  Both hold through the record as through four arrays and
    the reference's XLA twin."""
    ks = make_keyset(np.random.default_rng(0).uniform(0, 1e6, 2000))
    idx = build_rmi(ks, RMIConfig(num_leaves=40, stage0_hidden=(), stage0_train_steps=0))
    ins = np.setdiff1d(np.random.default_rng(1).uniform(0, 1e6, 80), ks.raw)[:64]
    buf = RefDelta.from_arrays(ins, np.zeros(64, np.int64), np.empty(0), 64)
    dk, dp = combine_for_device(None, buf, ks.normalize)
    assert dk.size == 64 and np.isfinite(dk).all()
    q = np.array([ks.norm[-1], 0.5, 1e30, np.nan, -np.inf, 2.0], np.float32)
    arrs, kw = _port_args(idx, ks, q)
    dkt, dpt = torch.as_tensor(dk), torch.as_tensor(dp)
    assert search_lib.lower_bound_full(dkt, torch.as_tensor(q))[2] == 65
    rec_arrs = (*arrs[:2], *record_columns(*arrs[2:6]), arrs[6])
    got = port_ref.rmi_merged_lookup_reference(*rec_arrs, dkt, dpt, **kw)
    xb, xm = jax_ref.rmi_merged_lookup_reference(
        *_jax_args(idx, ks, q), jnp.asarray(dk), jnp.asarray(dp),
        **{k: kw[k] for k in ("n", "num_leaves", "max_window")})
    assert np.array_equal(got[0].numpy(), np.asarray(xb))
    assert np.array_equal(got[1].numpy(), np.asarray(xm))
    assert got[1][0] == ks.n - 1 + 64
    assert got[0][2] == ks.n + 1 and got[0][5] == ks.n + 1


def test_tree_leaf_arrays_are_views_of_one_record():
    """`RMIndex.as_tree` hands out the four leaf arrays as the columns of
    one (M, 4) record, which the wrapper passes to the kernel as it is;
    four separate arrays, or columns of two records, are packed afresh."""
    ks, idx, _, _, _ = _case("uniform")
    from repro_torch import convert
    pi = convert.index_from_reference(idx)
    tree = pi.as_tree("cpu")
    cols = [tree[k] for k in LEAF_FIELDS]
    for c, k in zip(cols, LEAF_FIELDS):
        assert np.array_equal(c.numpy(), getattr(pi, k))
    dev = torch.device("cpu")
    record = cols[0].as_strided((pi.num_leaves, 4), (4, 1))
    assert rmi_lookup._leaf_record(*cols, dev) == (cols[0].data_ptr(), None)
    ptr, fresh = rmi_lookup._leaf_record(*(c.clone() for c in cols), dev)
    assert ptr == fresh.data_ptr() and torch.equal(fresh, record)
    other = pack_leaves(*(c.clone() for c in cols))
    ptr, mixed = rmi_lookup._leaf_record(cols[0], cols[1], other[:, 2], cols[3], dev)
    assert ptr == mixed.data_ptr() != record.data_ptr() and torch.equal(mixed, record)
    with pytest.raises(ValueError, match="err_hi"):
        rmi_lookup._leaf_record(*cols[:3], cols[3][:-1], dev)
    with pytest.raises(ValueError, match="leaf_b"):
        rmi_lookup._leaf_record(cols[0], cols[1].double(), *cols[2:], dev)


# ---------------------------------------------------------------------------
# B3: tiled range scan
# ---------------------------------------------------------------------------


INT32_MIN, INT32_MAX = -2**31, 2**31 - 1


def wrap32(x):
    """``x`` as the card's int32 arithmetic leaves it."""
    return (x - INT32_MIN) % 2**32 + INT32_MIN


def warp_lower_bound(arr, q, lo, hi):
    """The kernel's 33-ary warp search: ``lo + #{arr[lo:hi] < q}``."""
    while hi - lo > 32:
        span = hi - lo
        c = int((arr[lo + span * torch.arange(1, 33) // 33] < q).sum())
        lo, hi = (lo if c == 0 else lo + span * c // 33 + 1,
                  hi if c == 32 else lo + span * (c + 1) // 33)
    return lo + int((arr[lo:hi] < q).sum())


def span_lower_bound(span, q, size):
    """The kernel's in-span search: pinned fixed trips, one per bit of
    the span's size."""
    return port_ref.array_lower_bound(span, q, size, size.bit_length())


def place_spans(a, na, b, nb, ta, tb, acap, bcap, stats, names=("ins", "lp")):
    """The kernels' `place_spans`: the least and greatest rank of a tile
    placed in the index arrays ``a`` (j = lb(a, t)) and ``b`` (k = lb(b,
    t - j + 1)); each span is staged (a copy in the block's buffer) when
    it fits its buffer, else read in place.  ``stats`` counts both."""
    jf, jl = warp_lower_bound(a, ta, 0, na), warp_lower_bound(a, tb, 0, na)
    kf = warp_lower_bound(b, wrap32(ta - jl + 1), 0, nb)
    kl = warp_lower_bound(b, wrap32(tb - jf + 1), 0, nb)
    spans = []
    for name, arr, first, last, cap in ((names[0], a, jf, jl, acap),
                                        (names[1], b, kf, kl, bcap)):
        staged = last - first <= cap
        spans.append((first, arr[first:last].clone() if staged else arr[first:last]))
        k = f"{name}_{'staged' if staged else 'in_place'}"
        stats[k] = stats.get(k, 0) + 1
    return spans


def finish_ranks(spans, t):
    """The kernels' `finish_rank` on int32 ranks ``t`` of the tile:
    ``(j, u, k)`` searched inside the spans."""
    (jf, aspan), (kf, bspan) = spans
    j = jf + span_lower_bound(aspan, t, aspan.numel())
    u = t - j + 1
    return j, u, kf + span_lower_bound(bspan, u, bspan.numel())


def emulate_scan_range(bounds, base, bvals, lp, ins, ivals, ins_rank, *, page_size,
                       max_pages, tile, icap, pcap, stats=None):
    """The range kernel's rows, tile by tile (see the module docstring);
    ``stats`` counts the tiles whose spans were staged or searched in
    place, and the tiles that start on a staged insert."""
    stats = {} if stats is None else stats
    n, ni = base.shape[0], ins.shape[0]
    i32 = torch.int32
    ends = [int(lp[warp_lower_bound(base, b, 0, n)]) + warp_lower_bound(ins, b, 0, ni)
            for b in bounds.tolist()]
    r0, r1 = ends[0], max(ends[1], ends[0])
    lanes = max_pages * page_size
    keys = torch.full((lanes,), float("inf"))
    vals = torch.zeros(lanes, dtype=i32)
    live = torch.zeros(lanes, dtype=i32)
    for l0 in range(0, lanes, tile):
        l1 = min(lanes, l0 + tile)
        v1 = min(l1, max(r1 - r0, l0))
        if v1 <= l0:
            continue
        ta, tb = r0 + l0, r0 + v1 - 1
        spans = place_spans(ins_rank, ni, lp, n + 1, ta, tb, icap, pcap, stats)
        stats["starts_on_insert"] = stats.get("starts_on_insert", 0) + int(
            bool((ins_rank[:ni] == ta).any()))
        t = torch.arange(r0 + l0, r0 + v1, dtype=i32)
        j, _, k = finish_ranks(spans, t)
        key, v, lv = port_ref._emit(torch.ones_like(t, dtype=torch.bool), k - 1, j, base,
                                    bvals, ins, ivals)
        keys[l0:v1], vals[l0:v1], live[l0:v1] = key, v, lv
    shape = (max_pages, page_size)
    return keys.reshape(shape), vals.reshape(shape), live.reshape(shape)


def _same(got, want):
    """Bit-identical (keys, vals, live) triples, float keys compared by
    their bit patterns."""
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        if g.dtype != w.dtype or not np.array_equal(g, w):
            return False
    return True


TILINGS = ((16, 8, 16), (64, 32, 64), (rmi_scan.RANGE_TILE, rmi_scan.RANGE_INS_CAP,
                                        rmi_scan.RANGE_PREFIX_CAP))


@pytest.mark.parametrize("case", CASES)
def test_scan_decomposition_matches_plain_twin_and_reference(case):
    base, bvals, slab, _, pv = _kernel_case(case)
    ins, ivals, ins_rank, lp = slab
    bounds, _ = _bounds(base, pv)
    tt = [torch.as_tensor(a) for a in (base, bvals, lp, ins, ivals, ins_rank)]
    for name, b in bounds.items():
        bt = torch.as_tensor(np.asarray(b, np.float32))
        for page_size in (1, 160):
            kw = dict(page_size=page_size, max_pages=8)
            plain = port_ref.rmi_scan_range_reference(bt, *tt, **kw)
            xla = _xla_range(jnp.asarray(bt.numpy()), base, bvals, lp, ins, ivals,
                             ins_rank, **kw)
            for tile, icap, pcap in TILINGS:
                got = emulate_scan_range(bt, *tt, tile=tile, icap=icap, pcap=pcap, **kw)
                assert _same(got, plain), (case, name, page_size, tile)
                assert _same(got, xla), (case, name, page_size, tile)


def _dense_state():
    """600 base keys with a float32 duplicate run, a tombstone run of 200
    consecutive rows, 150 staged inserts packed between two base keys
    (some tying them in float32) and a few spread out."""
    base = np.concatenate([np.arange(0.0, 300.0), 300.0 + np.arange(40) * 1e-9,
                           np.arange(301.0, 561.0)])
    rng = np.random.default_rng(11)
    packed = np.unique(450.0 + rng.uniform(0, 1, 150))
    ties = base[[5, 20, 450]] + 1e-10            # distinct raw keys, same float32
    spread = np.setdiff1d(np.unique(rng.uniform(0, 560, 30)), base)
    ins = np.unique(np.concatenate([packed, ties, spread]))
    dels = base[100:300]
    return base, ins, dels


@pytest.mark.parametrize("tiling", [(16, 8, 16), (32, 16, 32), (64, 16, 48)])
def test_scan_decomposition_reaches_every_path_on_dense_tiles(tiling):
    """Tiles that start on a staged insert, cross the float32 duplicate
    run and lie inside a tombstone run longer than their buffer, or
    hold more inserts than theirs: every path of the decomposition,
    against the plain twin and the reference, empty and inverted ranges
    included."""
    tile, icap, pcap = tiling
    base_raw, ins_raw, dels = _dense_state()
    norm, *arrays, _, _ = _lowered(base_raw, ins_raw, dels)
    base, bvals, (ins, ivals, ins_rank, lp) = arrays
    tt = [torch.as_tensor(a) for a in (base, bvals, lp, ins, ivals, ins_rank)]
    stats = {}
    ranges = {"whole": (-1.0, 600.0), "from_tombstones": (150.0, 460.0),
              "dup_run": (299.5, 300.5), "packed": (450.2, 451.0), "empty": (300.0, 300.0),
              "inverted": (460.0, 150.0), "above": (600.0, 700.0)}
    for name, (lo, hi) in ranges.items():
        bt = torch.as_tensor(norm(np.array([lo, hi])))
        for page_size, pages in ((1, 700), (7, 100), (160, 5)):
            kw = dict(page_size=page_size, max_pages=pages)
            plain = port_ref.rmi_scan_range_reference(bt, *tt, **kw)
            xla = _xla_range(jnp.asarray(bt.numpy()), *(a.numpy() for a in tt), **kw)
            got = emulate_scan_range(bt, *tt, tile=tile, icap=icap, pcap=pcap, stats=stats,
                                     **kw)
            assert _same(got, plain) and _same(got, xla), (name, page_size)
            if name == "whole":
                live = int(plain[2].sum())
                assert live == min(pages * page_size, base_raw.size - dels.size + ins_raw.size)
    assert stats["lp_in_place"] > 0 and stats["ins_in_place"] > 0
    assert stats["lp_staged"] > 0 and stats["ins_staged"] > 0
    assert stats["starts_on_insert"] > 0


def test_warp_search_counts_like_the_fixed_trip_search():
    """The 33-ary search and the pinned fixed-trip search agree on every
    query of a non-decreasing array with runs, both ends and NaN."""
    rng = np.random.default_rng(5)
    for size in (1, 31, 32, 33, 100, 1089, 5000):
        arr = np.sort(rng.integers(0, size // 3 + 2, size)).astype(np.float32)
        qs = np.concatenate([arr[rng.integers(0, size, 40)], [-1.0, 1e9, np.nan],
                             rng.uniform(-1, size, 20)]).astype(np.float32)
        at = torch.as_tensor(arr)
        want = port_ref.array_lower_bound(at, torch.as_tensor(qs), size,
                                          search_lib._steps_for_window(size)).tolist()
        got = [warp_lower_bound(at, torch.tensor(q), 0, size) for q in qs]
        assert got == want, size
        lo, hi = size // 4, size - size // 5
        mid = [warp_lower_bound(at, torch.tensor(q), lo, hi) for q in qs]
        assert mid == [min(max(w, lo), hi) for w in want], size


# ---------------------------------------------------------------------------
# B6: rank-addressed pages through the pre-pass arrays
# ---------------------------------------------------------------------------

def page_prepass(base, ins, del_pos):
    """The page kernel's pre-pass: each insert slot's merged rank
    ``m + bl - lb(del_pos, bl)`` with ``bl = lb(base, ins[m])``, and each
    tombstone's gap ``del_pos[m] - m`` (INT32_MAX on a pad of n)."""
    n, ni, nd = base.shape[0], ins.shape[0], del_pos.shape[0]
    steps, dsteps = port_ref.trip_counts(n, nd)
    bl = port_ref.array_lower_bound(base, ins, n, steps)
    dl = port_ref.array_lower_bound(del_pos, bl, nd, dsteps)
    rank_of_ins = torch.arange(ni, dtype=torch.int32) + (bl - dl)
    gap = torch.where(del_pos < n, del_pos - torch.arange(nd, dtype=torch.int32),
                      torch.full_like(del_pos, INT32_MAX))
    return rank_of_ins, gap


def emulate_scan_page(starts, base, bvals, ins, ivals, del_pos, end_rank, *, page_size,
                      tile, icap, dcap, stats=None):
    """The page kernel's rows: the pre-pass, then tiles of the whole
    pages that hold about ``tile`` lanes, each placed from the least and
    greatest valid rank of its pages; ``stats`` counts the pre-passes,
    the tiles with no valid lane and the staged and in-place spans."""
    stats = {} if stats is None else stats
    n, ni, nd = base.shape[0], ins.shape[0], del_pos.shape[0]
    rank_of_ins, gap = page_prepass(base, ins, del_pos)
    stats["prepass"] = stats.get("prepass", 0) + 1
    pages, end = starts.shape[0], int(end_rank[0])
    keys = torch.full((pages * page_size,), float("inf"))
    vals = torch.zeros(pages * page_size, dtype=torch.int32)
    live = torch.zeros(pages * page_size, dtype=torch.int32)
    ppt = max(1, tile // page_size)
    for g0 in range(0, pages, ppt):
        g1 = min(pages, g0 + ppt)
        st = starts[g0:g1].long()
        va, vb = torch.clamp(-st, min=0), torch.clamp(end - st, max=page_size)
        runs = va < vb                  # a page's valid lanes are one run
        if not runs.any():
            stats["dead"] = stats.get("dead", 0) + 1
            continue
        ta, tb = int((st + va)[runs].min()), int((st + vb - 1)[runs].max())
        spans = place_spans(rank_of_ins, ni, gap, nd, ta, tb, icap, dcap, stats,
                            names=("rank", "gap"))
        lane = torch.arange(g0 * page_size, g1 * page_size)
        t = starts[lane // page_size] + (lane % page_size).to(torch.int32)
        valid = (t >= 0) & (t < end)
        j, u, k = finish_ranks(spans, t[valid])
        p = torch.clamp(u.long() - 1 + k, 0, n).to(torch.int32)
        key, v, lv = port_ref._emit(torch.ones_like(j, dtype=torch.bool), p, j, base, bvals,
                                    ins, ivals)
        at = lane[valid]
        keys[at], vals[at], live[at] = key, v, lv
    shape = (pages, page_size)
    return keys.reshape(shape), vals.reshape(shape), live.reshape(shape)


def _partition_and_select(t, base, ins, del_pos):
    """The plain twin's fixed-trip partition and select
    (`ref.scan_page_body`), step for step, without the emit: ``(j, p)``."""
    n, ni, nd = base.shape[0], ins.shape[0], del_pos.shape[0]
    steps, isteps, dsteps = port_ref.trip_counts(n, ni, nd)
    lo, hi = torch.zeros_like(t), torch.full_like(t, ni)
    for _ in range(isteps):
        mid = (lo + hi) >> 1
        ck = torch.where(mid >= ni, torch.tensor(float("inf")),
                         ins[torch.clamp(mid, 0, ni - 1)])
        bl = port_ref.array_lower_bound(base, ck, n, steps)
        dl = port_ref.array_lower_bound(del_pos, bl, nd, dsteps)
        pred = mid + (bl - dl) >= t
        lo, hi = torch.where(~pred & (lo < hi), mid + 1, lo), torch.where(pred, mid, hi)
    j, i1 = lo, t - lo + 1
    lo, hi = torch.zeros_like(t), torch.full_like(t, n)
    for _ in range(steps):
        mid = (lo + hi) >> 1
        pred = (mid + 1 - port_ref.array_lower_bound(del_pos, mid + 1, nd, dsteps)) >= i1
        lo, hi = torch.where(~pred & (lo < hi), mid + 1, lo), torch.where(pred, mid, hi)
    return j, lo


def _plan_tensors(plan):
    return [torch.as_tensor(a) for a in plan]


def _page_starts(live, page_size, extra=()):
    """The reference's edge starts (negative, past the end, wrapping
    int32), then consecutive pages over every live rank and one past."""
    run = page_size * np.arange(-(-(live + 1) // page_size) + 1)
    return np.concatenate([np.asarray(extra, np.int64), run]).astype(np.int32)


@pytest.mark.parametrize("case", CASES)
def test_page_prepass_is_the_partition_and_the_gap_the_select(case):
    """``lb(rank_of_ins, t)`` is the fixed-trip partition and
    ``clamp(u - 1 + lb(gap, u), 0, n)`` the fixed-trip select, for every
    rank from below 0 to past the live count and at the int32 ends."""
    base, _, _, plan, pv = _kernel_case(case)
    ins, _, dpos = _plan_tensors(plan)
    bt = torch.as_tensor(base)
    live = pv.live_count
    t = torch.as_tensor(np.concatenate([np.arange(-3, live + 300), [INT32_MAX - 1, INT32_MAX,
                                                                    INT32_MIN]]).astype(np.int32))
    j_fixed, p_fixed = _partition_and_select(t, bt, ins, dpos)
    rank_of_ins, gap = page_prepass(bt, ins, dpos)
    assert bool((rank_of_ins[1:] >= rank_of_ins[:-1]).all()) and bool((gap[1:] >= gap[:-1]).all())
    j = port_ref.array_lower_bound(rank_of_ins, t, ins.numel(), 40)
    assert torch.equal(j, j_fixed), case
    u = t - j + 1
    k = port_ref.array_lower_bound(gap, u, dpos.numel(), 40)
    assert torch.equal(torch.clamp(u.long() - 1 + k, 0, base.size).int(), p_fixed), case


PAGE_TILINGS = ((16, 4, 8), (64, 16, 32), (rmi_scan.RANGE_TILE, rmi_scan.RANGE_INS_CAP,
                                           rmi_scan.RANGE_PREFIX_CAP))


@pytest.mark.parametrize("case", CASES)
def test_page_decomposition_matches_plain_twin_and_reference(case):
    """Every lane bit for bit against the plain twin and the reference's
    XLA twin (and its Pallas kernel in interpret mode at one page size):
    the reference's edge starts, consecutive pages, page sizes that are
    not multiples of a warp, and an end rank past the live count."""
    base, bvals, _, plan, pv = _kernel_case(case)
    _, edge_starts = _bounds(base, pv)
    live = pv.live_count
    tt = [torch.as_tensor(a) for a in (base, bvals)] + _plan_tensors(plan)
    for page_size in (1, 16, 160, 256):
        starts = _page_starts(live, page_size, edge_starts)
        for end in (live, live + 37):
            et = torch.as_tensor(np.array([end], np.int32))
            st = torch.as_tensor(starts)
            plain = port_ref.rmi_scan_page_reference(st, *tt, et, page_size=page_size)
            xla = _xla_page(jnp.asarray(starts), base, bvals, *plan, np.array([end], np.int32),
                            page_size=page_size)
            assert _same(plain, xla), (case, page_size, end)
            for tile, icap, dcap in PAGE_TILINGS:
                got = emulate_scan_page(st, *tt, et, page_size=page_size, tile=tile, icap=icap,
                                        dcap=dcap)
                assert _same(got, plain), (case, page_size, end, tile)
    starts = _page_starts(live, 160, edge_starts)[:12]
    end = np.array([live], np.int32)
    pallas = rmi_scan_page_pallas(jnp.asarray(starts), base, bvals, *plan, jnp.asarray(end),
                                  page_size=160, interpret=True)
    got = emulate_scan_page(torch.as_tensor(starts), *tt, torch.as_tensor(end), page_size=160,
                            tile=64, icap=16, dcap=32)
    assert _same(got, pallas), case


@pytest.mark.parametrize("tiling", [(16, 4, 8), (64, 16, 32), (256, 64, 128)])
def test_page_decomposition_reaches_every_path_on_dense_pages(tiling):
    """Pages inside a tombstone run and an insert cluster longer than
    their buffers, across the float32 duplicate run and the ties (C6),
    pages that start mid-page on rank 0, past the live count, across the
    int32 wrap, tiles with no valid lane, and an end rank past the live
    count: every path against the plain twin and the reference."""
    tile, icap, dcap = tiling
    base_raw, ins_raw, dels = _dense_state()
    _, base, bvals, _, plan, live = _lowered(base_raw, ins_raw, dels)
    tt = [torch.as_tensor(a) for a in (base, bvals)] + _plan_tensors(plan)
    stats = {}
    for page_size in (1, 7, 160):
        edges = [-7, -page_size, live - 3, live + 500, INT32_MAX - 100, 2**31 - 9]
        starts = _page_starts(live, page_size, edges)
        for end in (live, live + 400, INT32_MAX, 0):
            et = torch.as_tensor(np.array([end], np.int32))
            st = torch.as_tensor(starts)
            plain = port_ref.rmi_scan_page_reference(st, *tt, et, page_size=page_size)
            xla = _xla_page(jnp.asarray(starts), base, bvals, *plan, np.array([end], np.int32),
                            page_size=page_size)
            got = emulate_scan_page(st, *tt, et, page_size=page_size, tile=tile, icap=icap,
                                    dcap=dcap, stats=stats)
            assert _same(got, plain) and _same(got, xla), (page_size, end)
    for k in ("rank_staged", "rank_in_place", "gap_staged", "gap_in_place", "dead",
              "prepass"):
        assert stats.get(k, 0) > 0, k


# ---------------------------------------------------------------------------
# B5: sharded tiles of stream slots
# ---------------------------------------------------------------------------

def emulate_sharded_scan(base, bvals, lp, ins, ivals, ins_rank, ls0, own_lo, own_hi, *,
                         page_size, max_pages, tile, icap, pcap, stats=None):
    """The sharded kernel's rows, tile by tile of each shard: a tile
    that owns no slot stays dead, one whose local ranks (or t - j + 1)
    would wrap int32 chains lane by lane (`ref.scan_rows_from_index`),
    the rest place their owned ranks' spans as the range kernel does;
    ``stats`` counts each path and the staged and in-place spans."""
    stats = {} if stats is None else stats
    S, n = base.shape
    ni = ins.shape[1]
    psteps, msteps = port_ref.trip_counts(n + 1, ni)
    lanes = max_pages * page_size
    keys = torch.full((S, lanes), float("inf"))
    vals = torch.zeros((S, lanes), dtype=torch.int32)
    live = torch.zeros((S, lanes), dtype=torch.int32)
    for s in range(S):
        lo, hi, r = int(own_lo[s]), int(own_hi[s]), int(ls0[s])
        for l0 in range(0, lanes, tile):
            l1 = min(lanes, l0 + tile)
            oa, ob = max(l0, lo), min(l1, hi)
            if oa >= ob:
                stats["dead"] = stats.get("dead", 0) + 1
                continue
            ta = wrap32(r + oa - lo)
            tb = ta + (ob - 1 - oa)
            row = (base[s], bvals[s])
            if ta < INT32_MIN + ni - 1 or tb > INT32_MAX - 1:
                stats["wrap"] = stats.get("wrap", 0) + 1
                lane = torch.arange(l0, l1)
                t = torch.as_tensor(wrap32(r + lane.numpy() - lo).astype(np.int32))
                out = port_ref.scan_rows_from_index(
                    t, (lane >= lo) & (lane < hi), *row, lp[s], ins[s], ivals[s], ins_rank[s],
                    psteps=psteps, msteps=msteps)
                keys[s, l0:l1], vals[s, l0:l1], live[s, l0:l1] = out
                continue
            stats["owned"] = stats.get("owned", 0) + 1
            spans = place_spans(ins_rank[s], ni, lp[s], n + 1, ta, tb, icap, pcap, stats)
            j, _, k = finish_ranks(spans, torch.arange(ta, tb + 1, dtype=torch.int32))
            out = port_ref._emit(torch.ones_like(j, dtype=torch.bool), k - 1, j, *row, ins[s],
                                 ivals[s])
            keys[s, oa:ob], vals[s, oa:ob], live[s, oa:ob] = out
    shape = (S, max_pages, page_size)
    return keys.reshape(shape), vals.reshape(shape), live.reshape(shape)


_xla_sharded = jax.jit(jax_ref.rmi_sharded_scan_page_reference,
                       static_argnames=("page_size", "max_pages"))
_SLAB_KEYS = ("base", "bvals", "live_prefix", "ins", "ivals", "ins_rank")

# adversarial owners: a local rank that wraps int32 inside a tile, one
# that starts just above INT32_MIN (t - j + 1 would wrap), a negative
# first slot, an inverted (empty) span and a tile owned from mid-tile
_OWNERS = {
    1: ([7], [5], [2**31 - 1]),
    3: ([0, 2**31 - 5, 7], [0, 300, 600], [300, 600, 2**31 - 1]),
    4: ([INT32_MIN + 2, 11, 2**31 - 40, 0], [-50, 333, 200, 901], [333, 200, 901, 5000]),
}


def _sharded_case(slabs, owners, kw, tiling, stats):
    ts = [torch.as_tensor(a) for a in slabs]
    own = [torch.as_tensor(np.array(a, np.int32)) for a in owners]
    plain = port_ref.rmi_sharded_scan_page_reference(*ts, *own, **kw)
    xla = _xla_sharded(*(jnp.asarray(a) for a in slabs),
                       *(jnp.asarray(o.numpy()) for o in own), **kw)
    tile, icap, pcap = tiling
    got = emulate_sharded_scan(*ts, *own, tile=tile, icap=icap, pcap=pcap, stats=stats, **kw)
    return got, plain, xla


@pytest.mark.parametrize("num,page_size", [(1, 256), (3, 160), (3, 1)])
def test_sharded_decomposition_matches_plain_twin_and_reference(num, page_size):
    """Owners from the op's rank pre-pass over NaN, inverted, infinite
    and out-of-span bounds, and adversarial raw owners (wrapping local
    ranks, an inverted span): every slot of every shard bit for bit
    against the plain twin and the reference's XLA twin, and its Pallas
    kernel in interpret mode on the adversarial owners."""
    p = _scan_slabs(num)
    slabs = [p[k] for k in _SLAB_KEYS]
    t = torch.as_tensor
    kw = dict(page_size=page_size, max_pages=40 if page_size == 1 else 6)
    stats = {}
    for lo, hi in _scan_bounds(p):
        owners = ops.sharded_scan_owners(t(np.array([lo, hi], np.float32)), t(p["base"]),
                                         t(p["live_prefix"]), t(p["ins"]))
        for tiling in ((64, 16, 32), (rmi_scan.RANGE_TILE, rmi_scan.RANGE_INS_CAP,
                                      rmi_scan.RANGE_PREFIX_CAP)):
            got, plain, xla = _sharded_case(slabs, [o.numpy() for o in owners], kw, tiling,
                                            stats)
            assert _same(got, plain) and _same(got, xla), (lo, hi, tiling)
    owners = [a[:num] for a in _OWNERS[3]]
    for pages in (-(-700 // page_size), 4):     # past the wrap; the Pallas kernel's size
        got, plain, xla = _sharded_case(slabs, owners, dict(page_size=page_size,
                                                            max_pages=pages), (64, 16, 32), stats)
        assert _same(got, plain) and _same(got, xla), pages
    pallas = rmi_sharded_scan_page_pallas(*(jnp.asarray(a) for a in slabs),
                                          *(jnp.asarray(np.array(o, np.int32)) for o in owners),
                                          page_size=page_size, max_pages=4, interpret=True)
    assert _same(got, pallas)
    assert stats["dead"] > 0 and stats["owned"] > 0
    assert (num == 1) or stats["wrap"] > 0


def _dense_shards(num):
    """``num`` shards cut from `_dense_state`'s keys (the tombstone run,
    the insert cluster with its float32 ties and the duplicate run fall
    in one shard), stacked by `stack_scan_slabs`."""
    base_raw, ins_raw, dels = _dense_state()
    cuts = np.linspace(0, base_raw.size, num + 1).astype(int)
    rng = np.random.default_rng(num)
    views = []
    for s in range(num):
        part = base_raw[cuts[s]:cuts[s + 1]]
        top = base_raw[cuts[s + 1]] if s + 1 < num else np.inf
        ins = ins_raw[(ins_raw >= part[0]) & (ins_raw < top)]
        snap = types.SimpleNamespace(keys=types.SimpleNamespace(raw=part),
                                     vals=rng.integers(-(1 << 40), 1 << 40, part.size))
        buf = DeltaBuffer.from_arrays(ins, rng.integers(1, 1 << 30, ins.size),
                                      dels[np.isin(dels, part)], ins.size + dels.size + 1)
        views.append(port_scan.pin_view(snap, None, buf))
    return port_scan.stack_scan_slabs(views), views


@pytest.mark.parametrize("num,tiling", [(1, (16, 4, 8)), (2, (32, 8, 16)), (3, (64, 16, 48))])
def test_sharded_decomposition_reaches_every_path_on_dense_tiles(num, tiling):
    """Tiles inside a tombstone run and an insert cluster longer than
    their buffers, tiles owned from mid-tile, dead tiles and wrapping
    tiles, at page sizes 1, 7 and 160 (S = 1 included): every path
    against the plain twin and the reference."""
    p, views = _dense_shards(num)
    slabs = [p[k] for k in _SLAB_KEYS]
    t = torch.as_tensor
    live = sum(v.live_count for v in views)
    stats = {}
    for page_size in (1, 7, 160):
        kw = dict(page_size=page_size, max_pages=-(-(live + 40) // page_size))
        for lo, hi in ((-1.0, 2.0), (0.3, 0.8), (0.81, 0.805), (np.nan, 0.5)):
            owners = ops.sharded_scan_owners(t(np.array([lo, hi], np.float32)),
                                             t(p["base"]), t(p["live_prefix"]), t(p["ins"]))
            got, plain, xla = _sharded_case(slabs, [o.numpy() for o in owners], kw, tiling,
                                            stats)
            assert _same(got, plain) and _same(got, xla), (page_size, lo, hi)
        owners = [a[:num] for a in _OWNERS[4]]
        got, plain, xla = _sharded_case(slabs, owners, kw, tiling, stats)
        assert _same(got, plain) and _same(got, xla), page_size
    for k in ("ins_staged", "ins_in_place", "lp_staged", "lp_in_place", "dead", "wrap",
              "owned"):
        assert stats.get(k, 0) > 0, k


# ---------------------------------------------------------------------------
# B4: one lane a (shard, query), base and delta trips side by side
# ---------------------------------------------------------------------------

def _warp_all(flags):
    """Each lane's warp-wide AND of ``flags`` (B,): lanes 32 apart in
    query order share a warp; the last warp may be partial."""
    b = flags.shape[0]
    pad = torch.ones(-(-b // 32) * 32, dtype=torch.bool)
    pad[:b] = flags
    return pad.view(-1, 32).all(1).repeat_interleave(32)[:b]


def emulate_sharded_lookup(q, s0, leaf_w, leaf_b, err_lo, err_hi, keys, dkeys, dprefix,
                           shard_n, shard_m, shard_ratio, *, hidden, max_window, stats):
    """B4's route, step for step: the leaf record the wrapper hands the
    kernel (the views' own, or a fresh pack), one lane a (shard, query)
    with the warps of a row 32 queries wide, each lane's window, then
    trip by trip its base and delta probes together.  A warp's base
    trips stop once every search of its lanes sits at a fixed point
    ((x + 1, x), or (x, x) after a probe at x not below the query);
    stopped lanes are not moved again, so only the fixed-point argument
    makes the answers the plain twin's."""
    S, B = q.shape
    D = dkeys.shape[1]
    steps, dsteps = search_lib._steps_for_window(max_window), search_lib._steps_for_window(D)
    record, rstride = rmi_lookup._stacked_leaf_record(leaf_w, leaf_b, err_lo, err_hi)
    rec4 = torch.as_strided(record, (S, leaf_w.shape[1], 4), (4 * rstride, 4, 1),
                            record.storage_offset())
    stats["record_in_place"] = stats.get("record_in_place", 0) + (record is leaf_w)
    stats["broadcast"] = stats.get("broadcast", 0) + any(
        t.stride(0) == 0 for t in (q, dkeys, dprefix, leaf_w))
    base = torch.empty((S, B), dtype=torch.int32)
    contrib = torch.empty((S, B), dtype=torch.int32)
    for s in range(S):
        n, m = int(shard_n[s]), int(shard_m[s])
        qq = q[s]
        p0 = stage0_apply(s0[s], hidden, qq)
        leaf = torch.clamp(search_lib.to_index(torch.floor(p0 * shard_ratio[s])), max=m - 1)
        rec = rec4[s][leaf.long()]
        # +inf takes f32(n - 1) whatever the slope (C17), then the clamp
        nm1 = float(np.float32(n - 1))
        pos = search_lib.clampf(torch.where(qq == torch.inf, nm1, rec[:, 0] * qq + rec[:, 1]),
                                0.0, nm1)
        lo = torch.clamp(search_lib.to_index(pos + rec[:, 2]), max=n)
        hi = torch.clamp(torch.clamp(search_lib.to_index(pos + rec[:, 3], -1.0) + 1, max=n),
                         min=0)
        p0i = torch.clamp(search_lib.to_index(pos), max=n - 1)
        right = keys[s][p0i.long()] < qq
        lo = torch.where(right, torch.maximum(lo, p0i + 1), lo)
        hi = torch.where(right, hi, torch.minimum(hi, p0i))
        fixed = lo == hi + 1
        dlo, dhi = torch.zeros_like(lo), torch.full_like(lo, D)
        running = torch.ones(B, dtype=torch.bool)
        for t in range(max(steps, dsteps)):
            if t < steps:
                running &= ~_warp_all(fixed)
                stats["stopped_early"] = stats.get("stopped_early", 0) + int((~running).sum())
                mid = (lo + hi) >> 1
                v = keys[s][torch.clamp(mid, max=n - 1).long()]
            if t < dsteps:
                dmid = (dlo + dhi) >> 1
                dv = dkeys[s][torch.clamp(dmid, max=D - 1).long()]
            if t < steps:
                r = (v < qq) & running
                stay = ~running
                lo = torch.where(r, mid + 1, lo)
                hi = torch.where(r | stay, hi, mid)
                fixed = (lo == hi + 1) | ((lo == hi) & ~(v < qq)) | stay
            if t < dsteps:
                r = dv < qq
                dlo, dhi = torch.where(r, dmid + 1, dlo), torch.where(r, dhi, dmid)
        base[s] = torch.clamp(lo, max=n)
        contrib[s] = dprefix[s][torch.clamp(dlo, max=D).long()]
    return base, contrib


@pytest.mark.parametrize("num,dist,delta", [
    (1, "maps", "empty"), (3, "dup", "pow2"), (5, "maps", "staged"), (8, "maps", "pow2"),
    (8, "dup", "staged"), (5, "dup", "empty"),
])
def test_sharded_lookup_decomposition_matches_plain_twin_and_reference(num, dist, delta):
    """The kernel's route over the record views `stack_rows` hands out
    (and over four separate arrays, packed afresh), on stored, absent,
    duplicate-run, edge, NaN and infinite queries: bit for bit against
    the plain twin, and against the reference's Pallas kernel (interpret
    mode) wherever the reference reads inside the delta row (C9) and no
    infinite query meets a flat leaf (C17).  The C17 lanes, where the
    reference's rank is wrong, equal the ``np.searchsorted`` oracle in
    each shard's own frame."""
    raw, shards, st, port, qs, dks, dps = _lookup_case(num, dist, delta, num + 11, b=300)
    qs = np.concatenate([qs, np.tile(np.array([np.nan, np.inf, -np.inf, 2.0, -1.0],
                                              np.float32), (num, 1))], axis=1)
    args = _lookup_args(port, qs, dks, dps)
    kw = dict(hidden=port["hidden"], max_window=port["max_window"])
    plain = port_ref.rmi_sharded_merged_lookup_reference(*args, **kw)
    separate = [*args[:2], *(a.contiguous() for a in args[2:6]), *args[6:]]
    assert not separate[2].data_ptr() + 4 == separate[3].data_ptr()
    stats = {}
    for a in (args, separate):
        got = emulate_sharded_lookup(*a, stats=stats, **kw)
        assert all(torch.equal(g, p) for g, p in zip(got, plain))
    assert stats["stopped_early"] > 0
    jargs = (jnp.asarray(qs), st["stage0"], st["leaf_w"], st["leaf_b"], st["err_lo"],
             st["err_hi"], st["keys"], jnp.asarray(dks), jnp.asarray(dps),
             st["shard_n"], st["shard_m"], st["shard_ratio"])
    kb, kc = rmi_sharded_merged_lookup_pallas(*jargs, hidden=st["hidden"],
                                              max_window=st["max_window"], interpret=True)
    flat = _nan_position(args, port["hidden"])
    assert np.array_equal(got[0].numpy()[~flat], np.asarray(kb)[~flat])
    past = flat | (np.isfinite(dks[:, -1:]) & (qs > dks[:, -1:]))
    assert np.array_equal(got[1].numpy()[~past], np.asarray(kc)[~past])
    for s in range(num):
        n = int(port["shard_n"][s])
        oracle = np.searchsorted(port["keys"][s, :n].numpy(), qs[s][flat[s]])
        assert np.array_equal(got[0][s].numpy()[flat[s]], oracle)
        assert np.array_equal(got[1][s].numpy()[flat[s]],
                              dps[s][np.searchsorted(dks[s], qs[s][flat[s]])])
    assert flat.any() or dist != "dup"
    assert stats["record_in_place"] == 1


def test_sharded_lookup_decomposition_reads_broadcast_rows():
    """Query and delta rows broadcast with stride 0, and a leaf record
    whose rows are all one shard's (the record's own row stride 0): read
    in place, equal to the plain twin on the materialised rows, at five
    and eight rows."""
    stats = {}
    for num in (5, 8):
        raw, shards, st, port, qs, dks, dps = _lookup_case(num, "maps", "staged", 3, b=200)
        args = _lookup_args(port, qs, dks, dps)
        kw = dict(hidden=port["hidden"], max_window=port["max_window"])
        args[0] = args[0][1:2].expand(num, -1)
        args[7], args[8] = args[7][:1].expand(num, -1), args[8][:1].expand(num, -1)
        rec = torch.stack([args[k][0] for k in range(2, 6)], dim=1)[None].expand(num, -1, -1)
        cols = list(rec.unbind(2))
        assert rmi_lookup._stacked_leaf_record(*cols)[1] == 0
        for leaves in (args[2:6], cols):
            a = [*args[:2], *leaves, *args[6:]]
            dense = [x.contiguous() for x in a]
            want = port_ref.rmi_sharded_merged_lookup_reference(*dense, **kw)
            got = emulate_sharded_lookup(*a, stats=stats, **kw)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), num
            assert all(torch.equal(g, w) for g, w in zip(
                port_ref.rmi_sharded_merged_lookup_reference(*a, **kw), want))
    assert stats["broadcast"] == 4 and stats["record_in_place"] == 4


# ---------------------------------------------------------------------------
# B7: the hash probe through 8-byte records
# ---------------------------------------------------------------------------

def emulate_hash_probe(q, s0, leaf_w, leaf_b, slot_key, slot_next, ovf_key, ovf_next, *,
                       n, num_leaves, num_slots, trips, stats):
    """B7's route, step for step: the three records the wrapper hands
    the kernel (the views' own, or fresh packs), read one 8-byte pair a
    gather — the leaf's (w, b), the slot's (key bits, next), then each
    overflow node's — and the walk that stops at a hit, at the chain's
    end or after ``trips`` hops."""
    leaves = hash_probe._pair_record(leaf_w, leaf_b)
    slots = hash_probe._pair_record(slot_key, slot_next)
    ovf = hash_probe._pair_record(ovf_key, ovf_next)
    stats["in_place"] = stats.get("in_place", 0) + sum(
        r is c for r, c in ((leaves, leaf_w), (slots, slot_key), (ovf, ovf_key)))

    def bits(rec, rows):
        pairs = torch.as_strided(rec, (rows, 2), (2, 1), rec.storage_offset())
        return pairs if pairs.dtype == torch.int32 else pairs.view(torch.int32)

    lf = bits(leaves, num_leaves).view(torch.float32)
    sl, ov = bits(slots, num_slots), bits(ovf, ovf_key.shape[0])
    f32 = np.float32
    p0 = q * s0[0] + s0[1]
    leaf = torch.clamp(search_lib.to_index(torch.floor(p0 * torch.tensor(
        f32(num_leaves / n)))), max=num_leaves - 1).long()
    nm1 = float(f32(n - 1))
    pos = search_lib.clampf(torch.where(q == torch.inf, nm1, lf[leaf, 0] * q + lf[leaf, 1]),
                            0.0, nm1)
    slot = torch.clamp(search_lib.to_index(pos * torch.tensor(f32(num_slots / n))),
                       max=num_slots - 1).long()
    rec = sl[slot]
    found = rec[:, 0].view(torch.float32) == q
    nxt = rec[:, 1]
    live = ~found & (nxt >= 0)
    for _ in range(trips):
        if not live.any():
            break
        rec = ov[torch.clamp(nxt, max=ov.shape[0] - 1).long()]
        hit = rec[:, 0].view(torch.float32) == q
        stats["hops"] = stats.get("hops", 0) + int(live.sum())
        stats["chain_hit"] = stats.get("chain_hit", 0) + int((live & hit).sum())
        stats["chain_end"] = stats.get("chain_end", 0) + int((live & ~hit & (rec[:, 1] < 0))
                                                            .sum())
        found = torch.where(live, hit, found)
        nxt = torch.where(live, rec[:, 1], nxt)
        live = live & ~found & (nxt >= 0)
    stats["cut"] = stats.get("cut", 0) + int(live.sum())
    return found


def _hash_layouts(tabs, idx):
    """The tables as `hash_probe_tensors` hands them out (record views),
    as separate contiguous arrays, and with the leaf pair taken from the
    (M, 4) lookup record `RMIndex.as_tree` hands out (strided columns,
    packed afresh)."""
    separate = tuple(t.contiguous() for t in tabs)
    tree = idx.as_tree("cpu")
    return {"records": tabs, "separate": separate,
            "lookup_record": (tabs[0], tree["leaf_w"], tree["leaf_b"], *tabs[3:])}


@pytest.mark.parametrize("dist,ratio", [("gen_maps", 0.75), ("gen_lognormal", 1.0),
                                        ("gen_weblogs", 1.25)])
def test_hash_probe_decomposition_matches_plain_twin_and_reference(dist, ratio):
    """Stored, absent, float32-equal, NaN, infinite and out-of-span
    queries through every layout, with the map's own trips and with
    fewer (walks cut short): bit for bit against the plain twin, and
    against the reference's Pallas kernel (interpret mode) wherever
    fused and unfused rounding pick the same slot (C2)."""
    raw, s, (hm, idx, ks), _ = _maps(dist, ratio)
    stored, absent, edges = _probe_queries(raw, np.random.default_rng(12))
    q = ks.normalize(np.concatenate([stored, absent, _f32_twins(raw, ks)[:50], edges]))
    qt = torch.as_tensor(q)
    tabs = ops.hash_probe_tensors(hm, idx, ks, "cpu")
    kw = dict(n=idx.n, num_leaves=idx.num_leaves, num_slots=s)
    trips = max(0, hm.max_chain - 1)
    stats = {}
    for name, layout in _hash_layouts(tabs, idx).items():
        for tr in (trips, 1, 0):
            got = emulate_hash_probe(qt, *layout, trips=tr, stats=stats, **kw)
            assert torch.equal(got, port_ref.hash_probe_reference(qt, *layout, trips=tr, **kw)), \
                (name, tr)
    got = emulate_hash_probe(qt, *tabs, trips=trips, stats=stats, **kw).numpy()
    s0 = tabs[0].numpy()
    want = np.asarray(hash_probe_pallas(
        jnp.asarray(q), jnp.asarray(s0[:1].reshape(1, 1)), jnp.asarray(s0[1:]),
        *(jnp.asarray(a.numpy()) for a in tabs[1:]), trips=trips, **kw))
    fma = _fma_decides(idx, q, s)
    assert np.array_equal(got[~fma], want[~fma])
    assert got[:stored.size].all() and not got[stored.size:stored.size + absent.size].any()
    # the record views are read in place; other arrays are packed
    assert stats["in_place"] == 3 * 3 + 2 * 3 + 3
    for k in ("chain_hit", "chain_end", "cut"):
        assert stats.get(k, 0) > 0, k


def test_hash_probe_decomposition_without_overflow_and_zero_trips():
    """A map so sparse that no slot overflows: its overflow record is one
    (NaN, -1) node, ``trips`` is 0, and every answer comes from the slot
    compare, in every layout, equal to the twin, and to the reference's
    Pallas kernel wherever fused and unfused rounding pick the same slot
    (C2)."""
    raw = gen_maps(400, seed=3)
    s = 1 << 20
    hm, idx, ks = learned_hash.build_model_hashmap(raw, s, device="cpu")
    assert hm.max_chain == 1 and hm.ovf_next.tolist() == [-1]
    q = ks.normalize(np.concatenate([raw, raw + 1e-3, [np.nan, np.inf, -np.inf]]))
    qt = torch.as_tensor(q)
    tabs = ops.hash_probe_tensors(hm, idx, ks, "cpu")
    kw = dict(n=idx.n, num_leaves=idx.num_leaves, num_slots=s, trips=0)
    stats = {}
    for layout in _hash_layouts(tabs, idx).values():
        got = emulate_hash_probe(qt, *layout, stats=stats, **kw)
        assert torch.equal(got, port_ref.hash_probe_reference(qt, *layout, **kw))
        assert got[:raw.size].all() and not got[raw.size:].any()
    s0 = tabs[0].numpy()
    want = np.asarray(hash_probe_pallas(
        jnp.asarray(q), jnp.asarray(s0[:1].reshape(1, 1)), jnp.asarray(s0[1:]),
        *(jnp.asarray(a.numpy()) for a in tabs[1:]), **kw))
    fma = _fma_decides(idx, q, s)
    assert np.array_equal(got.numpy()[~fma], want[~fma])
    assert stats.get("hops", 0) == 0


# ---------------------------------------------------------------------------
# B8: four queries a thread, each step one probe of every live query
# ---------------------------------------------------------------------------

def _np_mix32(h, seed):
    """The kernel's uint32 `mix32` in NumPy (uint32 products wrap)."""
    h = np.asarray(h, np.uint32) ^ np.uint32(seed * 0x9E3779B9 & 0xFFFFFFFF)
    with np.errstate(over="ignore"):
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x7FEB352D)
        h ^= h >> np.uint32(15)
        h *= np.uint32(0x846CA68B)
    return h ^ (h >> np.uint32(16))


def emulate_bloom_probe(queries, words, *, num_bits, k, per_thread, aligned, stats):
    """B8's route, step for step: ``per_thread`` queries a thread (keys
    by one vector load when the thread is whole and the tensors
    ``aligned``, else one by one; lanes past the batch dead from the
    start), each step the next probe of every live query gathered
    before any is tested (``h1 + i*h2`` kept as a running uint32 sum),
    and the thread stopping once none of its queries is live."""
    q = queries.numpy().view(np.uint32)
    w = words.numpy().view(np.uint32)
    b = q.size
    threads = -(-b // per_thread)
    lane = np.arange(threads * per_thread).reshape(threads, per_thread)
    live = lane < b
    stats["vector_threads"] = stats.get("vector_threads", 0) + int(
        (live.all(1) & aligned).sum())
    stats["tail_threads"] = stats.get("tail_threads", 0) + int((~live.all(1)).sum())
    key = np.zeros(lane.shape, np.uint32)
    key[live] = q[lane[live]]
    h, h2 = _np_mix32(key, 1), _np_mix32(key, 2) | np.uint32(1)
    hit = live.copy()
    running = np.ones(threads, bool)
    for i in range(k):
        bit = h % np.uint32(num_bits)
        issue = hit & running[:, None]
        word = np.zeros(lane.shape, np.uint32)
        word[issue] = w[bit[issue] >> np.uint32(5)]
        stats["loads"] = stats.get("loads", 0) + int(issue.sum())
        hit &= ((word >> (bit & np.uint32(31))) & np.uint32(1)).astype(bool)
        with np.errstate(over="ignore"):
            h = h + h2
        stopped = running & ~hit.any(1)
        if i + 1 < k:
            stats["stopped_early"] = stats.get("stopped_early", 0) + int(stopped.sum())
        running &= ~stopped
        if not running.any():
            break
    return torch.from_numpy(hit.reshape(-1)[:b].copy())


BLOOM_ROUTE_SHAPES = ((1 << 14, 3), (1 << 16, 7), (1 << 18, 10), ((1 << 31) + 96, 7),
                      (1, 3), (1 << 12, 0))


@pytest.mark.parametrize("num_bits,k", BLOOM_ROUTE_SHAPES)
def test_bloom_decomposition_matches_plain_twin(num_bits, k):
    """Members, random keys and 0 / 1 / 2**31 / 2**32 - 1 in batches of
    1, 3 and 777 (ragged tails) and 1,024, four queries a thread as the
    kernel takes them (`bloom_probe.QUERIES_PER_THREAD`), and one and
    eight, aligned and not: bit for bit against the plain twin, and
    every member found.  Above 2**31 bits ``h1 + i*h2`` wraps 2**32
    before the modulo; with one bit every key is a member."""
    rng = np.random.default_rng(num_bits % 997 + k)
    members = rng.integers(0, 1 << 32, 300, dtype=np.uint32)
    words = torch.from_numpy(_family_words(members, num_bits, k).view(np.int32))
    pool = np.concatenate([members, rng.integers(0, 1 << 32, 3_000, dtype=np.uint32),
                           np.array([0, 1, 1 << 31, (1 << 32) - 1], np.uint32)])
    stats = {}
    for batch in (1, 3, 777, 1024):
        q = torch.from_numpy(rng.choice(pool, batch).view(np.int32))
        want = port_ref.bloom_probe_reference(q, words, num_bits=num_bits, k=k)
        for per_thread in (bloom_probe.QUERIES_PER_THREAD, 1, 8):
            for aligned in (True, False):
                got = emulate_bloom_probe(q, words, num_bits=num_bits, k=k,
                                          per_thread=per_thread, aligned=aligned, stats=stats)
                assert torch.equal(got, want), (batch, per_thread, aligned)
    m = torch.from_numpy(members.view(np.int32))
    assert emulate_bloom_probe(m, words, num_bits=num_bits, k=k,
                               per_thread=bloom_probe.QUERIES_PER_THREAD, aligned=True,
                               stats=stats).all()
    assert stats["tail_threads"] > 0 and stats["vector_threads"] > 0
    assert (stats.get("stopped_early", 0) > 0) == (k > 1 and num_bits > 1)


def test_bloom_kernel_shape_is_the_sources():
    """The emulation's shape is the one `csrc/probe.cu` compiles."""
    src = hash_probe.SOURCE.read_text()
    assert f"constexpr int BLOOM_Q = {bloom_probe.QUERIES_PER_THREAD};" in src
