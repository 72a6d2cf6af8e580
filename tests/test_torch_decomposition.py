"""The decompositions of the redesigned lookup and range-scan kernels,
emulated in plain PyTorch on the host.

The CUDA kernels of `csrc/rmi_lookup.cu` and `csrc/rmi_scan.cu` reach
their plain twins' answers by another route, and the card is not here.
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
  each rank's search finished inside the span.

The kernels themselves meet these cases in the `cuda`-marked tests of
`test_torch_kernels.py` and `test_torch_scan.py`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import RMIConfig, build_rmi, make_keyset  # noqa: E402
from repro.index_service.delta import DeltaBuffer as RefDelta  # noqa: E402
from repro.index_service.delta import combine_for_device  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.rmi_lookup import (  # noqa: E402
    rmi_lookup_pallas,
    rmi_merged_lookup_pallas,
)
from test_torch_kernels import _case, _jax_args, _port_args, _queries  # noqa: E402
from test_torch_scan import CASES, _bounds, _kernel_case, _lowered, _xla_range  # noqa: E402

from repro_torch.core import search as search_lib  # noqa: E402
from repro_torch.core.rmi import LEAF_FIELDS, pack_leaves  # noqa: E402
from repro_torch.kernels import ref as port_ref  # noqa: E402
from repro_torch.kernels import rmi_lookup, rmi_scan  # noqa: E402

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


def warp_lower_bound(arr, q, lo, hi):
    """The kernel's 33-ary warp search: ``lo + #{arr[lo:hi] < q}``."""
    def below(p):
        return bool(arr[p] < q)

    while hi - lo > 32:
        span = hi - lo
        c = sum(below(lo + span * (i + 1) // 33) for i in range(32))
        lo, hi = (lo if c == 0 else lo + span * c // 33 + 1,
                  hi if c == 32 else lo + span * (c + 1) // 33)
    return lo + sum(below(p) for p in range(lo, hi))


def span_lower_bound(span, q, size):
    """The kernel's in-span search: pinned fixed trips, one per bit of
    the span's size."""
    return port_ref.array_lower_bound(span, q, size, size.bit_length())


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
        jf, jl = warp_lower_bound(ins_rank, ta, 0, ni), warp_lower_bound(ins_rank, tb, 0, ni)
        pf = warp_lower_bound(lp, ta - jl + 1, 0, n + 1)
        pl = warp_lower_bound(lp, tb - jf + 1, 0, n + 1)
        jn, pn = jl - jf, pl - pf
        # staged: a copy in the block's buffer; else read in place
        ispan = ins_rank[jf:jl].clone() if jn <= icap else ins_rank[jf:jl]
        pspan = lp[pf:pl].clone() if pn <= pcap else lp[pf:pl]
        for key, staged in (("ins", jn <= icap), ("lp", pn <= pcap)):
            k = f"{key}_{'staged' if staged else 'in_place'}"
            stats[k] = stats.get(k, 0) + 1
        stats["starts_on_insert"] = stats.get("starts_on_insert", 0) + int(
            bool((ins_rank[:ni] == ta).any()))
        t = torch.arange(r0 + l0, r0 + v1, dtype=i32)
        j = jf + span_lower_bound(ispan, t, jn)
        p = pf - 1 + span_lower_bound(pspan, t - j + 1, pn)
        k, v, lv = port_ref._emit(torch.ones_like(t, dtype=torch.bool), p, j, base, bvals,
                                  ins, ivals)
        keys[l0:v1], vals[l0:v1], live[l0:v1] = k, v, lv
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
