"""The port's merged range scans against the reference's.

* every function of `index_service/scan.py` against the reference's on
  the same seeded inputs, array for array;
* the plain twins of the two scan kernels (`rmi_scan_range_reference`,
  `rmi_scan_page_reference`) against the reference's XLA twins and its
  Pallas kernels in interpret mode, on every lane, masked lanes
  included: empty delta, tombstones only, inserts only, unpadded
  power-of-two arrays, NaN / inverted / out-of-span bounds, and a staged
  insert that ties a base key in float32;
* the service: one seeded op stream through the reference's
  `IndexService(strategy="xla_fused")` and the port's
  `IndexService(strategy="cuda_fused", device="cpu")`, with equal `scan`
  pages and `scan_batch` outputs, open iterators pinned across writes
  and a flush, one dispatch per warm `scan_batch` and the same scan
  plane hit/miss counts;
* `cuda`-marked tests hold both CUDA kernels against their plain twins
  on the card.

All comparisons are exact: the kernels only search, compare and gather.
"""

import types
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.index_service import IndexService as RefService  # noqa: E402
from repro.index_service import ServiceConfig as RefConfig  # noqa: E402
from repro.index_service import scan as ref_scan  # noqa: E402
from repro.index_service.delta import DeltaBuffer as RefDelta  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.rmi_lookup import (  # noqa: E402
    rmi_scan_page_pallas,
    rmi_scan_range_pallas,
)

from repro_torch.index_service import IndexService, ServiceConfig  # noqa: E402
from repro_torch.index_service import scan as port_scan  # noqa: E402
from repro_torch.index_service.delta import DeltaBuffer  # noqa: E402
from repro_torch.kernels import ops, rmi_scan  # noqa: E402
from repro_torch.kernels import ref as port_ref  # noqa: E402

N = 2_048          # base rows of the kernel-level cases
PAD = 256          # every delta pads (or fills) to 256 slots: one shape
MAX_PAGES = 8
PAGE_SIZES = (1, 16, 160)

# the reference's XLA twins, compiled once per shape
_xla_range = jax.jit(jax_ref.rmi_scan_range_reference,
                     static_argnames=("page_size", "max_pages"))
_xla_page = jax.jit(jax_ref.rmi_scan_page_reference, static_argnames=("page_size",))


# --------------------------------------------------------------------------
# seeded views: the same arrays as a port view and a reference view
# --------------------------------------------------------------------------

def _view_arrays(seed, *, n=N, n_ins=40, n_del=30, base_vals=True):
    rng = np.random.default_rng(seed)
    base = np.unique(rng.integers(0, 1 << 40, n + 64).astype(np.float64))[:n]
    bvals = rng.integers(-(1 << 40), 1 << 40, n) if base_vals else None
    ins = np.setdiff1d(np.unique(rng.integers(0, 1 << 40, n_ins + 8)
                                 .astype(np.float64)), base)[:n_ins]
    ivals = rng.integers(1, 1 << 30, ins.size)
    dels = np.sort(rng.choice(base, n_del, replace=False))
    return base, bvals, ins, ivals, dels


def _views(seed, **kw):
    """(port view, reference view) through each package's own pin_view
    over one delta buffer of the same staged arrays."""
    base, bvals, ins, ivals, dels = _view_arrays(seed, **kw)
    snap = types.SimpleNamespace(keys=types.SimpleNamespace(raw=base), vals=bvals)
    cap = ins.size + dels.size + 1
    pv = port_scan.pin_view(snap, None, DeltaBuffer.from_arrays(ins, ivals, dels, cap))
    rv = ref_scan.pin_view(snap, None, RefDelta.from_arrays(ins, ivals, dels, cap))
    return pv, rv


def _normalizer(lo, hi):
    return lambda x: ((np.asarray(x, np.float64) - lo) / (hi - lo)).astype(np.float32)


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x, y, equal_nan=True)


def _pages(it):
    return [(p.keys, p.vals, p.live_mask) for p in it]


# --------------------------------------------------------------------------
# scan.py, function by function
# --------------------------------------------------------------------------

def test_pad_bucket_matches_reference():
    for min_pad in (1, 64):
        got = [port_scan._pad_bucket(x, min_pad=min_pad) for x in range(1, 5001)]
        want = [ref_scan._pad_bucket(x, min_pad=min_pad) for x in range(1, 5001)]
        assert got == want


@pytest.mark.parametrize("n_pad", [None, N, N + 300])
def test_live_prefix_index_matches_reference(n_pad):
    for seed in range(3):
        pv, rv = _views(seed, n_del=37 * seed)
        _assert_same([port_scan.live_prefix_index(pv.del_pos, N, n_pad=n_pad)],
                     [ref_scan.live_prefix_index(rv.del_pos, N, n_pad=n_pad)])


@pytest.mark.parametrize("case", ["staged", "empty_delta", "no_payload"])
def test_device_lowerings_match_reference(case):
    kw = {"staged": {}, "empty_delta": {"n_ins": 0, "n_del": 0},
          "no_payload": {"base_vals": False}}[case]
    pv, rv = _views(5, **kw)
    _assert_same([pv.base_keys, pv.ins_keys, pv.ins_vals, pv.del_pos],
                 [rv.base_keys, rv.ins_keys, rv.ins_vals, rv.del_pos])
    lo, hi = port_scan.fit_scan_frame([pv])
    assert (lo, hi) == ref_scan.fit_scan_frame([rv])
    norm = _normalizer(lo, hi)
    base_norm = norm(pv.base_keys)
    _assert_same(port_scan.device_scan_slab(pv, base_norm, norm),
                 ref_scan.device_scan_slab(rv, base_norm, norm))
    _assert_same(port_scan.device_scan_plan(pv, norm),
                 ref_scan.device_scan_plan(rv, norm))
    got = port_scan.pack_scan_slab(pv, norm, N + 100, 320)
    want = ref_scan.pack_scan_slab(rv, norm, N + 100, 320)
    assert sorted(got) == sorted(want) and got["live"] == want["live"]
    _assert_same([got[k] for k in sorted(got) if k != "live"],
                 [want[k] for k in sorted(want) if k != "live"])


def test_stacked_slabs_and_page_bound_match_reference():
    pvs, rvs = zip(*(_views(s, n=N - 300 * s) for s in range(3)))
    got, want = port_scan.stack_scan_slabs(pvs), ref_scan.stack_scan_slabs(rvs)
    keys = ("base", "bvals", "live_prefix", "ins", "ivals", "ins_rank")
    assert (got["lo"], got["hi"], got["ins_total"]) == (want["lo"], want["hi"], want["ins_total"])
    _assert_same([got[k] for k in keys], [want[k] for k in keys])
    raws = [v.base_keys for v in pvs]
    rng = np.random.default_rng(1)
    for lo, hi in rng.uniform(-1e10, 1.2e12, (20, 2)):
        for page_size in PAGE_SIZES:
            assert (port_scan.scan_page_bound(raws, 77, lo, hi, page_size)
                    == ref_scan.scan_page_bound(raws, 77, lo, hi, page_size))


@pytest.mark.parametrize("page_size", [1, 7, 113, 4096])
def test_scan_pages_and_repack_match_reference(page_size):
    pv, rv = _views(9)
    keys = pv.base_keys
    for lo, hi in ((keys[3], keys[-3]), (keys[100], keys[101]), (keys[50], keys[10]),
                   (-1.0, keys[0]), (keys[-1] + 1, keys[-1] + 9), (np.nan, keys[9])):
        _assert_same(_pages(port_scan.scan_pages(pv, lo, hi, page_size)),
                     _pages(ref_scan.scan_pages(rv, lo, hi, page_size)))
    cuts = keys[[0, 500, 501, 1700]].tolist() + [keys[-1] + 1]
    got = port_scan.repack_pages(
        (port_scan.scan_pages(pv, a, b, 97) for a, b in zip(cuts, cuts[1:])), page_size)
    want = ref_scan.repack_pages(
        (ref_scan.scan_pages(rv, a, b, 97) for a, b in zip(cuts, cuts[1:])), page_size)
    _assert_same(_pages(got), _pages(want))
    np.testing.assert_array_equal(pv.rank(keys[::50]), rv.rank(keys[::50]))


# --------------------------------------------------------------------------
# the kernels' plain twins against the reference's twins and Pallas kernels
# --------------------------------------------------------------------------

def _kernel_case(case):
    """Device-lowered inputs of one case: (base_norm, bvals, range slab,
    page plan) with every delta array of exactly PAD slots."""
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    kw = {"empty": dict(n_ins=0, n_del=0), "tombstones": dict(n_ins=0, n_del=120),
          "inserts": dict(n_ins=150, n_del=0), "mixed": dict(n_ins=90, n_del=70),
          "pow2": dict(n_ins=PAD, n_del=PAD)}[case]
    pv, _ = _views(int(rng.integers(1 << 30)), **kw)
    lo, hi = port_scan.fit_scan_frame([pv])
    norm = _normalizer(lo, hi)
    base = norm(pv.base_keys)
    bvals = np.clip(pv.base_vals, -2**31, 2**31 - 1).astype(np.int32)
    ins, ivals, ins_rank, lp = port_scan.device_scan_slab(pv, base, norm, min_pad=PAD)
    pins, pivals, dpos = port_scan.device_scan_plan(pv, norm, min_pad=PAD)
    if case == "pow2":  # no pad slot at all: searches run to the end
        k = pv.ins_keys.size
        ins, ivals, ins_rank = ins[:k], ivals[:k], ins_rank[:k]
        pins, pivals, dpos = ins, ivals, pv.del_pos.astype(np.int32)
    assert ins.size == pins.size == dpos.size == PAD
    return base, bvals, (ins, ivals, ins_rank, lp), (pins, pivals, dpos), pv


def _bounds(base, pv):
    live_end = pv.live_count
    mid = base[N // 2]
    return {
        "inside": [base[100], base[1500]],
        "page_edge": [base[7], base[7 + 16 * 3]],
        "one_row": [base[9], np.nextafter(base[9], np.float32(2))],
        "past_max_pages": [base[0], base[-1]],
        "inverted": [base[900], base[300]],
        "empty": [mid, mid],
        "nan_lo": [np.nan, base[40]],
        "nan_hi": [base[40], np.nan],
        "below_span": [-3.0, -1.0],
        "above_span": [1.5, 9.0],
        "whole": [-np.inf, np.inf],
    }, np.array([-7, 0, 1, live_end // 2, live_end - 5, live_end, live_end + 99,
                 2**31 - 9], np.int32)


CASES = ["empty", "tombstones", "inserts", "mixed", "pow2"]


def _lowered(base_raw, ins_raw, dels, seed=3):
    """One staged state lowered for the scan kernels, as `_kernel_case`
    lowers it: ``(norm, base, bvals, (ins, ins_vals, ins_rank,
    live_prefix), (plan ins, plan vals, del_pos), live rows)``, random
    payloads."""
    rng = np.random.default_rng(seed)
    snap = types.SimpleNamespace(keys=types.SimpleNamespace(raw=base_raw),
                                 vals=rng.integers(-(1 << 40), 1 << 40, base_raw.size))
    buf = DeltaBuffer.from_arrays(ins_raw, rng.integers(1, 1 << 30, ins_raw.size), dels,
                                  ins_raw.size + dels.size + 1)
    view = port_scan.pin_view(snap, None, buf)
    norm = _normalizer(*port_scan.fit_scan_frame([view]))
    base = norm(view.base_keys)
    bvals = np.clip(view.base_vals, -2**31, 2**31 - 1).astype(np.int32)
    return (norm, base, bvals, port_scan.device_scan_slab(view, base, norm),
            port_scan.device_scan_plan(view, norm), view.live_count)


def _dense_card_case(case):
    """60k base keys, sized for the range kernel's own tiles and
    buffers: ranges that cross many tiles ("tile_crossing"), or a
    tombstone run and an insert cluster longer than its buffers
    ("dense_tombstones").  Returns `_lowered`'s arrays, bounds and page
    starts."""
    rng = np.random.default_rng(7)
    base_raw = np.unique(rng.uniform(0, 1e6, 60_000))
    if case == "tile_crossing":
        ins = np.setdiff1d(np.unique(rng.uniform(0, 1e6, 3000)), base_raw)
        dels = np.sort(rng.choice(base_raw, 3000, replace=False))
    else:
        ins = np.setdiff1d(np.unique(np.concatenate([
            base_raw[5000] + rng.uniform(0, 1e-3, 3 * rmi_scan.RANGE_INS_CAP),
            rng.uniform(0, 1e6, 500)])), base_raw)
        dels = base_raw[10_000:10_000 + 3 * rmi_scan.RANGE_PREFIX_CAP]
    norm, base, bvals, slab, plan, live = _lowered(base_raw, ins, dels)
    bounds = [norm(np.array(b)) for b in (
        (-1.0, 2e6), (base_raw[4990], base_raw[40_000]), (base_raw[10_100], 1e6),
        (base_raw[9000], base_raw[100]), (base_raw[7], base_raw[7]))]
    starts = np.array([-7, 0, 1, live // 2, live - 5, live, 2**31 - 9], np.int32)
    return base, bvals, slab, plan, live, bounds, starts


@pytest.mark.parametrize("case", CASES)
def test_scan_range_twin_matches_reference(case):
    base, bvals, slab, _, pv = _kernel_case(case)
    ins, ivals, ins_rank, lp = slab
    bounds, _ = _bounds(base, pv)
    tt = [torch.as_tensor(a) for a in (base, bvals, lp, ins, ivals, ins_rank)]
    for name, b in bounds.items():
        b = np.asarray(b, np.float32)
        for page_size in PAGE_SIZES:
            kw = dict(page_size=page_size, max_pages=MAX_PAGES)
            got = port_ref.rmi_scan_range_reference(torch.as_tensor(b), *tt, **kw)
            got = [g.numpy() for g in got]
            xla = _xla_range(
                jnp.asarray(b), base, bvals, lp, ins, ivals, ins_rank, **kw)
            pallas = rmi_scan_range_pallas(
                jnp.asarray(b), base, bvals, lp, ins, ivals, ins_rank,
                interpret=True, **kw)
            _assert_same(got, xla)
            _assert_same(got, pallas)
            # the wrapper and the op give the same on the host
            _assert_same(got, rmi_scan.rmi_scan_range_cuda(torch.as_tensor(b), *tt, **kw))
            k, v, live = ops.rmi_scan_range_op(b, *tt, **kw)
            assert live.dtype == torch.bool
            _assert_same(got[:2], [k, v])
            assert np.array_equal(got[2] == 1, live.numpy()), (case, name)


@pytest.mark.parametrize("case", CASES)
def test_scan_page_twin_matches_reference(case):
    base, bvals, _, plan, pv = _kernel_case(case)
    ins, ivals, dpos = plan
    _, starts = _bounds(base, pv)
    end = np.array([pv.live_count], np.int32)
    tt = [torch.as_tensor(a) for a in (base, bvals, ins, ivals, dpos, end)]
    for page_size in PAGE_SIZES:
        got = port_ref.rmi_scan_page_reference(
            torch.as_tensor(starts), *tt, page_size=page_size)
        got = [g.numpy() for g in got]
        xla = _xla_page(
            jnp.asarray(starts), base, bvals, ins, ivals, dpos, end, page_size=page_size)
        pallas = rmi_scan_page_pallas(
            jnp.asarray(starts), base, bvals, ins, ivals, dpos, end,
            page_size=page_size, interpret=True)
        _assert_same(got, xla)
        _assert_same(got, pallas)
        k, v, live = ops.rmi_scan_page_op(starts, *tt[:2], *plan, end,
                                          page_size=page_size)
        _assert_same(got[:2], [k, v])
        assert np.array_equal(got[2] == 1, live.numpy())
    empty = port_ref.rmi_scan_page_reference(
        torch.zeros(0, dtype=torch.int32), *tt, page_size=16)
    assert [tuple(e.shape) for e in empty] == [(0, 16)] * 3


def _endpoint_ranks(bounds, base, lp, ins):
    """(r0, max(r1, r0)): the merged ranks the range kernel starts and
    stops at."""
    t = torch.as_tensor
    steps, isteps = port_ref.trip_counts(base.shape[0], ins.shape[0])
    r = port_ref.merged_rank_from_prefix(
        t(np.asarray(bounds, np.float32)), t(base), t(lp), t(ins),
        steps=steps, isteps=isteps)
    return int(r[0]), max(int(r[1]), int(r[0]))


@pytest.mark.parametrize("case", ["mixed", "tombstones"])
def test_both_kernels_emit_the_same_rows(case):
    """The page kernel's nested searches and the range kernel's prefix
    index decompose every rank the same way: pages addressed at the
    range's own ranks hold the range kernel's rows."""
    base, bvals, slab, plan, pv = _kernel_case(case)
    ins, ivals, ins_rank, lp = slab
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    page_size = 16
    for b in ([base[100], base[1500]], [base[0], np.inf], [base[600], base[610]]):
        b = np.asarray(b, np.float32)
        rk, rv, rl = port_ref.rmi_scan_range_reference(
            t(b), t(base), t(bvals), t(lp), t(ins), t(ivals), t(ins_rank),
            page_size=page_size, max_pages=200)
        r0, r1 = _endpoint_ranks(b, base, lp, ins)
        starts = (r0 + page_size * np.arange(200)).astype(np.int32)
        pk, pvv, pl = port_ref.rmi_scan_page_reference(
            t(starts), t(base), t(bvals), *(t(a) for a in plan),
            t(np.array([r1], np.int32)), page_size=page_size)
        assert torch.equal(rl, pl) and int(rl.sum()) == r1 - r0
        assert torch.equal(rk, pk) and torch.equal(rv, pvv)


def test_array_lower_bound_pins_converged_lanes():
    """Extra trips past convergence never walk ``lo`` past ``size``, and
    a NaN query ranks 0 (``v < NaN`` is false)."""
    arr = torch.tensor([1.0, 2.0, 3.0, float("inf")])
    q = torch.tensor([0.0, 2.0, 3.5, float("inf"), 1e30, float("nan")])
    got = port_ref.array_lower_bound(arr, q, 4, 12)
    assert got.tolist() == [0, 1, 3, 3, 3, 0]
    ints = torch.arange(8, dtype=torch.int32)
    assert port_ref.array_lower_bound(ints, torch.tensor([9, 8, 7]).int(), 8, 9).tolist() == [8, 8, 7]


def test_float32_tie_drops_the_staged_insert_like_the_reference():
    """Pinned reference fault (ROADMAP queue C): a staged insert whose
    float32 key ties a live base key is ranked before the equal base run,
    and the select prefers the base row on the tie, so `scan_batch` emits
    that base row twice and never the insert's value.  Both packages do
    it bit for bit; the host `scan` gives the exact rows."""
    base = np.array([0.0, 0.25, 0.5, 0.75, 1.0])
    vals = np.arange(10, 15, dtype=np.int64)
    tie = 0.5 + 1e-12           # a distinct raw key, float32 0.5
    svc = IndexService(base, ServiceConfig(strategy="cuda_fused"), vals=vals, device="cpu")
    ref = RefService(base, RefConfig(strategy="xla_fused"), vals=vals)
    for s in (svc, ref):
        s.insert(np.array([tie]), np.array([99]))
    got = svc.scan_batch(0.0, 2.0, 8)
    _assert_same([g.numpy() for g in got], ref.scan_batch(0.0, 2.0, 8))
    live = got[2].numpy()
    assert got[1].numpy()[live].tolist() == [10, 11, 12, 12, 13, 14]
    assert got[0].numpy()[live].tolist() == [0.0, 0.25, 0.5, 0.5, 0.75, 1.0]
    exact = np.concatenate([p.vals[p.live_mask] for p in svc.scan(0.0, 2.0, 8)])
    assert exact.tolist() == [10, 11, 12, 99, 13, 14]


def test_scan_batch_holds_a_float32_duplicate_run_the_reference_truncates():
    """Reference fault, fixed in the port (ROADMAP queue C): the
    reference sizes `scan_batch`'s output from the float64 window plus
    one page, but the device ranks [lo, hi) in float32, where a
    duplicate run can add more rows than one page holds; at page size 1
    the reference returns 16 of the range's 20 float32 rows.  The port
    sizes the output in the float32 frame and returns all 20."""
    base = np.concatenate([[0.0], 0.5 + np.arange(20) * 1e-12, [1.0]])
    lo, hi = 0.5 + 5e-12, 0.75          # float32: [0.5, 0.75), 20 rows
    port = IndexService(base, ServiceConfig(strategy="cuda_fused"), device="cpu")
    ref = RefService(base, RefConfig(strategy="xla_fused"))
    assert int(np.asarray(ref.scan_batch(lo, hi, 1)[2]).sum()) == 16
    for page_size in (1, 2, 7):
        keys, _, live = port.scan_batch(lo, hi, page_size)
        assert int(live.sum()) == 20
        assert keys[live].tolist() == [0.5] * 20
    # the exact host scan holds the 15 float64 rows
    assert sum(p.count for p in port.scan(lo, hi, 1)) == 15


# --------------------------------------------------------------------------
# the service
# --------------------------------------------------------------------------

def _service_pair(capacity=384):
    rng = np.random.default_rng(21)
    base = np.unique(rng.integers(0, 1 << 40, 3_000).astype(np.float64))
    vals = rng.integers(0, 1 << 30, base.size)
    ref = RefService(base, RefConfig(strategy="xla_fused", delta_capacity=capacity), vals=vals)
    port = IndexService(base, ServiceConfig(strategy="cuda_fused", delta_capacity=capacity),
                        vals=vals, device="cpu")
    return rng, base, ref, port


def _same_scans(ref, port, lo, hi, page_size):
    got = port.scan_batch(lo, hi, page_size)
    assert all(g.device.type == "cpu" for g in got)
    _assert_same([g.numpy() for g in got], ref.scan_batch(lo, hi, page_size))
    _assert_same(_pages(port.scan(lo, hi, page_size)), _pages(ref.scan(lo, hi, page_size)))


def test_scan_op_stream_matches_reference():
    rng, base, ref, port = _service_pair()
    live = set(base.tolist())
    for step in range(7):
        ins = np.unique(rng.integers(0, 1 << 40, 60).astype(np.float64))
        iv = rng.integers(1, 1 << 30, ins.size)
        dels = rng.choice(np.array(sorted(live)), 40, replace=False)
        for s in (ref, port):
            s.insert(ins, iv)
            s.delete(dels)
        live |= set(ins.tolist())
        live -= set(dels.tolist())
        arr = np.array(sorted(live))
        a, b = np.sort(rng.integers(0, arr.size, 2))
        page_size = PAGE_SIZES[step % 3]
        _same_scans(ref, port, float(arr[a]), float(arr[b]), page_size)
        if step % 4 == 3:
            _same_scans(ref, port, float(arr[b]), float(arr[a]), 16)   # inverted
            _same_scans(ref, port, -5.0, float(arr[40]), 16)           # below the span
    assert port.stats["compactions"] == ref.stats["compactions"] >= 2
    got, want = port.stats_summary()["scan"], ref.stats_summary()["scan"]
    assert [got[k] for k in ("count", "pages", "rows")] == [want[k] for k in ("count", "pages", "rows")]


def test_open_scan_stays_pinned_across_writes_and_flush():
    rng, base, ref, port = _service_pair(capacity=4096)
    lo, hi = float(base[200]), float(base[2500])
    its = [s.scan(lo, hi, 37) for s in (ref, port)]
    want = ref_scan.scan_pages(ref._pin(), lo, hi, 37)
    firsts = [[p for _, p in zip(range(3), it)] for it in its]
    fresh = rng.uniform(lo, hi, 500)
    for s in (ref, port):
        s.insert(fresh, np.arange(500))
        s.delete(base[300:2000:3])
    rest0 = [[p for _, p in zip(range(4), it)] for it in its]
    for s in (ref, port):
        s.flush()
    assert port.version == ref.version == 1
    got = [f + r + list(it) for f, r, it in zip(firsts, rest0, its)]
    _assert_same(_pages(got[1]), _pages(got[0]))
    _assert_same(_pages(got[1]), _pages(want))
    _same_scans(ref, port, lo, hi, 160)   # a fresh scan sees the writes


def _scan_counters(svc):
    return svc.metrics.counter("plane.scan.hit").value, svc.metrics.counter("plane.scan.miss").value


@pytest.mark.parametrize("strategy", ["cuda_fused", "binary"])
def test_warm_scan_batch_is_one_dispatch(strategy):
    # the ledger is process-wide: start it empty so the rows below are
    # this test's scans, whatever ran earlier in the worker
    ops.reset_dispatch_stats()
    base = np.arange(2, 4002, dtype=np.float64) * 1024.0
    vals = np.arange(base.size, dtype=np.int64)
    port = IndexService(base, ServiceConfig(delta_capacity=512, strategy=strategy),
                        vals=vals, device="cpu")
    ref = RefService(base, RefConfig(delta_capacity=512, strategy="xla_fused"), vals=vals)
    lo, hi = float(base[10]), float(base[-10])

    def step(fn):
        for s in (ref, port):
            fn(s)
        assert _scan_counters(port) == _scan_counters(ref)

    step(lambda s: s.insert(np.arange(3, 300, 7, dtype=np.float64) * 1024.0 + 512.0))
    step(lambda s: s.delete(base[::11]))
    step(lambda s: s.scan_batch(lo, hi, 128))            # cold: one miss
    with ops.count_dispatches() as n:
        step(lambda s: s.scan_batch(lo, hi, 128))        # warm: a hit
        assert n() == 1
    assert _scan_counters(port) == (1, 1)
    step(lambda s: s.insert(np.array([5.0 * 1024.0 + 512.0])))
    with ops.count_dispatches() as n:
        step(lambda s: s.scan_batch(lo, hi, 128))        # a write re-packs
        assert n() == 1
    step(lambda s: s.flush())
    step(lambda s: s.scan_batch(lo, hi, 16))             # a swap re-packs
    step(lambda s: s.scan_batch(lo, hi, 160))
    assert _scan_counters(port) == (2, 3)
    rows = [r for r in ops.dispatch_summary()["rows"]
            if r["op"] == "rmi_scan_range" and r["strategy"] == strategy]
    assert rows and all(r["path"] == "plain" for r in rows)


def test_scan_page_fn_matches_scan_batch_rows():
    """`IndexSnapshot.scan_page_fn` over `device_scan_plan` at the ranks
    of a range gives `scan_batch`'s rows, under either strategy."""
    rng, base, ref, port = _service_pair(capacity=4096)
    port.insert(rng.uniform(base[0], base[-1], 300), np.arange(300) + 7)
    port.delete(base[::9])
    lo, hi = float(base[100]), float(base[2700])
    keys, vals, live = port.scan_batch(lo, hi, 64)
    view, snap = port._pin(), port._mgr.current()
    ins, _, _, lp = port_scan.device_scan_slab(view, snap.keys.norm, snap.keys.normalize)
    r0, r1 = _endpoint_ranks(snap.keys.normalize(np.array([lo, hi])), snap.keys.norm, lp, ins)
    assert int(live.sum()) == r1 - r0
    plan = port_scan.device_scan_plan(view, snap.keys.normalize)
    starts = r0 + 64 * np.arange(live.shape[0], dtype=np.int32)
    for strategy in ("cuda_fused", "binary"):
        pk, pv, pl = snap.scan_page_fn(strategy, 64)(starts, *plan, r1)
        assert torch.equal(pl, live) and torch.equal(pk, keys) and torch.equal(pv, vals)


def test_stats_summary_and_instrumentation():
    _, base, _, port = _service_pair()
    list(port.scan(float(base[3]), float(base[500]), 100))
    port.scan_batch(float(base[3]), float(base[500]), 100)
    summary = port.stats_summary()
    assert summary["scan"]["count"] == 1 and summary["scan"]["rows"] == 497
    assert summary["scan"]["pages"] == 5 and summary["scan_batch"]["count"] == 1
    for op in ("scan", "scan_batch", "scan_page"):
        assert port.metrics.histogram(f"op.{op}.latency_s").count >= 1
    with pytest.raises(ValueError):
        next(iter(port.scan(0.0, 1.0, 0)))


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES + ["tile_crossing", "dense_tombstones"])
def test_cuda_scan_kernels_match_plain_twins_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda")
    if case in CASES:
        base, bvals, slab, plan, pv = _kernel_case(case)
        bounds, starts = _bounds(base, pv)
        bounds, live = list(bounds.values()), pv.live_count
    else:
        base, bvals, slab, plan, live, bounds, starts = _dense_card_case(case)
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)  # noqa: E731
    rng_args = [t(a) for a in (base, bvals, slab[3], slab[0], slab[1], slab[2])]
    page_args = [t(a) for a in (base, bvals, *plan, np.array([live], np.int32))]
    for page_size in PAGE_SIZES:
        pages = MAX_PAGES if case in CASES else -(-live // page_size) + 2
        for b in bounds:
            kw = dict(page_size=page_size, max_pages=pages)
            got = rmi_scan.rmi_scan_range_cuda(t(np.asarray(b, np.float32)), *rng_args, **kw)
            want = port_ref.rmi_scan_range_reference(t(np.asarray(b, np.float32)), *rng_args, **kw)
            assert all(torch.equal(x, y) for x, y in zip(got, want))
        got = rmi_scan.rmi_scan_page_cuda(t(starts), *page_args, page_size=page_size)
        want = port_ref.rmi_scan_page_reference(t(starts), *page_args, page_size=page_size)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("page_size", PAGE_SIZES)
def test_cuda_page_kernel_reaches_every_path_on_card(page_size):
    """The page kernel's tiles on the dense card case: pages inside the
    tombstone run and the insert cluster (spans longer than their
    buffers), pages past the live count under an end rank past it, a
    page across the int32 wrap under end rank INT32_MAX, one page
    (G = 1), against the plain twin bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda")
    base, bvals, _, plan, live, _, starts = _dense_card_case("dense_tombstones")
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)  # noqa: E731
    args = [t(a) for a in (base, bvals, *plan)]
    run = page_size * np.arange(-(-live // page_size) + 2)
    cases = [(np.concatenate([starts, run]), live), (live - 5 + run[:40], live + 3000),
             ([2**31 - 100, -page_size // 2], 2**31 - 1), (run[len(run) // 3:][:1], live)]
    for st, end in cases:
        st, end = t(np.asarray(st).astype(np.int32)), t(np.array([end], np.int32))
        got = rmi_scan.rmi_scan_page_cuda(st, *args, end, page_size=page_size)
        want = port_ref.rmi_scan_page_reference(st, *args, end, page_size=page_size)
        assert all(torch.equal(x, y) for x, y in zip(got, want)), (page_size, int(end))
    torch.cuda.synchronize()
