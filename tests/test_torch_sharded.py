"""The port's sharded service against the reference's: the learned
router (routes, boundaries, weights, ``router.npz`` both ways), the
stacked shard layout, both sharded kernels' plain twins against the
reference's XLA fallbacks and interpret-mode Pallas kernels, the
snapshot-level `sharded_fused` strategy, and one op stream through both
`ShardedIndexService`s — all exact.  Also: K = 1 equals the unsharded
port service, one dispatch per warm read, save/load both ways, the
position clamp above 2**24, and uploads that never alias the host
mirrors.  The `cuda`-marked tests hold both kernels against their twins
on the card."""

import dataclasses
import functools
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import RMIConfig as RefRMIConfig  # noqa: E402
from repro.core import build_rmi as ref_build_rmi  # noqa: E402
from repro.core import make_keyset as ref_make_keyset  # noqa: E402
from repro.index_service import ServiceConfig as RefConfig  # noqa: E402
from repro.index_service import ShardedIndexService as RefSharded  # noqa: E402
from repro.index_service.delta import DeltaBuffer as RefDelta  # noqa: E402
from repro.index_service.delta import combine_for_device as ref_combine  # noqa: E402
from repro.index_service.router import LearnedRouter as RefRouter  # noqa: E402
from repro.index_service.snapshot import build_snapshot as ref_build_snapshot  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.rmi_lookup import (  # noqa: E402
    rmi_sharded_merged_lookup_pallas,
    rmi_sharded_scan_page_pallas,
)

from repro_torch import convert  # noqa: E402
from repro_torch.data import gen_maps  # noqa: E402
from repro_torch.index_service import (  # noqa: E402
    IndexService,
    LearnedRouter,
    ServiceConfig,
    ShardedIndexService,
)
from repro_torch.index_service.delta import DeltaBuffer  # noqa: E402
from repro_torch.index_service.scan import pin_view, stack_scan_slabs  # noqa: E402
from repro_torch.core import search as search_lib  # noqa: E402
from repro_torch.core.models import stage0_apply  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rmi_lookup, rmi_scan  # noqa: E402

SIZES = (900, 2_500, 1_400, 700, 1_100, 600, 1_300, 800)   # heterogeneous shards
LEAVES = (16, 61, 24, 9, 30, 12, 40, 20)                   # and leaf counts


# --------------------------------------------------------------------------
# router
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3, 8])
def test_router_matches_reference_and_files_load_both_ways(k, tmp_path):
    raw = np.unique(gen_maps(5_000, seed=k))
    port, refr = LearnedRouter.from_keys(raw, k), RefRouter.from_keys(raw, k)
    assert np.array_equal(port.boundaries, refr.boundaries)
    assert (port.weight, port.bias) == (refr.weight, refr.bias)
    q = np.concatenate([raw, np.random.default_rng(k).uniform(-200, 200, 3000),
                        port.boundaries, [-np.inf, np.inf]])
    assert np.array_equal(port.route(q), refr.route(q))
    assert port.stats == refr.stats and port.model_hit_rate == refr.model_hit_rate
    assert np.array_equal(port.split_points(raw), refr.split_points(raw))
    sample = raw[::7]
    fitted = LearnedRouter.fit(port.boundaries, sample)
    ref_fit = RefRouter.fit(refr.boundaries, sample)
    assert (fitted.weight, fitted.bias) == (ref_fit.weight, ref_fit.bias)
    # router.npz written by either package loads in the other
    a = LearnedRouter.load(refr.save(str(tmp_path / "ref.npz")))
    b = RefRouter.load(port.save(str(tmp_path / "port.npz")))
    for r in (a, b, convert.router_from_reference(refr)):
        assert np.array_equal(r.boundaries, refr.boundaries)
        assert (r.weight, r.bias) == (refr.weight, refr.bias)
        assert np.array_equal(r.route(q), refr.route(q))


# --------------------------------------------------------------------------
# the stacked layout and both kernels' plain twins
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _shards(num, dist):
    """``num`` reference-built shard indexes over contiguous, unequal
    slices of one key set, each in its own KeySet frame."""
    rng = np.random.default_rng(zlib.crc32(f"{dist}{num}".encode()))
    if dist == "maps":
        raw = np.unique(gen_maps(sum(SIZES[:num]) + 200, seed=num))
    else:  # runs of 64 keys that collide in float32
        runs = np.sort(rng.uniform(0.0, 1e12, 120))
        raw = np.unique(np.repeat(runs, 64) + np.tile(np.arange(64), 120) * 1e-4)
    cuts = np.concatenate([[0], np.cumsum(SIZES[:num])]) * raw.size // sum(SIZES[:num])
    out = []
    for s in range(num):
        ks = ref_make_keyset(raw[cuts[s]:cuts[s + 1]])
        idx = ref_build_rmi(ks, RefRMIConfig(num_leaves=LEAVES[s], stage0_hidden=(),
                                             stage0_train_steps=0))
        out.append((ks, idx))
    return raw, out


def _deltas(shards, kind, rng):
    """Per-shard (dk, dp) rows stacked like the service's device plan."""
    rows = []
    for s, (ks, _) in enumerate(shards):
        buf = None
        if kind == "staged":
            buf = RefDelta(capacity=1024)
            for k in np.setdiff1d(rng.uniform(ks.raw[0], ks.raw[-1], 90), ks.raw):
                buf.stage_insert(float(k), live_below=False)
            for k in rng.choice(ks.raw, 40, replace=False):
                buf.stage_delete(float(k), live_below=True)
        elif kind == "pow2" and s == 0:  # exactly 64 staged: no +inf pad
            ins = np.setdiff1d(rng.uniform(ks.raw[0], ks.raw[-1], 100), ks.raw)[:64]
            buf = RefDelta.from_arrays(ins, np.zeros(64, np.int64), np.empty(0), 64)
        rows.append(ref_combine(None, buf, ks.normalize))
    d = max(dk.size for dk, _ in rows)
    dks = np.full((len(rows), d), np.inf, np.float32)
    dps = np.zeros((len(rows), d + 1), np.int32)
    for s, (dk, dp) in enumerate(rows):
        dks[s, : dk.size] = dk
        dps[s, : dp.size] = dp
        dps[s, dp.size:] = dp[-1]
    return dks, dps


def _raw_queries(raw, rng, b):
    stored = rng.choice(raw, b // 2)
    absent = rng.uniform(raw[0], raw[-1], b // 2 - 8)
    edges = np.array([raw[0] - 1e3, raw[0] - 1e-9, raw[-1] + 1e-9, raw[-1] + 1e3,
                      -1e300, 1e300, raw[0], raw[-1]])
    return np.concatenate([stored, absent, edges])


@pytest.mark.parametrize("num", [1, 3])
def test_stacked_layout_matches_reference(num):
    _, shards = _shards(num, "maps")
    ref_idx = [idx for _, idx in shards]
    keys = [ks.norm for ks, _ in shards]
    port_idx = [convert.index_from_reference(i) for i in ref_idx]
    got = ops.stack_shard_arrays(port_idx, keys, "cpu")
    want = ref_ops.stack_shard_arrays(ref_idx, keys)
    for k in ("leaf_w", "leaf_b", "err_lo", "err_hi", "keys", "shard_n", "shard_m",
              "shard_ratio"):
        assert got[k].dtype == {np.dtype(np.float32): torch.float32,
                                np.dtype(np.int32): torch.int32}[np.asarray(want[k]).dtype]
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    flat = np.concatenate([np.asarray(p).reshape(num, -1) for p in want["stage0"]], axis=1)
    assert np.array_equal(got["stage0"].numpy(), flat)
    assert got["hidden"] == tuple(want["hidden"]) and got["max_window"] == want["max_window"]
    for ix, pix, k in zip(ref_idx, port_idx, keys):
        row = ops.pad_shard_row(pix, k, 3_000, 80)
        rrow = ref_ops.pad_shard_row(ix, k, 3_000, 80)
        for f in ("leaf_w", "leaf_b", "err_lo", "err_hi", "keys", "n", "m", "ratio"):
            assert np.asarray(row[f]).dtype == np.asarray(rrow[f]).dtype, f
            assert np.array_equal(row[f], rrow[f]), f
        assert np.array_equal(row["stage0"], np.concatenate(
            [np.asarray(p).reshape(-1) for p in rrow["stage0"]]))
        assert row["max_window"] == rrow["max_window"] and row["hidden"] == rrow["hidden"]


def _record_of(cols):
    """The (S, M, 4) record whose columns ``cols`` are, or None."""
    w = cols[0]
    if not (all(c.untyped_storage().data_ptr() == w.untyped_storage().data_ptr()
                for c in cols)
            and [c.data_ptr() - w.data_ptr() for c in cols] == [0, 4, 8, 12]
            and all(c.stride() == w.stride() for c in cols) and w.stride(1) == 4):
        return None
    return torch.as_strided(w, (w.shape[0], w.shape[1], 4), (w.stride(0), 4, 1))


@pytest.mark.parametrize("num", [1, 3, 5, 8])
def test_stacked_leaf_tensors_are_views_of_one_record(num):
    """`stack_rows` (through `stack_shard_arrays`, and through the sharded
    service's plan) hands out the four leaf tensors as the columns of one
    (S, M, 4) record, whose values stay the reference's stacked arrays;
    the kernel's wrapper reads it in place and packs separate arrays
    afresh, and `_row_stride` takes a record column where it asks for
    one and nothing else."""
    _, shards = _shards(num, "maps")
    ref_idx = [idx for _, idx in shards]
    keys = [ks.norm for ks, _ in shards]
    got = ops.stack_shard_arrays([convert.index_from_reference(i) for i in ref_idx], keys,
                                 "cpu")
    want = ref_ops.stack_shard_arrays(ref_idx, keys)
    cols = [got[k] for k in ("leaf_w", "leaf_b", "err_lo", "err_hi")]
    record = _record_of(cols)
    assert record is not None and record.shape == (num, cols[0].shape[1], 4)
    assert record.is_contiguous()
    for j, k in enumerate(("leaf_w", "leaf_b", "err_lo", "err_hi")):
        assert np.array_equal(record[:, :, j].numpy(), np.asarray(want[k])), k
    rec, stride = rmi_lookup._stacked_leaf_record(*cols)
    assert rec is cols[0] and stride == cols[0].shape[1]
    separate = [c.contiguous() for c in cols]
    rec, stride = rmi_lookup._stacked_leaf_record(*separate)
    assert torch.equal(rec, record) and stride == cols[0].shape[1]
    dev = torch.device("cpu")
    m = cols[0].shape[1]
    assert rmi_lookup._row_stride(cols[1], "leaf_b", torch.float32, dev, num,
                                  elem_stride=4) == 4 * m
    assert rmi_lookup._row_stride(separate[1], "leaf_b", torch.float32, dev, num,
                                  elem_stride=4) == m
    with pytest.raises(ValueError, match="contiguous rows"):
        rmi_lookup._row_stride(cols[0], "sorted_keys", torch.float32, dev, num)
    with pytest.raises(ValueError, match="record"):
        rmi_lookup._row_stride(torch.stack([separate[0]] * 2, dim=2)[:, :, 0], "leaf_w",
                               torch.float32, dev, num, elem_stride=4)
    # the sharded service's plan holds the same record
    base, _, port = _pair(num)
    port.lookup_batch(base[:8])
    plan = port._plan
    assert _record_of([plan.leaf_w, plan.leaf_b, plan.err_lo, plan.err_hi]) is not None


def _lookup_case(num, dist, delta, seed, b=400):
    raw, shards = _shards(num, dist)
    rng = np.random.default_rng(seed)
    ref_idx = [idx for _, idx in shards]
    keys = [ks.norm for ks, _ in shards]
    st = ref_ops.stack_shard_arrays(ref_idx, keys)
    dks, dps = _deltas(shards, delta, rng)
    qraw = _raw_queries(raw, rng, b)
    qs = np.stack([ks.normalize(qraw) for ks, _ in shards]).astype(np.float32)
    port = ops.stack_shard_arrays([convert.index_from_reference(i) for i in ref_idx],
                                  keys, "cpu")
    return raw, shards, st, port, qs, dks, dps


def _lookup_args(port, qs, dks, dps):
    t = torch.as_tensor
    return [t(qs), port["stage0"], port["leaf_w"], port["leaf_b"], port["err_lo"],
            port["err_hi"], port["keys"], t(dks), t(dps), port["shard_n"], port["shard_m"],
            port["shard_ratio"]]


def _port_lookup(port, qs, dks, dps):
    return ref.rmi_sharded_merged_lookup_reference(
        *_lookup_args(port, qs, dks, dps), hidden=port["hidden"],
        max_window=port["max_window"])


def _nan_position(args, hidden):
    """(S, B) lanes whose leaf product is 0 * inf = NaN for a query that
    is not NaN: an infinite query on a leaf of slope 0 (queue C 17,
    where the reference takes a wrong window and the port does not)."""
    q, s0, leaf_w, leaf_b = args[:4]
    out = []
    for s in range(q.shape[0]):
        p0 = stage0_apply(s0[s], hidden, q[s])
        leaf = torch.clamp(search_lib.to_index(torch.floor(p0 * args[11][s])),
                           max=int(args[10][s]) - 1).long()
        out.append(torch.isnan(leaf_w[s][leaf] * q[s] + leaf_b[s][leaf]) & ~torch.isnan(q[s]))
    return torch.stack(out).numpy()


@pytest.mark.parametrize("num,dist,delta", [
    (1, "maps", "empty"), (3, "maps", "staged"), (3, "dup", "pow2"),
    pytest.param(3, "maps", "empty", marks=pytest.mark.slow),
    pytest.param(3, "dup", "staged", marks=pytest.mark.slow),
    pytest.param(1, "dup", "pow2", marks=pytest.mark.slow),
])
def test_sharded_lookup_twin_matches_reference(num, dist, delta):
    raw, shards, st, port, qs, dks, dps = _lookup_case(num, dist, delta, num)
    lb, ct = _port_lookup(port, qs, dks, dps)
    jargs = (jnp.asarray(qs), st["stage0"], st["leaf_w"], st["leaf_b"], st["err_lo"],
             st["err_hi"], st["keys"], jnp.asarray(dks), jnp.asarray(dps),
             st["shard_n"], st["shard_m"], st["shard_ratio"])
    xb, xc = jax_ref.rmi_sharded_merged_lookup_reference(*jargs, max_window=st["max_window"])
    kb, kc = rmi_sharded_merged_lookup_pallas(
        *jargs, hidden=st["hidden"], max_window=st["max_window"], interpret=True)
    # C17: an infinite query on a flat leaf (keys of one float32 value:
    # every duplicate-heavy case, some Maps shards) takes a wrong window
    # in the reference; the port's rank there is the oracle's, below
    flat = _nan_position(_lookup_args(port, qs, dks, dps), port["hidden"])
    assert flat.any() or dist != "dup"
    assert np.array_equal(lb.numpy()[~flat], np.asarray(xb)[~flat])
    assert np.array_equal(lb.numpy()[~flat], np.asarray(kb)[~flat])
    # a query above every key of a row that nothing pads walks the delta
    # search to D + 1: the port clamps the prefix gather, the reference's
    # fallback and kernel read past the row (ROADMAP queue C)
    past = np.isfinite(dks[:, -1:]) & (qs > dks[:, -1:])
    assert past.any() == (delta == "pow2")
    for got in (np.asarray(xc), np.asarray(kc)):
        assert np.array_equal(ct.numpy()[~past], got[~past])
        assert (got[past] == np.iinfo(np.int32).min).all()
    # stored keys and the C17 lanes: each shard's own float32 lower
    # bound; and delta contributions
    for s, (ks, _) in enumerate(shards):
        stored = np.isin(qs[s], ks.norm) | flat[s]
        want = np.searchsorted(ks.norm, qs[s])
        assert np.array_equal(lb.numpy()[s][stored], want[stored])
        assert np.array_equal(ct.numpy()[s], dps[s][np.searchsorted(dks[s], qs[s])])


def test_sharded_lookup_twin_reads_broadcast_rows():
    """Stride-0 rows (a query or delta row broadcast with `expand`) give
    the answers of the materialized rows."""
    raw, shards, st, port, qs, dks, dps = _lookup_case(3, "maps", "staged", 5)
    dense = _port_lookup(port, np.broadcast_to(qs[1], qs.shape).copy(),
                         np.broadcast_to(dks[0], dks.shape).copy(),
                         np.broadcast_to(dps[0], dps.shape).copy())
    views = _port_lookup(port, torch.as_tensor(qs[1]).expand(3, -1),
                         torch.as_tensor(dks[0]).expand(3, -1),
                         torch.as_tensor(dps[0]).expand(3, -1))
    assert views[0].shape == (3, qs.shape[1])
    assert torch.equal(dense[0], views[0]) and torch.equal(dense[1], views[1])


def test_sharded_lookup_op_reassembles_global_ranks():
    raw, shards, st, port, qs, dks, dps = _lookup_case(3, "maps", "staged", 7)
    n = np.array([ks.n for ks, _ in shards])
    off = np.concatenate([[0], np.cumsum(n)[:-1]]).astype(np.int32)
    live = n + dps[:, -1]
    moff = np.concatenate([[0], np.cumsum(live)[:-1]]).astype(np.int32)
    route = np.random.default_rng(0).integers(0, 3, qs.shape[1]).astype(np.int32)
    t = torch.as_tensor
    args = (t(qs), port["stage0"], port["leaf_w"], port["leaf_b"], port["err_lo"],
            port["err_hi"], port["keys"], t(dks), t(dps), port["shard_n"],
            port["shard_m"], port["shard_ratio"])
    kw = dict(hidden=port["hidden"], max_window=port["max_window"])
    with ops.count_dispatches() as nd:
        gb, gm = ops.rmi_sharded_routed_lookup_op(args[0], t(route), *args[1:], t(off),
                                                  t(moff), **kw)
        assert nd() == 1
    lb, ct = ref.rmi_sharded_merged_lookup_reference(*args, **kw)
    wb, wm = ref_ops.sharded_reassemble(*(jnp.asarray(a) for a in (
        lb.numpy(), ct.numpy(), route, off, moff)))
    assert np.array_equal(gb.numpy(), np.asarray(wb)) and np.array_equal(gm.numpy(), np.asarray(wm))
    assert gb.dtype == gm.dtype == torch.int32


@functools.lru_cache(maxsize=None)
def _scan_slabs(num):
    """Port-packed stacked scan slabs (`stack_scan_slabs`) over ``num``
    shards with staged inserts (values) and tombstones."""
    raw, shards = _shards(num, "maps")
    rng = np.random.default_rng(num + 40)
    views = []
    for ks, _ in shards:
        ins = np.setdiff1d(rng.uniform(ks.raw[0], ks.raw[-1], 120), ks.raw)
        dels = np.sort(rng.choice(ks.raw, 50, replace=False))
        buf = DeltaBuffer.from_arrays(ins, rng.integers(1, 1 << 30, ins.size), dels,
                                      ins.size + dels.size + 1)
        snap = type("S", (), {"keys": ks, "vals": rng.integers(-1000, 1000, ks.n)})
        views.append(pin_view(snap, None, buf))
    return stack_scan_slabs(views)


def _scan_bounds(p):
    lo, hi = p["base"][0, 10], p["base"][-1, 50]
    return [(lo, hi), (hi, lo), (np.nan, hi), (lo, np.nan), (-np.inf, np.inf),
            (-2.0, -1.0), (1.5, 3.0), (p["base"][0, 3], p["base"][0, 4])]


@pytest.mark.parametrize("num,page_size", [
    (1, 256), (3, 160),
    pytest.param(3, 1, marks=pytest.mark.slow),
    pytest.param(3, 256, marks=pytest.mark.slow),
])
def test_sharded_scan_twin_matches_reference(num, page_size):
    p = _scan_slabs(num)
    slabs = [p[k] for k in ("base", "bvals", "live_prefix", "ins", "ivals", "ins_rank")]
    t = torch.as_tensor
    for lo, hi in _scan_bounds(p):
        bounds = np.array([lo, hi], np.float32)
        pages = 40 if page_size == 1 else 6
        got = ops.rmi_sharded_scan_page_op(t(bounds), *(t(a) for a in slabs),
                                           page_size=page_size, max_pages=pages)
        want = ref_ops.rmi_sharded_scan_page_op(bounds, *slabs, page_size=page_size,
                                                max_pages=pages, use_kernel=False)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w)), (lo, hi)
    # the raw (S, G, P) twin against the reference's fallback and kernel,
    # owners including an int32-wrapping local rank
    ls0 = np.array([0, 2**31 - 5, 7][:num], np.int32)
    own_lo = np.array([0, 300, 600][:num], np.int32)
    own_hi = np.array([300, 600, 2**31 - 1][:num], np.int32)
    args = (*slabs, ls0, own_lo, own_hi)
    kw = dict(page_size=page_size, max_pages=4)
    got = ref.rmi_sharded_scan_page_reference(*(t(a) for a in args), **kw)
    want = jax_ref.rmi_sharded_scan_page_reference(*(jnp.asarray(a) for a in args), **kw)
    kern = rmi_sharded_scan_page_pallas(*(jnp.asarray(a) for a in args), interpret=True, **kw)
    for g, w, k in zip(got, want, kern):
        assert np.array_equal(g.numpy(), np.asarray(w))
        assert np.array_equal(g.numpy(), np.asarray(k))


# --------------------------------------------------------------------------
# the snapshot-level sharded_fused strategy
# --------------------------------------------------------------------------

def test_snapshot_sharded_fused_plan_and_ranks_match_reference():
    raw = gen_maps(6_000, seed=21)
    rsnap, _ = ref_build_snapshot(raw)
    snap = convert.snapshot_from_reference(rsnap, device="cpu")
    plan, rplan = snap._sharded_plan(), rsnap._sharded_plan()
    assert plan["S"] == rplan["S"] == 4
    for k in ("leaf_w", "leaf_b", "err_lo", "err_hi", "keys", "shard_n", "shard_m",
              "shard_ratio", "starts", "base_off"):
        assert np.array_equal(plan[k].numpy(), np.asarray(rplan[k])), k
    flat = np.concatenate([np.asarray(a).reshape(4, -1) for a in rplan["stage0"]], axis=1)
    assert np.array_equal(plan["stage0"].numpy(), flat)
    assert plan["max_window"] == rplan["max_window"]
    rng = np.random.default_rng(3)
    ks = snap.keys
    q = np.concatenate([ks.norm[rng.choice(ks.n, 300)],
                        ks.normalize(rng.uniform(raw[0], raw[-1], 300)),
                        np.float32([-1.0, 2.0, 0.0, 1.0])]).astype(np.float32)
    delta = RefDelta(capacity=256)
    for k in np.setdiff1d(rng.uniform(raw[0], raw[-1], 100), raw):
        delta.stage_insert(float(k), live_below=False)
    for dk, dp in (ref_combine(None, None, ks.normalize), ref_combine(None, delta, ks.normalize)):
        pb, pm = snap.merged_lookup_fn("sharded_fused")(
            torch.as_tensor(q), torch.as_tensor(dk), torch.as_tensor(dp))
        rb, rm = rsnap.merged_lookup_fn("sharded_fused")(jnp.asarray(q), jnp.asarray(dk),
                                                        jnp.asarray(dp))
        assert np.array_equal(pb.numpy(), np.asarray(rb))
        assert np.array_equal(pm.numpy(), np.asarray(rm))
        cf = snap.merged_lookup_fn("cuda_fused")(
            torch.as_tensor(q), torch.as_tensor(dk), torch.as_tensor(dp))
        stored = np.isin(q, ks.norm)
        assert np.array_equal(pb.numpy()[stored], np.searchsorted(ks.norm, q[stored]))
        assert np.array_equal(pm.numpy()[stored], cf[1].numpy()[stored])
    base = snap.base_lookup_fn("sharded_fused")(torch.as_tensor(q))
    assert np.array_equal(base.numpy(), np.asarray(rsnap.base_lookup_fn("sharded_fused")(
        jnp.asarray(q))))


# --------------------------------------------------------------------------
# the service: one op stream through both packages
# --------------------------------------------------------------------------

def _pair(k, strategy="torch_fused", capacity=256, vals=None, n=6_000, seed=3):
    base = gen_maps(n, seed=seed)
    from repro_torch.index_service.snapshot import REFERENCE_STRATEGY
    cfg = dict(num_shards=k, delta_capacity=capacity)
    refs = RefSharded(base, RefConfig(strategy=REFERENCE_STRATEGY[strategy], **cfg),
                      vals=vals)
    port = ShardedIndexService(base, ServiceConfig(strategy=strategy, **cfg), vals=vals,
                               device="cpu")
    return base, refs, port


def _same_rows(got, want):
    gl, wl = got[2].numpy().ravel(), np.asarray(want[2]).ravel()
    assert gl.sum() == wl.sum()
    for g, w in zip(got[:2], want[:2]):
        assert np.array_equal(g.numpy().ravel()[gl], np.asarray(w).ravel()[wl])


def _same_reads(refs, port, q, lo, hi, page_size=16):
    for a, b in zip(port.get(q), refs.get(q)):
        assert np.array_equal(a, b)
    assert np.array_equal(port.contains(q), refs.contains(q))
    assert port.range_lookup(lo, hi) == refs.range_lookup(lo, hi)
    assert port.range_lookup(hi, lo) == refs.range_lookup(hi, lo)
    assert np.array_equal(port.lookup_batch(q).numpy(), np.asarray(refs.lookup_batch(q)))
    _same_rows(port.scan_batch(lo, hi, page_size), refs.scan_batch(lo, hi, page_size))
    assert np.array_equal(port.scan_normalize(q), refs.scan_normalize(q))
    hp = [(p.keys[p.live_mask], p.vals[p.live_mask]) for p in port.scan(lo, hi, page_size)]
    hr = [(p.keys[p.live_mask], p.vals[p.live_mask]) for p in refs.scan(lo, hi, page_size)]
    assert len(hp) == len(hr)
    for (pk, pv), (rk, rv) in zip(hp, hr):
        assert np.array_equal(pk, rk) and np.array_equal(pv, rv)


@pytest.mark.parametrize("k,strategy", [
    # torch_fused runs the same plain twins on the host as cuda_fused,
    # against the reference's XLA fallback rather than interpret-mode
    # Pallas (which takes minutes here)
    (3, "torch_fused"), (1, "torch_fused"),
    pytest.param(3, "cuda_fused", marks=pytest.mark.slow),
    pytest.param(3, "sharded_fused", marks=pytest.mark.slow),
    pytest.param(3, "binary", marks=pytest.mark.slow),
])
def test_op_stream_matches_reference(k, strategy):
    base, refs, port = _pair(k, strategy, vals=np.arange(6_000) * 3)
    rng = np.random.default_rng(k)
    live = set(base.tolist())
    for step in range(25):
        ins = np.concatenate([rng.uniform(-180, 180, 12), rng.choice(base, 2)])
        vals = rng.integers(0, 1 << 20, ins.size)
        assert port.insert(ins, vals) == refs.insert(ins, vals)
        live |= set(ins.tolist())
        dels = np.concatenate([rng.choice(np.array(sorted(live)), 9), rng.uniform(-180, 180, 2)])
        assert port.delete(dels) == refs.delete(dels)
        live -= set(dels.tolist())
        if step % 5 == 0:
            q = np.concatenate([rng.choice(np.array(sorted(live)), 30), ins[:4],
                                rng.choice(base, 10), rng.uniform(-181, 181, 30)])
            lo, hi = np.sort(rng.uniform(-181, 181, 2))
            _same_reads(refs, port, q, lo, hi)
        if step == 12:
            port.flush()
            refs.flush()
        if step == 18 and k > 1:
            port.rebalance(2)
            refs.rebalance(2)
            assert np.array_equal(port.router.boundaries, refs.router.boundaries)
    assert port.num_keys == refs.num_keys == len(live)
    arr = np.array(sorted(live))
    rank, present = port.get(arr)
    assert np.array_equal(rank, np.arange(arr.size)) and present.all()
    assert port.version == refs.version
    ps, rs = port.stats_summary(), refs.stats_summary()
    for key in ("num_shards", "live_keys", "shard_live_keys", "rebalances", "compactions",
                "insert_applied", "delete_applied"):
        assert ps[key] == rs[key], key
    ops_list = [("insert", [0.25]), ("get", [0.25, 1e9]), ("contains", [0.25]),
                ("range", -10.0, 10.0), ("delete", [0.25])]
    for a, b in zip(port.execute(ops_list), refs.execute(ops_list)):
        if isinstance(a, tuple) and isinstance(a[0], np.ndarray):
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
        else:
            assert np.array_equal(a, b)


def test_k1_equals_the_unsharded_port_service():
    base = gen_maps(5_000, seed=8)
    cfg = ServiceConfig(strategy="cuda_fused", delta_capacity=300)
    one = IndexService(base, cfg, device="cpu")
    svc = ShardedIndexService(base, dataclasses.replace(cfg, num_shards=1), device="cpu")
    rng = np.random.default_rng(8)
    for _ in range(12):
        ins = rng.uniform(-180, 180, 60)
        assert svc.insert(ins) == one.insert(ins)
        dels = rng.choice(base, 40)
        assert svc.delete(dels) == one.delete(dels)
        q = np.concatenate([rng.choice(base, 50), ins[:10], rng.uniform(-181, 181, 50)])
        for a, b in zip(svc.get(q), one.get(q)):
            assert np.array_equal(a, b)
        assert np.array_equal(svc.contains(q), one.contains(q))
        # lookup_batch: bit for bit, but above every base key, where the
        # unsharded search steps to n + 1 (queue C entry 5) and the
        # sharded kernel clamps to n, as the reference's does
        got, want = svc.lookup_batch(q).numpy(), one.lookup_batch(q).numpy()
        ks = one._mgr.current().keys
        above = ks.normalize(q) > ks.norm[-1]
        assert np.array_equal(got[~above], want[~above])
        assert np.array_equal(got[above], want[above] - 1)
        lo, hi = np.sort(rng.uniform(-181, 181, 2))
        assert svc.range_lookup(lo, hi) == one.range_lookup(lo, hi)
        got, want = svc.scan_batch(lo, hi, 32), one.scan_batch(lo, hi, 32)
        gm, wm = got[2].flatten(), want[2].flatten()
        assert int(gm.sum()) == int(wm.sum())
        assert torch.equal(got[1].flatten()[gm], want[1].flatten()[wm])
    assert svc.version == one.version >= 1


def test_one_dispatch_per_warm_read():
    _, _, port = _pair(3, "cuda_fused")
    port.insert(np.array([1.5, 2.5]))
    port.delete(port.shards[1]._mgr.current().keys.raw[:3])
    q = np.concatenate([port.shards[2]._mgr.current().keys.raw[:20], [1.5, 7.25]])
    calls = {
        "get": lambda: port.get(q), "contains": lambda: port.contains(q),
        "range_lookup": lambda: port.range_lookup(-50.0, 50.0),
        "lookup_batch": lambda: port.lookup_batch(q),
        "scan_batch": lambda: port.scan_batch(-50.0, 50.0, 64),
    }
    ops.reset_dispatch_stats()
    for name, call in calls.items():
        call()  # warm: plans packed
        with ops.count_dispatches() as nd:
            call()
            assert nd() == 1, name
    rows = {(r["op"], r["strategy"]): r["path"] for r in ops.dispatch_summary()["rows"]}
    assert rows == {("rmi_sharded_routed_lookup", "cuda_fused"): "plain",
                    ("rmi_sharded_scan_page", "cuda_fused"): "plain"}


def test_save_and_load_both_ways(tmp_path):
    base, refs, port = _pair(3, vals=np.arange(6_000))
    for svc in (refs, port):
        svc.insert(np.array([0.5, 1.5, 99.0]), np.array([7, 8, 9]))
        svc.delete(base[100:140])
    port.save(str(tmp_path / "port"))
    refs.save(str(tmp_path / "ref"))
    from_ref = ShardedIndexService.load(str(tmp_path / "ref"), device="cpu")
    from_port = RefSharded.load(str(tmp_path / "port"))
    rng = np.random.default_rng(4)
    q = np.concatenate([rng.choice(base, 200), [0.5, 1.5, 99.0], rng.uniform(-181, 181, 100)])
    for a, b in ((from_ref, refs), (port, from_port), (from_ref, from_port)):
        _same_reads(b, a, q, -30.0, 60.0)
    assert from_ref.num_shards == 3 and np.array_equal(
        from_ref.router.boundaries, refs.router.boundaries)


# --------------------------------------------------------------------------
# pinned divergences and the upload contract
# --------------------------------------------------------------------------

def test_position_clamp_above_2_24_follows_the_build():
    """The reference's sharded body clamps the position to f32(n) - 1,
    computed in float32; the port (kernel and twin) clamps to f32(n - 1),
    the build's clamp, which differs above 2**24 (ROADMAP queue C).  A
    virtual key row (one stored value broadcast to n positions) shows the
    twin's window landing there, without a 2**24-key array."""
    for n, port_clamp, ref_clamp in ((33_554_435, 33_554_432, 33_554_436),
                                     (16_777_219, 16_777_218, 16_777_220)):
        assert port_clamp <= n - 1 < ref_clamp
        assert float(np.float32(n - 1)) == port_clamp
        assert float(np.float32(n) - np.float32(1)) == ref_clamp
        one = torch.zeros((1, 1))
        f = torch.float32
        lb, _ = ref.rmi_sharded_merged_lookup_reference(
            torch.ones((1, 1)), torch.tensor([[0.0, 1e12]]),   # stage-0: pos -> clamp
            torch.zeros((1, 1)), torch.tensor([[1e12]]), one, one,
            torch.full((1, 1), 0.5).expand(1, n),              # every key 0.5 < q
            torch.full((1, 64), float("inf")), torch.zeros((1, 65), dtype=torch.int32),
            torch.tensor([n], dtype=torch.int32), torch.tensor([1], dtype=torch.int32),
            torch.tensor([1.0 / n], dtype=f), hidden=(), max_window=2)
        # window [c, c + 1] at the clamp c, first probe at c, then the
        # unpinned halving steps once more: c + 2, clamped to n (from
        # the reference's clamp the same walk ends at n)
        assert int(lb) == min(port_clamp + 2, n)


def test_uploads_never_alias_the_host_mirrors():
    """A write re-packs one shard's row of the host mirrors in place;
    the plans an earlier call took keep their tensors unchanged."""
    base, _, port = _pair(3)
    q = base[::50]
    port.lookup_batch(q)
    port.scan_batch(-100.0, 100.0, 64)
    plan, plane = port._plan, port._scan_cache
    frozen = {k: getattr(plan, k).clone() for k in ("dkeys", "dprefix", "merged_off")}
    frozen_scan = {k: getattr(plane, k).clone() for k in
                   ("base", "live_prefix", "ins", "ivals", "ins_rank")}
    fresh = np.setdiff1d(np.linspace(base[0], base[-1], 40), base)
    port.insert(fresh, np.arange(fresh.size) + 5)
    port.lookup_batch(q)
    port.scan_batch(-100.0, 100.0, 64)
    assert port._plan is not plan and port._scan_cache is not plane
    assert port._plan.dkeys_np is plan.dkeys_np       # mirrors re-packed in place
    assert not np.array_equal(port._plan.dkeys.numpy(), frozen["dkeys"].numpy())
    for k, v in frozen.items():
        assert torch.equal(getattr(plan, k), v), k
    for k, v in frozen_scan.items():
        assert torch.equal(getattr(plane, k), v), k


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("num,dist,delta", [(1, "maps", "empty"), (3, "maps", "staged"),
                                            (3, "dup", "pow2"), (5, "maps", "staged"),
                                            (8, "dup", "pow2"), (8, "maps", "empty")])
def test_sharded_lookup_kernel_matches_twin_on_card(num, dist, delta):
    """The kernel on the record views `stack_rows` hands out (read in
    place) and on four separate arrays (packed per call), at one to
    eight shard rows, with NaN and infinite queries, and on broadcast
    rows: bit for bit against the plain twin on the card and on the
    host."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda")
    raw, shards, st, port, qs, dks, dps = _lookup_case(num, dist, delta, num, b=5_000)
    qs = np.concatenate([qs, np.tile(np.array([np.nan, np.inf, -np.inf], np.float32),
                                     (num, 1))], axis=1)
    args = [torch.as_tensor(qs), port["stage0"], port["leaf_w"], port["leaf_b"],
            port["err_lo"], port["err_hi"], port["keys"], torch.as_tensor(dks),
            torch.as_tensor(dps), port["shard_n"], port["shard_m"], port["shard_ratio"]]
    kw = dict(hidden=port["hidden"], max_window=port["max_window"])
    d = [a.to(dev) for a in args]
    # .to(dev) copies each column alone; rebuild the record on the card
    rec = torch.stack(d[2:6], dim=2)
    d[2:6] = rec.unbind(2)
    assert rmi_lookup._stacked_leaf_record(*d[2:6])[0] is d[2]
    separate = [*d[:2], *(a.contiguous() for a in d[2:6]), *d[6:]]
    hb, hc = ref.rmi_sharded_merged_lookup_reference(*args, **kw)
    for a in (d, separate):
        before = rmi_lookup.LAUNCHES["rmi_sharded_merged_lookup_cuda"]
        kb, kc = rmi_lookup.rmi_sharded_merged_lookup_cuda(*a, **kw)
        assert rmi_lookup.LAUNCHES["rmi_sharded_merged_lookup_cuda"] == before + 1
        pb, pc = ref.rmi_sharded_merged_lookup_reference(*a, **kw)
        assert torch.equal(kb, pb) and torch.equal(kc, pc)
        assert torch.equal(kb.cpu(), hb) and torch.equal(kc.cpu(), hc)
    # broadcast rows read in place
    d[0] = d[0][:1].expand(num, -1)
    d[7], d[8] = d[7][:1].expand(num, -1), d[8][:1].expand(num, -1)
    kb, kc = rmi_lookup.rmi_sharded_merged_lookup_cuda(*d, **kw)
    pb, pc = ref.rmi_sharded_merged_lookup_reference(*d, **kw)
    assert torch.equal(kb, pb) and torch.equal(kc, pc)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("num,page_size", [(1, 256), (3, 160), (3, 1)])
def test_sharded_scan_kernel_matches_twin_on_card(num, page_size):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda")
    p = _scan_slabs(num)
    slabs = [torch.as_tensor(p[k], device=dev) for k in
             ("base", "bvals", "live_prefix", "ins", "ivals", "ins_rank")]
    for lo, hi in _scan_bounds(p):
        b = torch.as_tensor(np.array([lo, hi], np.float32), device=dev)
        kw = dict(page_size=page_size, max_pages=40 if page_size == 1 else 6)
        got = ops.rmi_sharded_scan_page_op(b, *slabs, **kw)
        want = ops.rmi_sharded_scan_page_op(b, *slabs, use_kernel=False, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert rmi_scan.LAUNCHES["rmi_sharded_scan_page_cuda"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("num", [1, 3])
def test_sharded_scan_kernel_wrapping_and_dead_tiles_on_card(num):
    """Raw owners whose tiles wrap int32 (inside the first tile and from
    slot 3,000 on), start just above INT32_MIN, start mid-tile, own
    nothing or hold an inverted span, at page sizes 256, 160 and 1:
    the kernel against its plain twin bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda")
    p = _scan_slabs(num)
    slabs = [torch.as_tensor(p[k], device=dev) for k in
             ("base", "bvals", "live_prefix", "ins", "ivals", "ins_rank")]
    owner_sets = (([0, 2**31 - 5, 7], [0, 300, 600], [300, 600, 2**31 - 1]),
                  ([-2**31 + 2, 2**31 - 3000, 0], [-50, 0, 901], [333, 5000, 5000]),
                  ([11, 0, 5], [333, 0, 2**31 - 1], [200, 4000, 0]))
    for page_size in (256, 160, 1):
        kw = dict(page_size=page_size, max_pages=-(-6000 // page_size))
        for owners in owner_sets:
            own = [torch.as_tensor(np.array(a[:num], np.int32), device=dev) for a in owners]
            got = rmi_scan.rmi_sharded_scan_page_cuda(*slabs, *own, **kw)
            want = ref.rmi_sharded_scan_page_reference(*slabs, *own, **kw)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), (page_size, owners)
    torch.cuda.synchronize()
