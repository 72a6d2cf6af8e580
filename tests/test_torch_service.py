"""The port's writable index service against the reference service: one
seeded op stream through both, equal answers throughout (across several
compactions), snapshot files that load in either package with equal
ranks, and one dispatch per hot read."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.rmi import RMIConfig as RefRMIConfig  # noqa: E402
from repro.index_service import IndexService as RefService  # noqa: E402
from repro.index_service import ServiceConfig as RefConfig  # noqa: E402
from repro.index_service.snapshot import IndexSnapshot as RefSnapshot  # noqa: E402
from repro.index_service.snapshot import build_snapshot as ref_build_snapshot  # noqa: E402

from repro_torch import convert, faults  # noqa: E402
from repro_torch.data import gen_maps  # noqa: E402
from repro_torch.index_service import (  # noqa: E402
    REFERENCE_STRATEGY,
    IndexService,
    IndexSnapshot,
    ServiceConfig,
)
from repro_torch.index_service.delta import combine_for_device  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

N = 5_000


def _pair(strategy="cuda_fused", capacity=256, vals=None):
    base = gen_maps(N, seed=11)
    ref = RefService(base, RefConfig(strategy=REFERENCE_STRATEGY[strategy],
                                     delta_capacity=capacity), vals=vals)
    port = IndexService(base, ServiceConfig(strategy=strategy, delta_capacity=capacity),
                        vals=vals, device="cpu")
    return base, ref, port


def _assert_same_reads(ref, port, q, lo, hi):
    rr, rl = ref.get(q)
    pr, pl = port.get(q)
    assert np.array_equal(pr, rr) and np.array_equal(pl, rl)
    assert np.array_equal(port.contains(q), ref.contains(q))
    assert port.range_lookup(lo, hi) == ref.range_lookup(lo, hi)
    assert np.array_equal(port.lookup_batch(q).numpy(), np.asarray(ref.lookup_batch(q)))


@pytest.mark.parametrize("strategy", [
    "cuda_fused",
    pytest.param("torch_fused", marks=pytest.mark.slow),
    pytest.param("binary", marks=pytest.mark.slow),
])
def test_op_stream_matches_reference(strategy):
    base, ref, port = _pair(strategy)
    rng = np.random.default_rng(3)
    live = set(base.tolist())
    for step in range(160):
        kind = rng.integers(0, 4)
        if kind == 0:
            ins = np.concatenate([rng.uniform(-180, 180, 8),
                                  rng.choice(base, 2)])
            assert port.insert(ins) == ref.insert(ins)
            live |= set(ins.tolist())
        elif kind == 1:
            dels = np.concatenate([rng.choice(np.array(sorted(live)), 8),
                                   rng.uniform(-180, 180, 2)])
            assert port.delete(dels) == ref.delete(dels)
            live -= set(dels.tolist())
        else:
            q = np.concatenate([rng.choice(np.array(sorted(live)), 40),
                                rng.choice(base, 20), rng.uniform(-181, 181, 40)])
            lo, hi = rng.uniform(-181, 181, 2)
            _assert_same_reads(ref, port, q, lo, hi)
    arr = np.array(sorted(live))
    assert port.num_keys == ref.num_keys == arr.size
    rank, present = port.get(arr)
    assert np.array_equal(rank, np.arange(arr.size)) and present.all()
    assert port.stats["compactions"] == ref.stats["compactions"] >= 2
    assert port.version == ref.version


def test_flush_and_compacted_arrays_match_reference():
    base, ref, port = _pair(capacity=512)
    rng = np.random.default_rng(4)
    for svc in (ref, port):
        svc.insert(np.random.default_rng(5).uniform(-180, 180, 150))
        svc.delete(base[::37])
        svc.flush()
    r, p = ref._mgr.current(), port._mgr.current()
    assert p.version == r.version == 1
    for k in ("leaf_w", "leaf_b", "err_lo", "err_hi", "seg_lo", "seg_hi"):
        assert np.array_equal(getattr(p.index, k), getattr(r.index, k)), k
    assert port.stats["leaves_refit"] == ref.stats["leaves_refit"]
    q = rng.uniform(-181, 181, 300)
    _assert_same_reads(ref, port, q, -10.0, 10.0)


def _npz_arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("hidden", [(), (16,)])
def test_snapshot_files_load_both_ways(hidden, tmp_path):
    """A snapshot written by either package loads in the other, array for
    array.  With the linear stage-0 the merged ranks are equal on every
    query.  With an MLP stage-0 the reference sums its hidden layer in
    XLA's dot order and the port in ascending order, so only the
    contract is held: stored keys and the exact refined ranks."""
    raw = gen_maps(3_000, seed=12)
    vals = np.arange(raw.size, dtype=np.int64) * 3
    rsnap, _ = ref_build_snapshot(raw, vals=vals, config=RefRMIConfig(
        num_leaves=64, stage0_hidden=hidden, stage0_train_steps=40 if hidden else 0))
    psnap = convert.snapshot_from_reference(rsnap, device="cpu")
    rpath = rsnap.save(str(tmp_path / "ref"))
    ppath = psnap.save(str(tmp_path / "port"))
    a, b = _npz_arrays(rpath), _npz_arrays(ppath)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k], equal_nan=True), k

    rng = np.random.default_rng(1)
    stored = raw[rng.choice(raw.size, 300)]
    q = np.concatenate([stored, rng.uniform(-180, 180, 300)])
    loaded_port = IndexSnapshot.load(rpath, device="cpu")
    loaded_ref = RefSnapshot.load(ppath)
    for ps, rs in ((loaded_port, rsnap), (psnap, loaded_ref)):
        qn = ps.keys.normalize(q)
        dk, dp = combine_for_device(None, None, ps.keys.normalize)
        pb, pm = ps.merged_lookup_fn("cuda_fused")(
            torch.as_tensor(qn), torch.as_tensor(dk), torch.as_tensor(dp))
        rb, rm = rs.merged_lookup_fn("pallas_fused")(qn, dk, dp)
        pm, rm = pm.numpy(), np.asarray(rm)
        if not hidden:
            assert np.array_equal(pm, rm)
        want = np.searchsorted(ps.keys.norm, qn[:stored.size])
        assert np.array_equal(pm[:stored.size], want)
        assert np.array_equal(rm[:stored.size], want)
        assert np.array_equal(ps.refine_base_rank(q, pb.numpy())[0],
                              rs.refine_base_rank(q, np.asarray(rb))[0])
        assert np.array_equal(ps.vals, vals)


def test_service_restart_from_reference_files(tmp_path):
    base, ref, _ = _pair()
    ref.insert(np.array([0.123456, 1.5]))
    ref.save(str(tmp_path))
    port = IndexService.load(str(tmp_path), device="cpu")
    q = np.concatenate([base[::50], [0.123456, 1.5, 200.0]])
    assert np.array_equal(port.get(q)[0], ref.get(q)[0])


@pytest.mark.parametrize("strategy", ["cuda_fused", "cuda", "binary"])
def test_hot_reads_are_one_dispatch(strategy):
    # the ledger is process-wide: start it empty so the rows below are
    # this test's reads, whatever ran earlier in the worker
    ops.reset_dispatch_stats()
    base, _, port = _pair(strategy)
    port.insert(np.array([1.25, 2.5]))
    port.delete(base[:3])
    q = base[::40]
    for read in (lambda: port.lookup_batch(q), lambda: port.get(q),
                 lambda: port.contains(q), lambda: port.range_lookup(-5.0, 5.0)):
        read()
        with ops.count_dispatches() as n:
            read()
            assert n() == 1
    rows = [r for r in ops.dispatch_summary()["rows"] if r["strategy"] == strategy]
    assert rows and all(r["path"] == "plain" for r in rows)


def test_compaction_supervisor_restarts_after_a_crash():
    base, _, port = _pair()
    port.insert(np.array([3.5, 4.5]))
    with faults.inject(faults.FaultSchedule({"compactor.crash": 1})):
        port.flush()
    assert port.metrics.counter("compact.worker_restarts").value == 1
    assert port.version == 1 and not port.compactor_escalated
    assert port.get(np.array([3.5]))[1].all()


def test_background_compaction_and_execute():
    base = gen_maps(N, seed=11)
    port = IndexService(base, ServiceConfig(strategy="cuda_fused", delta_capacity=64,
                                            background=True), device="cpu")
    fresh = np.random.default_rng(9).uniform(-180, 180, 300)
    for chunk in np.array_split(fresh, 10):
        port.insert(chunk)
    port.flush()
    out = port.execute([("get", fresh[:5]), ("contains", fresh[:5]),
                        ("range", -1.0, 1.0), ("delete", fresh[:5])])
    assert out[1].all() and out[3] == 5
    assert port.num_keys == base.size + fresh.size - 5
    with pytest.raises(ValueError):
        port.execute([("bogus", 1)])
