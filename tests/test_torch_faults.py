"""The port's fault plane and healing paths against the reference's
(twin of ``tests/test_faults.py``).

* Every fault point registered in `repro_torch.faults.FAULT_POINTS`
  fires at a weave site of the port.
* The kernel failover: retry once, sticky reroute, re-probe every 64th
  call, recovery; the same call outcomes through both packages'
  `run_with_failover` give the same results, counters and summaries.
* The same `FaultSchedule` of ``kernel.dispatch`` faults through both
  packages' services (`cuda_fused` on the CPU against `pallas_fused` in
  interpret mode, `sharded_fused` against `sharded_fused`, their scans)
  gives the same answers, counters and `failover_summary()`, names
  mapped by `snapshot.REFERENCE_STRATEGY`.
* Torn, crashed and corrupt checkpoints are quarantined or ignored and
  restore falls back to the newest intact step.
* The frontend's degradation ladder and its dispatch-time deadlines.
"""

import os
import random
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import faults as ref_faults  # noqa: E402
from repro.index_service import IndexService as RefService  # noqa: E402
from repro.index_service import ServiceConfig as RefConfig  # noqa: E402
from repro.index_service import ShardedIndexService as RefSharded  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.obs.metrics import default_registry as ref_registry  # noqa: E402

from repro_torch import faults  # noqa: E402
from repro_torch.distributed.fault_tolerance import (  # noqa: E402
    CheckpointCorrupt,
    CheckpointManager,
    IndexCheckpointer,
    newest_intact_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.index_service import (  # noqa: E402
    REFERENCE_STRATEGY,
    IndexService,
    ServiceConfig,
    ShardedIndexService,
)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.obs.metrics import default_registry  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    DEGRADED_WRITES,
    HEALTHY,
    STALE_READS,
    UNAVAILABLE,
    Backpressure,
    DeadlineExceeded,
    FrontendConfig,
    IndexFrontend,
    WriteShed,
    retry_with_backoff,
)

COUNTERS = ("kernel_failover", "kernel_failover.errors", "kernel_failover.recoveries")


def _keys(n=2048, seed=0):
    rng = np.random.default_rng(seed)
    return np.unique(rng.integers(0, 1 << 40, n).astype(np.float64))


def _fresh(base, n=512, seed=1):
    rng = np.random.default_rng(seed)
    return np.setdiff1d(
        rng.integers(0, 1 << 40, 4 * n).astype(np.float64), base
    )[:n]


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": torch.as_tensor(rng.normal(0, 1, (4, 8)).astype(np.float32)),
        "nested": {"b": torch.as_tensor(rng.integers(0, 5, (3,)).astype(np.int32))},
    }


def _counts(registry):
    return {k: int(registry.counter(k).value) for k in COUNTERS}


def _port_summary():
    """The port's failover summary under the reference's names."""
    out = {}
    for key, row in ops.failover_summary().items():
        op, strategy = key.split(":")
        out[f"{op}:{REFERENCE_STRATEGY.get(strategy, strategy)}"] = row
    return out


@pytest.fixture(autouse=True)
def _clean_failover():
    ops.reset_failover()
    ref_ops.reset_failover()
    yield
    ops.reset_failover()
    ref_ops.reset_failover()


# ---- fault-point completeness --------------------------------------------

def _trigger_ckpt_torn(tmp):
    save_checkpoint(str(tmp), 1, _tree())  # torn fires post-publish


def _trigger_ckpt_crash(tmp):
    with pytest.raises(faults.InjectedFault):
        save_checkpoint(str(tmp), 1, _tree())


def _trigger_compactor_crash(tmp):
    svc = IndexService(_keys(512), ServiceConfig(
        delta_capacity=64, compact_backoff_s=0.001,
        compact_backoff_cap_s=0.002,
    ), device="cpu")
    svc.insert(_fresh(_keys(512), 80))  # crosses the compaction trigger


def _trigger_kernel_dispatch(tmp):
    # through a real op: the merged lookup of a cuda_fused service
    keys = _keys(512)
    svc = IndexService(keys, ServiceConfig(strategy="cuda_fused"), device="cpu")
    found = svc.get(keys[:32])[1]
    assert found.all()


def _trigger_router_refit(tmp):
    svc = ShardedIndexService(_keys(512), ServiceConfig(
        delta_capacity=256, num_shards=2), device="cpu")
    with pytest.raises(faults.InjectedFault):
        svc.rebalance()


def _trigger_frontend_delay(tmp):
    f = IndexFrontend(_StubService(), FrontendConfig(request_deadline_s=5.0))
    f.submit("t", "get", np.array([1.0]))
    f.pump()


TRIGGERS = {
    "ckpt.write.torn": _trigger_ckpt_torn,
    "ckpt.write.crash": _trigger_ckpt_crash,
    "compactor.crash": _trigger_compactor_crash,
    "kernel.dispatch": _trigger_kernel_dispatch,
    "router.refit": _trigger_router_refit,
    "frontend.queue.delay": _trigger_frontend_delay,
}


def test_every_registered_fault_point_fires_in_the_port(tmp_path):
    assert set(faults.FAULT_POINTS) == set(ref_faults.FAULT_POINTS)
    assert set(TRIGGERS) >= set(faults.FAULT_POINTS), (
        f"fault points missing a trigger: {set(faults.FAULT_POINTS) - set(TRIGGERS)}")
    for name, trigger in TRIGGERS.items():
        sub = tmp_path / name.replace(".", "_")
        sub.mkdir()
        with faults.inject(faults.FaultSchedule({name: 1})) as sched:
            trigger(sub)
        assert sched.fired[name] == 1, f"{name} never fired"


# ---- the failover policy ---------------------------------------------------

def test_failover_retries_once_then_sticks_then_recovers():
    calls = {"kernel": 0, "fallback": 0}

    def broken():
        calls["kernel"] += 1
        raise RuntimeError("kernel boom")

    def fallback():
        calls["fallback"] += 1
        return "fb"

    reg = default_registry()
    before = _counts(reg)
    assert ops.run_with_failover("t_op", "cuda", broken, fallback) == "fb"
    assert calls["kernel"] == 2  # retried once before failing over
    assert ops.failover_summary()["t_op:cuda"]["disabled"]
    # sticky: the kernel is not attempted again off the re-probe cadence
    assert ops.run_with_failover("t_op", "cuda", broken, fallback) == "fb"
    assert calls["kernel"] == 2

    def healed():
        calls["kernel"] += 1
        return "kk"

    outs = [ops.run_with_failover("t_op", "cuda", healed, fallback)
            for _ in range(ops.FAILOVER_REPROBE_EVERY)]
    # the 64th call since disablement re-probes and re-enables
    assert outs.index("kk") == ops.FAILOVER_REPROBE_EVERY - 2
    assert not ops.failover_summary()["t_op:cuda"]["disabled"]
    after = _counts(reg)
    assert {k: after[k] - before[k] for k in COUNTERS} == {
        "kernel_failover": 1, "kernel_failover.errors": 2,
        "kernel_failover.recoveries": 1}


def test_failover_policy_matches_reference_on_one_outcome_stream():
    """A kernel that fails on a seeded set of attempts: both packages'
    policies make the same calls and return the same results."""
    rng = np.random.default_rng(7)
    fails = set(rng.choice(400, 160, replace=False).tolist()) | set(range(64, 200))
    out = {}
    for name, mod, reg in (("ref", ref_ops, ref_registry()), ("port", ops, default_registry())):
        attempt = [0]

        def kernel():
            a = attempt[0]
            attempt[0] += 1
            if a in fails:
                raise RuntimeError("boom")
            return ("k", a)

        before = _counts(reg)
        results = [mod.run_with_failover("stream", "s", kernel, lambda: "f")
                   for _ in range(300)]
        after = _counts(reg)
        out[name] = (results, attempt[0], mod.failover_summary(),
                     {k: after[k] - before[k] for k in COUNTERS})
    assert out["port"] == out["ref"]
    assert out["port"][3]["kernel_failover.recoveries"] >= 1


def test_fallback_errors_propagate():
    def broken():
        raise RuntimeError("kernel boom")

    def broken_twin():
        raise ValueError("twin boom")

    with pytest.raises(ValueError):
        ops.run_with_failover("t_op", "cuda", broken, broken_twin)


# ---- one schedule through both packages' services -------------------------

def _single_pair(strategy="cuda_fused"):
    keys = _keys(2048)
    fresh = _fresh(keys, 100)
    ref = RefService(keys, RefConfig(delta_capacity=256,
                                     strategy=REFERENCE_STRATEGY[strategy]))
    port = IndexService(keys, ServiceConfig(delta_capacity=256, strategy=strategy),
                        device="cpu")
    for svc in (ref, port):
        svc.insert(fresh)
    probe = np.concatenate([keys[:200], fresh, _fresh(keys, 50, seed=3)])
    return keys, fresh, ref, port, probe


def _sharded_pair():
    keys = _keys(2048)
    fresh = _fresh(keys, 100)
    ref = RefSharded(keys, RefConfig(delta_capacity=256, num_shards=3,
                                     strategy="sharded_fused"))
    port = ShardedIndexService(keys, ServiceConfig(
        delta_capacity=256, num_shards=3, strategy="sharded_fused"), device="cpu")
    for svc in (ref, port):
        svc.insert(fresh)
        svc.delete(keys[5:40])
    probe = np.concatenate([keys[:200], fresh, _fresh(keys, 50, seed=3)])
    return keys, fresh, ref, port, probe


def _as_np(out):
    if isinstance(out, tuple):
        return tuple(_as_np(o) for o in out)
    return np.asarray(out.cpu() if isinstance(out, torch.Tensor) else out)


def _same(a, b):
    a, b = _as_np(a), _as_np(b)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return np.array_equal(a, b)


def _twin(ref_call, port_call, plan):
    """Run each package's call under its own copy of ``plan``; returns
    {side: (result, fired, counter deltas, summary)}."""
    out = {}
    for side, fmod, reg, call, summary in (
            ("ref", ref_faults, ref_registry(), ref_call, ref_ops.failover_summary),
            ("port", faults, default_registry(), port_call, _port_summary)):
        before = _counts(reg)
        with fmod.inject(fmod.FaultSchedule(plan)) as sched:
            res = call()
        after = _counts(reg)
        out[side] = (res, dict(sched.fired),
                     {k: after[k] - before[k] for k in COUNTERS}, summary())
    return out


def _assert_twins(out):
    (rres, rfired, rctr, rsum), (pres, pfired, pctr, psum) = out["ref"], out["port"]
    assert _same(pres, rres)
    assert pfired == rfired
    assert pctr == rctr
    assert psum == rsum


@pytest.mark.parametrize("kind", ["single", "sharded"])
def test_injected_kernel_fault_reroutes_like_the_reference(kind):
    keys, fresh, ref, port, probe = (_single_pair() if kind == "single"
                                     else _sharded_pair())
    want = port.get(probe)
    assert _same(want, ref.get(probe))  # warm, and the healthy answers agree
    # two faults: the attempt and its retry -> one sticky failover
    out = _twin(lambda: ref.get(probe), lambda: port.get(probe), {"kernel.dispatch": 2})
    _assert_twins(out)
    assert _same(out["port"][0], want)
    assert out["port"][2] == {"kernel_failover": 1, "kernel_failover.errors": 2,
                              "kernel_failover.recoveries": 0}
    assert any(row["disabled"] for row in out["port"][3].values())
    # the sticky twin serves bit-exact answers until the 64th call since
    # the failover re-probes the healthy kernel and re-enables it
    for i in range(1, ops.FAILOVER_REPROBE_EVERY + 1):
        out = _twin(lambda: ref.get(probe), lambda: port.get(probe), {})
        _assert_twins(out)
        assert _same(out["port"][0], want)
        recovered = out["port"][2]["kernel_failover.recoveries"]
        assert recovered == (1 if i == ops.FAILOVER_REPROBE_EVERY else 0), i
    assert not any(row["disabled"] for row in out["port"][3].values())


@pytest.mark.parametrize("kind", ["single", "sharded"])
def test_injected_scan_fault_reroutes_like_the_reference(kind):
    keys, fresh, ref, port, probe = (_single_pair() if kind == "single"
                                     else _sharded_pair())
    lo, hi = float(keys[100]), float(keys[900])

    def rows(out):
        k, v, live = _as_np(out)
        return k[live], v[live]

    healthy = rows(port.scan_batch(lo, hi, 64))
    assert _same(healthy, rows(ref.scan_batch(lo, hi, 64)))
    out = _twin(lambda: rows(ref.scan_batch(lo, hi, 64)),
                lambda: rows(port.scan_batch(lo, hi, 64)), {"kernel.dispatch": 2})
    _assert_twins(out)
    assert _same(out["port"][0], healthy)
    assert out["port"][2]["kernel_failover"] == 1


def test_one_injected_fault_heals_on_the_retry_like_the_reference():
    _, _, ref, port, probe = _single_pair()
    port.get(probe)
    ref.get(probe)
    out = _twin(lambda: ref.get(probe), lambda: port.get(probe), {"kernel.dispatch": 1})
    _assert_twins(out)
    assert out["port"][2] == {"kernel_failover": 0, "kernel_failover.errors": 1,
                              "kernel_failover.recoveries": 0}
    assert not any(row["disabled"] for row in out["port"][3].values())


def test_base_lookup_closure_reroutes_to_binary():
    keys = _keys(2048)
    port = IndexService(keys, ServiceConfig(strategy="cuda_fused"), device="cpu")
    snap = port._mgr.current()
    q = torch.as_tensor(snap.keys.norm[::7].copy())
    want = snap.base_lookup_fn("binary")(q)
    fn = snap.base_lookup_fn("cuda_fused")
    with faults.inject(faults.FaultSchedule({"kernel.dispatch": 2})):
        got = fn(q)
    assert torch.equal(got, want)
    assert ops.failover_summary() == {"base_lookup:cuda": {
        "disabled": True, "fallback_calls": 0}}
    rows = {(r["op"], r["strategy"]) for r in ops.dispatch_summary()["rows"]}
    assert ("base_lookup", "binary") in rows  # the twin counted under its own tag


# ---- checkpoint integrity --------------------------------------------------

def _assert_tree_equal(a, b):
    assert torch.equal(a["w"], b["w"])
    assert torch.equal(a["nested"]["b"], b["nested"]["b"])


def test_torn_checkpoint_quarantined_and_restore_falls_back(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 5, t)
    with faults.inject(faults.FaultSchedule({"ckpt.write.torn": 1})):
        save_checkpoint(str(tmp_path), 9, _tree(seed=9))
    restored, step = restore_checkpoint(str(tmp_path), t, device="cpu")
    assert step == 5
    _assert_tree_equal(restored, t)
    assert os.path.isdir(tmp_path / "step_0000000009.quarantine")
    assert not os.path.isdir(tmp_path / "step_0000000009")


def test_crash_before_publish_leaves_no_step(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 5, t)
    with faults.inject(faults.FaultSchedule({"ckpt.write.crash": 1})):
        with pytest.raises(faults.InjectedFault):
            save_checkpoint(str(tmp_path), 9, t)
    assert not os.path.isdir(tmp_path / "step_0000000009")
    assert os.path.isdir(tmp_path / "step_0000000009.tmp")
    _, step = restore_checkpoint(str(tmp_path), t, device="cpu")
    assert step == 5


def test_manual_corruption_detected_by_checksum(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 5, t)
    save_checkpoint(str(tmp_path), 9, t)
    d = tmp_path / "step_0000000009"
    leaves = [p for p in sorted(os.listdir(d)) if p != "manifest.json"]
    victim = d / leaves[0]
    victim.write_bytes(victim.read_bytes()[: max(1, victim.stat().st_size // 2)])
    _, step = restore_checkpoint(str(tmp_path), t, device="cpu")
    assert step == 5
    assert os.path.isdir(tmp_path / "step_0000000009.quarantine")


def test_explicit_corrupt_step_raises_not_falls_back(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 5, t)
    save_checkpoint(str(tmp_path), 9, t)
    d = tmp_path / "step_0000000009"
    leaves = [p for p in sorted(os.listdir(d)) if p != "manifest.json"]
    (d / leaves[0]).write_bytes(b"rot")
    with pytest.raises(CheckpointCorrupt):
        newest_intact_step(str(tmp_path), step=9)


def test_restore_or_init_falls_back_to_init_on_corruption(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=10)
    t = _tree()
    mgr.save(10, t)
    d = tmp_path / "step_0000000010"
    leaves = [p for p in sorted(os.listdir(d)) if p != "manifest.json"]
    (d / leaves[0]).write_bytes(b"rot")
    init_calls = []

    def init_fn():
        init_calls.append(1)
        return t

    _, step = mgr.restore_or_init(t, init_fn, device="cpu")
    assert step == 0 and init_calls  # quarantined -> nothing intact -> init


def test_index_checkpointer_restores_newest_intact(tmp_path):
    keys = _keys(1024)
    cfg = ServiceConfig(delta_capacity=256, num_shards=2)
    svc = ShardedIndexService(keys, cfg, device="cpu")
    fresh = _fresh(keys, 200)
    svc.insert(fresh[:100])
    probe = np.concatenate([keys[:128], fresh])
    want = svc.contains(probe)
    ckpt = IndexCheckpointer(str(tmp_path), keep_last=4)
    ckpt.save(1, svc)
    svc.insert(fresh[100:])
    with faults.inject(faults.FaultSchedule({"ckpt.write.torn": 1})) as s:
        ckpt.save(2, svc)
    assert s.fired["ckpt.write.torn"] == 1
    del svc
    back, step = ckpt.restore(cfg, device="cpu")
    assert step == 1  # step 2 quarantined, fell back
    np.testing.assert_array_equal(back.contains(probe), want)


def test_index_checkpointer_crash_leaves_the_previous_step(tmp_path):
    keys = _keys(1024)
    svc = ShardedIndexService(keys, ServiceConfig(num_shards=2), device="cpu")
    ckpt = IndexCheckpointer(str(tmp_path))
    ckpt.save(1, svc)
    svc.insert(_fresh(keys, 50))
    with faults.inject(faults.FaultSchedule({"ckpt.write.crash": 1})):
        with pytest.raises(faults.InjectedFault):
            ckpt.save(2, svc)
    back, step = ckpt.restore(device="cpu")
    assert step == 1
    np.testing.assert_array_equal(back.contains(keys), np.ones(keys.size, bool))


# ---- frontend: degradation ladder + deadlines -----------------------------

class _StubService:
    """Deterministic op surface for ladder tests."""

    def __init__(self):
        self.fail_reads = False
        self.fail_writes = None  # exception TYPE to raise, or None
        self.compactor_escalated = False

    def _maybe_fail_read(self):
        if self.fail_reads:
            raise RuntimeError("service down")

    def get(self, q):
        self._maybe_fail_read()
        return np.zeros(q.size, bool), np.zeros(q.size, np.int64)

    def contains(self, q):
        self._maybe_fail_read()
        return np.zeros(q.size, bool)

    def range_lookup(self, lo, hi):
        self._maybe_fail_read()
        return np.array([], np.float64)

    def scan_batch(self, lo, hi, page):
        self._maybe_fail_read()
        return []

    def insert(self, keys, vals):
        if self.fail_writes is not None:
            raise self.fail_writes("write pressure")
        return keys.size

    def delete(self, keys):
        if self.fail_writes is not None:
            raise self.fail_writes("write pressure")
        return keys.size


def test_ladder_degraded_writes_then_recovers():
    svc = _StubService()
    f = IndexFrontend(svc, FrontendConfig())
    assert f.health() == HEALTHY
    svc.fail_writes = OverflowError
    req = f.submit("t", "insert", np.array([1.0]), np.array([0]))
    f.pump()
    with pytest.raises(WriteShed):
        req.wait(1.0)
    assert f.health() == DEGRADED_WRITES
    assert f.serving_summary()["health"] == DEGRADED_WRITES
    svc.fail_writes = None
    req = f.submit("t", "insert", np.array([2.0]), np.array([0]))
    f.pump()
    assert req.wait(1.0) == 1
    assert f.health() == HEALTHY


def test_ladder_stale_reads_fails_writes_fast_at_admission():
    svc = _StubService()
    svc.compactor_escalated = True
    f = IndexFrontend(svc, FrontendConfig())
    assert f.health() == STALE_READS
    with pytest.raises(WriteShed):
        f.submit("t", "insert", np.array([1.0]), np.array([0]))
    req = f.submit("t", "contains", np.array([1.0]))
    f.pump()
    assert req.wait(1.0) is not None
    svc.compactor_escalated = False
    assert f.health() == HEALTHY


def test_ladder_stale_reads_from_an_escalated_port_service():
    keys = _keys(1024)
    svc = IndexService(keys, ServiceConfig(
        delta_capacity=128, compact_max_failures=2,
        compact_backoff_s=0.001, compact_backoff_cap_s=0.002), device="cpu")
    f = IndexFrontend(svc, FrontendConfig())
    fresh = _fresh(keys, 150)
    with faults.inject(faults.FaultSchedule({"compactor.crash": {"times": None}})):
        try:
            svc.insert(fresh)
        except RuntimeError:
            pass  # the parked worker error may surface here
    assert f.health() == STALE_READS
    with pytest.raises(WriteShed):
        f.insert("t", keys[:1] + 0.5)
    req = f.submit("t", "contains", fresh)
    f.pump()
    assert req.wait(1.0).all()  # reads keep serving from the level stack


def test_ladder_unavailable_rejects_all_then_probe_recovers():
    svc = _StubService()
    f = IndexFrontend(svc, FrontendConfig(unavailable_after=3))
    svc.fail_reads = True
    for _ in range(3):
        req = f.submit("t", "get", np.array([1.0]))
        f.pump()
        with pytest.raises(RuntimeError):
            req.wait(1.0)
    assert f.health() == UNAVAILABLE
    with pytest.raises(Backpressure):
        f.submit("t", "get", np.array([1.0]))
    with pytest.raises(Backpressure):
        f.submit("t", "insert", np.array([1.0]), np.array([0]))
    assert int(f.metrics.counter("frontend.probe_failures").value) == 0
    f.pump()  # empty queue + UNAVAILABLE -> probe (still down)
    assert int(f.metrics.counter("frontend.probe_failures").value) == 1
    assert f.health() == UNAVAILABLE
    svc.fail_reads = False
    f.pump()  # probe succeeds -> ladder climbs back up
    assert f.health() == HEALTHY
    req = f.submit("t", "get", np.array([1.0]))
    f.pump()
    assert req.wait(1.0) is not None


def test_injected_queue_delay_fails_deadline_not_serves_late():
    f = IndexFrontend(_StubService(), FrontendConfig(request_deadline_s=5.0))
    req = f.submit("t", "get", np.array([1.0]))
    with faults.inject(faults.FaultSchedule({"frontend.queue.delay": 1})) as s:
        served = f.pump()
    assert s.fired["frontend.queue.delay"] == 1
    assert served == 1
    with pytest.raises(DeadlineExceeded):
        req.wait(1.0)
    assert int(f.metrics.counter("frontend.deadline_exceeded").value) == 1
    assert f.serving_summary()["deadline_exceeded"] == 1
    req = f.submit("t", "get", np.array([1.0]))
    f.pump()
    assert req.wait(1.0) is not None


def test_deadline_disabled_when_none():
    f = IndexFrontend(_StubService(), FrontendConfig(request_deadline_s=None))
    req = f.submit("t", "get", np.array([1.0]))
    req.enqueued_at -= 3600.0  # an hour old
    f.pump()
    assert req.wait(1.0) is not None  # served, never expired


def test_default_timeout_comes_from_config():
    f = IndexFrontend(_StubService(), FrontendConfig(default_timeout_s=0.05))
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError):
        f.get("t", [1.0])  # no dispatcher running
    assert time.perf_counter() - t0 < 5.0
    with pytest.raises(TimeoutError):
        f.contains("t", [1.0], timeout=0.01)


def test_retry_with_backoff_retries_then_succeeds():
    calls = {"n": 0}
    delays = []

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise Backpressure("full")
        return "ok"

    out = retry_with_backoff(flaky, attempts=5, base_s=0.01, cap_s=0.5,
                             rng=random.Random(0), sleep=delays.append)
    assert out == "ok"
    assert calls["n"] == 3
    assert len(delays) == 2
    assert delays[1] > delays[0]
    assert all(d <= 0.5 * 1.5 for d in delays)


def test_retry_with_backoff_exhausts_and_raises_last():
    delays = []

    def always():
        raise Backpressure("full")

    with pytest.raises(Backpressure):
        retry_with_backoff(always, attempts=3, base_s=0.001,
                           rng=random.Random(1), sleep=delays.append)
    assert len(delays) == 2
    with pytest.raises(DeadlineExceeded):
        retry_with_backoff(
            lambda: (_ for _ in ()).throw(DeadlineExceeded("late")),
            attempts=3, sleep=delays.append,
        )
    assert len(delays) == 2


def test_frontend_dispatcher_thread_probes_while_unavailable():
    svc = _StubService()
    svc.fail_reads = True
    f = IndexFrontend(svc, FrontendConfig(unavailable_after=1))
    with f:
        with pytest.raises(RuntimeError):
            f.get("t", [1.0], timeout=5.0)
        deadline = time.time() + 5.0
        while f.health() != UNAVAILABLE and time.time() < deadline:
            time.sleep(0.01)
        assert f.health() == UNAVAILABLE
        svc.fail_reads = False
        deadline = time.time() + 5.0
        while f.health() != HEALTHY and time.time() < deadline:
            time.sleep(0.01)
        assert f.health() == HEALTHY  # background probe recovered
        assert f.contains("t", [1.0]) is not None
