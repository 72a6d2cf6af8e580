"""The port's multi-tenant frontend and exporters against the reference's
(twin of ``tests/test_frontend.py``).

* One seeded multi-tenant script through `pump()` in both packages:
  identical results and identical per-kind, per-tenant counters.
* Coalescing keeps one dispatch per read kind a round (`pump()` runs on
  the calling thread, and dispatch counts are thread-local).
* Admission control, write shedding, and read-your-writes across a
  forced freeze, a compaction stall and eight client threads.
* The exporters give identical text and JSON for identically filled
  registries.
"""

import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.index_service import IndexService as RefService  # noqa: E402
from repro.index_service import ServiceConfig as RefConfig  # noqa: E402
from repro.obs import export as ref_export  # noqa: E402
from repro.obs.metrics import MetricsRegistry as RefRegistry  # noqa: E402
from repro.serve import FrontendConfig as RefFrontendConfig  # noqa: E402
from repro.serve import IndexFrontend as RefFrontend  # noqa: E402

from repro_torch.index_service import IndexService, ServiceConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    lockstat,
    op_latency_rows,
    prometheus_text,
    registry_json,
    write_json,
    write_prometheus,
)
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    Backpressure,
    FrontendConfig,
    IndexFrontend,
    WriteShed,
)


def _lattice(n=2_000):
    return np.arange(2, n + 2, dtype=np.float64) * 1024.0


def _frontend(base=None, delta_capacity=512, **svc_kw):
    base = _lattice() if base is None else base
    svc = IndexService(base, ServiceConfig(delta_capacity=delta_capacity, **svc_kw),
                       device="cpu")
    return IndexFrontend(svc, FrontendConfig(max_queue=256))


# ---- one script through both packages ---------------------------------------

def _script(seed, tenants=6, rounds=12):
    """[[(tenant, kind, args)] per round]: point reads of 1-64 keys,
    inserts and deletes of each tenant's own keys followed by a read of
    them, ranges, and scans of 1-1,500 rows."""
    rng = np.random.default_rng(seed)
    base = _lattice()
    out = []
    for r in range(rounds):
        reqs = []
        for t in range(tenants):
            name = f"t{t}"
            own = base[-1] + 1000.0 * (1 + t) + 10.0 * r + np.arange(4) * 0.25
            for _ in range(rng.integers(1, 4)):
                kind = ["get", "contains", "insert", "delete", "range", "scan"][
                    rng.integers(0, 6)]
                if kind in ("get", "contains"):
                    q = rng.choice(base, rng.integers(1, 65))
                    q[::3] += 0.5  # some absent keys
                    reqs.append((name, kind, (q,)))
                elif kind == "insert":
                    reqs.append((name, "insert", (own, np.arange(4, dtype=np.int64) + r)))
                    reqs.append((name, "get", (own,)))
                elif kind == "delete":
                    q = np.concatenate([own[:2], rng.choice(base, 3)])
                    reqs.append((name, "delete", (q,)))
                    reqs.append((name, "contains", (q,)))
                else:
                    i = int(rng.integers(0, base.size - 1))
                    j = min(base.size - 1, i + int(rng.integers(1, 1_500)))
                    args = (float(base[i]), float(base[j]))
                    reqs.append((name, kind, args + ((64,) if kind == "scan" else ())))
        out.append(reqs)
    return out


def _norm(kind, res):
    if kind == "scan":
        k, v, live = (np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x).ravel()
                      for x in res)
        live = live.astype(bool)
        return ("scan", k[live].tobytes(), v[live].tobytes())
    if kind == "get":
        return tuple(np.asarray(x).tobytes() for x in res)
    if kind == "contains":
        return np.asarray(res).tobytes()
    return res


def _run_script(fe, script):
    results = []
    for reqs in script:
        pending = [(kind, fe.submit(t, kind, *args)) for t, kind, args in reqs]
        assert fe.pump() == len(pending)
        results.append([_norm(kind, r.wait(1.0)) for kind, r in pending])
    summary = fe.serving_summary()
    counts = {k: summary[k] for k in ("health", "rounds", "requests", "rejected",
                                      "shed_writes", "deadline_exceeded")}
    counts["tenants"] = {
        name: (row["requests"], row["errors"], row["shed_writes"],
               {op: r["count"] for op, r in row["ops"].items()})
        for name, row in summary["tenants"].items()}
    counts["kinds"] = {k: int(fe._hist[k].count) for k in fe._hist}
    counts["writes_applied"] = int(fe.metrics.counter("frontend.writes_applied").value)
    return results, counts


def test_script_matches_reference():
    base = _lattice()
    script = _script(5)
    port = IndexFrontend(IndexService(base, ServiceConfig(delta_capacity=64,
                                                          strategy="cuda_fused"),
                                      device="cpu"), FrontendConfig(max_queue=256))
    ref = RefFrontend(RefService(base, RefConfig(delta_capacity=64, strategy="xla_fused")),
                      RefFrontendConfig(max_queue=256))
    got, want = _run_script(port, script), _run_script(ref, script)
    assert got[1] == want[1]
    assert got[0] == want[0]
    # the churn crossed freezes and compactions in both
    assert port.service.stats["compactions"] == ref.service.stats["compactions"] >= 1


# ---- coalescing keeps the one-dispatch discipline ---------------------------

def _pump_dispatches(fe, enqueue) -> int:
    enqueue()
    fe.pump()  # warm round: fills the device-plane caches
    enqueue()
    with ops.count_dispatches() as n:
        fe.pump()
        return n()


def test_coalesced_gets_one_dispatch():
    fe = _frontend(strategy="cuda_fused")
    base = _lattice()

    def enqueue():
        for c in range(12):  # 12 tenants' point reads, one round
            fe.submit(f"t{c}", "get", base[c * 7: c * 7 + 4])

    assert _pump_dispatches(fe, enqueue) == 1


def test_mixed_round_dispatches_per_kind_not_per_request():
    fe = _frontend(strategy="cuda_fused")
    base = _lattice()
    fresh = [7.25]

    def enqueue():
        fresh[0] += 1.0
        for c in range(8):
            fe.submit(f"g{c}", "get", base[c: c + 3])
        for c in range(6):
            fe.submit(f"c{c}", "contains", base[c * 5: c * 5 + 2])
        fe.submit("s", "scan", float(base[10]), float(base[400]), 64)
        fe.submit("w", "insert", np.array([fresh[0]]), np.zeros(1, np.int64))

    # 8 gets -> one dispatch, 6 contains -> another, the scan a third;
    # the staged insert is host work
    assert _pump_dispatches(fe, enqueue) == 3


# ---- admission control ------------------------------------------------------

def test_backpressure_when_queue_full():
    fe = _frontend()
    fe.config = FrontendConfig(max_queue=2, submit_timeout_s=0.05)
    fe.submit("a", "get", np.array([2048.0]))
    fe.submit("a", "get", np.array([2048.0]))
    with pytest.raises(Backpressure):
        fe.submit("a", "get", np.array([2048.0]))
    assert fe.metrics.counter("frontend.rejected").value == 1
    fe.pump()
    fe.submit("a", "get", np.array([2048.0]))
    fe.pump()


def test_write_shed_keeps_reads_serving():
    class _DegradedService:
        def insert(self, keys, vals=None):
            raise OverflowError("delta full; compaction stalled")

        def get(self, keys):
            q = np.atleast_1d(keys)
            return np.zeros(q.shape, np.int64), np.ones(q.shape, bool)

    fe = IndexFrontend(_DegradedService(), FrontendConfig())
    w = fe.submit("a", "insert", np.array([1.0]), np.zeros(1, np.int64))
    r = fe.submit("b", "get", np.array([1.0]))
    fe.pump()
    with pytest.raises(WriteShed):
        w.wait(1)
    _, live = r.wait(1)
    assert live.all()
    assert fe.metrics.counter("frontend.shed_writes").value == 1
    summary = fe.serving_summary()
    assert summary["tenants"]["a"]["shed_writes"] == 1
    assert summary["tenants"]["b"]["errors"] == 0


# ---- read-your-writes across the maintenance machinery ----------------------

def test_threaded_clients_read_their_writes():
    lockstat.enable()
    lockstat.reset()
    fe = _frontend(delta_capacity=64, strategy="cuda_fused")  # small: force freezes
    errors = []

    def client(tenant, lo):
        keys = lo + np.arange(24, dtype=np.float64) * 0.5
        try:
            for chunk in np.split(keys, 4):
                fe.insert(tenant, chunk, np.arange(chunk.size))
                _, live = fe.get(tenant, chunk)
                if not live.all():
                    errors.append((tenant, "get missed acked insert"))
                if not fe.contains(tenant, chunk).all():
                    errors.append((tenant, "contains missed acked insert"))
        except BaseException as e:  # noqa: BLE001 — collected for assert
            errors.append((tenant, repr(e)))

    with fe:
        threads = [threading.Thread(target=client, args=(f"t{i}", 7.0 + i * 100))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    try:
        lockstat.assert_acyclic()
    finally:
        lockstat.disable()
        lockstat.reset()
    assert not errors
    assert fe.service.metrics.counter("delta.freezes").value >= 1
    summary = fe.serving_summary()
    assert len(summary["tenants"]) == 8
    for name, row in summary["tenants"].items():
        assert row["requests"] == 12, name  # 4 chunks x 3 ops
        assert row["errors"] == 0
        assert set(row["ops"]) == {"insert", "get", "contains"}


def test_read_your_writes_across_compaction_stall():
    base = np.arange(2, 19, dtype=np.float64) * 1024.0  # 17 keys
    fe = _frontend(base=base, delta_capacity=16)
    svc = fe.service
    r0 = fe.submit("a", "delete", base[:16])
    fe.pump()
    r0.wait(1)
    r_del = fe.submit("a", "delete", base[16:])
    r_live = fe.submit("b", "contains", base)
    fe.pump()
    r_del.wait(1)
    assert svc.stats["compact_stalls"] >= 1
    assert not r_live.wait(1).any()
    fresh = np.arange(40, 72, dtype=np.float64) * 1024.0 + 512.0
    r_ins = fe.submit("a", "insert", fresh, np.arange(fresh.size))
    fe.pump()
    assert r_ins.wait(1) == fresh.size
    r_chk = fe.submit("a", "contains", fresh)
    fe.pump()
    assert r_chk.wait(1).all()


def test_ryw_across_forced_freeze_single_thread():
    fe = _frontend(delta_capacity=32, strategy="cuda_fused")
    svc = fe.service
    start = float(_lattice()[-1]) + 1000.0
    for round_i in range(6):  # 6 x 16 staged writes across a 32 delta
        keys = start + round_i * 100 + np.arange(16, dtype=np.float64)
        fe.submit("a", "insert", keys, np.arange(16))
        r = fe.submit("a", "get", keys)
        fe.pump()
        _, live = r.wait(1)
        assert live.all(), f"round {round_i} lost acked writes"
    assert svc.metrics.counter("delta.freezes").value >= 1


# ---- exporters ----------------------------------------------------------------

def _fill(reg, seed):
    rng = np.random.default_rng(seed)
    for i in range(5):
        reg.counter(f"svc.op{i}.count").add(int(rng.integers(0, 100)))
    reg.gauge("frontend.queue_depth").set(int(rng.integers(0, 50)))
    reg.gauge("9.leading.digit").set(3)
    for name in ("op.get.latency_s", "op.scan.latency_s", "op.empty.latency_s",
                 "frontend.requests_per_round"):
        h = reg.histogram(name)
        if name != "op.empty.latency_s":
            for x in rng.lognormal(-8, 2, 300):
                h.observe(float(x))


def test_exporters_match_reference(tmp_path):
    port, ref = MetricsRegistry("exp"), RefRegistry("exp")
    _fill(port, 4)
    _fill(ref, 4)
    assert prometheus_text(port) == ref_export.prometheus_text(ref)
    assert registry_json(port) == ref_export.registry_json(ref)
    assert op_latency_rows(port) == ref_export.op_latency_rows(ref)
    assert set(op_latency_rows(port)) == {"get", "scan"}
    paths = {}
    for side, mod, reg in (("port", None, port), ("ref", ref_export, ref)):
        j, p = tmp_path / f"{side}.json", tmp_path / f"{side}.prom"
        if mod is None:
            write_json(reg, str(j))
            write_prometheus(reg, str(p))
        else:
            mod.write_json(reg, str(j))
            mod.write_prometheus(reg, str(p))
        paths[side] = (j.read_text(), p.read_text())
    assert paths["port"] == paths["ref"]
    assert json.loads(paths["port"][0])["registry"] == "exp"


def test_chrome_trace_export_is_valid_json(tmp_path):
    from repro_torch.obs import chrome_trace, write_chrome_trace
    from repro_torch.obs.trace import Tracer

    tr = Tracer(capacity=64)
    tr.enable()
    with tr.span("frontend.round", cat="serve", requests=3):
        tr.instant("kernel.failover", cat="fault", op="merged_lookup")
    doc = json.loads(json.dumps(chrome_trace(tr)))
    names = [e["name"] for e in doc["traceEvents"]]
    assert "frontend.round" in names and "kernel.failover" in names
    path = write_chrome_trace(str(tmp_path / "t.json"), tr)
    assert json.loads(open(path).read())["traceEvents"]
