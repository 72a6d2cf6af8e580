"""The port's checkpoints against the reference's (twin of the
checkpointer part of ``tests/test_distributed.py`` and the kill/restart
cases of ``tests/test_chaos.py``).

* Tree checkpoints: round trip, keep-last, partial tmp dirs, LATEST
  healing, age-gated GC; a tree of float32, int32 and bf16 leaves
  written by either package restores in the other with identical
  leaves, under the same leaf paths and order.
* `IndexCheckpointer`: a `ShardedIndexService` checkpoint written by
  either package mid-churn restores in the other and answers `get`,
  `lookup_batch` and `scan_batch` alike; kill/restart mid-churn
  converges to the `np.searchsorted` oracle.
* `StragglerPolicy` raises the same flags on the same step times.
"""

import json
import os
import shutil
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.distributed import fault_tolerance as ref_ft  # noqa: E402
from repro.index_service import ServiceConfig as RefConfig  # noqa: E402
from repro.index_service import ShardedIndexService as RefSharded  # noqa: E402

from repro_torch.data import gen_maps  # noqa: E402
from repro_torch.distributed import (  # noqa: E402
    CheckpointManager,
    IndexCheckpointer,
    StragglerPolicy,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.index_service import ServiceConfig, ShardedIndexService  # noqa: E402


def _tree(seed=0):
    """float32, int32 and bf16 leaves, nested, dict keys out of order."""
    rng = np.random.default_rng(seed)
    return {
        "z": torch.as_tensor(rng.normal(0, 1, (4, 8)).astype(np.float32)),
        "nested": {"b": torch.as_tensor(rng.integers(-5, 5, (3,)).astype(np.int32)),
                   "a": [torch.as_tensor(rng.normal(0, 3, (2, 5)).astype(np.float32))
                         .to(torch.bfloat16),
                         torch.arange(6, dtype=torch.int32).reshape(2, 3)]},
        "a": torch.as_tensor(np.float32(1.5)),
    }


def _jax_tree(t):
    """The same tree as JAX arrays (bf16 through its bit pattern)."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v) for v in x]
        if x.dtype == torch.bfloat16:
            bits = x.view(torch.int16).numpy().view(np.uint16)
            return jnp.asarray(bits.view(ml_dtypes.bfloat16))
        return jnp.asarray(x.numpy())
    return conv(t)


def _leaves_np(tree):
    """Leaves of either package's tree as (path, dtype name, bit array)."""
    from repro_torch.distributed.fault_tolerance import _flatten
    if isinstance(jax.tree.leaves(tree)[0], jax.Array):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        out = []
        for path, leaf in flat:
            a = np.asarray(leaf)
            p = "/".join(str(getattr(e, "key", getattr(e, "idx", ""))) for e in path)
            out.append((p, str(a.dtype), a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16
                        else a))
        return out
    out = []
    for p, leaf in _flatten(tree):
        if leaf.dtype == torch.bfloat16:
            out.append((p, "bfloat16", leaf.view(torch.int16).numpy().view(np.uint16)))
        else:
            out.append((p, str(leaf.numpy().dtype), leaf.numpy()))
    return out


def _assert_same_leaves(a, b):
    la, lb = _leaves_np(a), _leaves_np(b)
    assert [(p, d) for p, d, _ in la] == [(p, d) for p, d, _ in lb]
    for (_, _, x), (_, _, y) in zip(la, lb):
        assert x.shape == y.shape and np.array_equal(x, y)


def _manifest(d):
    with open(os.path.join(d, "manifest.json")) as f:
        m = json.load(f)
    return [{k: e[k] for k in ("path", "file", "shape", "dtype", "sha256")}
            for e in m["leaves"]]


# ---- tree checkpoints ------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 7, t)
    restored, step = restore_checkpoint(str(tmp_path), t, device="cpu")
    assert step == 7
    _assert_same_leaves(restored, t)


def test_tree_checkpoint_files_match_the_reference(tmp_path):
    """Same leaf order, paths, shapes, dtypes and bytes as JAX's
    `tree_flatten_with_path` gives the reference."""
    t = _tree(3)
    save_checkpoint(str(tmp_path / "port"), 1, t)
    ref_ft.save_checkpoint(str(tmp_path / "ref"), 1, _jax_tree(t))
    assert (_manifest(tmp_path / "port" / "step_0000000001")
            == _manifest(tmp_path / "ref" / "step_0000000001"))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_tree_checkpoint_restores_across_packages(writer, tmp_path):
    t = _tree(5)
    if writer == "port":
        save_checkpoint(str(tmp_path), 4, t)
        back, step = ref_ft.restore_checkpoint(str(tmp_path), _jax_tree(_tree(0)))
    else:
        ref_ft.save_checkpoint(str(tmp_path), 4, _jax_tree(t))
        back, step = restore_checkpoint(str(tmp_path), _tree(0), device="cpu")
    assert step == 4
    _assert_same_leaves(back, _jax_tree(t) if writer == "port" else t)


def test_restore_casts_to_the_like_tree_and_checks_leaf_count(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 1, t)
    like = _tree()
    like["z"] = like["z"].double()
    back, _ = restore_checkpoint(str(tmp_path), like, device="cpu")
    assert back["z"].dtype == torch.float64
    assert torch.equal(back["z"], t["z"].double())
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), {"only": t["z"]}, device="cpu")


def test_checkpoint_keep_last_and_latest(tmp_path):
    t = _tree()
    for s in (10, 20, 30, 40):
        save_checkpoint(str(tmp_path), s, t, keep_last=2)
    names = sorted(os.listdir(tmp_path))
    assert "step_0000000030" in names and "step_0000000040" in names
    assert "step_0000000010" not in names
    assert latest_step(str(tmp_path)) == 40


def test_checkpoint_ignores_partial_tmp(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 5, t)
    os.makedirs(tmp_path / "step_0000000006.tmp")  # a crash mid-write of step 6
    _, step = restore_checkpoint(str(tmp_path), t, device="cpu")
    assert step == 5


def test_latest_step_heals_stale_pointer(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 5, t)
    save_checkpoint(str(tmp_path), 9, t)
    shutil.rmtree(tmp_path / "step_0000000009")
    assert latest_step(str(tmp_path)) == 5
    assert (tmp_path / "LATEST").read_text().strip() == "5"
    assert latest_step(str(tmp_path)) == 5


def test_checkpoint_manager_restore_or_init(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=10)
    t = _tree()
    _, step = mgr.restore_or_init(t, lambda: t, device="cpu")
    assert step == 0
    assert not mgr.should_save(5) and mgr.should_save(10)
    mgr.save(10, t)
    got, step = mgr.restore_or_init(t, lambda: t, device="cpu")
    assert step == 10
    _assert_same_leaves(got, t)


def test_restore_defaults_to_the_card(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        restore_checkpoint(str(tmp_path), _tree())


def test_gc_spares_fresh_foreign_tmp_dirs(tmp_path):
    t = _tree()
    foreign = tmp_path / "step_0000000042.tmp"
    os.makedirs(foreign)
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path), s, t, keep_last=2)
    assert foreign.is_dir()  # a concurrent writer's dir survived the sweep
    old = time.time() - 24 * 3600
    os.utime(foreign, (old, old))
    save_checkpoint(str(tmp_path), 6, t, keep_last=2)
    assert not foreign.exists()


def test_straggler_policy_matches_reference():
    rng = np.random.default_rng(2)
    times = np.concatenate([[1.0, 50.0, 1.0], rng.uniform(0.8, 1.2, 40),
                            [5.0, 1.0, 9.0], rng.uniform(0.5, 4.0, 60)])
    for kw in (dict(factor=2.0, min_samples=3), dict()):
        port, ref = StragglerPolicy(**kw), ref_ft.StragglerPolicy(**kw)
        flags = [port.observe(float(x)) for x in times]
        assert flags == [ref.observe(float(x)) for x in times]
        assert port.events == ref.events >= 1


def test_config_fingerprint_matches_reference():
    from repro_torch.distributed import config_fingerprint
    assert (config_fingerprint(ServiceConfig(num_shards=3, delta_capacity=64))
            == ref_ft.config_fingerprint(RefConfig(num_shards=3, delta_capacity=64)))
    assert config_fingerprint("not a dataclass") == ref_ft.config_fingerprint("not a dataclass")


# ---- index checkpoints across packages --------------------------------------

def _churned(cls, cfg, k, seed, **kw):
    rng = np.random.default_rng(seed)
    base = gen_maps(3_000, seed=seed)
    vals = np.arange(base.size, dtype=np.int64) * 3
    svc = cls(base, cfg(num_shards=k, delta_capacity=256), vals=vals, **kw)
    ins = np.setdiff1d(rng.uniform(base[0], base[-1], 300), base)
    dels = rng.choice(base, 120, replace=False)
    svc.insert(ins, np.arange(ins.size, dtype=np.int64) + 7)
    svc.delete(dels)
    svc.insert(dels[:20], np.full(20, 99, np.int64))  # tombstone, then re-insert
    live = np.setdiff1d(np.union1d(base, ins), dels[20:])
    return svc, live, rng


def _assert_same_service_answers(a, b, live, rng):
    q = np.concatenate([rng.choice(live, 400), rng.uniform(live[0], live[-1], 200),
                        [live[0] - 1.0, live[-1] + 1.0]])
    for x, y in zip(a.get(q), b.get(q)):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    assert np.array_equal(np.asarray(a.contains(q)), np.asarray(b.contains(q)))
    la, lb = a.lookup_batch(q), b.lookup_batch(q)
    assert np.array_equal(np.asarray(la.cpu() if isinstance(la, torch.Tensor) else la),
                          np.asarray(lb.cpu() if isinstance(lb, torch.Tensor) else lb))
    for lo, hi in ((live[10], live[900]), (live[0] - 5, live[-1] + 5)):
        ra, rb = a.scan_batch(lo, hi, 64), b.scan_batch(lo, hi, 64)
        ra = [np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x).ravel() for x in ra]
        rb = [np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x).ravel() for x in rb]
        assert ra[2].sum() == rb[2].sum()
        for x, y in zip(ra[:2], rb[:2]):
            assert np.array_equal(x[ra[2].astype(bool)], y[rb[2].astype(bool)])


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_index_checkpoint_restores_across_packages(writer, tmp_path):
    port, live, rng = _churned(ShardedIndexService, ServiceConfig, 3, 21, device="cpu")
    ref, live_r, _ = _churned(RefSharded, RefConfig, 3, 21)
    assert np.array_equal(live, live_r)
    if writer == "port":
        IndexCheckpointer(str(tmp_path)).save(3, port)
        back, step = ref_ft.IndexCheckpointer(str(tmp_path)).restore(
            RefConfig(strategy="xla_fused"))
        live_svc = ref
    else:
        ref_ft.IndexCheckpointer(str(tmp_path)).save(3, ref)
        back, step = IndexCheckpointer(str(tmp_path)).restore(
            ServiceConfig(strategy="sharded_fused"), device="cpu")
        live_svc = port
    assert step == 3
    assert back.num_shards == 3
    assert sum(len(s._active) for s in back.shards) > 0  # restored mid-churn
    _assert_same_service_answers(back, live_svc, live, rng)
    _assert_same_service_answers(back, port, live, rng)


def test_index_checkpoint_files_match_the_reference(tmp_path):
    port, _, _ = _churned(ShardedIndexService, ServiceConfig, 2, 5, device="cpu")
    ref, _, _ = _churned(RefSharded, RefConfig, 2, 5)
    IndexCheckpointer(str(tmp_path / "port")).save(1, port)
    ref_ft.IndexCheckpointer(str(tmp_path / "ref")).save(1, ref)
    manifests = []
    for side in ("port", "ref"):
        with open(tmp_path / side / "step_0000000001" / "manifest.json") as f:
            m = json.load(f)
        manifests.append(({k: m[k] for k in ("step", "num_shards", "shards")},
                          sorted(m["files"])))
        for s in range(2):
            with np.load(tmp_path / side / "step_0000000001" / f"shard-{s:02d}"
                         / "delta.npz") as z:
                manifests[-1] += (tuple(z[k].tobytes() for k in sorted(z.files)),)
    assert manifests[0] == manifests[1]


def test_restore_does_not_refit(tmp_path, monkeypatch):
    port, live, rng = _churned(ShardedIndexService, ServiceConfig, 2, 8, device="cpu")
    IndexCheckpointer(str(tmp_path)).save(1, port)
    from repro_torch.core import rmi as rmi_mod
    from repro_torch.index_service import snapshot as snap_mod

    def no_fit(*a, **k):
        raise AssertionError("restore refit an RMI")

    for mod in (rmi_mod, snap_mod):
        monkeypatch.setattr(mod, "build_rmi", no_fit)
        monkeypatch.setattr(mod, "refit_rmi", no_fit)
    back, _ = IndexCheckpointer(str(tmp_path)).restore(device="cpu")
    for a, b in zip(back.shards, port.shards):
        sa, sb = a._mgr.current(), b._mgr.current()
        assert np.array_equal(sa.index.leaf_w, sb.index.leaf_w)
        assert np.array_equal(sa.keys.raw, sb.keys.raw)


# ---- kill/restart mid-churn (twin of tests/test_chaos.py) -----------------

def _cfg(k):
    return ServiceConfig(num_shards=k, delta_capacity=64, bloom_fpr=0.02)


def _churn(svc, live, rng, rounds, n_ins, n_del, span=1 << 30):
    for _ in range(rounds):
        ins = np.unique(rng.integers(0, span, n_ins).astype(np.float64))
        svc.insert(ins)
        live = np.union1d(live, ins)
        if live.size > n_del + 8:
            dels = rng.choice(live, n_del, replace=False)
            svc.delete(dels)
            live = np.setdiff1d(live, dels)
    return live


def _assert_oracle(svc, live, rng, n_present=400, n_absent=200):
    sample = np.concatenate([
        rng.choice(live, min(n_present, live.size), replace=False),
        rng.integers(1 << 31, 1 << 32, n_absent).astype(np.float64),
    ])
    ranks, found = svc.get(sample)
    np.testing.assert_array_equal(found, np.isin(sample, live))
    np.testing.assert_array_equal(ranks, np.searchsorted(live, sample))
    np.testing.assert_array_equal(svc.contains(sample), np.isin(sample, live))


def _kill_restart_roundtrip(tmp_path, k, rounds, n_ins, n_del, seed):
    rng = np.random.default_rng(seed)
    base = np.unique(rng.integers(0, 1 << 30, 2_000).astype(np.float64))
    svc = ShardedIndexService(base, _cfg(k), device="cpu")
    live = _churn(svc, base, rng, rounds, n_ins, n_del)
    ckpt = IndexCheckpointer(str(tmp_path / f"ckpt-{k}"), keep_last=2)
    ckpt.save(1, svc)
    post_ins = np.unique(rng.integers(0, 1 << 30, 120).astype(np.float64))
    post_del = rng.choice(live, 30, replace=False)
    svc.insert(post_ins)
    svc.delete(post_del)
    del svc  # SIGKILL simulation: every in-memory structure is gone
    back, step = ckpt.restore(_cfg(k), device="cpu")
    assert step == 1
    back.insert(post_ins)
    back.delete(post_del)
    live = np.setdiff1d(np.union1d(live, post_ins), post_del)
    _assert_oracle(back, live, rng)
    back.flush()  # the restored service stays writable
    _assert_oracle(back, live, rng)
    return back, live


@pytest.mark.parametrize("k", [1, 3, pytest.param(8, marks=pytest.mark.slow)])
def test_kill_restart_mid_churn_converges(tmp_path, k):
    _kill_restart_roundtrip(tmp_path, k, rounds=3, n_ins=150, n_del=40, seed=k)


@pytest.mark.slow
@pytest.mark.parametrize("k", [1, 3, 8])
def test_kill_restart_long_churn_converges(tmp_path, k):
    back, live = _kill_restart_roundtrip(tmp_path, k, rounds=12, n_ins=600, n_del=220,
                                         seed=100 + k)
    rng = np.random.default_rng(999 + k)
    live = _churn(back, live, rng, rounds=4, n_ins=300, n_del=120)
    _assert_oracle(back, live, rng)


def test_checkpoint_mid_churn_captures_staged_deltas(tmp_path):
    base = np.arange(0, 1000, dtype=np.float64)
    svc = ShardedIndexService(base, _cfg(3), device="cpu")
    staged_ins = np.arange(2000, 2030, dtype=np.float64) + 0.5
    staged_del = np.arange(10, 40, dtype=np.float64)
    svc.insert(staged_ins)
    svc.delete(staged_del)
    ckpt = IndexCheckpointer(str(tmp_path), keep_last=2)
    ckpt.save(7, svc)
    del svc
    back, step = ckpt.restore(_cfg(3), device="cpu")
    assert step == 7
    assert sum(len(s._active) for s in back.shards) == staged_ins.size + staged_del.size
    live = np.setdiff1d(np.union1d(base, staged_ins), staged_del)
    _assert_oracle(back, live, np.random.default_rng(0))
