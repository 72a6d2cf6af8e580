"""The services' Bloom screen in front of ``contains`` against the
reference's: one seeded op stream through both packages'
`IndexService(bloom_fpr=0.02)` and a K = 3 `ShardedIndexService(bloom_fpr
=0.02)` — through ``flush()`` and, sharded, ``rebalance`` — gives equal
``contains`` answers and equal ``bloom_screened`` / ``bloom_fp`` counts
throughout; snapshot files with a screen load both ways."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.rmi import RMIConfig as RefRMIConfig  # noqa: E402
from repro.index_service import IndexService as RefService  # noqa: E402
from repro.index_service import ServiceConfig as RefConfig  # noqa: E402
from repro.index_service import ShardedIndexService as RefSharded  # noqa: E402
from repro.index_service.snapshot import IndexSnapshot as RefSnapshot  # noqa: E402
from repro.index_service.snapshot import build_snapshot as ref_build_snapshot  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import RMIConfig  # noqa: E402
from repro_torch.data import gen_maps  # noqa: E402
from repro_torch.index_service import (  # noqa: E402
    IndexService,
    IndexSnapshot,
    ServiceConfig,
    ShardedIndexService,
)
from repro_torch.index_service.snapshot import build_snapshot  # noqa: E402

FPR = 0.02


def _pair(k, n=6_000, capacity=256):
    base = gen_maps(n, seed=21 + k)
    cfg = dict(bloom_fpr=FPR, delta_capacity=capacity)
    if k == 1:
        return base, (RefService(base, RefConfig(strategy="xla_fused", **cfg)),
                      IndexService(base, ServiceConfig(strategy="torch_fused", **cfg),
                                   device="cpu"))
    return base, (RefSharded(base, RefConfig(strategy="xla_fused", num_shards=k, **cfg)),
                  ShardedIndexService(base, ServiceConfig(strategy="torch_fused",
                                                          num_shards=k, **cfg),
                                      device="cpu"))


def _screen_stats(svc):
    c = svc.stats_summary()["contains"]
    return c["bloom_screened"], c["bloom_fp"], c["count"]


def _shard_stats(svc):
    return [(int(sh.stats["bloom_screened"]), int(sh.stats["bloom_fp"]))
            for sh in svc.shards]


@pytest.mark.parametrize("k", [1, 3])
def test_screened_contains_matches_reference(k):
    base, (refs, port) = _pair(k)
    rng = np.random.default_rng(k)
    live = set(base.tolist())
    screened_at_start = None
    for step in range(24):
        ins = rng.uniform(-180, 180, 15)
        assert port.insert(ins) == refs.insert(ins)
        live |= set(ins.tolist())
        dels = rng.choice(np.array(sorted(live)), 10)
        assert port.delete(dels) == refs.delete(dels)
        live -= set(dels.tolist())
        if step % 4 == 0:
            arr = np.array(sorted(live))
            q = np.concatenate([rng.choice(arr, 300), ins, dels, rng.choice(base, 50),
                                rng.uniform(-181, 181, 400)])
            got = port.contains(q)
            assert np.array_equal(got, refs.contains(q))
            assert np.array_equal(got, np.isin(q, arr))
            assert _screen_stats(port) == _screen_stats(refs)
            if screened_at_start is None:
                screened_at_start = _screen_stats(port)[0]
        if step == 10:
            port.flush()
            refs.flush()
        if step == 16 and k > 1:
            port.rebalance(2)
            refs.rebalance(2)
            assert np.array_equal(port.router.boundaries, refs.router.boundaries)
            # every reshaped shard carries a screen over its own keys
            assert all(sh._mgr.current().bloom is not None for sh in port.shards)
    port.flush()
    refs.flush()
    arr = np.array(sorted(live))
    q = np.concatenate([arr, rng.uniform(-181, 181, 2_000)])
    assert np.array_equal(port.contains(q), refs.contains(q))
    screened, fp, count = _screen_stats(port)
    assert (screened, fp, count) == _screen_stats(refs)
    assert screened_at_start > 0 and screened > screened_at_start and fp > 0
    if k > 1:
        assert _shard_stats(port) == _shard_stats(refs)
        assert port.stats_summary()["bloom_screened"] == refs.stats_summary()["bloom_screened"]
    # after the flush each snapshot's screen equals the reference's, word for word
    snaps = ([port._mgr.current()] if k == 1 else [s._mgr.current() for s in port.shards])
    rsnaps = ([refs._mgr.current()] if k == 1 else [s._mgr.current() for s in refs.shards])
    for ps, rs in zip(snaps, rsnaps):
        assert (ps.bloom.num_bits, ps.bloom.num_hashes) == (rs.bloom.num_bits,
                                                            rs.bloom.num_hashes)
        assert np.array_equal(ps.bloom.words, rs.bloom.words)


def _npz_arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_snapshot_files_with_a_screen_load_both_ways(tmp_path):
    raw = gen_maps(3_000, seed=13)
    cfg = dict(num_leaves=64, stage0_hidden=(), stage0_train_steps=0)
    rsnap, _ = ref_build_snapshot(raw, config=RefRMIConfig(**cfg), bloom_fpr=FPR)
    psnap, _ = build_snapshot(raw, config=RMIConfig(**cfg), bloom_fpr=FPR, device="cpu")
    assert np.array_equal(psnap.bloom.words, rsnap.bloom.words)
    a = _npz_arrays(rsnap.save(str(tmp_path / "ref")))
    b = _npz_arrays(psnap.save(str(tmp_path / "port")))
    assert sorted(a) == sorted(b) and "bloom_words" in a
    for key in a:
        assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key], equal_nan=True)
    loaded_port = IndexSnapshot.load(str(tmp_path / "ref" / "snapshot-000000.npz"),
                                     device="cpu")
    loaded_ref = RefSnapshot.load(str(tmp_path / "port" / "snapshot-000000.npz"))
    carried = convert.snapshot_from_reference(rsnap, device="cpu")
    q = np.concatenate([raw[::7], np.random.default_rng(2).uniform(-181, 181, 3_000)])
    want = rsnap.bloom.contains(q)
    for snap in (loaded_port, loaded_ref, carried):
        assert (snap.bloom.num_bits, snap.bloom.num_hashes) == (rsnap.bloom.num_bits,
                                                                rsnap.bloom.num_hashes)
        assert np.array_equal(snap.bloom.contains(q), want)
    assert carried.bloom.words is not rsnap.bloom.words
    # a service restarts from the reference's files with its screen
    ref = RefService(raw, RefConfig(bloom_fpr=FPR, snapshot_dir=str(tmp_path / "svc")))
    ref.save(str(tmp_path / "svc"))
    port = IndexService.load(str(tmp_path / "svc"), device="cpu")
    assert port._mgr.current().bloom is not None
    assert np.array_equal(port.contains(q), ref.contains(q))
    assert _screen_stats(port)[:2] == _screen_stats(ref)[:2]
