"""The port's RMI core against the reference: same generators, same
build arrays for the linear stage-0, same leaf assignment (up to a
pinned FMA difference of the reference's XLA build on the CPU), exact
lookups with a port-trained MLP stage-0, and the four fixed-trip
searches equal on the same inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import rmi as ref_rmi  # noqa: E402
from repro.core import search as ref_search  # noqa: E402
from repro.core.keys import make_keyset as ref_make_keyset  # noqa: E402
from repro.data import datasets as ref_datasets  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import rmi as port_rmi  # noqa: E402
from repro_torch.core import search as port_search  # noqa: E402
from repro_torch.core.keys import make_keyset  # noqa: E402
from repro_torch.core.models import MLPSpec, mlp_init, mlp_train  # noqa: E402
from repro_torch.data import datasets  # noqa: E402
from repro_torch.kernels.rmi_lookup import rmi_lookup_cuda, stage0_flat  # noqa: E402

N = 4_000
ARRAYS = ("leaf_w", "leaf_b", "err_lo", "err_hi", "sigma", "seg_lo",
          "seg_hi", "is_btree")


def _raw(dist, n=N, seed=0):
    gen = {"maps": datasets.gen_maps, "lognormal": datasets.gen_lognormal}[dist]
    return gen(n, seed=seed)


def _linear_cfg(mod, n):
    return mod.RMIConfig(num_leaves=max(16, n // 48), stage0_hidden=(),
                         stage0_train_steps=0)


@pytest.mark.parametrize("name", ["gen_maps", "gen_lognormal"])
@pytest.mark.parametrize("seed", [0, 7])
def test_generators_match_reference(name, seed):
    a = getattr(datasets, name)(3_000, seed=seed)
    b = getattr(ref_datasets, name)(3_000, seed=seed)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("dist", ["maps", "lognormal"])
def test_linear_build_arrays_match_reference(dist):
    raw = _raw(dist)
    ks, rks = make_keyset(raw), ref_make_keyset(raw)
    assert np.array_equal(ks.norm, rks.norm)
    idx = port_rmi.build_rmi(ks, _linear_cfg(port_rmi, ks.n), device="cpu")
    ref = ref_rmi.build_rmi(rks, _linear_cfg(ref_rmi, rks.n))
    for k in ("w0", "b0"):
        assert np.array_equal(idx.stage0_params[k], ref.stage0_params[k])
    for k in ARRAYS:
        assert np.array_equal(getattr(idx, k), getattr(ref, k)), k
    assert idx.max_window == ref.max_window


def _unfused_leaf(q, w, b, ratio):
    p0 = (q * w).astype(np.float32) + b
    return np.floor(p0.astype(np.float32) * ratio)


def _fused_leaf(q, w, b, ratio):
    # f32 x f32 is exact in f64; one f64 add then one rounding to f32
    p0 = (q.astype(np.float64) * np.float64(w) + np.float64(b)).astype(np.float32)
    return np.floor(p0 * ratio)


def _flip_points(norm, w, b, ratio):
    """The exact float32 query where the (unfused) leaf changes, for
    every leaf boundary between two stored keys, by bisection over the
    float32 bit patterns (keys are non-negative, so bit order is value
    order)."""
    leaf = _unfused_leaf(norm, w, b, ratio)
    e = np.nonzero(leaf[1:] != leaf[:-1])[0]
    lo = norm[e].view(np.int32).astype(np.int64)
    hi = norm[e + 1].view(np.int32).astype(np.int64)
    target = leaf[e + 1]
    for _ in range(32):
        mid = (lo + hi) // 2
        up = _unfused_leaf(mid.astype(np.int32).view(np.float32), w, b, ratio) >= target
        hi = np.where(up, mid, hi)
        lo = np.where(up, lo, mid)
    return hi.astype(np.int32)


@pytest.mark.parametrize("dist", ["maps", "lognormal"])
def test_leaf_assignment_at_leaf_boundaries(dist):
    """Queries within two ulps of every exact leaf flip.  The port's
    build and lookup arithmetic is separately rounded; the reference's
    XLA build on the CPU contracts ``q*w + b`` into one FMA.  Pinned:
    the port equals the unfused float32 formula everywhere, and differs
    from the reference only at queries where FMA and unfused rounding
    pick different leaves (ROADMAP queue C)."""
    raw = _raw(dist)
    rks = ref_make_keyset(raw)
    m = max(16, rks.n // 48)
    ref = ref_rmi.build_rmi(rks, _linear_cfg(ref_rmi, rks.n))
    s0 = ref.stage0_params
    w, b = s0["w0"][0, 0], s0["b0"][0]
    ratio = np.float32(m / rks.n)
    flips = _flip_points(rks.norm, w, b, ratio)
    q = np.concatenate([(flips + k).view(np.float32) for k in range(-2, 3)])
    port_leaf = port_rmi.stage0_segments(s0, q, n=rks.n, m=m, device="cpu")
    ref_leaf = ref_rmi.stage0_segments(s0, q, n=rks.n, m=m)
    unfused = np.clip(_unfused_leaf(q, w, b, ratio), 0, m - 1)
    fused = np.clip(_fused_leaf(q, w, b, ratio), 0, m - 1)
    assert (fused != unfused).any(), "no query where the roundings differ"
    assert np.array_equal(port_leaf, unfused)
    assert ((ref_leaf == port_leaf) | (fused != unfused)).all()


def test_mlp_stage0_lookups_exact():
    """A (16,16) MLP stage-0 trained by the port: every stored key's
    lookup, through every search strategy and the kernel wrapper's plain
    version, equals np.searchsorted."""
    ks = make_keyset(_raw("lognormal", seed=3))
    idx = port_rmi.build_rmi(ks, port_rmi.RMIConfig(
        num_leaves=ks.n // 48, stage0_hidden=(16, 16), stage0_train_steps=60,
    ), device="cpu")
    want = np.searchsorted(ks.norm, ks.norm, side="left")
    q = torch.as_tensor(ks.norm)
    for strategy in port_search.STRATEGIES:
        got = port_rmi.compile_lookup(idx, ks, strategy, device="cpu")(q)
        assert np.array_equal(got.numpy(), want), strategy
    got = rmi_lookup_cuda(
        q, stage0_flat(idx.stage0_params, "cpu"),
        *(torch.as_tensor(a) for a in (idx.leaf_w, idx.leaf_b, idx.err_lo,
                                        idx.err_hi, ks.norm)),
        hidden=idx.hidden, n=idx.n, num_leaves=idx.num_leaves,
        max_window=idx.max_window,
    )
    assert np.array_equal(got.numpy(), want)


def test_mlp_train_is_seeded():
    x = np.linspace(0, 1, 500, dtype=np.float32)
    y = np.arange(500, dtype=np.float32)
    spec = MLPSpec(hidden=(8,))
    a = mlp_train(spec, x, y, steps=5, seed=3, device="cpu")
    b = mlp_train(spec, x, y, steps=5, seed=3, device="cpu")
    assert all(np.array_equal(a[k], b[k]) for k in a)
    p = mlp_init(spec, torch.Generator().manual_seed(0))
    assert p["w0"].shape == (1, 8) and p["b1"].shape == (1,)


@pytest.mark.parametrize("dist", ["maps", "lognormal"])
def test_searches_match_reference(dist):
    raw = _raw(dist, seed=1)
    rks = ref_make_keyset(raw)
    ref = ref_rmi.build_rmi(rks, _linear_cfg(ref_rmi, rks.n))
    rng = np.random.default_rng(5)
    q = np.concatenate([
        rks.norm[rng.choice(rks.n, 600)],
        rks.normalize(rng.uniform(rks.lo, rks.hi, 600)),
        np.array([-1e30, -1.0, 0.0, 1.0, 2.0, 1e30], np.float32),
    ]).astype(np.float32)
    pos, lo, hi, sig = (np.asarray(a) for a in ref_rmi.rmi_predict(
        ref.as_pytree(), jnp.asarray(q), n=ref.n, num_leaves=ref.num_leaves))
    elo, ehi = lo - pos, hi - pos
    mw = ref.max_window
    j = jnp.asarray
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    cases = {
        "lower_bound_full": ((rks.norm, q), ()),
        "model_binary_search": ((rks.norm, q, pos, elo, ehi), (mw,)),
        "biased_search": ((rks.norm, q, pos, elo, ehi, sig), (mw,)),
        "biased_quaternary_search": ((rks.norm, q, pos, elo, ehi, sig), (mw,)),
    }
    for name, (arrs, static) in cases.items():
        want = np.asarray(getattr(ref_search, name)(*map(j, arrs), *static))
        got = getattr(port_search, name)(*map(t, arrs), *static).numpy()
        assert np.array_equal(got, want), name


def test_refit_matches_reference():
    """Warm refit after deletes + inserts: the port's vectorized clean
    leaf check gives the reference loop's arrays and refit count."""
    raw = _raw("maps", seed=4)
    rng = np.random.default_rng(6)
    new_raw = np.union1d(np.delete(raw, rng.choice(raw.size, 200, replace=False)),
                         rng.uniform(-100, 100, 150))
    rks_old, rks_new = ref_make_keyset(raw), ref_make_keyset(new_raw)
    ref_old = ref_rmi.build_rmi(rks_old, _linear_cfg(ref_rmi, rks_old.n))
    want, want_refit = ref_rmi.refit_rmi(ref_old, rks_old, rks_new)
    got, got_refit = port_rmi.refit_rmi(
        convert.index_from_reference(ref_old), convert.keyset_from_reference(rks_old),
        make_keyset(new_raw), device="cpu",
    )
    assert got_refit == want_refit and 0 < got_refit < got.num_leaves
    for k in ARRAYS:
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    for k in want.stage0_params:
        assert np.array_equal(got.stage0_params[k], want.stage0_params[k])


def test_segment_reduce_equals_ufunc_at():
    rng = np.random.default_rng(8)
    vals = rng.normal(size=2000)
    for seg in (np.sort(rng.integers(0, 50, 2000)), rng.integers(0, 50, 2000)):
        for uf, init in ((np.minimum, 0.0), (np.maximum, 0.0)):
            want = np.full(60, init)
            uf.at(want, seg, vals)
            got = port_rmi._segment_reduce(uf, init, seg, vals, 60, np.float64)
            assert np.array_equal(got, want)


def test_window_bounds_cover_positions_above_2_24():
    """Above 2**24 keys float32 positions round to a coarser grid and the
    reference's floor/ceil residual bounds can miss a stored key's exact
    position (ROADMAP queue C).  The port tightens each key's bounds
    until its own float32 window arithmetic covers the exact position."""
    n = 2**24 + 2**21
    rng = np.random.default_rng(0)
    k = np.arange(n, dtype=np.int64)
    pred1 = np.clip((k + rng.normal(0.0, 3.0, n)).astype(np.float32), 0, n - 1)
    resid = np.arange(n, dtype=np.float32) - pred1
    lo_ref = (pred1 + np.floor(resid)).astype(np.int64)
    hi_ref = (pred1 + np.ceil(resid)).astype(np.int64) + 1
    assert ((lo_ref > k) | (hi_ref < k)).any(), "reference bounds never miss"
    e_lo, e_hi = port_rmi._key_window_bounds(pred1, resid)
    assert ((pred1 + e_lo).astype(np.int64) <= k).all()
    assert ((pred1 + e_hi).astype(np.int64) + 1 >= k).all()
    small = slice(0, 2**20)
    assert np.array_equal(e_lo[small], np.floor(resid[small]))


@pytest.mark.slow
def test_stored_keys_found_above_2_24():
    """End to end at 2**24 + 2**22 keys: every sampled stored key above
    2**24 is found at its float32 lower bound."""
    ks = make_keyset(datasets.gen_maps(2**24 + 2**22, seed=0))
    idx = port_rmi.build_rmi(ks, _linear_cfg(port_rmi, ks.n), device="cpu")
    sample = np.random.default_rng(1).integers(2**24, ks.n, 500_000)
    got = rmi_lookup_cuda(
        torch.as_tensor(ks.norm[sample]), stage0_flat(idx.stage0_params, "cpu"),
        *(torch.as_tensor(a) for a in (idx.leaf_w, idx.leaf_b, idx.err_lo,
                                        idx.err_hi, ks.norm)),
        hidden=(), n=idx.n, num_leaves=idx.num_leaves, max_window=idx.max_window,
    )
    assert np.array_equal(got.numpy(), np.searchsorted(ks.norm, ks.norm[sample]))


# ROADMAP queue C 15: 17 keys with 4 distinct float32 values make the
# build fit leaf 3 with a slope of ~2.5e8 and heavy cancellation.  The
# reference builds positions in NumPy (unfused) but looks up in XLA,
# which a CPU contracts into one FMA, so there the reference's own
# lookup misses 11 of the 17 stored keys; that depends on the CPU's
# contraction, so only the port's side is asserted.
C15_RAW = np.concatenate([[-415979315.0], np.linspace(-0.9, 0.99, 15), [833290259.0]])


@pytest.mark.parametrize("strategy", ["binary", "biased", "quaternary", "torch_fused"])
def test_c15_tied_float32_keys_are_all_found_at_their_lower_bound(strategy):
    from repro_torch.index_service.delta import combine_for_device
    from repro_torch.index_service.snapshot import build_snapshot

    cfg = port_rmi.RMIConfig(num_leaves=8, stage0_hidden=(), stage0_train_steps=0)
    ks = make_keyset(C15_RAW)
    assert np.unique(ks.norm).size == 4
    want = np.searchsorted(ks.norm, ks.norm)
    q = torch.as_tensor(ks.norm)
    if strategy == "torch_fused":
        snap, _ = build_snapshot(C15_RAW, config=cfg, device="cpu")
        assert np.array_equal(snap.keys.norm, ks.norm)
        dk, dp = combine_for_device(None, None, snap.keys.normalize)
        _, got = snap.merged_lookup_fn(strategy)(q, torch.as_tensor(dk), torch.as_tensor(dp))
    else:
        idx = port_rmi.build_rmi(ks, cfg, device="cpu")
        got = port_rmi.compile_lookup(idx, ks, strategy, device="cpu")(q)
    np.testing.assert_array_equal(got.numpy(), want)
