"""The port's plain kernel versions against the reference's kernels.

An index and delta built by the reference, carried across with
`repro_torch.convert`, give the same ``(base_lb, merged_rank)`` through
the port's `rmi_merged_lookup_reference` as through the reference's XLA
fallback and its Pallas kernel (interpret mode), and the same base
lower bound through `rmi_lookup_reference` as through
`rmi_lookup_pallas` — on every query: stored, absent, staged and
out of range, over the parity suite's four key distributions.  The
`cuda`-marked test holds the CUDA kernels against the plain versions on
the card.
"""

import functools
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import RMIConfig, build_rmi, make_keyset  # noqa: E402
from repro.index_service.delta import combine_for_device  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.rmi_lookup import (  # noqa: E402
    rmi_lookup_pallas,
    rmi_merged_lookup_pallas,
    stage0_flat as jax_stage0_flat,
)
from test_lookup_parity import DISTRIBUTIONS, _staged_delta  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ref as port_ref  # noqa: E402
from repro_torch.kernels import rmi_lookup  # noqa: E402

BATCHES = (1, 777, 1025)


@functools.lru_cache(maxsize=None)
def _case(dist, hidden=(), steps=0):
    rng = np.random.default_rng(zlib.crc32(dist.encode()))
    ks = make_keyset(DISTRIBUTIONS[dist](rng, 4_000))
    idx = build_rmi(ks, RMIConfig(
        num_leaves=max(16, ks.n // 48), stage0_hidden=hidden,
        stage0_train_steps=steps,
    ))
    delta = _staged_delta(np.random.default_rng(17), ks)
    # both deltas pad to 256 slots, so the interpret-mode kernels
    # compile once per batch shape
    deltas = {
        "empty": combine_for_device(None, None, ks.normalize, min_pad=256),
        "staged": combine_for_device(None, delta, ks.normalize, min_pad=256),
    }
    r = np.random.default_rng(2)
    span = ks.hi - ks.lo
    pool = np.concatenate([
        ks.norm[r.choice(ks.n, 600)],
        ks.normalize(r.uniform(ks.raw[0], ks.raw[-1], 600)),
        ks.normalize(np.concatenate([delta.ins_keys, delta.del_keys])),
        np.nextafter(ks.norm[r.choice(ks.n, 100)], np.float32(np.inf)),
    ]).astype(np.float32)
    out_of_range = np.concatenate([
        np.array([-1e30, 1e30, -1.0, 2.0], np.float32),
        ks.normalize(np.array([ks.lo - 1, ks.hi + 1, ks.lo - span, ks.hi + span])),
    ]).astype(np.float32)
    return ks, idx, deltas, pool, out_of_range


def _queries(pool, out_of_range, batch, seed):
    q = np.random.default_rng(seed).choice(pool, batch)
    k = min(batch, out_of_range.size)
    q[:k] = out_of_range[:k]
    return q


def _port_args(idx, ks, q):
    pi = convert.index_from_reference(idx)
    t = torch.as_tensor
    arrs = (t(q), rmi_lookup.stage0_flat(pi.stage0_params, "cpu"),
            *(t(a) for a in (pi.leaf_w, pi.leaf_b, pi.err_lo, pi.err_hi)),
            t(np.array(ks.norm)))
    kw = dict(hidden=pi.hidden, n=pi.n, num_leaves=pi.num_leaves,
              max_window=pi.max_window)
    return arrs, kw


def _jax_args(idx, ks, q):
    return (jnp.asarray(q), jax_stage0_flat(idx.stage0_params),
            *(jnp.asarray(a) for a in (idx.leaf_w, idx.leaf_b, idx.err_lo,
                                       idx.err_hi, ks.norm)))


@pytest.mark.parametrize("dist", list(DISTRIBUTIONS))
def test_plain_versions_match_reference_kernels(dist):
    ks, idx, deltas, pool, oor = _case(dist)
    jkw = dict(n=idx.n, num_leaves=idx.num_leaves, max_window=idx.max_window)
    for batch in BATCHES:
        q = _queries(pool, oor, batch, batch)
        arrs, kw = _port_args(idx, ks, q)
        jargs = _jax_args(idx, ks, q)
        base = port_ref.rmi_lookup_reference(*arrs, **kw).numpy()
        want = rmi_lookup_pallas(*jargs, hidden=idx.config.stage0_hidden,
                                 interpret=True, **jkw)
        assert np.array_equal(base, np.asarray(want)), (dist, batch)
        for dname, (dk, dp) in deltas.items():
            pb, pm = port_ref.rmi_merged_lookup_reference(
                *arrs, torch.as_tensor(dk), torch.as_tensor(dp), **kw)
            kb, km = rmi_merged_lookup_pallas(
                *jargs, jnp.asarray(dk), jnp.asarray(dp),
                hidden=idx.config.stage0_hidden, interpret=True, **jkw)
            xb, xm = jax_ref.rmi_merged_lookup_reference(
                *jargs, jnp.asarray(dk), jnp.asarray(dp), **jkw)
            for got, want in ((pb, kb), (pm, km), (pb, xb), (pm, xm)):
                assert np.array_equal(got.numpy(), np.asarray(want)), (dist, batch, dname)
            # stored keys: exact merged ranks in the float32 frame
            stored = np.isin(q, ks.norm)
            oracle = (np.searchsorted(ks.norm, q) + dp[np.searchsorted(dk, q)])
            assert np.array_equal(pm.numpy()[stored], oracle[stored])


def test_plain_versions_match_reference_mlp_stage0():
    """A one-hidden-layer stage-0 trained by the reference: the port's
    fixed-order sum and XLA's dot agree on these queries (a single
    product per hidden unit, then one sum of 16 in ascending order)."""
    ks, idx, deltas, pool, oor = _case("lognormal", hidden=(16,), steps=40)
    q = _queries(pool, oor, 777, 9)
    arrs, kw = _port_args(idx, ks, q)
    jargs = _jax_args(idx, ks, q)
    dk, dp = deltas["staged"]
    pb, pm = port_ref.rmi_merged_lookup_reference(
        *arrs, torch.as_tensor(dk), torch.as_tensor(dp), **kw)
    stored = np.isin(q, ks.norm)
    want = np.searchsorted(ks.norm, q) + dp[np.searchsorted(dk, q)]
    assert np.array_equal(pm.numpy()[stored], want[stored])
    xb, _ = jax_ref.rmi_merged_lookup_reference(
        *jargs, jnp.asarray(dk), jnp.asarray(dp), n=idx.n,
        num_leaves=idx.num_leaves, max_window=idx.max_window)
    assert np.array_equal(pb.numpy()[stored], np.asarray(xb)[stored])


def test_query_above_every_key_steps_past_n_like_the_reference():
    """Pinned reference behaviour (ROADMAP queue C): for a query above
    every stored key the fixed-trip search of `_base_lower_bound` steps
    to n + 1 when the window reaches n.  The port reproduces it; `get`
    refines it away on the host."""
    ks, idx, deltas, _, _ = _case("uniform")
    q = np.array([1e30, 2.0], np.float32)
    arrs, kw = _port_args(idx, ks, q)
    dk, dp = deltas["empty"]
    pb, _ = port_ref.rmi_merged_lookup_reference(
        *arrs, torch.as_tensor(dk), torch.as_tensor(dp), **kw)
    assert pb.tolist() == [ks.n + 1, ks.n + 1]


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [(), (16, 16)])
def test_cuda_kernels_match_plain_versions_on_card(hidden):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    ks, idx, deltas, pool, oor = _case("lognormal", hidden=hidden,
                                       steps=40 if hidden else 0)
    dev = torch.device("cuda")
    for batch in BATCHES + (1 << 16,):
        q = _queries(pool, oor, batch, batch)
        arrs, kw = _port_args(idx, ks, q)
        darrs = tuple(a.to(dev) for a in arrs)
        for dk, dp in deltas.values():
            d = (torch.as_tensor(dk, device=dev), torch.as_tensor(dp, device=dev))
            kb, km = rmi_lookup.rmi_merged_lookup_cuda(*darrs, *d, **kw)
            pb, pm = port_ref.rmi_merged_lookup_reference(*darrs, *d, **kw)
            assert torch.equal(kb, pb) and torch.equal(km, pm)
        assert torch.equal(rmi_lookup.rmi_lookup_cuda(*darrs, **kw),
                           port_ref.rmi_lookup_reference(*darrs, **kw))
        torch.cuda.synchronize()


def test_unpadded_power_of_two_delta_clamps_the_prefix_gather():
    """With exactly 64 staged entries nothing pads the delta, and a query
    above every staged key walks the delta search to D + 1.  The port
    clamps the prefix index like the reference's XLA fallback and gives
    the right merged rank (the reference's Pallas kernel reads past the
    prefix there: ROADMAP queue C)."""
    from repro.index_service.delta import DeltaBuffer
    ks = make_keyset(np.random.default_rng(0).uniform(0, 1e6, 2000))
    idx = build_rmi(ks, RMIConfig(num_leaves=40, stage0_hidden=(),
                                  stage0_train_steps=0))
    ins = np.setdiff1d(np.random.default_rng(1).uniform(0, 1e6, 80), ks.raw)[:64]
    buf = DeltaBuffer.from_arrays(ins, np.zeros(64, np.int64), np.empty(0), 64)
    dk, dp = combine_for_device(None, buf, ks.normalize)
    assert dk.size == 64 and np.isfinite(dk).all()
    q = np.array([ks.norm[-1], 0.5, 1e30], np.float32)
    arrs, kw = _port_args(idx, ks, q)
    pb, pm = port_ref.rmi_merged_lookup_reference(
        *arrs, torch.as_tensor(dk), torch.as_tensor(dp), **kw)
    xb, xm = jax_ref.rmi_merged_lookup_reference(
        *_jax_args(idx, ks, q), jnp.asarray(dk), jnp.asarray(dp),
        n=idx.n, num_leaves=idx.num_leaves, max_window=idx.max_window)
    assert np.array_equal(pm.numpy(), np.asarray(xm))
    assert pm[0] == ks.n - 1 + 64


def test_ops_dispatch_once_and_tag_the_plain_path_on_the_host():
    from repro_torch.kernels import ops
    ks, idx, deltas, pool, oor = _case("uniform")
    pi = convert.index_from_reference(idx)
    q = torch.as_tensor(_queries(pool, oor, 777, 3))
    dk, dp = deltas["staged"]
    ops.reset_dispatch_stats()
    with ops.count_dispatches() as n:
        b1, m1 = ops.rmi_merged_lookup_op(pi, ks.norm, q, dk, dp)
        assert n() == 1
    b2, m2 = ops.rmi_merged_lookup_op(pi, ks.norm, q, dk, dp, use_kernel=False)
    base = ops.rmi_lookup_op(pi, ks.norm, q)
    assert torch.equal(b1, b2) and torch.equal(m1, m2) and torch.equal(base, b1)
    rows = {(r["op"], r["strategy"]): r["path"] for r in ops.dispatch_summary()["rows"]}
    assert rows == {("rmi_merged_lookup", "cuda_fused"): "plain",
                    ("rmi_merged_lookup", "torch_fused"): "plain",
                    ("rmi_lookup", "cuda"): "plain"}
