"""The port's MoE FFN (`repro_torch.models.moe`) against the reference's
(`repro.models.moe`, plain `jnp` on the CPU), from the same NumPy
inputs: both dispatches exactly (slots, destinations, tokens, gates and
buffers), `_top_k` on tied rows, `cdf_dispatch_slots` at
`benchmarks/moe_dispatch.py`'s inputs, `moe_ffn` in float32 with the
weights carried across, and the reduced olmoe-1b-7b and
moonshot-v1-16b-a3b in float32 (loss and every gradient under each
remat setting, prefill and decode).  Also pins ROADMAP queue C 23 (the
cdf key's score rounds away from expert 16 up) and C 24 (capacity 1 at
olmoe's decode shape).  The card's twins are in `test_torch_card.py`.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import get_model, moe  # noqa: E402
from repro_torch.train.train_step import loss_and_grads  # noqa: E402

MOE_ARCHS = ("olmoe-1b-7b", "moonshot-v1-16b-a3b")


def _np(a):
    return np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)


def _routing(t, e, k, seed, d=16):
    """(x (T, D), softmax scores (T, E), renormalised gate, expert ids)
    as float32 / int32 NumPy, the ids and gate from the reference's
    `_top_k`."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d)).astype(np.float32)
    logits = rng.standard_normal((t, e)).astype(np.float32) * 2
    scores = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    gate, eidx = (np.array(a) for a in jax_moe._top_k(jnp.asarray(scores), k))
    gate = gate / np.maximum(gate.sum(-1, keepdims=True), 1e-9)
    return x, scores, gate.astype(np.float32), eidx.astype(np.int32)


def _both(fn_j, fn_t, *arrays, **kw):
    """``fn_j`` on jnp arrays and ``fn_t`` on torch tensors of the same
    NumPy inputs (int32 ids widened to int64 for torch)."""
    tj = [torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a) for a in arrays]
    return fn_j(*(jnp.asarray(a) for a in arrays), **kw), fn_t(*tj, **kw)


# ---------------------------------------------------------------------------
# 1. the dispatch functions, exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity_factor", [1.0, 1.25, 8.0])
@pytest.mark.parametrize("k", [2, 6])
@pytest.mark.parametrize("dispatch", ["sort", "cdf"])
def test_dispatch_matches_reference_exactly(dispatch, k, capacity_factor):
    t, e = 96, 8
    x, scores, gate, eidx = _routing(t, e, k, seed=k)
    capacity = max(1, int(t * k / e * capacity_factor))
    (jb, jd, jst, jsg), (b, d, st, sg) = _both(
        functools.partial(jax_moe._dispatch_one_group, num_experts=e, capacity=capacity,
                          dispatch=dispatch),
        functools.partial(moe._dispatch_one_group, num_experts=e, capacity=capacity,
                          dispatch=dispatch),
        x, scores, gate, eidx)
    assert tuple(b.shape) == (e, capacity, x.shape[1]) == jb.shape
    for got, want in ((b, jb), (d, jd), (st, jst), (sg, jsg)):
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    if capacity_factor == 8.0:
        assert bool((sg != 0).all())
    # the functions below the group dispatch, on the same inputs
    if dispatch == "sort":
        for got, want in zip(moe.sort_dispatch(torch.from_numpy(x),
                                               torch.from_numpy(eidx).long(),
                                               torch.from_numpy(gate), e, capacity),
                             jax_moe.sort_dispatch(jnp.asarray(x), jnp.asarray(eidx),
                                                   jnp.asarray(gate), e, capacity)):
            np.testing.assert_array_equal(_np(got), np.asarray(want))
    else:
        flat_e = eidx.reshape(-1)
        flat_s = np.take_along_axis(scores, eidx, axis=1).reshape(-1)
        want, got = _both(functools.partial(jax_moe.cdf_dispatch_slots, num_experts=e,
                                            capacity=capacity),
                          functools.partial(moe.cdf_dispatch_slots, num_experts=e,
                                            capacity=capacity),
                          flat_s, flat_e)
        np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_top_k_takes_the_lower_index_first_on_ties_like_lax():
    rows = np.array([
        np.zeros(8),                               # an all-zero hidden row's scores
        np.full(8, 0.125),
        [0.1, 0.3, 0.3, 0.1, 0.3, 0.0, 0.1, 0.1],
        [0.5, 0.1, 0.1, 0.1, 0.1, 0.1, 0.0, 0.0],
        np.arange(8)[::-1] * 0.1,
    ], np.float32)
    for k in (1, 2, 3, 6, 8):
        want = jax.lax.top_k(jnp.asarray(rows), k)
        got = moe._top_k(torch.from_numpy(rows), k)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), np.asarray(w))
    np.testing.assert_array_equal(_np(moe._top_k(torch.zeros(1, 64), 8)[1])[0], np.arange(8))


# ---------------------------------------------------------------------------
# 2. the cdf slots at benchmarks/moe_dispatch.py's inputs, and C23
# ---------------------------------------------------------------------------

def _benchmark_inputs():
    """`benchmarks/moe_dispatch.py`'s router (E 32, K 4, T 65,536, seed 0):
    (flat scores, flat expert ids)."""
    e, k, t = 32, 4, 65_536
    rng = np.random.default_rng(0)
    popularity = 1.0 / (np.arange(e) + 1.0) ** 0.7
    logits = rng.normal(0, 1, (t, e)) + np.log(popularity)[None]
    scores = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    top = np.argsort(-scores, axis=1)[:, :k]
    return (np.take_along_axis(scores, top, axis=1).reshape(-1).astype(np.float32),
            top.reshape(-1).astype(np.int32))


def _drop_frac_reference(slots, expert_of, capacity):
    # benchmarks/moe_dispatch.py's `drop_frac_of`
    dest = expert_of * capacity + slots
    winner = np.full(32 * capacity, len(dest))
    np.minimum.at(winner, dest, np.arange(len(dest)))
    return 1.0 - (winner[dest] == np.arange(len(dest))).mean()


@pytest.mark.parametrize("capacity_factor", [1.0, 1.25, 1.5])
def test_cdf_slots_match_reference_at_the_benchmark_inputs(capacity_factor):
    flat_s, flat_e = _benchmark_inputs()
    capacity = int(65_536 * 4 / 32 * capacity_factor)
    want = np.asarray(jax.jit(lambda s, e: jax_moe.cdf_dispatch_slots(s, e, 32, capacity))(
        jnp.asarray(flat_s), jnp.asarray(flat_e)))
    got = moe.cdf_dispatch_slots(torch.from_numpy(flat_s), torch.from_numpy(flat_e).long(),
                                 32, capacity)
    np.testing.assert_array_equal(_np(got), want)
    # the port's collision rule (as `_dispatch_one_group` resolves it)
    dest = torch.from_numpy(flat_e).long() * capacity + got
    winner = torch.full((32 * capacity,), dest.numel(), dtype=torch.int64)
    winner.scatter_reduce_(0, dest, torch.arange(dest.numel()), "amin", include_self=True)
    port_drop = 1.0 - float((winner[dest] == torch.arange(dest.numel())).double().mean())
    ref_drop = _drop_frac_reference(want, flat_e, capacity)
    assert port_drop == pytest.approx(ref_drop, abs=0) and 0 < ref_drop < 0.5


def _order_slots(order_key, expert_of, e, capacity):
    """⌊rank / count · C⌋ per entry, rank within its expert by a stable
    sort on ``order_key``."""
    slots = np.empty(expert_of.size, np.int64)
    for x in range(e):
        idx = np.flatnonzero(expert_of == x)
        rank = np.empty(idx.size, np.int64)
        rank[np.argsort(order_key[idx], kind="stable")] = np.arange(idx.size)
        slots[idx] = np.clip((rank / max(idx.size, 1) * capacity).astype(np.int64),
                             0, capacity - 1)
    return slots


def test_c23_cdf_key_loses_the_score_from_expert_16_up_in_both_packages():
    """ROADMAP queue C 23 (reference behaviour, mirrored): the float32 key
    ``expert * 1e6 + score`` keeps the score for expert 0 (slots in score
    order) and rounds it away for experts >= 16 (ulp >= 1; slots in
    arrival order), E 64, T 4,096, C 80, scores in [0, 0.3)."""
    e, t, capacity = 64, 4096, 80
    rng = np.random.default_rng(23)
    expert_of = rng.integers(0, e, t).astype(np.int32)
    score = (rng.random(t) * 0.3).astype(np.float32)
    want = np.asarray(jax_moe.cdf_dispatch_slots(jnp.asarray(score), jnp.asarray(expert_of),
                                                 e, capacity))
    got = _np(moe.cdf_dispatch_slots(torch.from_numpy(score),
                                     torch.from_numpy(expert_of).long(), e, capacity))
    np.testing.assert_array_equal(got, want)
    by_score = _order_slots(score, expert_of, e, capacity)
    by_arrival = _order_slots(np.arange(t), expert_of, e, capacity)
    zero = expert_of == 0
    high = expert_of >= 16
    np.testing.assert_array_equal(got[zero], by_score[zero])
    np.testing.assert_array_equal(got[high], by_arrival[high])
    assert not np.array_equal(by_score[high], by_arrival[high])


# ---------------------------------------------------------------------------
# 3. moe_ffn and C24
# ---------------------------------------------------------------------------

def _ffn_weights(d, e, f, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)
            for shape in ((d, e), (e, d, f), (e, d, f), (e, f, d))]


def _ffn_pair(x, weights, **kw):
    (jy, jaux), (y, aux) = _both(jax_moe.moe_ffn, moe.moe_ffn, x, *weights, **kw)
    return jy, jaux, y, aux


@pytest.mark.parametrize("dispatch", ["sort", "cdf"])
def test_moe_ffn_matches_reference_in_float32(dispatch):
    x = np.random.default_rng(5).standard_normal((2, 40, 32)).astype(np.float32)
    jy, jaux, y, aux = _ffn_pair(x, _ffn_weights(32, 8, 48, 6), experts_per_token=2,
                                 capacity_factor=1.0, dispatch=dispatch)
    assert y.dtype == torch.float32 and tuple(y.shape) == x.shape
    jy = np.asarray(jy)
    assert np.abs(_np(y) - jy).max() <= 1e-5 * np.abs(jy).max()
    assert float(aux["moe_aux_loss"]) == pytest.approx(float(jaux["moe_aux_loss"]), rel=1e-6)
    assert float(aux["moe_drop_frac"]) == float(jaux["moe_drop_frac"]) > 0


@pytest.mark.parametrize("dispatch", ["sort", "cdf"])
def test_c24_decode_capacity_is_one_at_olmoes_shape(dispatch):
    """ROADMAP queue C 24 (reference behaviour, mirrored): 8 decode slots
    of olmoe (E 64, top-8) give capacity max(1, int(8·8/64·1.25)) = 1, so
    about a third of the (token, expert) pairs drop in both packages;
    at capacity factor E/k none does."""
    x = np.random.default_rng(24).standard_normal((8, 1, 32)).astype(np.float32)
    weights = _ffn_weights(32, 64, 16, 25)
    drops = []
    for cf in (1.25, 64 / 8):
        jy, jaux, y, aux = _ffn_pair(x, weights, experts_per_token=8, capacity_factor=cf,
                                     dispatch=dispatch)
        assert float(aux["moe_drop_frac"]) == float(jaux["moe_drop_frac"])
        assert np.abs(_np(y) - np.asarray(jy)).max() <= 1e-5 * np.abs(np.asarray(jy)).max()
        drops.append(float(aux["moe_drop_frac"]))
    assert 0.2 < drops[0] < 0.5 and drops[1] == 0.0


# ---------------------------------------------------------------------------
# 4. the reduced MoE models in float32
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _pair(name):
    """(reference api, reference params, port params) in float32, the
    reference's parameters carried across."""
    jcfg = dataclasses.replace(jax_get_arch(name, reduced=True), dtype="float32")
    cfg = dataclasses.replace(get_arch(name, reduced=True), dtype="float32")
    japi = jax_get_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    return japi, jparams, convert.lm_params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _batch(vocab, seed=0, b=2, s=24):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@functools.lru_cache(maxsize=None)
def _reference_grads(name):
    japi, jparams, _ = _pair(name)
    batch = _batch(japi.cfg.vocab_size)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(japi.loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return batch, float(loss), float(metrics["aux"]), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("remat", ["off", "full", "block_io"])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_reduced_moe_loss_and_grads_match_reference(name, remat):
    batch, jloss, jaux, jgrads = _reference_grads(name)
    _, _, params = _pair(name)
    cfg = dataclasses.replace(get_arch(name, reduced=True), dtype="float32",
                              remat=remat != "off",
                              remat_policy="full" if remat == "off" else remat)
    api = get_model(cfg, "cpu")
    loss, metrics, grads = loss_and_grads(
        api.loss, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(loss) == pytest.approx(jloss, rel=1e-5)
    assert float(metrics["aux"]) == pytest.approx(jaux, rel=1e-5) and jaux > 0
    leaves = [("embed", grads["embed"], jgrads["embed"]),
              ("final_norm", grads["final_norm"], jgrads["final_norm"])]
    leaves += [(f"blocks.{i}.{n}", blk[n], w[i]) for n, w in jgrads["blocks"].items()
               for i, blk in enumerate(grads["blocks"])]
    assert {n for n, _, _ in leaves} >= {"blocks.0.router", "blocks.1.we_down"}
    for leaf, g, w in leaves:
        err = float(np.abs(_np(g) - w).max())
        assert err <= 1e-4 * float(np.abs(w).max()), (leaf, err)


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_reduced_moe_prefill_and_decode_match_reference(name):
    japi, jparams, params = _pair(name)
    api = get_model(dataclasses.replace(get_arch(name, reduced=True), dtype="float32"), "cpu")
    toks = _batch(api.cfg.vocab_size, seed=1)["tokens"]
    jl, jc = japi.prefill(jparams, {"tokens": jnp.asarray(toks)})
    logits, cache = api.prefill(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(logits), np.asarray(jl), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(cache["k"]), np.asarray(jc["k"]), atol=1e-4, rtol=1e-4)
    jcache, cache = japi.init_cache(2, 8), api.init_cache(2, 8)
    jdecode = jax.jit(japi.decode)
    for t in range(6):
        jl, jcache = jdecode(jparams, jcache, jnp.asarray(toks[:, t]))
        logits, cache = api.decode(params, cache, torch.from_numpy(toks[:, t]))
        np.testing.assert_allclose(_np(logits), np.asarray(jl), atol=1e-4, rtol=1e-4)


def test_moe_cdf_and_sort_dispatch_agree_when_no_drops():
    """The twin of the reference's `tests/test_models.py` case: with a
    generous capacity both dispatches compute the same FFN."""
    cfg = dataclasses.replace(get_arch("olmoe-1b-7b", reduced=True), capacity_factor=8.0,
                              moe_dispatch="sort")
    api_s, api_c = get_model(cfg, "cpu"), get_model(
        dataclasses.replace(cfg, moe_dispatch="cdf"), "cpu")
    params = api_s.init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab_size, seed=2).items()}
    l_s, _ = api_s.loss(params, batch)
    l_c, _ = api_c.loss(params, batch)
    np.testing.assert_allclose(float(l_s), float(l_c), rtol=1e-3)
