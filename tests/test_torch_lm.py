"""The port's dense LM serving path against the reference: reduced yi-6b
and yi-9b with the reference's parameters carried across
(`convert.lm_params_from_reference`), `prefill` logits and KV cache and
eight `decode_step`s, at 2e-2 in bfloat16 and 1e-4 in a float32 copy of
each config; the port's prefill against its own sequential decode
(the reference's `tests/test_models.py` contract); `rmsnorm`,
`apply_rope` and `swiglu` against the reference in bfloat16; and the
families the port does not hold yet raising.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCHS, REDUCED, get_arch  # noqa: E402
from repro_torch.models import get_model, layers  # noqa: E402

TOL = {"bfloat16": 2e-2, "float32": 1e-4}
B, S, STEPS = 2, 24, 8


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _pair(name, dtype):
    """(reference api, reference params, port api, port params) with the
    reference's parameters carried across."""
    jcfg = dataclasses.replace(jax_get_arch(name, reduced=True), dtype=dtype)
    cfg = dataclasses.replace(get_arch(name, reduced=True), dtype=dtype)
    japi = jax_get_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    params = convert.lm_params_from_reference(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return japi, jparams, get_model(cfg, "cpu"), params


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", ["yi-6b", "yi-9b"])
def test_prefill_and_decode_match_reference(name, dtype):
    japi, jparams, api, params = _pair(name, dtype)
    tol = TOL[dtype]
    toks = _tokens(api.cfg, (B, S))
    jl, jc = japi.prefill(jparams, {"tokens": jnp.asarray(toks)})
    logits, cache = api.prefill(params, {"tokens": torch.as_tensor(toks)})
    assert logits.dtype == layers.dtype_of(dtype)
    assert logits.shape == (B, api.cfg.padded_vocab) and cache["len"] == int(jc["len"]) == S
    np.testing.assert_allclose(_f32(logits), _f32(jl), atol=tol, rtol=tol)
    for key in ("k", "v"):
        assert tuple(cache[key].shape) == jc[key].shape
        np.testing.assert_allclose(_f32(cache[key]), _f32(jc[key]), atol=tol, rtol=tol)

    jcache = japi.init_cache(B, STEPS + 2)
    cache = api.init_cache(B, STEPS + 2)
    for t in range(STEPS):
        jl, jcache = japi.decode(jparams, jcache, jnp.asarray(toks[:, t]))
        logits, cache = api.decode(params, cache, torch.as_tensor(toks[:, t]))
        np.testing.assert_allclose(_f32(logits), _f32(jl), atol=tol, rtol=tol)
    assert cache["len"] == int(jcache["len"]) == STEPS
    np.testing.assert_allclose(_f32(cache["k"]), _f32(jcache["k"]), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_prefill_matches_sequential_decode(dtype):
    """Prefill(prompt) equals decoding the prompt token by token (the
    reference's parallel/sequential contract, `tests/test_models.py`)."""
    cfg = dataclasses.replace(REDUCED["yi-6b"], dtype=dtype)
    api = get_model(cfg, "cpu")
    params = api.init(torch.Generator().manual_seed(0))
    toks = torch.as_tensor(_tokens(cfg, (B, 16), seed=1))
    lp, _ = api.prefill(params, {"tokens": toks})
    cache = api.init_cache(B, 20)
    for t in range(toks.shape[1]):
        ld, cache = api.decode(params, cache, toks[:, t])
    np.testing.assert_allclose(_f32(lp), _f32(ld), atol=2e-2, rtol=2e-2)
    assert bool((lp.argmax(-1) == ld.argmax(-1)).all())


def test_decode_updates_the_cache_in_place():
    api = get_model(REDUCED["yi-6b"], "cpu")
    params = api.init(torch.Generator().manual_seed(0))
    cache = api.init_cache(2, 8)
    k0 = cache["k"]
    _, out = api.decode(params, cache, torch.tensor([1, 2]))
    assert out["k"] is k0 and out["len"] == 1
    assert bool(k0[:, :, :, 0].abs().sum(-1).gt(0).all())   # position 0 written
    assert not bool(k0[:, :, :, 1:].any())                    # nothing else


def _bf16_pair(shape, seed, scale=1.0):
    a = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def test_rmsnorm_matches_reference_in_bf16():
    jx, tx = _bf16_pair((3, 5, 64), 0, 3.0)
    js, ts = _bf16_pair((64,), 1)
    got = layers.rmsnorm(tx, ts)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(jax_layers.rmsnorm(jx, js)), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_reference_in_bf16(theta):
    jx, tx = _bf16_pair((2, 4, 10, 32), 2)
    pos = np.arange(10, dtype=np.int32) * 7
    want = jax_layers.apply_rope(jx, jnp.asarray(pos), theta)
    got = layers.apply_rope(tx, torch.as_tensor(pos), theta)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(_f32(layers.rope_freqs(32, theta)),
                               _f32(jax_layers.rope_freqs(32, theta)), rtol=1e-6)


def test_swiglu_matches_reference_in_bf16():
    jx, tx = _bf16_pair((2, 3, 32), 3)
    ws = [_bf16_pair(shape, 4 + i, 0.2) for i, shape in
          enumerate([(32, 48), (32, 48), (48, 32)])]
    want = jax_layers.swiglu(jx, *(w[0] for w in ws))
    got = layers.swiglu(tx, *(w[1] for w in ws))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-2, rtol=2e-2)


def test_configs_are_the_references():
    from repro.configs import ARCHS as JAX_ARCHS, REDUCED as JAX_REDUCED
    for table, jtable in ((ARCHS, JAX_ARCHS), (REDUCED, JAX_REDUCED)):
        assert table.keys() == jtable.keys()
        for name in table:
            assert dataclasses.asdict(table[name]) == dataclasses.asdict(jtable[name])


@pytest.mark.parametrize("name,item", [
    ("olmoe-1b-7b", "MoE"), ("moonshot-v1-16b-a3b", "MoE"), ("xlstm-1.3b", "ssm"),
    ("jamba-1.5-large-398b", "hybrid"), ("llava-next-mistral-7b", "vlm"),
    ("seamless-m4t-large-v2", "audio"),
])
def test_families_not_ported_raise(name, item):
    with pytest.raises(NotImplementedError, match=f"{item}.*ROADMAP queue A"):
        get_model(REDUCED[name], "cpu")


def test_training_and_moe_ffn_raise_until_ported():
    """Training is ported (the dense family's `loss` runs); the MoE FFN
    still raises, naming its ROADMAP item."""
    api = get_model(REDUCED["yi-6b"], "cpu")
    params = api.init(torch.Generator().manual_seed(0))
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    loss, metrics = api.loss(params, {"tokens": tokens, "labels": tokens})
    assert loss.ndim == 0 and bool(torch.isfinite(loss))
    assert set(metrics) == {"loss", "nll", "aux"}
    from repro_torch.models import transformer
    moe = dataclasses.replace(REDUCED["yi-6b"], num_experts=4)
    with pytest.raises(NotImplementedError, match="MoE.*item 5"):
        transformer._ffn(moe, {}, torch.zeros(1, 1, 64))


def test_batch_spec_mirrors_the_reference():
    from repro.configs import SHAPES as JAX_SHAPES
    api = get_model(REDUCED["yi-6b"], "cpu")
    japi = jax_get_model(jax_get_arch("yi-6b", reduced=True))
    for shape in JAX_SHAPES.values():
        got = api.batch_spec(shape)
        want = japi.batch_spec(shape)
        assert {k: v[0] for k, v in got.items()} == {k: v[0] for k, v in want.items()}
        assert all(v[1] == torch.int32 for v in got.values())
