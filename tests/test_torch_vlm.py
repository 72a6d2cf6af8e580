"""The port's vlm family (`repro_torch.models.vlm`, llava-next-mistral-7b)
against the reference's (`repro.models.vlm`, plain `jnp` on the CPU),
from the same NumPy inputs and the reference's parameters carried across
by `convert`, in float32, on the reduced config: the projector, the
training logits, the loss and every gradient under each remat setting,
prefill and decode; `convert` carries the projector and refuses another
config's tree; prefill of a prompt less its last tokens, then decode
steps, against the whole prompt's prefill; ROADMAP queue C 26 (the
reference's prefill cache length is ``d_model``, the port's is
T_img + S_text); 16 requests through both packages' `ServeEngine`; and
the bf16 prefill parting from float32 alike in both packages.  The
card's twins are in `test_torch_card.py`.
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
from repro.models import vlm as jax_vlm  # noqa: E402
from repro.obs.metrics import MetricsRegistry as JaxRegistry  # noqa: E402
from repro.serve import engine as jax_engine  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import get_model, transformer, vlm  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train.optimizer import tree_leaves  # noqa: E402
from repro_torch.train.train_step import loss_and_grads  # noqa: E402

ARCH = "llava-next-mistral-7b"


def _np(a):
    return np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)


def _cfgs(**kw):
    kw = {"dtype": "float32", **kw}
    return (dataclasses.replace(jax_get_arch(ARCH, reduced=True), **kw),
            dataclasses.replace(get_arch(ARCH, reduced=True), **kw))


def _close(got, want, tol=1e-4, what=""):
    want = np.asarray(want)
    err = float(np.abs(_np(got) - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err, float(np.abs(want).max()))


@functools.lru_cache(maxsize=None)
def _pair():
    """(reference api, reference params, port params) in float32."""
    jcfg, cfg = _cfgs()
    japi = jax_get_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    return japi, jparams, convert.lm_params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _batch(cfg, seed=0, b=2, s=24):
    """Text tokens and labels (B, S_text) and unit-normal patches (B,
    T_img, F), as NumPy arrays."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    patches = rng.standard_normal((b, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "patches": patches}


def _jx(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tx(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# 1. the projector, the parameters
# ---------------------------------------------------------------------------

def test_project_matches_reference():
    """The two-layer projector with GELU in its tanh form (the default of
    ``jax.nn.gelu``)."""
    _, jparams, params = _pair()
    patches = _batch(_cfgs()[1], seed=3)["patches"]
    _close(vlm._project(params, torch.from_numpy(patches)),
           jax_vlm._project(jparams, jnp.asarray(patches)), 1e-5)


def test_init_draws_the_reference_layout_and_dtypes():
    jcfg, cfg = _cfgs(dtype="bfloat16")
    jparams = jax_get_model(jcfg).init(jax.random.PRNGKey(0))
    params = get_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    assert set(params) == set(jparams)
    for name, shape in vlm.projector_shapes(cfg).items():
        assert tuple(params[name].shape) == shape == jparams[name].shape
        assert params[name].dtype == torch.bfloat16
    assert not params["proj_b1"].any() and not params["proj_b2"].any()
    assert len(params["blocks"]) == cfg.num_layers
    for blk in params["blocks"]:
        assert {n: tuple(w.shape) for n, w in blk.items()} == transformer.block_param_shapes(cfg)
    assert all(w.dtype == torch.bfloat16 for w in tree_leaves(params))


def test_convert_carries_the_projector_and_refuses_other_trees():
    jcfg, cfg = _cfgs(dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jax_get_model(jcfg).init(jax.random.PRNGKey(1)))
    params = convert.lm_params_from_reference(tree, cfg, "cpu")
    for name in vlm.projector_shapes(cfg):
        assert params[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(params[name].float()), tree[name].astype(np.float32))
    with pytest.raises(ValueError, match="proj_w1.*config has"):     # another frontend width
        convert.lm_params_from_reference(tree, dataclasses.replace(cfg, frontend_dim=16), "cpu")
    with pytest.raises(ValueError, match="proj_b2 missing"):
        convert.lm_params_from_reference(
            {k: v for k, v in tree.items() if k != "proj_b2"}, cfg, "cpu")


# ---------------------------------------------------------------------------
# 2. training: logits, loss, gradients
# ---------------------------------------------------------------------------

def test_forward_train_covers_the_text_part_like_the_reference():
    japi, jparams, params = _pair()
    jcfg, cfg = _cfgs()
    batch = _batch(cfg, seed=1)
    jl, jaux = jax_vlm.forward_train(jcfg, jparams, jnp.asarray(batch["tokens"]),
                                     jnp.asarray(batch["patches"]))
    logits, aux = vlm.forward_train(cfg, params, torch.from_numpy(batch["tokens"]),
                                    torch.from_numpy(batch["patches"]))
    assert tuple(logits.shape) == jl.shape == (2, 24, cfg.padded_vocab)
    _close(logits, jl)
    assert float(aux) == float(jaux) == 0.0


@functools.lru_cache(maxsize=None)
def _reference_grads():
    japi, jparams, _ = _pair()
    batch = _batch(japi.cfg)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(japi.loss, has_aux=True))(
        jparams, _jx(batch))
    return batch, float(loss), float(metrics["nll"]), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("remat", ["off", "full", "block_io"])
def test_reduced_llava_loss_and_grads_match_reference(remat):
    """The loss within 1e-5 relative and every gradient (the projector's
    too) within 1e-4 x its max, under each remat setting."""
    batch, jloss, jnll, jgrads = _reference_grads()
    _, _, params = _pair()
    _, cfg = _cfgs(remat=remat != "off", remat_policy="full" if remat == "off" else remat)
    loss, metrics, grads = loss_and_grads(get_model(cfg, "cpu").loss, params, _tx(batch))
    assert float(loss) == pytest.approx(jloss, rel=1e-5)
    assert float(metrics["nll"]) == pytest.approx(jnll, rel=1e-5)
    assert float(metrics["aux"]) == 0.0
    want = convert.lm_params_from_reference(jgrads, cfg, "cpu")
    assert float(np.abs(_np(grads["proj_w1"])).max()) > 0
    for g, w in zip(tree_leaves(grads), tree_leaves(want)):
        _close(g, w)


# ---------------------------------------------------------------------------
# 3. serving: prefill, decode, C26
# ---------------------------------------------------------------------------

def test_reduced_llava_prefill_and_decode_match_reference():
    japi, jparams, params = _pair()
    api = get_model(_cfgs()[1], "cpu")
    batch = _batch(api.cfg, seed=2)
    del batch["labels"]
    jl, jc = japi.prefill(jparams, _jx(batch))
    logits, cache = api.prefill(params, _tx(batch))
    _close(logits, jl)
    for name in ("k", "v"):
        assert tuple(cache[name].shape) == jc[name].shape
        _close(cache[name], jc[name], what=name)
    jcache, cache = japi.init_cache(2, 8), api.init_cache(2, 8)
    jdecode = jax.jit(japi.decode)
    for t in range(6):
        jl, jcache = jdecode(jparams, jcache, jnp.asarray(batch["tokens"][:, t]))
        logits, cache = api.decode(params, cache, torch.from_numpy(batch["tokens"][:, t]))
        _close(logits, jl, what=f"step {t}")
    _close(cache["k"], jcache["k"])
    assert cache["len"] == int(jcache["len"]) == 6


def _continue(api, params, cache, tokens, room):
    """Extend a prefill cache by ``room`` positions, then decode
    ``tokens`` (B, n) one at a time; the last logits."""
    full = transformer.extend_cache(cache, cache["len"] + room)
    for t in range(tokens.shape[1]):
        logits, full = api.decode(params, full, tokens[:, t])
    return logits


def test_prefill_then_decode_equals_the_whole_prompts_prefill():
    """The parallel/sequential contract of `tests/test_models.py`: prefill
    of [image ; text less its last 4 tokens], then 4 decode steps, gives
    the whole prompt's prefill logits (float32, 1e-4 x max)."""
    _, _, params = _pair()
    api = get_model(_cfgs()[1], "cpu")
    batch = _tx(_batch(api.cfg, seed=4))
    want, _ = api.prefill(params, {"tokens": batch["tokens"], "patches": batch["patches"]})
    _, cache = api.prefill(params, {"tokens": batch["tokens"][:, :-4],
                                    "patches": batch["patches"]})
    got = _continue(api, params, cache, batch["tokens"][:, -4:], room=8)
    _close(got, _np(want))


def test_c26_prefill_cache_length_is_the_sequence_not_d_model():
    """ROADMAP queue C 26: the reference's prefill returns ``len``
    d_model (it reads x.shape[1] of the last position's (B, D) state),
    so a decode after it writes and attends at the wrong position; the
    port's ``len`` is T_img + S_text, and its decode continues the
    prompt."""
    japi, jparams, params = _pair()
    api = get_model(_cfgs()[1], "cpu")
    cfg = api.cfg
    batch = _batch(cfg, seed=5)
    t_img, s_text = cfg.frontend_tokens, batch["tokens"].shape[1]
    assert t_img + s_text != cfg.d_model
    prompt = {"tokens": batch["tokens"][:, :-1], "patches": batch["patches"]}
    _, jc = japi.prefill(jparams, _jx(prompt))
    _, cache = api.prefill(params, _tx(prompt))
    assert int(jc["len"]) == cfg.d_model
    assert cache["len"] == t_img + s_text - 1 == jc["k"].shape[3]
    # the reference's decode from its own cache lands at position d_model
    # and parts from its whole prompt's prefill; the port's continues it
    want, _ = japi.prefill(jparams, _jx({"tokens": batch["tokens"],
                                         "patches": batch["patches"]}))
    room = cfg.d_model + 2
    jfull = japi.init_cache(2, room)
    jfull = {**jfull, "k": jfull["k"].at[:, :, :, :cache["len"]].set(jc["k"]),
             "v": jfull["v"].at[:, :, :, :cache["len"]].set(jc["v"]), "len": jc["len"]}
    jgot, jfull = japi.decode(jparams, jfull, jnp.asarray(batch["tokens"][:, -1]))
    assert int(jfull["len"]) == cfg.d_model + 1
    assert float(np.abs(np.asarray(jgot) - np.asarray(want)).max()) > 1e-2 * float(
        np.abs(np.asarray(want)).max())
    got = _continue(api, params, cache, torch.from_numpy(batch["tokens"][:, -1:]), room=2)
    _close(got, want)


def test_sixteen_requests_through_the_engine_match_the_reference():
    """16 requests through both packages' `ServeEngine` (text prompts, as
    the reference's engine feeds them): every request completes with the
    reference's tokens."""
    japi, jparams, params = _pair()
    api = get_model(_cfgs()[1], "cpu")
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(0, api.cfg.vocab_size, rng.integers(4, 12))]
               for _ in range(16)]
    out = {}
    for pkg, mod, a, p, reg in (("jax", jax_engine, japi, jparams, JaxRegistry),
                                ("torch", engine, api, params, MetricsRegistry)):
        eng = mod.ServeEngine(a, p, batch_slots=4, max_len=64,
                              metrics=reg(f"test.vlm_serve.{pkg}"))
        done = eng.run([mod.Request(uid=i, prompt=list(pr), max_new_tokens=6)
                        for i, pr in enumerate(prompts)])
        out[pkg] = sorted((r.uid, list(map(int, r.generated))) for r in done)
        assert eng.kv.num_allocated == 0
    assert len(out["torch"]) == 16 and all(len(g) == 6 for _, g in out["torch"])
    assert out["torch"] == out["jax"]


def test_bf16_prefill_parts_from_float32_alike_in_both_packages():
    """Why the card holds llava's bf16 prefill against decode by max |Δ|
    and its top-1 in float32: the reduced llava's bf16 prefill logits
    part from its float32 ones by ~1% of max |logit| in the reference as
    in the port (the same rounding, not the port's), so two leading
    logits closer than that are ordered by rounding in either package."""
    jcfg, cfg = _cfgs(dtype="bfloat16")
    japi = jax_get_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    j32 = jax_get_model(dataclasses.replace(jcfg, dtype="float32"))
    c32 = dataclasses.replace(cfg, dtype="float32")
    batch = _batch(cfg, seed=6, b=4)
    del batch["labels"]
    want = np.asarray(j32.prefill(jax.tree.map(lambda a: a.astype(jnp.float32), jparams),
                                  _jx(batch))[0])
    got32 = get_model(c32, "cpu").prefill(convert.lm_params_from_reference(tree, c32, "cpu"),
                                          _tx(batch))[0]
    _close(got32, want)
    jb = np.asarray(japi.prefill(jparams, {**_jx(batch), "patches": jnp.asarray(
        batch["patches"], jnp.bfloat16)})[0], np.float32)
    tb = get_model(cfg, "cpu").prefill(convert.lm_params_from_reference(tree, cfg, "cpu"), {
        **_tx(batch), "patches": torch.from_numpy(batch["patches"]).bfloat16()})[0].float()
    scale = float(np.abs(want).max())
    ref_err = float(np.abs(jb - want).max()) / scale
    port_err = float(np.abs(_np(tb) - want).max()) / scale
    assert 1e-3 < ref_err < 0.05 and 1e-3 < port_err < 0.05, (ref_err, port_err)
    assert 0.5 < port_err / ref_err < 2.0, (ref_err, port_err)
