"""The port's hybrid family (`repro_torch.models.hybrid`, jamba) and
`transformer.block_decode_attn_only` against the reference's
(`repro.models.hybrid`, `transformer`, plain `jnp` on the CPU), from the
same NumPy inputs and the reference's parameters carried across by
`convert`, in float32: the attention mixer's decode step, and the
reduced jamba-1.5-large-398b whole (prefill logits and cache, 6 decode
steps, the loss and every gradient under each remat setting).  Also:
`convert` keeps each leaf's dtype and refuses a tree that is not the
config's; ROADMAP queue C 25 through the model (a 2-token prefill, then
a decode step); and the recurrent form of queue C 14 (a recycled engine
slot continues from its previous occupant's Mamba state and KV).  The
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
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.obs.metrics import MetricsRegistry as JaxRegistry  # noqa: E402
from repro.serve import engine as jax_engine  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import get_model, hybrid, transformer  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train.optimizer import tree_leaves  # noqa: E402
from repro_torch.train.train_step import loss_and_grads  # noqa: E402

ARCH = "jamba-1.5-large-398b"


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


def _batch(vocab, seed=0, b=2, s=24):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# ---------------------------------------------------------------------------
# 1. the attention mixer's decode step
# ---------------------------------------------------------------------------

def test_block_decode_attn_only_matches_reference_and_writes_in_place():
    """Six steps of the attention mixer (no FFN) over a float32 cache,
    against the reference's; the port writes the cache in place, and
    `block_decode` is this step followed by the FFN."""
    _, jparams, params = _pair()
    jcfg, cfg = _cfgs()
    per = cfg.attn_period
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][f"mix{per - 1}"])
    p = params["blocks"][0][f"mix{per - 1}"]
    hd = transformer._head_dim(cfg)
    x = np.random.default_rng(8).standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    jk = jv = jnp.zeros((2, cfg.num_kv_heads, 8, hd), jnp.float32)
    kc = torch.zeros((2, cfg.num_kv_heads, 8, hd))
    vc = torch.zeros_like(kc)
    for t in range(6):
        jy, jk, jv = jax_transformer.block_decode_attn_only(
            jcfg, jp, jnp.asarray(x[:, t:t + 1]), jk, jv, t)
        y, k2, v2 = transformer.block_decode_attn_only(cfg, p, torch.from_numpy(x[:, t:t + 1]),
                                                       kc, vc, t)
        assert k2 is kc and v2 is vc
        _close(y, jy, what=f"step {t}")
        _close(kc, jk, what="k")
        _close(vc, jv, what="v")
    # the same step then the FFN is block_decode (a dense layer's params)
    blk = {**p, **params["blocks"][0]["ffn1"]}
    k0, v0 = torch.zeros_like(kc), torch.zeros_like(vc)
    xa, _, _ = transformer.block_decode_attn_only(cfg, blk, torch.from_numpy(x[:, :1]),
                                                  k0.clone(), v0.clone(), 0)
    want, _ = transformer._ffn(dataclasses.replace(cfg, num_experts=0), blk, xa)
    got, _, _ = transformer.block_decode(dataclasses.replace(cfg, num_experts=0), blk,
                                         torch.from_numpy(x[:, :1]), k0, v0, 0)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# 2. parameters: init, convert
# ---------------------------------------------------------------------------

def test_init_draws_the_reference_layout_and_dtypes():
    jcfg, cfg = _cfgs(dtype="bfloat16")
    jparams = jax_get_model(jcfg).init(jax.random.PRNGKey(0))
    params = get_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    shapes = hybrid.superblock_param_shapes(cfg)
    assert len(params["blocks"]) == cfg.num_layers // cfg.attn_period
    for blk in params["blocks"]:
        assert set(blk) == set(shapes) == set(jparams["blocks"])
        for key, leaves in blk.items():
            for name, w in leaves.items():
                ref = jparams["blocks"][key][name]
                assert tuple(w.shape) == shapes[key][name] == ref.shape[1:]
                assert str(w.dtype).split(".")[1] == ref.dtype.name, (key, name)
    assert params["blocks"][0]["mix0"]["a_log"].dtype == torch.float32
    assert set(params["blocks"][0]["ffn0"]) >= {"router", "we_gate"}     # i % moe_every == 0
    assert set(params["blocks"][0]["ffn1"]) >= {"w_gate"}


def test_convert_keeps_each_leafs_dtype_and_refuses_other_trees():
    jcfg, cfg = _cfgs(dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jax_get_model(jcfg).init(jax.random.PRNGKey(1)))
    params = convert.lm_params_from_reference(tree, cfg, "cpu")
    mix = params["blocks"][1]["mix0"]
    assert mix["a_log"].dtype == mix["dt_bias"].dtype == mix["d_skip"].dtype == torch.float32
    assert mix["in_proj"].dtype == params["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(mix["a_log"]), tree["blocks"]["mix0"]["a_log"][1])
    np.testing.assert_array_equal(_np(mix["in_proj"].float()),
                                  tree["blocks"]["mix0"]["in_proj"][1].astype(np.float32))
    with pytest.raises(ValueError, match="config has"):     # another width
        convert.lm_params_from_reference(tree, dataclasses.replace(cfg, mamba_d_state=4), "cpu")
    with pytest.raises(ValueError, match="stacked superblocks"):
        convert.lm_params_from_reference(tree, dataclasses.replace(cfg, num_layers=6), "cpu")
    with pytest.raises(ValueError, match="bfloat16 .* config has float32"):
        a_log = tree["blocks"]["mix0"]["a_log"]
        bad = {**tree["blocks"]["mix0"], "a_log": a_log.astype(tree["embed"].dtype)}
        convert.lm_params_from_reference(
            {**tree, "blocks": {**tree["blocks"], "mix0": bad}}, cfg, "cpu")
    with pytest.raises(ValueError, match="leaves"):
        convert.lm_params_from_reference(
            {**tree, "blocks": {**tree["blocks"], "ffn1": {
                k: v for k, v in tree["blocks"]["ffn1"].items() if k != "w_up"}}}, cfg, "cpu")


# ---------------------------------------------------------------------------
# 3. the reduced jamba whole
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_grads():
    japi, jparams, _ = _pair()
    batch = _batch(japi.cfg.vocab_size)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(japi.loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return batch, float(loss), float(metrics["aux"]), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("remat", ["off", "full", "block_io"])
def test_reduced_jamba_loss_and_grads_match_reference(remat):
    """Under ``remat`` each layer is rematerialised whatever the policy;
    the MoE aux loss is carried as the reference carries it."""
    batch, jloss, jaux, jgrads = _reference_grads()
    _, _, params = _pair()
    _, cfg = _cfgs(remat=remat != "off", remat_policy="full" if remat == "off" else remat)
    loss, metrics, grads = loss_and_grads(
        get_model(cfg, "cpu").loss, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(loss) == pytest.approx(jloss, rel=1e-5)
    assert float(metrics["aux"]) == pytest.approx(jaux, rel=1e-5) and jaux > 0
    want = convert.lm_params_from_reference(jgrads, cfg, "cpu")
    for g, w in zip(tree_leaves(grads), tree_leaves(want)):
        _close(g, w)


def test_reduced_jamba_prefill_and_decode_match_reference():
    japi, jparams, params = _pair()
    api = get_model(_cfgs()[1], "cpu")
    toks = _batch(api.cfg.vocab_size, seed=1)["tokens"]
    jl, jc = japi.prefill(jparams, {"tokens": jnp.asarray(toks)})
    logits, cache = api.prefill(params, {"tokens": torch.from_numpy(toks)})
    _close(logits, jl)
    assert cache["len"] == int(jc["len"]) == toks.shape[1]
    for name in ("k", "v"):
        assert tuple(cache[name].shape) == jc[name].shape
        _close(cache[name], jc[name], what=name)
    for name, t in cache["mamba"].items():
        assert tuple(t.shape) == jc["mamba"][name].shape
        _close(t, jc["mamba"][name], what=name)
    jcache, cache = japi.init_cache(2, 8), api.init_cache(2, 8)
    jdecode = jax.jit(japi.decode)
    for t in range(6):
        jl, jcache = jdecode(jparams, jcache, jnp.asarray(toks[:, t]))
        logits, cache = api.decode(params, cache, torch.from_numpy(toks[:, t]))
        _close(logits, jl, what=f"step {t}")
    for name, t in cache["mamba"].items():
        _close(t, jcache["mamba"][name], what=name)
    _close(cache["k"], jcache["k"])
    assert cache["len"] == int(jcache["len"]) == 6


def test_c25_two_token_prefill_then_decode_equals_three_decode_steps():
    """ROADMAP queue C 25 through the model: the port's prefill of 2
    tokens plus one decode step gives the logits of 3 sequential decode
    steps; the reference's prefill keeps a (…, 1, di) conv state and its
    decode step raises."""
    japi, jparams, params = _pair()
    api = get_model(_cfgs()[1], "cpu")
    toks = np.array([[3, 17, 250], [9, 41, 77]], np.int32)
    _, cache = api.prefill(params, {"tokens": torch.from_numpy(toks[:, :2])})
    conv = api.cfg.mamba_d_conv
    assert cache["mamba"]["conv"].shape[3] == conv - 1
    # the prefill cache holds KV for the prompt only: copy it into one of
    # room for the next position, as a server would
    full = api.init_cache(2, 4)
    full["mamba"] = cache["mamba"]
    full["k"][:, :, :, :2], full["v"][:, :, :, :2] = cache["k"], cache["v"]
    full["len"] = 2
    got, _ = api.decode(params, full, torch.from_numpy(toks[:, 2]))
    seq = api.init_cache(2, 4)
    for t in range(3):
        want, seq = api.decode(params, seq, torch.from_numpy(toks[:, t]))
    _close(got, _np(want), 1e-5)
    _, jc = japi.prefill(jparams, {"tokens": jnp.asarray(toks[:, :2])})
    assert jc["mamba"]["conv"].shape[3] == 1
    jfull = {**japi.init_cache(2, 4), "mamba": jc["mamba"], "len": jnp.int32(2)}
    with pytest.raises(ValueError):
        japi.decode(jparams, jfull, jnp.asarray(toks[:, 2]))


def test_chunk_must_divide_the_prefill():
    api = get_model(_cfgs()[1], "cpu")
    params = api.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="multiple of the scan chunk"):
        api.prefill(params, {"tokens": torch.zeros((1, 300), dtype=torch.int32)})


# ---------------------------------------------------------------------------
# 4. C14 for the recurrent state
# ---------------------------------------------------------------------------

def test_recycled_slot_continues_its_previous_occupants_state_like_the_reference():
    """ROADMAP queue C 14, recurrent form: a recycled slot keeps its
    previous occupant's Mamba states (and KV), so the second request
    generates other tokens than when served alone, in both packages,
    token for token."""
    japi, jparams, params = _pair()
    api = get_model(_cfgs()[1], "cpu")
    first, second = [3, 17, 250, 9, 41], [77, 5, 130, 8]
    gens = {}
    for pkg, mod, a, p, reg in (("jax", jax_engine, japi, jparams, JaxRegistry),
                                ("torch", engine, api, params, MetricsRegistry)):
        def serve(prompts, mod=mod, a=a, p=p, reg=reg, pkg=pkg):
            eng = mod.ServeEngine(a, p, batch_slots=1, max_len=64,
                                  metrics=reg(f"test.jamba_slot.{pkg}"))
            done = eng.run([mod.Request(uid=i, prompt=list(pr), max_new_tokens=8)
                            for i, pr in enumerate(prompts)])
            return [list(map(int, r.generated)) for r in sorted(done, key=lambda r: r.uid)]
        gens[pkg] = (serve([first, second])[1], serve([second])[0])
    assert gens["torch"] == gens["jax"]
    after, alone = gens["torch"]
    assert after != alone
