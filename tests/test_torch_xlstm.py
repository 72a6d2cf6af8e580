"""The port's xLSTM (`repro_torch.models.xlstm`, `xlstm_model`) against
the reference's (`repro.models.xlstm`, `xlstm_model`, plain `jnp` on the
CPU), from the same NumPy inputs and the reference's parameters carried
across by `convert`, in float32: `mlstm_train` and `slstm_train` (output,
returned state and gradients, one chunk and several, remat on and off),
their decode steps, and the reduced xlstm-1.3b whole (prefill logits and
cache, 6 decode steps, the loss and every gradient under each remat
setting).  Also pins the recurrent form of ROADMAP queue C 14: a
recycled engine slot continues from its previous occupant's state in
both packages.  The card's twins are in `test_torch_card.py`.
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
from repro.models import xlstm as jax_xlstm  # noqa: E402
from repro.obs.metrics import MetricsRegistry as JaxRegistry  # noqa: E402
from repro.serve import engine as jax_engine  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import get_model, xlstm, xlstm_model  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train.optimizer import tree_leaves  # noqa: E402
from repro_torch.train.train_step import loss_and_grads  # noqa: E402

ARCH = "xlstm-1.3b"


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


def _torch_tree(jp):
    return {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _x(b, s, d, seed=1):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


# ---------------------------------------------------------------------------
# 1. the cells
# ---------------------------------------------------------------------------

CELLS = {"mlstm": (jax_xlstm.init_mlstm_params, jax_xlstm.mlstm_train, xlstm.mlstm_train,
                   xlstm.mlstm_param_shapes),
         "slstm": (jax_xlstm.init_slstm_params, jax_xlstm.slstm_train, xlstm.slstm_train,
                   xlstm.slstm_param_shapes)}


def test_cell_params_follow_the_reference():
    jcfg, cfg = _cfgs(dtype="bfloat16")
    for name, init in (("mlstm", xlstm.init_mlstm_params), ("slstm", xlstm.init_slstm_params)):
        jp = CELLS[name][0](jcfg, jax.random.PRNGKey(0))
        p = init(cfg, torch.Generator().manual_seed(0))
        assert {k: tuple(v.shape) for k, v in p.items()} == {k: v.shape for k, v in jp.items()}
        assert {k: tuple(v) for k, v in CELLS[name][3](cfg).items()} == {
            k: v.shape for k, v in jp.items()}
        assert all(v.dtype == torch.bfloat16 for v in p.values())


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("cell,s,chunk", [("mlstm", 24, 256), ("mlstm", 24, 8),
                                          ("mlstm", 32, 16), ("slstm", 24, None)])
def test_cell_train_and_state_match_reference(cell, s, chunk, remat):
    jcfg, cfg = _cfgs(remat=remat)
    jinit, jtrain, train, _ = CELLS[cell]
    jp = jinit(jcfg, jax.random.PRNGKey(2))
    p = _torch_tree(jp)
    x = _x(2, s, cfg.d_model)
    kw = {} if chunk is None else {"chunk": chunk}
    jy, jst = jtrain(jcfg, jp, jnp.asarray(x), return_state=True, **kw)
    y, st = train(cfg, p, torch.from_numpy(x), return_state=True, **kw)
    _close(y, jy, what="out")
    assert set(st) == set(jst)
    for name in st:
        assert st[name].dtype == torch.float32 and jst[name].dtype == jnp.float32
        _close(st[name], jst[name], what=name)
    _close(train(cfg, p, torch.from_numpy(x), **kw), jy)


@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
def test_cell_gradients_match_reference(cell):
    jcfg, cfg = _cfgs()
    jinit, jtrain, train, _ = CELLS[cell]
    jp = jinit(jcfg, jax.random.PRNGKey(3))
    x = _x(2, 16, cfg.d_model, seed=3)
    w = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    kw = {"chunk": 8} if cell == "mlstm" else {}

    def jloss(jp, x):
        return jnp.sum(jtrain(jcfg, jp, x, **kw) * w)
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.requires_grad_(True) for k, v in _torch_tree(jp).items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    (train(cfg, leaves, xt, **kw) * torch.from_numpy(w)).sum().backward()
    _close(xt.grad, jgx, what="x")
    for name, leaf in leaves.items():
        _close(leaf.grad, jg[name], what=name)


@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
def test_cell_decode_matches_reference_and_ends_at_the_scan(cell):
    jcfg, cfg = _cfgs()
    jinit, _, train, _ = CELLS[cell]
    jdecode = getattr(jax_xlstm, f"{cell}_decode")
    decode = getattr(xlstm, f"{cell}_decode")
    jp = jinit(jcfg, jax.random.PRNGKey(5))
    p = _torch_tree(jp)
    x = _x(2, 6, cfg.d_model, seed=6)
    jst = getattr(jax_xlstm, f"init_{cell}_state")(jcfg, 2)
    st = getattr(xlstm, f"init_{cell}_state")(cfg, 2, "cpu")
    assert {k: tuple(v.shape) for k, v in st.items()} == {k: v.shape for k, v in jst.items()}
    for t in range(x.shape[1]):
        jy, jst = jdecode(jcfg, jp, jnp.asarray(x[:, t:t + 1]), jst)
        y, st = decode(cfg, p, torch.from_numpy(x[:, t:t + 1]), st)
        _close(y, jy, what=f"step {t}")
        for name in st:
            _close(st[name], jst[name], what=f"{name} step {t}")
    y_all, st_all = train(cfg, p, torch.from_numpy(x), return_state=True)
    _close(y, _np(y_all)[:, -1:])
    for name in st:
        _close(st[name], _np(st_all[name]), what=name)


def test_slstm_carries_h_in_the_activation_dtype_and_emits_float32():
    """The reference rounds the carried h to the activation dtype and
    emits the float32 h (`xlstm.py:146`): in bf16 the returned state's
    h is bf16, its c, n and m float32, in both packages."""
    jcfg, cfg = _cfgs(dtype="bfloat16")
    jp = jax_xlstm.init_slstm_params(jcfg, jax.random.PRNGKey(7))
    p = {k: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
         for k, v in jp.items()}
    x = _x(2, 8, cfg.d_model)
    _, jst = jax_xlstm.slstm_train(jcfg, jp, jnp.asarray(x, jnp.bfloat16), return_state=True)
    y, st = xlstm.slstm_train(cfg, p, torch.from_numpy(x).to(torch.bfloat16),
                              return_state=True)
    assert y.dtype == torch.bfloat16
    assert {k: str(v.dtype).split(".")[1] for k, v in st.items()} == {
        k: v.dtype.name for k, v in jst.items()} == {
        "c": "float32", "n": "float32", "m": "float32", "h": "bfloat16"}


# ---------------------------------------------------------------------------
# 2. the reduced xlstm-1.3b whole
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _pair():
    jcfg, cfg = _cfgs()
    japi = jax_get_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    return japi, jparams, convert.lm_params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _batch(vocab, seed=0, b=2, s=24):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@functools.lru_cache(maxsize=None)
def _reference_grads():
    japi, jparams, _ = _pair()
    batch = _batch(japi.cfg.vocab_size)
    (loss, _), grads = jax.jit(jax.value_and_grad(japi.loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return batch, float(loss), jax.tree.map(np.asarray, grads)


def test_reduced_xlstm_params_carry_across_and_init_draws_them():
    japi, jparams, params = _pair()
    cfg = dataclasses.replace(get_arch(ARCH, reduced=True), dtype="float32")
    ns, nm = cfg.num_layers // cfg.xlstm_slstm_every, cfg.xlstm_slstm_every - 1
    assert len(params["blocks"]) == ns and all(len(b["mlstm"]) == nm for b in params["blocks"])
    np.testing.assert_array_equal(_np(params["blocks"][1]["mlstm"][0]["wq"]),
                                  np.asarray(jparams["blocks"]["mlstm"]["wq"][1, 0]))
    own = get_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    assert [tuple(t.shape) for t in tree_leaves(own)] == [
        tuple(t.shape) for t in tree_leaves(params)]


@pytest.mark.parametrize("remat", ["off", "on"])
def test_reduced_xlstm_loss_and_grads_match_reference(remat):
    batch, jloss, jgrads = _reference_grads()
    _, _, params = _pair()
    _, cfg = _cfgs(remat=remat == "on")
    loss, metrics, grads = loss_and_grads(
        get_model(cfg, "cpu").loss, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(loss) == pytest.approx(jloss, rel=1e-5)
    assert set(metrics) == {"loss", "nll"}
    want = convert.lm_params_from_reference(jgrads, cfg, "cpu")
    for g, w in zip(tree_leaves(grads), tree_leaves(want)):
        _close(g, w)


def test_reduced_xlstm_prefill_and_decode_match_reference():
    japi, jparams, params = _pair()
    api = get_model(dataclasses.replace(get_arch(ARCH, reduced=True), dtype="float32"), "cpu")
    toks = _batch(api.cfg.vocab_size, seed=1)["tokens"]
    jl, jc = japi.prefill(jparams, {"tokens": jnp.asarray(toks)})
    logits, cache = api.prefill(params, {"tokens": torch.from_numpy(toks)})
    _close(logits, jl)
    assert cache["len"] == int(jc["len"]) == toks.shape[1]
    for part in ("m", "s"):
        for name, t in cache[part].items():
            assert tuple(t.shape) == jc[part][name].shape
            _close(t, jc[part][name], what=f"{part}.{name}")
    jcache, cache = japi.init_cache(2, 8), api.init_cache(2, 8)
    jdecode = jax.jit(japi.decode)
    for t in range(6):
        jl, jcache = jdecode(jparams, jcache, jnp.asarray(toks[:, t]))
        logits, cache = api.decode(params, cache, torch.from_numpy(toks[:, t]))
        _close(logits, jl, what=f"step {t}")
    for part in ("m", "s"):
        for name, t in cache[part].items():
            _close(t, jcache[part][name], what=f"{part}.{name}")
    assert cache["len"] == int(jcache["len"]) == 6


def test_init_cache_is_recurrent_state_only():
    _, cfg = _cfgs()
    cache = xlstm_model.init_cache(cfg, 3, 1 << 20, "cpu")
    assert set(cache) == {"m", "s", "len"}
    assert cache["m"]["c"].shape[:3] == (cfg.num_layers // cfg.xlstm_slstm_every,
                                         cfg.xlstm_slstm_every - 1, 3)
    assert float(cache["m"]["m"].max()) == float(cache["s"]["m"].min()) == np.float32(xlstm.M0)


# ---------------------------------------------------------------------------
# 3. C14 for the recurrent state
# ---------------------------------------------------------------------------

def test_recycled_slot_continues_its_previous_occupants_state_like_the_reference():
    """ROADMAP queue C 14, recurrent form: the lockstep engine does not
    clear a slot it recycles, so a request served after another in the
    same slot starts from the earlier request's xLSTM state and
    generates other tokens than when served alone, in both packages,
    token for token."""
    japi, jparams, params = _pair()
    api = get_model(dataclasses.replace(get_arch(ARCH, reduced=True), dtype="float32"), "cpu")
    first, second = [3, 17, 250, 9, 41], [77, 5, 130, 8]
    gens = {}
    for pkg, mod, a, p, reg in (("jax", jax_engine, japi, jparams, JaxRegistry),
                                ("torch", engine, api, params, MetricsRegistry)):
        def serve(prompts, mod=mod, a=a, p=p, reg=reg, pkg=pkg):
            eng = mod.ServeEngine(a, p, batch_slots=1, max_len=64,
                                  metrics=reg(f"test.xlstm_slot.{pkg}"))
            done = eng.run([mod.Request(uid=i, prompt=list(pr), max_new_tokens=8)
                            for i, pr in enumerate(prompts)])
            return [list(map(int, r.generated)) for r in sorted(done, key=lambda r: r.uid)]
        gens[pkg] = (serve([first, second])[1], serve([second])[0])
    assert gens["torch"] == gens["jax"]
    after, alone = gens["torch"]
    assert after != alone


def test_bf16_rounding_is_amplified_by_depth_in_both_packages():
    """Why `chip_smoke.py`'s lm_ssm holds bf16 layer by layer: under
    random weights the xLSTM stack amplifies a rounding with depth, so at
    16 layers (d_model 256) the bf16 prefill's logits already part from
    the float32 prefill's by more than 5% of max |logit|, in the
    reference as in the port, while the port's float32 prefill stays
    within 1e-4 x max of the reference's."""
    kw = dict(d_model=256, num_layers=16, vocab_size=4096)
    jcfg, cfg = _cfgs(**kw)
    jcfg16, cfg16 = _cfgs(dtype="bfloat16", **kw)
    jparams = jax_get_model(jcfg).init(jax.random.PRNGKey(0))
    jparams16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    toks = np.random.default_rng(9).integers(0, 4096, (2, 64)).astype(np.int32)
    logits = {}
    for name, jc, c, jp in (("f32", jcfg, cfg, jparams), ("bf16", jcfg16, cfg16, jparams16)):
        jl, _ = jax.jit(jax_get_model(jc).prefill)(jp, {"tokens": jnp.asarray(toks)})
        params = convert.lm_params_from_reference(jax.tree.map(np.asarray, jp), c, "cpu")
        tl, _ = get_model(c, "cpu").prefill(params, {"tokens": torch.from_numpy(toks)})
        logits[name] = (np.asarray(jl, np.float32), _np(tl.float()))
    (jf, tf), (jb, tb) = logits["f32"], logits["bf16"]
    _close(tf, jf)
    top = float(np.abs(jf).max())
    assert float(np.abs(jb - jf).max()) > 0.05 * top
    assert float(np.abs(tb - tf).max()) > 0.05 * top
