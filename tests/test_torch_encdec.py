"""The port's audio family (`repro_torch.models.encdec`,
seamless-m4t-large-v2) against the reference's (`repro.models.encdec`,
plain `jnp` on the CPU), from the same NumPy inputs and the reference's
parameters carried across by `convert`, in float32, on the reduced
config: `encode`, `_enc_kv` and `_cross_attn` with Sq != Sk (40 target
positions over 72 source frames, ragged against the attention chunk),
the training logits, the loss and every gradient with and without
remat, prefill and decode (the cross KV carried through the cache);
`convert` carries every leaf and refuses another config's tree;
prefill against sequential decode on a cache built from `encode` and
`_enc_kv` (the contract of `tests/test_models.py`); and 16 requests
through both packages' `ServeEngine`, which decode against the zero
cross KV of `init_cache` as the reference's does.  The card's twins are
in `test_torch_card.py`.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import encdec as jax_encdec  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import registry as jax_registry  # noqa: E402
from repro.obs.metrics import MetricsRegistry as JaxRegistry  # noqa: E402
from repro.serve import engine as jax_engine  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.models import encdec, get_model, registry, transformer  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train.optimizer import tree_leaves  # noqa: E402
from repro_torch.train.train_step import loss_and_grads  # noqa: E402

ARCH = "seamless-m4t-large-v2"
SRC, TGT = 72, 40          # source frames, target tokens: Sq != Sk, ragged chunks


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


def _batch(cfg, seed=0, b=2, src=SRC, tgt=TGT):
    """Unit-normal frames (B, src, F), tokens and labels (B, tgt), as
    NumPy arrays."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, tgt + 1)).astype(np.int32)
    frames = rng.standard_normal((b, src, cfg.frontend_dim)).astype(np.float32)
    return {"frames": frames, "tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _jx(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tx(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


# ---------------------------------------------------------------------------
# 1. parameters
# ---------------------------------------------------------------------------

def test_init_draws_the_reference_layout_and_dtypes():
    jcfg, cfg = _cfgs(dtype="bfloat16")
    jparams = jax_get_model(jcfg).init(jax.random.PRNGKey(0))
    params = get_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    assert set(params) == set(jparams)
    for key, shapes, n in (("enc", encdec.enc_param_shapes(cfg), cfg.num_encoder_layers),
                           ("dec", encdec.dec_param_shapes(cfg), cfg.num_layers)):
        assert len(params[key]) == n and len(shapes) == {"enc": 9, "dec": 14}[key]
        for blk in params[key]:
            assert {k: tuple(w.shape) for k, w in blk.items()} == shapes
            assert shapes == {k: a.shape[1:] for k, a in jparams[key].items()}
    for name in ("embed", "frontend", "final_norm", "enc_norm"):
        assert tuple(params[name].shape) == jparams[name].shape
    assert all(w.dtype == torch.bfloat16 for w in tree_leaves(params))


def test_convert_carries_every_leaf_and_refuses_other_trees():
    jcfg, cfg = _cfgs(dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jax_get_model(jcfg).init(jax.random.PRNGKey(1)))
    params = convert.lm_params_from_reference(tree, cfg, "cpu")
    np.testing.assert_array_equal(_np(params["dec"][1]["x_wk"].float()),
                                  tree["dec"]["x_wk"][1].astype(np.float32))
    np.testing.assert_array_equal(_np(params["frontend"].float()),
                                  tree["frontend"].astype(np.float32))
    assert len(jax.tree.leaves(tree)) == 4 + 9 + 14          # stacked by layer
    assert len(tree_leaves(params)) == 4 + 9 * cfg.num_encoder_layers + 14 * cfg.num_layers
    with pytest.raises(ValueError, match="stacked enc layers"):
        convert.lm_params_from_reference(
            tree, dataclasses.replace(cfg, num_encoder_layers=3), "cpu")
    with pytest.raises(ValueError, match="enc leaves .* config has"):     # another FFN width
        convert.lm_params_from_reference(tree, dataclasses.replace(cfg, d_ff=64), "cpu")
    with pytest.raises(ValueError, match="frontend"):
        convert.lm_params_from_reference(
            tree, dataclasses.replace(cfg, frontend_dim=8), "cpu")
    with pytest.raises(ValueError, match="dec leaves"):
        convert.lm_params_from_reference(
            {**tree, "dec": {k: v for k, v in tree["dec"].items() if k != "x_ln"}},
            cfg, "cpu")


def test_batch_spec_and_cache_follow_the_reference():
    """The registry's batch specs (train: source and target halves of the
    sequence) and the decode cache's source length."""
    jcfg, cfg = _cfgs()
    japi, api = jax_get_model(jcfg), get_model(cfg, "cpu")
    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig(name=kind, kind=kind, seq_len=64, global_batch=2)
        want = japi.batch_spec(shape)
        got = api.batch_spec(shape)
        assert {k: s for k, (s, _) in got.items()} == {k: s for k, (s, _) in want.items()}
        assert {k: str(d).split(".")[-1] for k, (_, d) in got.items()} == {
            k: jnp.dtype(d).name for k, (_, d) in want.items()}
    assert registry.ENCDEC_DECODE_SRC_LEN == jax_registry.ENCDEC_DECODE_SRC_LEN == 3072
    cache = api.init_cache(2, 16)
    assert tuple(cache["xk"].shape) == japi.init_cache(2, 16)["xk"].shape
    assert cache["xk"].shape[3] == 3072 and cache["len"] == 0


# ---------------------------------------------------------------------------
# 2. the encoder, the cross KV, cross-attention at Sq != Sk
# ---------------------------------------------------------------------------

def test_encode_matches_reference():
    _, jparams, params = _pair()
    jcfg, cfg = _cfgs()
    frames = _batch(cfg, seed=1)["frames"]
    want = jax_encdec.encode(jcfg, jparams, jnp.asarray(frames))
    got = encdec.encode(cfg, params, torch.from_numpy(frames))
    assert tuple(got.shape) == want.shape == (2, SRC, cfg.d_model)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("chunk", [32, 50])
def test_enc_kv_and_cross_attention_at_sq_ne_sk_match_reference(chunk):
    """40 decoder positions over 72 encoder frames, non-causal, the chunk
    ragged against Sk (72 = 2 x 32 + 8, 50 + 22): `_enc_kv` and
    `_cross_attn` against the reference's."""
    _, jparams, params = _pair()
    jcfg, cfg = _cfgs(attn_chunk=chunk)
    rng = np.random.default_rng(chunk)
    enc_out = rng.standard_normal((2, SRC, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((2, TGT, cfg.d_model)).astype(np.float32)
    jp, p = _layer(jparams["dec"], 1), params["dec"][1]
    jkv = jax_encdec._enc_kv(jcfg, jp, jnp.asarray(enc_out))
    kv = encdec._enc_kv(cfg, p, torch.from_numpy(enc_out))
    for got, want in zip(kv, jkv):
        assert tuple(got.shape) == want.shape == (2, cfg.num_kv_heads, SRC, encdec._hd(cfg))
        _close(got, want, 1e-5)
    want = jax_encdec._cross_attn(jcfg, jp, jnp.asarray(x), jkv)
    got = encdec._cross_attn(cfg, p, torch.from_numpy(x), kv)
    assert tuple(got.shape) == want.shape == (2, TGT, cfg.d_model)
    _close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# 3. training: logits, loss, gradients
# ---------------------------------------------------------------------------

def test_forward_train_matches_reference():
    _, jparams, params = _pair()
    jcfg, cfg = _cfgs()
    batch = _batch(cfg, seed=2)
    want = jax_encdec.forward_train(jcfg, jparams, jnp.asarray(batch["frames"]),
                                    jnp.asarray(batch["tokens"]))
    got = encdec.forward_train(cfg, params, torch.from_numpy(batch["frames"]),
                               torch.from_numpy(batch["tokens"]))
    assert tuple(got.shape) == want.shape == (2, TGT, cfg.padded_vocab)
    _close(got, want)


@functools.lru_cache(maxsize=None)
def _reference_grads(src, tgt):
    japi, jparams, _ = _pair()
    batch = _batch(japi.cfg, seed=3, src=src, tgt=tgt)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(japi.loss, has_aux=True))(
        jparams, _jx(batch))
    return batch, float(loss), float(metrics["nll"]), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("src,tgt", [(SRC, TGT), (32, 32)])
def test_reduced_seamless_loss_and_grads_match_reference(remat, src, tgt):
    """The loss within 1e-5 relative and every gradient within 1e-4 x its
    max, with and without remat; at Sq != Sk (the CPU's loop; the card's
    backward kernel takes Sq == Sk only, ROADMAP queue C 13) and at the
    registry's train spec, where source and target lengths are equal."""
    batch, jloss, jnll, jgrads = _reference_grads(src, tgt)
    _, _, params = _pair()
    _, cfg = _cfgs(remat=remat)
    loss, metrics, grads = loss_and_grads(get_model(cfg, "cpu").loss, params, _tx(batch))
    assert float(loss) == pytest.approx(jloss, rel=1e-5)
    assert float(metrics["nll"]) == pytest.approx(jnll, rel=1e-5)
    want = convert.lm_params_from_reference(jgrads, cfg, "cpu")
    assert float(np.abs(_np(grads["frontend"])).max()) > 0
    for g, w in zip(tree_leaves(grads), tree_leaves(want)):
        _close(g, w)


# ---------------------------------------------------------------------------
# 4. serving
# ---------------------------------------------------------------------------

def test_reduced_seamless_prefill_and_decode_match_reference():
    """Prefill's logits and its self and cross KV, then 6 decode steps
    continuing from that cache (the cross KV read at every step)."""
    japi, jparams, params = _pair()
    api = get_model(_cfgs()[1], "cpu")
    batch = _batch(api.cfg, seed=4)
    prompt = {"frames": batch["frames"], "tokens": batch["tokens"][:, :24]}
    jl, jc = japi.prefill(jparams, _jx(prompt))
    logits, cache = api.prefill(params, _tx(prompt))
    _close(logits, jl)
    assert cache["len"] == int(jc["len"]) == 24
    for name in ("k", "v", "xk", "xv"):
        assert tuple(cache[name].shape) == jc[name].shape
        _close(cache[name], jc[name], what=name)
    room = 32
    jfull = jax_encdec.init_cache(japi.cfg, 2, room, SRC)
    jfull = {**jfull, "k": jfull["k"].at[:, :, :, :24].set(jc["k"]),
             "v": jfull["v"].at[:, :, :, :24].set(jc["v"]), "xk": jc["xk"], "xv": jc["xv"],
             "len": jc["len"]}
    full = transformer.extend_cache(cache, room)
    jdecode = jax.jit(japi.decode)
    for t in range(24, 30):
        jl, jfull = jdecode(jparams, jfull, jnp.asarray(batch["tokens"][:, t]))
        logits, full = api.decode(params, full, torch.from_numpy(batch["tokens"][:, t]))
        _close(logits, jl, what=f"step {t}")
    _close(full["k"], jfull["k"])
    assert full["len"] == int(jfull["len"]) == 30


def test_prefill_matches_sequential_decode_on_a_cache_from_encode():
    """The contract of `tests/test_models.py`: prefill of the prompt
    against decoding it token by token on a cache whose cross KV comes
    from `encode` and `_enc_kv` (float32, 1e-4 x max), in both
    packages."""
    japi, jparams, params = _pair()
    jcfg, cfg = _cfgs()
    api = get_model(cfg, "cpu")
    batch = _batch(cfg, seed=5, tgt=16)
    want, _ = api.prefill(params, {"frames": torch.from_numpy(batch["frames"]),
                                   "tokens": torch.from_numpy(batch["tokens"])})
    jwant, _ = japi.prefill(jparams, {"frames": jnp.asarray(batch["frames"]),
                                      "tokens": jnp.asarray(batch["tokens"])})
    _close(want, jwant)
    enc_out = encdec.encode(cfg, params, torch.from_numpy(batch["frames"]))
    cache = encdec.init_cache(cfg, 2, 20, SRC, "cpu")
    for i, p in enumerate(params["dec"]):
        cache["xk"][i], cache["xv"][i] = encdec._enc_kv(cfg, p, enc_out)
    for t in range(batch["tokens"].shape[1]):
        got, cache = api.decode(params, cache, torch.from_numpy(batch["tokens"][:, t]))
    _close(got, _np(want))
    assert int(torch.argmax(got[0])) == int(torch.argmax(want[0]))


def test_sixteen_requests_through_the_engine_match_the_reference():
    """16 text requests through both packages' `ServeEngine`, decoding
    against `init_cache`'s zero cross KV over 3,072 frames (reference
    behaviour): every request completes with the reference's tokens."""
    japi, jparams, params = _pair()
    api = get_model(_cfgs()[1], "cpu")
    rng = np.random.default_rng(8)
    prompts = [[int(t) for t in rng.integers(0, api.cfg.vocab_size, rng.integers(4, 12))]
               for _ in range(16)]
    out = {}
    for pkg, mod, a, p, reg in (("jax", jax_engine, japi, jparams, JaxRegistry),
                                ("torch", engine, api, params, MetricsRegistry)):
        eng = mod.ServeEngine(a, p, batch_slots=4, max_len=64,
                              metrics=reg(f"test.encdec_serve.{pkg}"))
        done = eng.run([mod.Request(uid=i, prompt=list(pr), max_new_tokens=6)
                        for i, pr in enumerate(prompts)])
        out[pkg] = sorted((r.uid, list(map(int, r.generated))) for r in done)
        assert eng.kv.num_allocated == 0
    assert len(out["torch"]) == 16 and all(len(g) == 6 for _, g in out["torch"])
    assert out["torch"] == out["jax"]
