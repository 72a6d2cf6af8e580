"""The port's training path against the reference: `layers.cross_entropy`,
`get_model(...).loss` and its gradients against `jax.value_and_grad` of
the reference's `loss_fn` from carried parameters, the remat policies,
`lr_schedule` and `adamw_update` from a carried optimizer state
(`convert.opt_state_from_reference`), `make_train_step` against the
reference's jitted step on the same NumPy batches, and `launch.train`
on the host (the reference's `tests/test_system.py` training cases,
plus a bit-for-bit resume).  Reduced yi-6b throughout, float32 where the
tolerance is tight.  The `cuda` cases live in `tests/test_torch_card.py`.
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
from repro.train import optimizer as jax_opt  # noqa: E402
from repro.train.train_step import make_train_step as jax_make_train_step  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.distributed import latest_step, restore_checkpoint  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import get_model, layers  # noqa: E402
from repro_torch.train import (  # noqa: E402
    OptimizerConfig,
    adamw_init,
    adamw_update,
    lr_schedule,
    make_train_step,
)
from repro_torch.train.optimizer import tree_leaves  # noqa: E402
from repro_torch.train.train_step import loss_and_grads  # noqa: E402

ARCH = "yi-6b"
B, S = 2, 24


def _pair(dtype, **changes):
    """(reference api, reference params, port api, port params): reduced
    yi-6b in ``dtype``, the reference's parameters carried across."""
    jcfg = dataclasses.replace(jax_get_arch(ARCH, reduced=True), dtype=dtype, **changes)
    cfg = dataclasses.replace(get_arch(ARCH, reduced=True), dtype=dtype, **changes)
    japi = jax_get_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    params = convert.lm_params_from_reference(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return japi, jparams, get_model(cfg, "cpu"), params


def _batch(cfg, b=B, s=S, seed=0, mask=False):
    """The same NumPy batch for both packages."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if mask:
        out["mask"] = (rng.random((b, s)) < 0.7).astype(np.float32)
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _pairs(jtree, tree):
    """(name, port leaf, reference leaf) over a parameter-shaped tree,
    port layer i against the reference's stacked slice i."""
    yield "embed", tree["embed"], np.asarray(jtree["embed"], np.float32)
    yield "final_norm", tree["final_norm"], np.asarray(jtree["final_norm"], np.float32)
    for name, stacked in jtree["blocks"].items():
        for i, blk in enumerate(tree["blocks"]):
            yield f"blocks.{i}.{name}", blk[name], np.asarray(stacked[i], np.float32)


def _within(got, want, tol):
    """max |got - want| <= tol x max |want| over one leaf."""
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    return err <= tol * float(np.max(np.abs(want))), err


# ---------------------------------------------------------------------------
# 1. the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mask", ["none", "partial", "zeros"])
def test_cross_entropy_matches_reference(mask):
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((3, 7, 37)) * 4).astype(np.float32)
    labels = rng.integers(0, 37, (3, 7)).astype(np.int32)
    m = {"none": None, "partial": (rng.random((3, 7)) < 0.5).astype(np.float32),
         "zeros": np.zeros((3, 7), np.float32)}[mask]
    want_loss, want = jax_layers.cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), None if m is None else jnp.asarray(m))
    got_loss, got = layers.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if m is None else torch.from_numpy(m))
    assert set(got) == set(want) == {"loss", "nll"}
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-6)
    for k in ("loss", "nll"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# 2. loss and gradients through the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_reference(dtype):
    japi, jparams, api, params = _pair(dtype)
    batch = _batch(api.cfg, mask=dtype == "float32")
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(japi.loss, has_aux=True))(
        jparams, _j(batch))
    loss, metrics, grads = loss_and_grads(api.loss, params, _t(batch))
    assert set(metrics) == set(jmetrics) == {"loss", "nll", "aux"}
    assert float(metrics["aux"]) == 0.0
    if dtype == "float32":
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(metrics["nll"]), float(jmetrics["nll"]), rtol=1e-5)
        for name, g, w in _pairs(jgrads, grads):
            assert g.dtype == torch.float32
            ok, err = _within(g, w, 1e-4)
            assert ok, (name, err)
        return
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-2)
    for name, g, w in _pairs(jgrads, grads):
        assert g.dtype == torch.bfloat16
        gf, wf = g.float().numpy().ravel(), w.ravel()
        cos = float(gf @ wf / (np.linalg.norm(gf) * np.linalg.norm(wf)))
        assert cos >= 0.99, (name, cos)


def test_remat_policies_change_nothing():
    """No remat, "full" and "block_io" give bit-identical gradients."""
    base = dataclasses.replace(get_arch(ARCH, reduced=True), dtype="float32")
    _, _, _, params = _pair("float32")
    batch = _t(_batch(base, seed=3))
    got = []
    for changes in ({"remat": False}, {"remat": True, "remat_policy": "full"},
                    {"remat": True, "remat_policy": "block_io"}):
        api = get_model(dataclasses.replace(base, **changes), "cpu")
        loss, _, grads = loss_and_grads(api.loss, params, batch)
        got.append((loss, tree_leaves(grads)))
    for loss, leaves in got[1:]:
        assert torch.equal(loss, got[0][0])
        assert all(torch.equal(a, b) for a, b in zip(leaves, got[0][1]))


# ---------------------------------------------------------------------------
# 4. the optimizer
# ---------------------------------------------------------------------------

OPT = dict(lr=3e-4, warmup_steps=5, total_steps=20)


def test_lr_schedule_matches_reference_within_one_ulp():
    cfg, jcfg = OptimizerConfig(**OPT), jax_opt.OptimizerConfig(**OPT)
    for step in range(OPT["total_steps"] + 6):
        got = np.float32(lr_schedule(cfg, torch.tensor(step, dtype=torch.int32)))
        want = np.float32(jax_opt.lr_schedule(jcfg, jnp.int32(step)))
        assert abs(got - want) <= np.spacing(np.abs(want)), (step, got, want)


def _state_pair(jparams, cfg, count, seed):
    """A reference AdamW state with moments drawn from ``seed`` at
    ``count``, and the port's copy of it."""
    rng = np.random.default_rng(seed)
    jstate = jax_opt.adamw_init(jparams)
    jstate["m"] = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape) * 1e-3, jnp.float32), jparams)
    jstate["v"] = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape) ** 2 * 1e-6, jnp.float32), jparams)
    jstate["count"] = jnp.int32(count)
    state = convert.opt_state_from_reference(jax.tree.map(np.asarray, jstate), cfg, "cpu")
    return jstate, state


@pytest.mark.parametrize("count,grad_scale", [
    (0, 1e-3), (OPT["warmup_steps"] - 1, 1e-3), (OPT["warmup_steps"] + 3, 1e-3),
    (OPT["warmup_steps"] + 3, 1.0), (0, 1.0),
], ids=["count0", "end-of-warmup", "past-warmup", "past-warmup-clipped", "count0-clipped"])
def test_adamw_update_matches_reference(count, grad_scale):
    japi, jparams, api, params = _pair("float32")
    cfg, jcfg = OptimizerConfig(**OPT), jax_opt.OptimizerConfig(**OPT)
    jstate, state = _state_pair(jparams, api.cfg, count, seed=count)
    rng = np.random.default_rng(100 + count)
    jgrads = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape) * grad_scale, jnp.float32), jparams)
    grads = convert.lm_params_from_reference(jax.tree.map(np.asarray, jgrads), api.cfg, "cpu")
    want_p, want_s, want_m = jax.jit(jax_opt.adamw_update, static_argnums=0)(
        jcfg, jparams, jgrads, jstate)
    got_p, got_s, got_m = adamw_update(cfg, params, grads, state)
    clipped = float(want_m["grad_norm"]) > cfg.grad_clip
    assert clipped == (grad_scale == 1.0)
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]), rtol=1e-6)
    assert got_s["count"].dtype == torch.int32 and int(got_s["count"]) == count + 1
    for tree, jtree in ((got_p, want_p), (got_s["m"], want_s["m"]), (got_s["v"], want_s["v"]),
                        (got_s["master"], want_s["master"])):
        for name, g, w in _pairs(jtree, tree):
            ok, err = _within(g, w, 1e-6)
            assert ok, (name, err)


def test_adamw_init_mirrors_the_parameters():
    _, _, api, params = _pair("bfloat16")
    state = adamw_init(params)
    assert state["count"].dtype == torch.int32 and int(state["count"]) == 0
    assert len(state["master"]["blocks"]) == api.cfg.num_layers
    for p, ms in zip(tree_leaves(params), tree_leaves(state["master"])):
        assert ms.dtype == torch.float32 and ms.shape == p.shape
        assert ms.data_ptr() != p.data_ptr() and torch.equal(ms, p.float())


# ---------------------------------------------------------------------------
# 5. the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference_jitted_step(microbatches):
    """Three steps through both packages from the same parameters and
    state on the same batches: the losses within 1e-5 relative and the
    final master within 1e-5 x its leaf's max.  The packages sum in
    different orders, so their gradients differ by float32 noise, ~2e-8 x
    the leaf's max |gradient|; where a gradient is within 500x of that
    (below 1e-5 x the max at some step), Adam's step g / (|g| + eps)
    turns the noise into a step that differs by more than 0.2%: there
    the master is held to the sum of the steps' learning rates, and such
    elements must stay under 1%."""
    japi, jparams, api, params = _pair("float32")
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=3)
    jstep = jax.jit(jax_make_train_step(japi.loss, jax_opt.OptimizerConfig(**opt),
                                        microbatches=microbatches))
    step = make_train_step(api.loss, OptimizerConfig(**opt), microbatches=microbatches)
    jstate, state = jax_opt.adamw_init(jparams), adamw_init(params)
    quiet, lr_sum = None, 0.0
    for i in range(3):
        batch = _batch(api.cfg, b=4, s=16, seed=10 + i)
        _, _, grads = loss_and_grads(api.loss, params, _t(batch))
        q = [g.abs() < 1e-5 * g.abs().max() for g in tree_leaves(grads)]
        quiet = q if quiet is None else [a | b for a, b in zip(quiet, q)]
        jparams, jstate, jm = jstep(jparams, jstate, _j(batch))
        params, state, m = step(params, state, _t(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        assert set(m) == set(jm)
        lr_sum += float(m["lr"])
    assert int(state["count"]) == 3
    quiet_of = {id(t): qm for t, qm in zip(tree_leaves(state["master"]), quiet)}
    n_quiet = sum(int(qm.sum()) for qm in quiet)
    assert n_quiet < 1e-2 * sum(qm.numel() for qm in quiet), n_quiet
    for name, g, w in _pairs(jstate["master"], state["master"]):
        qm = quiet_of[id(g)].numpy()
        err = np.abs(g.numpy() - w)
        assert float(err[~qm].max()) <= 1e-5 * float(np.abs(w).max()), name
        assert not qm.any() or float(err[qm].max()) <= lr_sum, name


# ---------------------------------------------------------------------------
# 7. the entry point on the host (the reference's tests/test_system.py)
# ---------------------------------------------------------------------------

def _argv(*extra):
    return ["--arch", ARCH, "--reduced", "--device", "cpu", *extra]


def test_launcher_checkpoint_restart_resumes(tmp_path):
    ckpt = str(tmp_path / "ck")
    args = _argv("--steps", "12", "--global-batch", "2", "--seq", "32", "--warmup", "2",
                 "--checkpoint-dir", ckpt, "--checkpoint-every", "5")
    train_mod.main(args)
    assert latest_step(ckpt) == 12
    args[args.index("12")] = "16"
    train_mod.main(args)
    assert latest_step(ckpt) == 16


def test_launcher_microbatched_matches_single_batch_loss():
    common = ("--steps", "1", "--global-batch", "4", "--seq", "32")
    o1 = train_mod.main(_argv(*common, "--microbatches", "1"))
    o2 = train_mod.main(_argv(*common, "--microbatches", "4"))
    assert abs(o1["first_loss"] - o2["first_loss"]) < 2e-2


def test_launcher_loss_decreases():
    out = train_mod.main(_argv("--steps", "30", "--global-batch", "4", "--seq", "64",
                               "--warmup", "5", "--lr", "3e-3", "--log-every", "10"))
    assert out["last_loss"] < out["first_loss"], out


def test_launcher_resume_is_bit_for_bit(tmp_path, monkeypatch):
    """Steps 13-16 of a run stopped at step 12 and resumed give the
    losses, and the final state, of one uninterrupted 16-step run."""
    losses = []
    real = train_mod.make_train_step

    def recording(*a, **kw):
        step = real(*a, **kw)

        def run(params, state, batch):
            out = step(params, state, batch)
            losses.append(float(out[2]["loss"]))
            return out
        return run

    monkeypatch.setattr(train_mod, "make_train_step", recording)
    common = ("--global-batch", "2", "--seq", "32", "--checkpoint-every", "5")
    whole, cut = str(tmp_path / "whole"), str(tmp_path / "cut")
    train_mod.main(_argv("--steps", "16", "--checkpoint-dir", whole, *common))
    want = losses[12:]
    train_mod.main(_argv("--steps", "12", "--checkpoint-dir", cut, *common))
    del losses[:]
    train_mod.main(_argv("--steps", "16", "--checkpoint-dir", cut, *common))
    assert losses == want and len(want) == 4
    api = get_model(get_arch(ARCH, reduced=True), "cpu")
    params = api.init(torch.Generator().manual_seed(0))
    like = (params, adamw_init(params))
    a, sa = restore_checkpoint(whole, like, device="cpu")
    b, sb = restore_checkpoint(cut, like, device="cpu")
    assert sa == sb == 16
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_launcher_refuses_a_model_axis():
    """On one device the mesh's size (1) does not divide by a model axis
    of 2: `make_host_mesh` fails the reference's assertion before any
    step, and the process group it started is gone."""
    import torch.distributed as dist
    with pytest.raises(AssertionError):
        train_mod.main(_argv("--steps", "1", "--model-axis", "2"))
    assert not dist.is_initialized()
