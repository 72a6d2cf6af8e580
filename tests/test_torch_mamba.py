"""The port's Mamba mixer (`repro_torch.models.mamba`) against the
reference's (`repro.models.mamba`, plain `jnp` on the CPU), from the same
NumPy inputs and the reference's parameters, in float32: `mamba_train`
(output and returned state, one chunk and several, remat on and off, and
its gradients), `mamba_decode`, and `softplus`.  Also pins ROADMAP queue
C 25: a prefill shorter than ``d_conv - 1`` keeps a short conv state in
the reference, so its next decode step raises; the port left-pads the
state with zeros.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import mamba as jax_mamba  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import mamba  # noqa: E402

ARCH = "jamba-1.5-large-398b"


def _np(a):
    return np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)


def _cfgs(**kw):
    kw = {"dtype": "float32", **kw}
    jcfg = dataclasses.replace(jax_get_arch(ARCH, reduced=True), **kw)
    return jcfg, dataclasses.replace(get_arch(ARCH, reduced=True), **kw)


def _params(jcfg, seed=0):
    """The reference's mixer parameters, as jnp and as torch tensors."""
    jp = jax_mamba.init_mamba_params(jcfg, jax.random.PRNGKey(seed))
    # give conv_b and d_skip values of their own so both enter the check
    rng = np.random.default_rng(seed)
    jp = {**jp, "conv_b": jnp.asarray(rng.standard_normal(jp["conv_b"].shape) * 0.1,
                                      jnp.float32),
          "d_skip": jnp.asarray(rng.random(jp["d_skip"].shape) + 0.5, jnp.float32)}
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _x(b, s, d, seed=1):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _close(got, want, tol=1e-4):
    want = np.asarray(want)
    err = float(np.abs(_np(got) - want).max())
    assert err <= tol * float(np.abs(want).max()), (err, float(np.abs(want).max()))


def test_param_shapes_and_dtypes_follow_the_reference():
    jcfg, cfg = _cfgs(dtype="bfloat16")
    jp = jax_mamba.init_mamba_params(jcfg, jax.random.PRNGKey(0))
    p = mamba.init_mamba_params(cfg, torch.Generator().manual_seed(0))
    assert set(p) == set(jp) == set(mamba.param_shapes(cfg))
    for name, w in p.items():
        assert tuple(w.shape) == jp[name].shape == mamba.param_shapes(cfg)[name]
        assert str(w.dtype).split(".")[1] == jp[name].dtype.name
        assert w.dtype == mamba.leaf_dtype(cfg, name)
    for name in ("a_log", "dt_bias", "d_skip"):
        np.testing.assert_allclose(_np(p[name]), np.asarray(jp[name]), rtol=1e-6)


def test_softplus_matches_jax():
    """`mamba.softplus` is ``jax.nn.softplus`` (log(1 + e^x) for every x,
    where torch's own switches to x above its threshold)."""
    x = np.concatenate([np.linspace(-80, 80, 3201), [-1e4, 1e-7, 1e4]]).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = _np(mamba.softplus(torch.from_numpy(x)))
    # XLA on the CPU flushes the subnormal results below x = -87 to 0
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=1e-37)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("s,chunk", [(24, 256), (24, 8), (32, 16)])
def test_mamba_train_and_state_match_reference(s, chunk, remat):
    jcfg, cfg = _cfgs(remat=remat)
    jp, p = _params(jcfg)
    x = _x(2, s, cfg.d_model)
    jy, jst = jax_mamba.mamba_train(jcfg, jp, jnp.asarray(x), chunk=chunk, return_state=True)
    y, st = mamba.mamba_train(cfg, p, torch.from_numpy(x), chunk=chunk, return_state=True)
    _close(y, jy)
    _close(st["h"], jst["h"])
    _close(st["conv"], jst["conv"])
    _close(mamba.mamba_train(cfg, p, torch.from_numpy(x), chunk=chunk), jy)


def test_mamba_train_gradients_match_reference():
    jcfg, cfg = _cfgs()
    jp, p = _params(jcfg)
    x = _x(2, 16, cfg.d_model)
    w = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)

    def jloss(jp, x):
        return jnp.sum(jax_mamba.mamba_train(jcfg, jp, x, chunk=8) * w)
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    (mamba.mamba_train(cfg, leaves, xt, chunk=8) * torch.from_numpy(w)).sum().backward()
    _close(xt.grad, jgx)
    for name, leaf in leaves.items():
        _close(leaf.grad, jg[name])


def test_chunk_must_divide_the_sequence():
    _, cfg = _cfgs()
    p = mamba.init_mamba_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="multiple of the scan chunk"):
        mamba.mamba_train(cfg, p, torch.zeros((1, 24, cfg.d_model)), chunk=16)


def test_mamba_decode_matches_reference_over_steps():
    jcfg, cfg = _cfgs()
    jp, p = _params(jcfg)
    x = _x(2, 6, cfg.d_model, seed=4)
    jst = jax_mamba.init_mamba_state(jcfg, 2)
    st = mamba.init_mamba_state(cfg, 2, "cpu")
    for name in jst:
        assert tuple(st[name].shape) == jst[name].shape
    for t in range(x.shape[1]):
        jy, jst = jax_mamba.mamba_decode(jcfg, jp, jnp.asarray(x[:, t:t + 1]), jst)
        y, st = mamba.mamba_decode(cfg, p, torch.from_numpy(x[:, t:t + 1]), st)
        _close(y, jy)
        _close(st["h"], jst["h"])
        _close(st["conv"], jst["conv"])
    # and the decode steps end where the parallel scan ends
    y_all, st_all = mamba.mamba_train(cfg, p, torch.from_numpy(x), return_state=True)
    _close(y, _np(y_all)[:, -1:])
    _close(st["h"], _np(st_all["h"]))


@pytest.mark.parametrize("s", [1, 2, 3])
def test_c25_short_prefill_state_continues_like_sequential_decode(s):
    """ROADMAP queue C 25: a prefill of s < d_conv - 1 tokens, then one
    decode step, equals s + 1 decode steps from `init_mamba_state` in the
    port.  The reference's ``xi[:, s - (d_conv - 1):]`` starts from the
    end when negative: its conv state is short and the next decode step
    raises."""
    jcfg, cfg = _cfgs()
    jp, p = _params(jcfg)
    x = _x(2, s + 1, cfg.d_model, seed=5)
    conv = cfg.mamba_d_conv
    _, st = mamba.mamba_train(cfg, p, torch.from_numpy(x[:, :s]), return_state=True)
    assert tuple(st["conv"].shape) == (2, conv - 1, mamba._d_inner(cfg))
    y, st = mamba.mamba_decode(cfg, p, torch.from_numpy(x[:, s:]), st)
    seq = mamba.init_mamba_state(cfg, 2, "cpu")
    for t in range(s + 1):
        y_seq, seq = mamba.mamba_decode(cfg, p, torch.from_numpy(x[:, t:t + 1]), seq)
    _close(y, _np(y_seq), 1e-5)
    _close(st["h"], _np(seq["h"]), 1e-5)
    _close(st["conv"], _np(seq["conv"]), 1e-6)
    _, jst = jax_mamba.mamba_train(jcfg, jp, jnp.asarray(x[:, :s]), return_state=True)
    if s >= conv - 1:
        assert jst["conv"].shape == tuple(st["conv"].shape)
        return
    assert jst["conv"].shape[1] < conv - 1
    with pytest.raises(ValueError):
        jax_mamba.mamba_decode(jcfg, jp, jnp.asarray(x[:, s:]), jst)
