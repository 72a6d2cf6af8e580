"""The port's dry run (`repro_torch.launch.dryrun`) against the
reference's.

`count_params` equals the reference's for all ten full archs (the
reference's module is imported with ``XLA_FLAGS`` saved and restored:
its first lines force 512 host devices into the environment, which
every later child process of the test worker would inherit).  A
subprocess run of the port's dry run for yi-6b ``decode_32k`` on 16x16
(the fake process group lives in that process only) writes ``status:
ok``, per-device argument bytes equal to the sum worked out from the
reference's shardings over the reference's abstract parameters, cache
and token, and a FLOP count equal, within 1%, to the one worked out by
hand from the config.  A cell `shape_supported` rejects is ``skipped``
with the reference's reason, and starts no process group.
"""

import json
import math
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import shape_supported as jax_shape_supported  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import get_model  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def _reference_dryrun():
    """`repro.launch.dryrun`, imported with the environment's XLA_FLAGS
    put back as they were."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_count_params_equals_the_reference(arch):
    saved = os.environ.get("XLA_FLAGS")
    ref = _reference_dryrun()
    assert os.environ.get("XLA_FLAGS") == saved
    want = ref.count_params(jax.eval_shape(jax_get_model(JAX_ARCHS[arch]).init,
                                           jax.random.PRNGKey(0)), JAX_ARCHS[arch])
    with FakeTensorMode():
        params = get_model(ARCHS[arch], "cpu").init(torch.Generator().manual_seed(0))
    assert dryrun.count_params(params, ARCHS[arch]) == want


class FakeMesh:
    def __init__(self, **axes):
        self.shape = dict(axes)


def _reference_argument_bytes(arch, shape_name, mesh, monkeypatch):
    """Per-device bytes of the decode cell's (params, cache, token) from
    the reference's shardings over its abstract trees."""
    cfg, shape = JAX_ARCHS[arch], JAX_SHAPES[shape_name]
    api = jax_get_model(cfg)
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: spec)
    jsh.set_dp_over_model(cfg.dp_over_model)
    try:
        params = jax.eval_shape(api.init, jax.random.PRNGKey(0))
        cache = jax.eval_shape(lambda: api.init_cache(shape.global_batch, shape.seq_len))
        tok = {"token": jax.ShapeDtypeStruct((shape.global_batch,), jnp.int32)}
        specs = (jsh.param_shardings(params, cfg, mesh),
                 jsh.cache_shardings(cache, cfg, mesh, batch_size=shape.global_batch),
                 jsh.batch_shardings(tok, mesh))
    finally:
        jsh.set_dp_over_model(False)
    total = 0
    for tree, spec_tree in zip((params, cache, tok), specs):
        leaves = jax.tree.leaves(tree)
        spec_leaves = jax.tree.leaves(spec_tree, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
        assert len(leaves) == len(spec_leaves)
        for leaf, spec in zip(leaves, spec_leaves):
            local = list(leaf.shape)
            for i, part in enumerate(spec):
                if part is not None:
                    names = part if isinstance(part, tuple) else (part,)
                    local[i] //= math.prod(mesh.shape[n] for n in names)
            total += math.prod(local) * np.dtype(leaf.dtype).itemsize
    return total


def _decode_flops(cfg, b, s):
    """The matrix products of one decode step, by hand: the projections
    and the FFN of every layer, attention over the whole ``s``-long
    cache (scores and values), and the logits."""
    hd = cfg.head_dim or cfg.d_model // cfg.num_heads
    d = cfg.d_model
    per_layer = (2 * b * d * cfg.num_heads * hd            # wq
                 + 2 * 2 * b * d * cfg.num_kv_heads * hd   # wk, wv
                 + 2 * b * cfg.num_heads * hd * d          # wo
                 + 3 * 2 * b * d * cfg.d_ff                # w_gate, w_up, w_down
                 + 2 * 2 * b * cfg.num_heads * s * hd)     # q k^T, p v
    return cfg.num_layers * per_layer + 2 * b * d * cfg.padded_vocab


def test_decode_cell_in_a_subprocess_matches_the_reference_bytes(tmp_path, monkeypatch):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "yi-6b",
         "--shape", "decode_32k", "--mesh", "single", "--out", str(tmp_path),
         "--subprocess"],
        env=dict(os.environ, PYTHONPATH=str(SRC)), capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads((tmp_path / "yi-6b__decode_32k__16x16.json").read_text())
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["num_devices"] == 256
    want = _reference_argument_bytes("yi-6b", "decode_32k", FakeMesh(data=16, model=16),
                                     monkeypatch)
    assert rec["memory"]["argument_bytes"] == want
    assert 0 < rec["memory"]["output_bytes"] <= want
    flops = _decode_flops(ARCHS["yi-6b"], 128, 32768)
    assert abs(rec["flops"] - flops) <= 0.01 * flops, (rec["flops"], flops)
    assert rec["flops_per_device"] == rec["flops"] / 256
    with FakeTensorMode():
        params = get_model(ARCHS["yi-6b"], "cpu").init(torch.Generator().manual_seed(0))
    assert rec["params"] == dryrun.count_params(params, ARCHS["yi-6b"])
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch,shape_name", [
    (a, s) for a in sorted(ARCHS) for s in ("long_500k", "decode_32k")
    if not jax_shape_supported(JAX_ARCHS[a], JAX_SHAPES[s])[0]])
def test_skipped_cell_carries_the_reference_reason(arch, shape_name, tmp_path):
    rec = dryrun.run_cell(arch, shape_name, False, str(tmp_path))
    assert rec["status"] == "skipped"
    assert rec["reason"] == jax_shape_supported(JAX_ARCHS[arch], JAX_SHAPES[shape_name])[1]
    assert json.loads((tmp_path / f"{arch}__{shape_name}__16x16.json").read_text()) == rec
    assert not dist.is_initialized()
