"""The port's int8 error-feedback all-reduce
(`repro_torch.distributed.collectives`) against the reference's.

`quantize_int8` / `dequantize_int8` bit for bit against the reference's
over seeds and adversarial values (all zeros, values on the half-way
ties of a 127-step scale, one huge element among small ones); the
reference's error bound as a hypothesis property, and its error
feedback converging in mean; `make_compressed_allreduce` on a gloo
world of one against the reference's on jax's one-device host mesh,
bit for bit over 3 error-feedback steps of a reduced yi-6b's gradient
trees (the same tree layout on both sides: quantization is per leaf);
and 4 gloo ranks, each with its own gradients, against the reference's
`compressed_psum_leaf` under a `shard_map` over 4 forced host devices
(both in subprocesses of their own: the ranks, and JAX with its device
count forced), output and residual bit for bit on every rank.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.distributed import collectives as jcol  # noqa: E402
from repro.launch.mesh import make_host_mesh as jax_host_mesh  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.distributed import collectives as col  # noqa: E402
from repro_torch.distributed.sharding import tree_leaves_with_path  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.train.train_step import loss_and_grads  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(autouse=True)
def _no_group_outlives_a_test():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _adversarial():
    rng = np.random.default_rng(7)
    ties = (np.arange(-127, 128, dtype=np.float32) + 0.5) * np.float32(3.0 / 127.0)
    huge = rng.standard_normal(1000).astype(np.float32) * 1e-3
    huge[417] = 3e38
    return {
        "zeros": np.zeros(64, np.float32),
        "ties": ties,
        "ties_neg": -ties,
        "huge": huge,
        "tiny": np.full(33, 1e-30, np.float32),
        "one": np.array([-2.5], np.float32),
    }


CASES = [pytest.param(("seed", s), id=f"seed{s}") for s in range(8)] + [
    pytest.param(("adv", k), id=k) for k in _adversarial()]


@pytest.mark.parametrize("case", CASES)
def test_quantize_and_dequantize_bit_equal_to_reference(case):
    kind, key = case
    if kind == "seed":
        rng = np.random.default_rng(key)
        x = (rng.standard_normal((17, 33)) * 10.0 ** rng.uniform(-6, 4)).astype(np.float32)
    else:
        x = _adversarial()[key]
    jq, js = jcol.quantize_int8(jnp.asarray(x))
    q, s = col.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert _bits(s.numpy()) == _bits(np.asarray(js))
    np.testing.assert_array_equal(_bits(col.dequantize_int8(q, s).numpy()),
                                  _bits(jcol.dequantize_int8(jq, js)))


@settings(max_examples=10, deadline=None)
@given(st.lists(st.floats(-1e4, 1e4, allow_nan=False), min_size=1, max_size=64))
def test_property_int8_quantization_error_bounded(xs):
    x = torch.tensor(np.array(xs, np.float32))
    q, scale = col.quantize_int8(x)
    deq = col.dequantize_int8(q, scale)
    err = (deq - x).abs().numpy()
    assert (err <= float(scale) * 0.5 + 1e-6).all()


def test_error_feedback_converges_in_mean():
    """Repeated compress+feedback of a constant recovers it on average."""
    x = torch.from_numpy(np.full((32,), 0.001, np.float32)
                         + np.random.default_rng(0).normal(0, 1, 32).astype(np.float32))
    err = torch.zeros_like(x)
    total = torch.zeros_like(x)
    for _ in range(50):
        q, scale = col.quantize_int8(x + err)
        deq = col.dequantize_int8(q, scale)
        err = (x + err) - deq
        total = total + deq
    np.testing.assert_allclose((total / 50).numpy(), x.numpy(), atol=1e-3)


def _grad_trees(steps=3):
    """The reduced yi-6b's float32 gradient trees of ``steps`` batches."""
    import dataclasses
    cfg = dataclasses.replace(get_arch("yi-6b", reduced=True), dtype="float32")
    api = get_model(cfg, "cpu")
    params = api.init(torch.Generator().manual_seed(0))
    out = []
    for step in range(steps):
        rng = np.random.default_rng(step)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 17)), dtype=torch.int32)
        _, _, grads = loss_and_grads(api.loss, params, {"tokens": toks[:, :-1],
                                                        "labels": toks[:, 1:]})
        out.append(grads)
    return out


def _as_jax(tree):
    if isinstance(tree, dict):
        return {k: _as_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_jax(v) for v in tree)
    return jnp.asarray(tree.numpy())


def _by_path(tree) -> dict:
    """A JAX tree's leaves by their "/"-joined paths (keys, indices)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(e, "key", getattr(e, "idx", ""))) for e in path): leaf
            for path, leaf in flat}


def _part(tree):
    """Four leaves of a gradient tree (embedding, one layer's wq and
    w_down, the final norm), in its layout."""
    return {"embed": tree["embed"], "blocks": [{n: tree["blocks"][0][n] for n in ("wq", "w_down")}],
            "final_norm": tree["final_norm"]}


@pytest.mark.parametrize("whole", [
    pytest.param(False, id="four_leaves"), pytest.param(True, id="whole", marks=pytest.mark.slow)])
def test_compressed_allreduce_on_one_rank_bit_equal_to_reference(whole):
    """A gloo world of one against the reference's `shard_map` (run as the
    reference runs it, not under `jax.jit`, which changes its float32
    bits) on its host mesh of one device: three error-feedback steps,
    the output and the residual of every leaf bit for bit; on one rank
    the output is dequantize(quantize(g + err)) and the residual what
    that drops.  Tier 1 takes four leaves of the tree (the reference's
    eager `shard_map` compiles each operation at each leaf's shape);
    ``-m slow`` the whole tree."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    reduce_fn = col.make_compressed_allreduce(make_host_mesh(1, "cpu"))
    jreduce = jcol.make_compressed_allreduce(jax_host_mesh(1))
    trees = [t if whole else _part(t) for t in _grad_trees()]
    err = col.init_error_state(trees[0])
    jerr = _as_jax(err)
    for grads in trees:
        out, new_err = reduce_fn(grads, err)
        jout, jnew = jreduce(_as_jax(grads), jerr)
        leaves = tree_leaves_with_path(grads)
        for (path, g), (_, o), (_, e), (_, e0) in zip(
                leaves, tree_leaves_with_path(out), tree_leaves_with_path(new_err),
                tree_leaves_with_path(err)):
            q, s = col.quantize_int8(g + e0)
            np.testing.assert_array_equal(_bits(o.numpy()),
                                          _bits(col.dequantize_int8(q, s).numpy()), path)
            np.testing.assert_array_equal(_bits(e.numpy()), _bits((g + e0 - o).numpy()), path)
        for mine, ref in ((out, jout), (new_err, jnew)):
            want = _by_path(ref)
            got = tree_leaves_with_path(mine)
            assert len(got) == len(want)
            for path, leaf in got:
                np.testing.assert_array_equal(_bits(leaf.numpy()), _bits(want[path]), path)
        err, jerr = new_err, jnew
    assert col.bf16_grads(out)["embed"].dtype == torch.bfloat16


_RANK = r"""
import json, sys
import numpy as np
import torch, torch.distributed as dist
from repro_torch.distributed import collectives as col
from repro_torch.launch.mesh import make_host_mesh
rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)
rng = np.random.default_rng(100 + rank)
grads = {"w": torch.from_numpy((rng.standard_normal((64, 48)) * (rank + 1)).astype(np.float32)),
         "b": [torch.from_numpy(rng.standard_normal(96).astype(np.float32))]}
err = col.init_error_state(grads)
reduce_fn = col.make_compressed_allreduce(make_host_mesh(1, "cpu"))
res = {}
for step in range(3):
    grads = {"w": grads["w"] * 0.5 + step, "b": [grads["b"][0] - step]}
    o, err = reduce_fn(grads, err)
    res[f"o{step}_w"], res[f"o{step}_b"] = o["w"].numpy(), o["b"][0].numpy()
    res[f"e{step}_w"], res[f"e{step}_b"] = err["w"].numpy(), err["b"][0].numpy()
np.savez(out, **res)
dist.destroy_process_group()
"""

_JAX_SHARDS = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.distributed.collectives import compressed_psum_leaf
world, out = int(sys.argv[1]), sys.argv[2]
mesh = Mesh(np.asarray(jax.devices()[:world]), ("data",))

def leaf(x, e):
    o, ne = jax.shard_map(lambda x, e: tuple(a[None] for a in compressed_psum_leaf(
        x[0], e[0], ("data",))), mesh=mesh, in_specs=(P("data"), P("data")),
        out_specs=(P("data"), P("data")), check_vma=False)(x, e)
    return np.asarray(o), np.asarray(ne)

rngs = [np.random.default_rng(100 + r) for r in range(world)]
w = np.stack([(g.standard_normal((64, 48)) * (r + 1)).astype(np.float32)
              for r, g in enumerate(rngs)])
b = np.stack([g.standard_normal(96).astype(np.float32) for g in rngs])
ew, eb = np.zeros_like(w), np.zeros_like(b)
res = {}
for step in range(3):
    w, b = w * np.float32(0.5) + np.float32(step), b - np.float32(step)
    (ow, ew), (ob, eb) = leaf(w, ew), leaf(b, eb)
    res[f"o{step}_w"], res[f"o{step}_b"], res[f"e{step}_w"], res[f"e{step}_b"] = ow, ob, ew, eb
np.savez(out, **res)
"""


def test_compressed_allreduce_on_four_ranks_matches_reference(tmp_path):
    """4 gloo ranks (processes of their own, a file store), each with its
    own gradients, three feedback steps, against the reference's
    `compressed_psum_leaf` under `shard_map` over 4 forced host devices:
    every rank's output and residual bit for bit; the output is the
    same on every rank."""
    world = 4
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), str(world),
                               str(tmp_path / "store"), str(tmp_path / f"rank{r}.npz")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(world)]
    ref = subprocess.run([sys.executable, "-c", _JAX_SHARDS, str(world),
                          str(tmp_path / "ref.npz")], env=env, capture_output=True,
                         text=True, timeout=240)
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err.decode()[-3000:]
    assert ref.returncode == 0, ref.stderr[-3000:]
    want = np.load(tmp_path / "ref.npz")
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]
    for key in want.files:
        for r, got in enumerate(ranks):
            np.testing.assert_array_equal(_bits(got[key]), _bits(want[key][r]),
                                          json.dumps([key, r]))
        if key.startswith("o"):
            for got in ranks[1:]:
                np.testing.assert_array_equal(_bits(got[key]), _bits(ranks[0][key]))
