"""The port's partitioned train step on a mesh of more than one rank
against the reference's jitted step on a JAX host mesh of the same
shape.

(a) 4 gloo ranks (processes of their own, a file store) run the reduced
yi-6b for 3 steps on a (data, model) = (2, 2) mesh: parameters carried
from the reference (`convert.lm_params_from_reference`, float32), placed
by `param_shardings`, the optimizer state by `opt_state_shardings`
(ZeRO-1), each NumPy batch by `place_batch`.  They are held against
`jax.jit(make_train_step(...))` over 4 forced host devices (its own
subprocess; `make_host_mesh`'s mesh with Auto axes, the GSPMD mesh the
reference's step is written for; parameters placed by the reference's
`param_shardings`, the batch handed over as its launcher hands it) and
against the port's one-rank step in
this process: the loss and `grad_norm` within 1e-5 relative at every
step; the final master and parameters within 1e-5 x the leaf's max under
the quiet-element rule of `tests/test_torch_train.py`; every rank's
local shape and placements of every parameter and state leaf as its
spec says.  (b) the same at (4, 1), at (1, 4) (the reduced yi-6b's 2 KV
heads do not divide the model axis: k and v are replicated there), and
for the reduced mistral-large-123b at (2, 2) with its full config's
``fsdp_params`` (weights sharded over ``data`` too), under ``-m slow``
with the rest of the microbatch matrix.  (c) `launch.train --model-axis
2` on 4 gloo ranks against one rank, float32: losses, a checkpoint
saved on the mesh restored with ``shardings=`` to the saved bits, and a
resumed run.  (d) a moe arch on a mesh of 2 raises before any step.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.distributed.sharding import tree_leaves_with_path  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.train import OptimizerConfig, adamw_init, make_train_step  # noqa: E402
from repro_torch.train.train_step import loss_and_grads  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
WORLD = 4
STEPS = 3
B, S = 4, 16
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=3)
TIMEOUT_S = 300


@pytest.fixture(autouse=True)
def _no_group_outlives_a_test():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _env():
    return dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")


def _ranks(script, tmp_path, *args):
    """``script`` started as WORLD gloo ranks sharing a file store under
    ``tmp_path``; each gets (rank, world, store, *args)."""
    store = tmp_path / "store"
    return [subprocess.Popen([sys.executable, "-c", script, str(r), str(WORLD), str(store),
                              *map(str, args)], env=_env(), stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE) for r in range(WORLD)]


def _wait(procs):
    for p in procs:
        try:
            _, err = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err.decode()[-4000:]


def _configs(arch, fsdp):
    """(reference config, port config): reduced ``arch`` in float32, with
    ``fsdp_params`` as asked (the reduced configs leave it off)."""
    change = dict(dtype="float32", fsdp_params=fsdp)
    return (dataclasses.replace(jax_get_arch(arch, reduced=True), **change),
            dataclasses.replace(get_arch(arch, reduced=True), **change))


def _batches(cfg):
    """STEPS NumPy batches of B x S tokens from a seed, for every side,
    each with a mask: a microbatch's loss is the mean over its own
    masked tokens, so it shows which global rows the microbatch holds."""
    out = []
    for i in range(STEPS):
        rng = np.random.default_rng(10 + i)
        toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        mask = (rng.random((B, S)) < 0.3 + 0.2 * np.arange(B)[:, None]).astype(np.float32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask})
    return out


_RANK = r"""
import dataclasses, json, sys
import numpy as np, torch, torch.distributed as dist
from torch.distributed.tensor import DTensor
from repro_torch.configs import get_arch
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import get_model
from repro_torch.train import OptimizerConfig, adamw_init, make_train_step
(rank, world, store, arch, fsdp, model_axis, micro, steps, opt, params_path, batches_path,
 out) = sys.argv[1:]
rank, world, model_axis, micro, steps = map(int, (rank, world, model_axis, micro, steps))
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)
cfg = dataclasses.replace(get_arch(arch, reduced=True), dtype="float32",
                          fsdp_params=fsdp == "1")
api = get_model(cfg, "cpu")
saved, data = np.load(params_path), np.load(batches_path)
params = sh.tree_map_with_path(lambda p, x: torch.from_numpy(saved[p]),
                               api.init(torch.Generator().manual_seed(0)))
mesh = make_host_mesh(model_axis, "cpu")
losses, norms, bad = [], [], []
with sh.use_mesh(mesh):
    psh = sh.param_shardings(params, cfg, mesh)
    params = sh.device_put(params, psh)
    state = adamw_init(params, sh.opt_state_shardings(params, cfg, mesh))
    step = make_train_step(api.loss, OptimizerConfig(**json.loads(opt)), microbatches=micro)
    for i in range(steps):
        batch = sh.place_batch({k: data[f"{k}{i}"] for k in ("tokens", "labels", "mask")}, mesh)
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    for tree, shardings in ((params, psh), (state, sh.opt_state_shardings(state, cfg, mesh))):
        want = dict(sh.tree_leaves_with_path(shardings))
        for path, x in sh.tree_leaves_with_path(tree):
            s = want[path]
            if not (isinstance(x, DTensor) and tuple(x.placements) == s.placements()
                    and tuple(x.to_local().shape) == s.local_shape(x.shape)):
                bad.append([path, str(s.spec), str(getattr(x, "placements", None))])
    whole = {f"{name}/{path}": x.full_tensor().numpy()
             for name, tree in (("master", state["master"]), ("params", params))
             for path, x in sh.tree_leaves_with_path(tree)}
if rank == 0:
    np.savez(out + ".npz", **whole)
with open(f"{out}.{rank}.json", "w") as f:
    json.dump({"losses": losses, "norms": norms, "bad": bad,
               "sharded": sum(s.local_shape(x.shape) != tuple(x.shape) for (_, x), (_, s)
                              in zip(sh.tree_leaves_with_path(params),
                                     sh.tree_leaves_with_path(psh)))}, f)
dist.destroy_process_group()
"""

_JAX = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, json
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_arch
from repro.distributed.sharding import param_shardings
from jax.sharding import AxisType
from repro.launch.mesh import make_host_mesh
from repro.models import get_model
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step
arch, fsdp, model_axis, micro, steps, opt, batches_path, out = sys.argv[1:]
cfg = dataclasses.replace(get_arch(arch, reduced=True), dtype="float32",
                          fsdp_params=fsdp == "1")
api = get_model(cfg)
# `make_host_mesh`'s shape and names with Auto axes: the GSPMD
# partitioning the reference's step is written for (`jax.make_mesh`'s
# default, Explicit axes, refuses its embedding gather on a sharded
# table: `explicit_error` below)
n = len(jax.devices())
mesh = jax.make_mesh((n // int(model_axis), int(model_axis)), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
data = np.load(batches_path)
losses, norms = [], []
# ROADMAP queue C 30: the reference's own `make_host_mesh` (Explicit
# axes) refuses its loss once the vocabulary shards over `model`
explicit_error = None
if int(model_axis) > 1:
    explicit = make_host_mesh(int(model_axis))
    try:
        with explicit:
            p0 = jax.device_put(api.init(jax.random.PRNGKey(0)), param_shardings(
                jax.eval_shape(api.init, jax.random.PRNGKey(0)), cfg, explicit))
            jax.jit(api.loss)(p0, {k: jnp.asarray(data[f"{k}0"])
                                   for k in ("tokens", "labels", "mask")})
    except Exception as e:  # recorded for the test to hold, not handled
        explicit_error = type(e).__name__
with mesh:
    params = api.init(jax.random.PRNGKey(0))
    psh = param_shardings(jax.eval_shape(api.init, jax.random.PRNGKey(0)), cfg, mesh)
    params = jax.device_put(params, psh)
    state = jopt.adamw_init(params)
    step = jax.jit(make_train_step(api.loss, jopt.OptimizerConfig(**json.loads(opt)),
                                   microbatches=int(micro)))
    for i in range(int(steps)):
        batch = {k: jnp.asarray(data[f"{k}{i}"]) for k in ("tokens", "labels", "mask")}
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
flat, _ = jax.tree_util.tree_flatten_with_path({"master": state["master"], "params": params})
np.savez(out + ".npz", **{"/".join(str(getattr(e, "key", getattr(e, "idx", ""))) for e in path):
                          np.asarray(leaf) for path, leaf in flat})
with open(out + ".json", "w") as f:
    json.dump({"losses": losses, "norms": norms, "devices": len(jax.devices()),
               "explicit_error": explicit_error}, f)
"""


def _reference_leaf(ref, name, path):
    """The reference's leaf of port ``path`` (``blocks/i/wq`` is slice i
    of the stacked ``blocks/wq``)."""
    parts = path.split("/")
    if parts[0] == "blocks":
        return ref[f"{name}/blocks/{parts[2]}"][int(parts[1])]
    return ref[f"{name}/{path}"]


def _close(got, want, quiet, lr_sum, what):
    """Within 1e-5 x the leaf's max outside the quiet elements, within
    the steps' summed learning rates on them."""
    err = np.abs(got - want)
    assert float(err[~quiet].max(initial=0.0)) <= 1e-5 * float(np.abs(want).max()), what
    assert not quiet.any() or float(err[quiet].max()) <= lr_sum, what


def _mesh_case(tmp_path, arch, fsdp, model_axis, micro):
    """(a) and (b): the 4 ranks, the reference's jitted step and the
    port's one-rank step on the same parameters and batches."""
    jcfg, cfg = _configs(arch, fsdp)
    jparams = jax_get_model(jcfg).init(jax.random.PRNGKey(0))
    params = convert.lm_params_from_reference(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    np.savez(tmp_path / "params.npz",
             **{p: x.numpy() for p, x in tree_leaves_with_path(params)})
    batches = _batches(cfg)
    np.savez(tmp_path / "batches.npz", **{f"{k}{i}": v for i, b in enumerate(batches)
                                          for k, v in b.items()})
    common = (arch, int(fsdp), model_axis, micro, STEPS, json.dumps(OPT))
    ref = subprocess.Popen([sys.executable, "-c", _JAX, *map(str, common),
                            str(tmp_path / "batches.npz"), str(tmp_path / "ref")],
                           env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    ranks = _ranks(_RANK, tmp_path, *common, tmp_path / "params.npz",
                   tmp_path / "batches.npz", tmp_path / "mesh")

    # the port's one-rank step, and the quiet elements of each leaf's
    # gradient (the microbatches' mean) along the way
    # (tests/test_torch_train.py's rule)
    api = get_model(cfg, "cpu")
    step = make_train_step(api.loss, OptimizerConfig(**OPT), microbatches=micro)
    state = adamw_init(params)
    one = {"losses": [], "norms": []}
    quiet, lr_sum = None, 0.0
    for batch in batches:
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        n = B // micro
        grads = [dict(tree_leaves_with_path(loss_and_grads(
            api.loss, params, {k: v[i * n:(i + 1) * n] for k, v in batch.items()})[2]))
            for i in range(micro)]
        q = {}
        for p in grads[0]:
            g = sum(mg[p] for mg in grads) / micro
            q[p] = (g.abs() < 1e-5 * g.abs().max()).numpy()
        quiet = q if quiet is None else {p: quiet[p] | q[p] for p in q}
        params, state, m = step(params, state, batch)
        one["losses"].append(float(m["loss"]))
        one["norms"].append(float(m["grad_norm"]))
        lr_sum += float(m["lr"])

    _wait(ranks)
    out, err = ref.communicate(timeout=TIMEOUT_S)
    assert ref.returncode == 0, err.decode()[-4000:]
    got = [json.loads((tmp_path / f"mesh.{r}.json").read_text()) for r in range(WORLD)]
    want = json.loads((tmp_path / "ref.json").read_text())
    assert want["devices"] == WORLD
    assert want["explicit_error"] == ("ShardingTypeError" if model_axis > 1 else None)
    for r, rank in enumerate(got):
        assert not rank["bad"], (r, rank["bad"])
        assert rank["losses"] == got[0]["losses"] and rank["norms"] == got[0]["norms"], r
    if model_axis > 1 or fsdp:
        assert got[0]["sharded"] > 0
    for key in ("losses", "norms"):
        np.testing.assert_allclose(got[0][key], want[key], rtol=1e-5, err_msg=key)
        np.testing.assert_allclose(got[0][key], one[key], rtol=1e-5, err_msg=key)

    n_quiet = sum(int(m.sum()) for m in quiet.values())
    assert n_quiet < 1e-2 * sum(m.size for m in quiet.values()), n_quiet
    mesh, jax_out = np.load(tmp_path / "mesh.npz"), np.load(tmp_path / "ref.npz")
    ones = {"master": dict(tree_leaves_with_path(state["master"])),
            "params": dict(tree_leaves_with_path(params))}
    for name in ("master", "params"):
        for path, leaf in ones[name].items():
            g = mesh[f"{name}/{path}"]
            _close(g, _reference_leaf(jax_out, name, path), quiet[path], lr_sum,
                   (name, path, "reference"))
            _close(g, leaf.numpy(), quiet[path], lr_sum, (name, path, "one rank"))


MESH_CASES = [
    pytest.param("yi-6b", False, 2, 2, id="yi-6b-2x2-micro2"),
    pytest.param("yi-6b", False, 2, 1, id="yi-6b-2x2-micro1", marks=pytest.mark.slow),
    pytest.param("yi-6b", False, 1, 2, id="yi-6b-4x1-micro2", marks=pytest.mark.slow),
    pytest.param("yi-6b", False, 4, 2, id="yi-6b-1x4-micro2", marks=pytest.mark.slow),
    pytest.param("yi-6b", False, 4, 1, id="yi-6b-1x4-micro1", marks=pytest.mark.slow),
    pytest.param("mistral-large-123b", True, 2, 2, id="mistral-large-fsdp-2x2-micro2",
                 marks=pytest.mark.slow),
]


@pytest.mark.parametrize("arch,fsdp,model_axis,micro", MESH_CASES)
def test_partitioned_step_matches_reference_and_one_rank(tmp_path, arch, fsdp, model_axis,
                                                         micro):
    """(a), (b): three partitioned steps against the reference's jitted
    step on a JAX mesh of the same shape and against the one-rank step."""
    _mesh_case(tmp_path, arch, fsdp, model_axis, micro)


# ---------------------------------------------------------------------------
# (c) the launcher on 4 ranks, (d) the refusal
# ---------------------------------------------------------------------------

LAUNCH_ARGV = ["--arch", "yi-6b", "--reduced", "--device", "cpu", "--global-batch", "4",
               "--seq", "16", "--warmup", "2", "--checkpoint-every", "2", "--log-every", "100"]

_LAUNCH = r"""
import dataclasses, json, os, sys
import numpy as np, torch, torch.distributed as dist
from torch.distributed.tensor import DTensor
from repro_torch.configs import get_arch
from repro_torch.distributed import restore_checkpoint, sharding as sh
from repro_torch.launch import train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import get_model
from repro_torch.train import adamw_init
rank, world, store, ckpt, argv, out = sys.argv[1:]
rank, world, argv = int(rank), int(world), json.loads(argv)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)
train.get_arch = lambda name, reduced=False: dataclasses.replace(
    get_arch(name, reduced=reduced), dtype="float32")
argv = argv + ["--model-axis", "2", "--checkpoint-dir", ckpt]
first = train.main(argv + ["--steps", "4"])
# the saved step 4 restored onto the mesh: every leaf in its spec's
# placements, gathered whole equal to the files' bits
cfg = train.get_arch("yi-6b", reduced=True)
mesh = make_host_mesh(2, "cpu")
params = get_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
psh = sh.param_shardings(params, cfg, mesh)
params = sh.device_put(params, psh)
state = adamw_init(params, sh.opt_state_shardings(params, cfg, mesh))
shardings = (psh, sh.opt_state_shardings(state, cfg, mesh))
(params, state), at = restore_checkpoint(ckpt, (params, state), shardings=shardings)
manifest = json.load(open(os.path.join(ckpt, f"step_{at:010d}", "manifest.json")))
files = {e["path"]: np.load(os.path.join(ckpt, f"step_{at:010d}", e["file"]))
         for e in manifest["leaves"]}
want = dict(sh.tree_leaves_with_path(shardings))
restored, placed = 0, 0
for path, x in sh.tree_leaves_with_path((params, state)):
    whole = x.full_tensor().numpy()
    restored += (whole.dtype == files[path].dtype and whole.shape == files[path].shape
                 and whole.tobytes() == files[path].tobytes())
    placed += (isinstance(x, DTensor) and tuple(x.placements) == want[path].placements()
               and tuple(x.to_local().shape) == want[path].local_shape(x.shape))
second = train.main(argv + ["--steps", "6"])
with open(f"{out}.{rank}.json", "w") as f:
    json.dump({"first": first, "second": second, "at": at, "leaves": len(files),
               "restored_bits": int(restored), "placed": int(placed)}, f)
dist.destroy_process_group()
"""


def test_launcher_trains_on_four_ranks_as_on_one(tmp_path, monkeypatch):
    """(c): `launch.train --model-axis 2` on 4 gloo ranks (a (2, 2)
    mesh), float32: 4 steps checkpointed at 2 and 4, then a run to 6
    resuming from 4, against the same two runs on one rank: first and
    last losses within 1e-5 relative; the step-4 checkpoint written by
    the mesh restored with ``shardings=`` on every rank into its specs'
    placements, bit for bit the files'."""
    ranks = _ranks(_LAUNCH, tmp_path, tmp_path / "mesh_ck", json.dumps(LAUNCH_ARGV),
                   tmp_path / "launch")
    monkeypatch.setattr(train_mod, "get_arch", lambda name, reduced=False: dataclasses.replace(
        get_arch(name, reduced=reduced), dtype="float32"))
    argv = LAUNCH_ARGV + ["--checkpoint-dir", str(tmp_path / "one_ck")]
    one = [train_mod.main(argv + ["--steps", "4"]), train_mod.main(argv + ["--steps", "6"])]
    _wait(ranks)
    got = [json.loads((tmp_path / f"launch.{r}.json").read_text()) for r in range(WORLD)]
    for rank in got:
        assert rank["at"] == 4
        assert rank["restored_bits"] == rank["placed"] == rank["leaves"] > 0, rank
        for run, want in zip((rank["first"], rank["second"]), one):
            for key in ("first_loss", "last_loss"):
                np.testing.assert_allclose(run[key], want[key], rtol=1e-5, err_msg=key)
    assert sorted(os.listdir(tmp_path / "mesh_ck")) == sorted(os.listdir(tmp_path / "one_ck"))


def test_launcher_refuses_other_families_on_a_mesh_of_two(monkeypatch):
    """(d): a moe arch on a mesh of 2 (a fake group of 2 ranks) raises
    `NotImplementedError` naming ROADMAP queue A item 11 before any
    step: no train step is even built."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    built = []
    monkeypatch.setattr(train_mod, "make_train_step", lambda *a, **kw: built.append(a))
    with pytest.raises(NotImplementedError, match="queue A item 11"):
        train_mod.main(["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
                        "--model-axis", "2", "--steps", "1"])
    assert not built
