"""Shared by the `tests/test_torch_train_mesh*.py` files: the port's
partitioned train step on WORLD gloo ranks (processes of their own, a
file store) against the reference's jitted step on a JAX host mesh of
the same shape and against the port's one-rank step.

`mesh_case` runs one case.  The ranks (`RANK`) take parameters carried
from the reference (`convert.lm_params_from_reference`, float32), place
them by `param_shardings`, the optimizer state by `opt_state_shardings`
(ZeRO-1) and each NumPy batch by `place_batch`.  The reference
(`JAX`, its own subprocess over 4 forced host devices) runs
`jax.jit(make_train_step(...))` on `make_host_mesh`'s shape with Auto
axes, the GSPMD mesh its step is written for.  The one-rank step runs
in the calling process under a duck-typed mesh of the same shape
(`FakeMesh`), which plain tensors ignore but the MoE's group count
reads.  Held: the loss and `grad_norm` within 1e-5 relative at every
step; the final master and parameters within 1e-5 x the leaf's max
under the quiet-element rule of `tests/test_torch_train.py` (an expert
leaf's element whose gradient is exactly zero at a step in both
packages, an expert no token reached, is held at 1e-5 x max too); every
rank's local shape and placements of every parameter and state leaf as
its spec says; the MoE's dispatch group count at each token count equal
in all three.  With ``recurrent`` (the ssm and hybrid families, whose
scans sum in another order than the reference's) every leaf's
first-step gradient is held within 1e-5 x its max too, and the final
state gets `RECURRENT_STEP_SHARE` of the summed steps beside 1e-5 x max.
The ranks also record the MoE's (G, E, C, D) buffers as the expert
products meet them, each `on_local_heads` call's global and local q and
k shapes and each `on_local_blocks` call's function and global and local
input shapes, for the family's own checks (`expert_parallel`,
`local_heads`, the scans' blocks).

Batches come from NumPy with a seed: tokens, labels and a mask for
every family, plus ``patches`` (B, T_img, F) for vlm and ``frames`` (B,
S_SRC, F) for audio (S_SRC != S: the decoder's queries over more
encoder keys).
"""

import dataclasses
import inspect
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

import jax

from repro.configs import get_arch as jax_get_arch
from repro.models import get_model as jax_get_model

from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.distributed.sharding import tree_leaves_with_path, use_mesh
from repro_torch.models import get_model
from repro_torch.models import moe as moe_lib
from repro_torch.train import OptimizerConfig, adamw_init, make_train_step
from repro_torch.train.train_step import loss_and_grads

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
WORLD = 4
STEPS = 3
B, S = 4, 16
S_SRC = 40
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=3)
TIMEOUT_S = 300
BATCH_KEYS = ("tokens", "labels", "mask", "patches", "frames")
# the MoE's expert leaves: an expert that no token reached in a step has
# an exactly zero gradient there, in both packages
EXPERT_LEAVES = ("we_gate", "we_up", "we_down")
# ROADMAP queue C 30: the reference's own `make_host_mesh` (Explicit
# axes) refuses its loss where the model axis is larger than one: the
# embedding gather on the sharded table (`ShardingTypeError`), or first
# the audio family's encoder, whose `pin_dp` constraint names an
# Explicit axis (`ValueError`)
EXPLICIT_ERRORS = {"audio": "ValueError"}
# the share of each Adam step that float32 noise may move in the ssm and
# hybrid families (`mesh_case(recurrent=True)`): their scans sum in
# another order than the reference's, and their gradients differ from it
# by 1-6e-6 x max (2e-8 in the dense family); tests/test_torch_train.py
# puts the step a noise-dominated gradient moves at 0.2%
RECURRENT_STEP_SHARE = 2e-3


class FakeMesh:
    """A mesh as the sharding rules and the MoE's group count read one:
    a ``shape`` dict of axis sizes."""

    def __init__(self, **shape):
        self.shape = shape


def env():
    return dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")


def ranks(script, tmp_path, *args):
    """``script`` started as WORLD gloo ranks sharing a file store under
    ``tmp_path``; each gets (rank, world, store, *args)."""
    store = tmp_path / "store"
    return [subprocess.Popen([sys.executable, "-c", script, str(r), str(WORLD), str(store),
                              *map(str, args)], env=env(), stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE) for r in range(WORLD)]


def wait(procs):
    for p in procs:
        try:
            _, err = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err.decode()[-4000:]


def configs(arch, fsdp):
    """(reference config, port config): reduced ``arch`` in float32, with
    ``fsdp_params`` as asked (the reduced configs leave it off)."""
    change = dict(dtype="float32", fsdp_params=fsdp)
    return (dataclasses.replace(jax_get_arch(arch, reduced=True), **change),
            dataclasses.replace(get_arch(arch, reduced=True), **change))


def batches(cfg):
    """STEPS NumPy batches of B x S tokens from a seed, for every side,
    each with a mask: a microbatch's loss is the mean over its own
    masked tokens, so it shows which global rows the microbatch holds.
    The vlm family adds ``patches``, the audio family ``frames``, drawn
    after the rest from the same generator."""
    out = []
    for i in range(STEPS):
        rng = np.random.default_rng(10 + i)
        toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        mask = (rng.random((B, S)) < 0.3 + 0.2 * np.arange(B)[:, None]).astype(np.float32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}
        if cfg.family == "vlm":
            batch["patches"] = rng.standard_normal(
                (B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
        if cfg.family == "audio":
            batch["frames"] = rng.standard_normal((B, S_SRC, cfg.frontend_dim)).astype(
                np.float32)
        out.append(batch)
    return out


def record_groups(module, seen):
    """``module._num_dispatch_groups`` wrapped to record each token count
    and the group count it gave into ``seen``."""
    inner = module._num_dispatch_groups

    def groups(t):
        seen[str(t)] = g = inner(t)
        return g

    module._num_dispatch_groups = groups


RANK = r"""
import dataclasses, json, sys
import numpy as np, torch, torch.distributed as dist
from torch.distributed.tensor import DTensor
from repro_torch.configs import get_arch
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import get_model, moe
from repro_torch.train import OptimizerConfig, adamw_init, make_train_step
(rank, world, store, arch, fsdp, model_axis, micro, steps, opt, first_grads, params_path,
 batches_path, out) = sys.argv[1:]
rank, world, model_axis, micro, steps = map(int, (rank, world, model_axis, micro, steps))
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)
cfg = dataclasses.replace(get_arch(arch, reduced=True), dtype="float32",
                          fsdp_params=fsdp == "1")
api = get_model(cfg, "cpu")
saved, data = np.load(params_path), np.load(batches_path)
keys = [k for k in BATCH_KEYS if f"{k}0" in data.files]
params = sh.tree_map_with_path(lambda p, x: torch.from_numpy(saved[p]),
                               api.init(torch.Generator().manual_seed(0)))
mesh = make_host_mesh(model_axis, "cpu")
groups, buffers = {}, []
record_groups(moe, groups)
experts = moe._experts


def recorded_experts(buf, *ws):
    if not buffers:
        buffers.append([str(buf.placements), list(buf.to_local().shape), list(buf.shape)])
    return experts(buf, *ws)


moe._experts = recorded_experts
heads = set()
on_local_heads = sh.on_local_heads


def recorded_heads(fn, q, k, v):
    def local(ql, kl, vl):
        heads.add(tuple(map(tuple, (q.shape, k.shape, ql.shape, kl.shape))))
        return fn(ql, kl, vl)
    return on_local_heads(local, q, k, v)


sh.on_local_heads = recorded_heads
blocks = set()
on_local_blocks = sh.on_local_blocks


def recorded_blocks(fn, xs, *args, **kw):
    def local(*ls):
        blocks.add((getattr(fn, "func", fn).__name__, tuple(tuple(x.shape) for x in xs),
                    tuple(tuple(x.shape) for x in ls)))
        return fn(*ls)
    return on_local_blocks(local, xs, *args, **kw)


sh.on_local_blocks = recorded_blocks
losses, norms, bad = [], [], []
with sh.use_mesh(mesh):
    psh = sh.param_shardings(params, cfg, mesh)
    params = sh.device_put(params, psh)
    state = adamw_init(params, sh.opt_state_shardings(params, cfg, mesh))
    first = {}

    def record_first(grads):
        # the first step's gradient (the microbatches' mean), gathered whole
        if first_grads == "1" and not first:
            first.update((f"grad0/{p}", g.full_tensor().numpy())
                         for p, g in sh.tree_leaves_with_path(grads))
        return grads

    step = make_train_step(api.loss, OptimizerConfig(**json.loads(opt)), microbatches=micro,
                           compress_fn=record_first)
    for i in range(steps):
        batch = sh.place_batch({k: data[f"{k}{i}"] for k in keys}, mesh)
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
    whole.update(first)
    local = {path: list(x.to_local().shape) for path, x in sh.tree_leaves_with_path(params)}
if rank == 0:
    np.savez(out + ".npz", **whole)
with open(f"{out}.{rank}.json", "w") as f:
    json.dump({"losses": losses, "norms": norms, "bad": bad, "groups": groups,
               "buffers": buffers, "local": local, "heads": sorted(heads),
               "blocks": sorted(blocks),
               "sharded": sum(s.local_shape(x.shape) != tuple(x.shape) for (_, x), (_, s)
                              in zip(sh.tree_leaves_with_path(params),
                                     sh.tree_leaves_with_path(psh)))}, f)
dist.destroy_process_group()
"""

JAX = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, json
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_arch
from repro.distributed.sharding import param_shardings
from jax.sharding import AxisType
from repro.launch.mesh import make_host_mesh
from repro.models import get_model, moe
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step
arch, fsdp, model_axis, micro, steps, opt, first_grads, batches_path, out = sys.argv[1:]
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
keys = [k for k in BATCH_KEYS if f"{k}0" in data.files]
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
            jax.jit(api.loss)(p0, {k: jnp.asarray(data[f"{k}0"]) for k in keys})
    except Exception as e:  # recorded for the test to hold, not handled
        explicit_error = type(e).__name__
# the group count the step's trace reads (`_num_dispatch_groups` finds
# the mesh of `with mesh:`), recorded at each token count
groups = {}
record_groups(moe, groups)


def flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(e, "key", getattr(e, "idx", ""))) for e in path): leaf
            for path, leaf in leaves}


# where each step's gradient (the microbatches' mean, taken before the
# step) of an expert leaf is exactly zero: an expert no token reached
zeros = {}
grad = jax.jit(jax.grad(lambda p, b: api.loss(p, b)[0]))
with mesh:
    params = api.init(jax.random.PRNGKey(0))
    psh = param_shardings(jax.eval_shape(api.init, jax.random.PRNGKey(0)), cfg, mesh)
    params = jax.device_put(params, psh)
    state = jopt.adamw_init(params)
    step = jax.jit(make_train_step(api.loss, jopt.OptimizerConfig(**json.loads(opt)),
                                   microbatches=int(micro)))
    experts = [p for p in flat(params) if p.rsplit("/", 1)[-1] in EXPERT_LEAVES]
    for i in range(int(steps)):
        batch = {k: jnp.asarray(data[f"{k}{i}"]) for k in keys}
        if experts or (first_grads == "1" and i == 0):
            n = batch["tokens"].shape[0] // int(micro)
            gs = [flat(grad(params, {k: v[j * n:(j + 1) * n] for k, v in batch.items()}))
                  for j in range(int(micro))]
            for p in experts:
                zeros[f"zero{i}/{p}"] = np.asarray(sum(g[p] for g in gs) / int(micro)) == 0
            if first_grads == "1" and i == 0:
                zeros.update((f"grad0/{p}", np.asarray(sum(g[p] for g in gs) / int(micro)))
                             for p in gs[0])
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
np.savez(out + ".npz", **{p: np.asarray(x) for p, x in flat(
    {"master": state["master"], "params": params}).items()}, **zeros)
with open(out + ".json", "w") as f:
    json.dump({"losses": losses, "norms": norms, "devices": len(jax.devices()),
               "explicit_error": explicit_error, "groups": groups}, f)
"""

# what both subprocess scripts share with this module
PRELUDE = (f"BATCH_KEYS = {BATCH_KEYS!r}\nEXPERT_LEAVES = {EXPERT_LEAVES!r}\n"
           f"{inspect.getsource(record_groups)}")


def reference_leaf(ref, name, path):
    """The reference's leaf of port ``path`` (``blocks/i/wq`` is slice i
    of the stacked ``blocks/wq``; ``enc`` and ``dec`` alike; the xLSTM's
    ``blocks/j/mlstm/i/wq`` is slice (j, i) of ``blocks/mlstm/wq``, the
    hybrid's ``blocks/j/mix0/a_log`` slice j of ``blocks/mix0/a_log``)."""
    parts = path.split("/")
    if parts[0] in ("blocks", "enc", "dec"):
        index = tuple(int(p) for p in parts if p.isdigit())
        return ref["/".join([name] + [p for p in parts if not p.isdigit()])][index]
    return ref[f"{name}/{path}"]


def close(got, want, quiet, lr_sum, what, step_share=0.0):
    """Within 1e-5 x the leaf's max (plus ``step_share`` of the steps'
    summed learning rates) outside the quiet elements, within the steps'
    summed learning rates on them."""
    err = np.abs(got - want)
    bound = 1e-5 * float(np.abs(want).max()) + step_share * lr_sum
    assert float(err[~quiet].max(initial=0.0)) <= bound, what
    assert not quiet.any() or float(err[quiet].max()) <= lr_sum, what


def mesh_case(tmp_path, arch, fsdp, model_axis, micro, recurrent=False):
    """The WORLD ranks, the reference's jitted step and the port's
    one-rank step on the same parameters and batches; returns the
    ranks' records.  With ``recurrent`` (the ssm and hybrid families)
    every leaf's first-step gradient (the microbatches' mean, from the
    same parameters everywhere) is held within 1e-5 x its max of the
    one-rank step's and the reference's, and the final master and
    parameters get RECURRENT_STEP_SHARE of the summed steps beside 1e-5
    x max (their float32 gradients differ from the reference's by ~1e-6
    x max, not ~2e-8, so Adam moves every small element's step)."""
    jcfg, cfg = configs(arch, fsdp)
    jparams = jax_get_model(jcfg).init(jax.random.PRNGKey(0))
    params = convert.lm_params_from_reference(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    np.savez(tmp_path / "params.npz",
             **{p: x.numpy() for p, x in tree_leaves_with_path(params)})
    data = batches(cfg)
    np.savez(tmp_path / "batches.npz", **{f"{k}{i}": v for i, b in enumerate(data)
                                          for k, v in b.items()})
    common = (arch, int(fsdp), model_axis, micro, STEPS, json.dumps(OPT), int(recurrent))
    ref = subprocess.Popen([sys.executable, "-c", PRELUDE + JAX, *map(str, common),
                            str(tmp_path / "batches.npz"), str(tmp_path / "ref")],
                           env=env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    procs = ranks(PRELUDE + RANK, tmp_path, *common, tmp_path / "params.npz",
                  tmp_path / "batches.npz", tmp_path / "mesh")

    # the port's one-rank step under a mesh of the ranks' shape (the
    # MoE's group count reads it), and each step's quiet elements of each
    # leaf's gradient (the microbatches' mean) along the way
    # (tests/test_torch_train.py's rule), with the expert leaves' exact
    # zeros
    api = get_model(cfg, "cpu")
    step = make_train_step(api.loss, OptimizerConfig(**OPT), microbatches=micro)
    state = adamw_init(params)
    one = {"losses": [], "norms": [], "groups": {}}
    quiet_steps, lr_sum, first = [], 0.0, {}
    inner = moe_lib._num_dispatch_groups
    record_groups(moe_lib, one["groups"])
    try:
        with use_mesh(FakeMesh(data=WORLD // model_axis, model=model_axis)):
            for batch in data:
                batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
                n = B // micro
                grads = [dict(tree_leaves_with_path(loss_and_grads(
                    api.loss, params, {k: v[i * n:(i + 1) * n] for k, v in batch.items()})[2]))
                    for i in range(micro)]
                q, z = {}, {}
                for p in grads[0]:
                    g = sum(mg[p] for mg in grads) / micro
                    first.setdefault(p, g.numpy())
                    q[p] = (g.abs() < 1e-5 * g.abs().max()).numpy()
                    if p.rsplit("/", 1)[-1] in EXPERT_LEAVES:
                        z[p] = (g == 0).numpy()
                quiet_steps.append((q, z))
                params, state, m = step(params, state, batch)
                one["losses"].append(float(m["loss"]))
                one["norms"].append(float(m["grad_norm"]))
                lr_sum += float(m["lr"])
    finally:
        moe_lib._num_dispatch_groups = inner

    wait(procs)
    out, err = ref.communicate(timeout=TIMEOUT_S)
    assert ref.returncode == 0, err.decode()[-4000:]
    got = [json.loads((tmp_path / f"mesh.{r}.json").read_text()) for r in range(WORLD)]
    want = json.loads((tmp_path / "ref.json").read_text())
    assert want["devices"] == WORLD
    assert want["explicit_error"] == (EXPLICIT_ERRORS.get(cfg.family, "ShardingTypeError")
                                      if model_axis > 1 else None)
    for r, rank in enumerate(got):
        assert not rank["bad"], (r, rank["bad"])
        assert rank["losses"] == got[0]["losses"] and rank["norms"] == got[0]["norms"], r
        assert rank["groups"] == want["groups"] == one["groups"], (r, rank["groups"], want)
    if model_axis > 1 or fsdp:
        assert got[0]["sharded"] > 0
    for key in ("losses", "norms"):
        np.testing.assert_allclose(got[0][key], want[key], rtol=1e-5, err_msg=key)
        np.testing.assert_allclose(got[0][key], one[key], rtol=1e-5, err_msg=key)

    # the quiet elements: quiet at any step, except an expert leaf's
    # element whose gradient was exactly zero there in both packages (no
    # token reached the expert: the moe family at 8 tokens a group), which
    # is held at 1e-5 x max like the rest.  The rule has teeth: few quiet
    # elements
    mesh, jax_out = np.load(tmp_path / "mesh.npz"), np.load(tmp_path / "ref.npz")
    quiet = {}
    for i, (q, z) in enumerate(quiet_steps):
        for p, m in q.items():
            if p in z:
                m = m & ~(z[p] & reference_leaf(jax_out, f"zero{i}", p))
            quiet[p] = m if p not in quiet else quiet[p] | m
    n_quiet = sum(int(m.sum()) for m in quiet.values())
    assert n_quiet < 1e-2 * sum(m.size for m in quiet.values()), n_quiet
    if recurrent:
        for path, g in first.items():
            for want, side in ((g, "one rank"), (reference_leaf(jax_out, "grad0", path),
                                                 "reference")):
                err = float(np.abs(mesh[f"grad0/{path}"] - want).max())
                assert err <= 1e-5 * float(np.abs(want).max()), ("grad0", path, side, err)
    share = RECURRENT_STEP_SHARE if recurrent else 0.0
    ones = {"master": dict(tree_leaves_with_path(state["master"])),
            "params": dict(tree_leaves_with_path(params))}
    for name in ("master", "params"):
        for path, leaf in ones[name].items():
            g = mesh[f"{name}/{path}"]
            close(g, reference_leaf(jax_out, name, path), quiet[path], lr_sum,
                  (name, path, "reference"), share)
            close(g, leaf.numpy(), quiet[path], lr_sum, (name, path, "one rank"), share)
    return got


def expert_parallel(got, cfg, model_axis):
    """The moe family's expert parallelism on every rank: each step's
    group count is the data axis' size (the tokens divide it here); the
    (G, E, C, D) buffers hold G / data groups and E / model experts; every
    layer's expert leaves hold E / model experts."""
    data = WORLD // model_axis
    e = cfg.num_experts
    for rank in got:
        assert rank["groups"] and set(rank["groups"].values()) == {data}, rank["groups"]
        (placements, local, whole), = rank["buffers"]
        assert whole[:2] == [data, e], whole
        assert local == [1, e // model_axis] + whole[2:], (placements, local)
        for path, shape in rank["local"].items():
            if path.rsplit("/", 1)[-1] in ("we_gate", "we_up", "we_down"):
                assert shape[0] == e // model_axis, (path, shape)


def local_heads(got, q_seq, k_seq, model_axis, cfg):
    """Every rank ran an attention of ``q_seq`` queries over ``k_seq``
    keys on its local rows (a microbatch's B over ``data``) and its local
    heads: the query heads over ``model`` where they divide it, the KV
    heads with them (repeated for their query heads where only those
    divide it)."""
    data = WORLD // model_axis
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    want_q = hq // model_axis if hq % model_axis == 0 else hq
    want_kv = (hkv // model_axis if hkv % model_axis == 0
               else want_q if hq % model_axis == 0 else hkv)
    for rank in got:
        calls = [c for c in rank["heads"] if c[0][2] == q_seq and c[1][2] == k_seq]
        assert calls, rank["heads"]
        for q, k, ql, kl in calls:
            rows = q[0] // data if q[0] % data == 0 else q[0]
            assert ql == [rows, want_q, q_seq, q[3]], (q, ql)
            assert kl == [rows, want_kv, k_seq, k[3]], (k, kl)
