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
resumed run.  (d) `launch.train --model-axis 2` of the reduced xlstm-1.3b
and jamba-1.5-large-398b on 4 gloo ranks against one rank.  The moe,
vlm, audio, ssm and hybrid families' partitioned steps are held in
`tests/test_torch_train_mesh_{moe,vlm,audio,ssm,hybrid}.py`, the cases
run by `tests/_torch_train_mesh.py`.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from _torch_train_mesh import WORLD, FakeMesh, mesh_case, ranks, wait  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.distributed.sharding import use_mesh  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402


@pytest.fixture(autouse=True)
def _no_group_outlives_a_test():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


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
    mesh_case(tmp_path, arch, fsdp, model_axis, micro)


# ---------------------------------------------------------------------------
# (c) the launcher on 4 ranks, (d) the recurrent families through it
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
    procs = ranks(_LAUNCH, tmp_path, tmp_path / "mesh_ck", json.dumps(LAUNCH_ARGV),
                   tmp_path / "launch")
    monkeypatch.setattr(train_mod, "get_arch", lambda name, reduced=False: dataclasses.replace(
        get_arch(name, reduced=reduced), dtype="float32"))
    argv = LAUNCH_ARGV + ["--checkpoint-dir", str(tmp_path / "one_ck")]
    one = [train_mod.main(argv + ["--steps", "4"]), train_mod.main(argv + ["--steps", "6"])]
    wait(procs)
    got = [json.loads((tmp_path / f"launch.{r}.json").read_text()) for r in range(WORLD)]
    for rank in got:
        assert rank["at"] == 4
        assert rank["restored_bits"] == rank["placed"] == rank["leaves"] > 0, rank
        for run, want in zip((rank["first"], rank["second"]), one):
            for key in ("first_loss", "last_loss"):
                np.testing.assert_allclose(run[key], want[key], rtol=1e-5, err_msg=key)
    assert sorted(os.listdir(tmp_path / "mesh_ck")) == sorted(os.listdir(tmp_path / "one_ck"))


_LAUNCH_RECURRENT = r"""
import dataclasses, json, sys
import torch.distributed as dist
from repro_torch.configs import get_arch
from repro_torch.launch import train
rank, world, store, argv, out = sys.argv[1:]
dist.init_process_group("gloo", init_method="file://" + store, rank=int(rank),
                        world_size=int(world))
train.get_arch = lambda name, reduced=False: dataclasses.replace(
    get_arch(name, reduced=reduced), dtype="float32")
got = train.main(json.loads(argv) + ["--model-axis", "2"])
with open(f"{out}.{rank}.json", "w") as f:
    json.dump(got, f)
dist.destroy_process_group()
"""


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "jamba-1.5-large-398b"])
def test_launcher_trains_recurrent_families_on_four_ranks_as_on_one(tmp_path, monkeypatch,
                                                                    arch):
    """(d): `launch.train --reduced --model-axis 2` of an ssm and a hybrid
    arch on 4 gloo ranks (a (2, 2) mesh, the scans on each rank's local
    blocks), float32, 2 steps: the first and last losses within 1e-5
    relative of one rank's, whose MoE dispatch (jamba's) takes the
    ranks' group count through a duck-typed mesh of their shape."""
    argv = ["--arch", arch] + LAUNCH_ARGV[2:] + ["--steps", "2"]
    procs = ranks(_LAUNCH_RECURRENT, tmp_path, json.dumps(argv), tmp_path / "launch")
    monkeypatch.setattr(train_mod, "get_arch", lambda name, reduced=False: dataclasses.replace(
        get_arch(name, reduced=reduced), dtype="float32"))
    inner = moe_lib._num_dispatch_groups

    def mesh_groups(t):
        with use_mesh(FakeMesh(data=2, model=2)):
            return inner(t)

    monkeypatch.setattr(moe_lib, "_num_dispatch_groups", mesh_groups)
    one = train_mod.main(argv)
    wait(procs)
    for r in range(WORLD):
        got = json.loads((tmp_path / f"launch.{r}.json").read_text())
        for key in ("first_loss", "last_loss"):
            np.testing.assert_allclose(got[key], one[key], rtol=1e-5, err_msg=(r, key))
