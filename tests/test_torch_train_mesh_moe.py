"""The moe family's train step partitioned on a mesh of more than one
rank, expert-parallel (`tests/_torch_train_mesh.py` runs each case).

(a) 4 gloo ranks run the reduced olmoe-1b-7b (the paper's CDF dispatch,
`cdf`) for 3 float32 steps on a (data, model) = (2, 2) mesh in 2
microbatches, held against the reference's jitted step on a JAX mesh of
the same shape (Auto axes) and against the port's one-rank step: loss
and `grad_norm` within 1e-5 relative at every step, the final master and
parameters within 1e-5 x the leaf's max, every leaf's local shape and
placements as its spec says.  The dispatch group count is the one the
reference's trace read at each token count (the data axis' size), the
(G, E, C, D) buffers hold one group and E / model experts on every rank,
and so do the expert leaves.  (b) under ``-m slow``: moonshot-v1-16b-a3b
(`sort`) at (2, 2), olmoe at (1, 4) (8 experts over 4 model ranks) and
at (4, 1).  (c) `launch.train --arch olmoe-1b-7b --model-axis 2` on 4
gloo ranks trains with the losses of one rank that dispatches in the
ranks' group count.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from _torch_train_mesh import (  # noqa: E402
    PRELUDE,
    WORLD,
    FakeMesh,
    expert_parallel,
    mesh_case,
    ranks,
    record_groups,
    wait,
)
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.distributed.sharding import use_mesh  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402

MESH_CASES = [
    pytest.param("olmoe-1b-7b", 2, 2, id="olmoe-cdf-2x2-micro2"),
    pytest.param("moonshot-v1-16b-a3b", 2, 2, id="moonshot-sort-2x2-micro2",
                 marks=pytest.mark.slow),
    pytest.param("olmoe-1b-7b", 4, 2, id="olmoe-cdf-1x4-micro2", marks=pytest.mark.slow),
    pytest.param("olmoe-1b-7b", 1, 2, id="olmoe-cdf-4x1-micro2", marks=pytest.mark.slow),
]


@pytest.fixture(autouse=True)
def _no_group_outlives_a_test():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,model_axis,micro", MESH_CASES)
def test_partitioned_moe_step_matches_reference_and_one_rank(tmp_path, arch, model_axis,
                                                             micro):
    """(a), (b): three partitioned steps against the reference's jitted
    step and the one-rank step, the experts parallel over ``model``."""
    got = mesh_case(tmp_path, arch, False, model_axis, micro)
    expert_parallel(got, get_arch(arch, reduced=True), model_axis)


LAUNCH_ARGV = ["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu", "--global-batch", "4",
               "--seq", "16", "--warmup", "2", "--steps", "4", "--log-every", "100"]

_LAUNCH = r"""
import dataclasses, json, sys
import torch.distributed as dist
from repro_torch.configs import get_arch
from repro_torch.launch import train
from repro_torch.models import moe
rank, world, store, argv, out = sys.argv[1:]
dist.init_process_group("gloo", init_method="file://" + store, rank=int(rank),
                        world_size=int(world))
train.get_arch = lambda name, reduced=False: dataclasses.replace(
    get_arch(name, reduced=reduced), dtype="float32")
groups = {}
record_groups(moe, groups)
got = train.main(json.loads(argv) + ["--model-axis", "2"])
with open(f"{out}.{rank}.json", "w") as f:
    json.dump({"run": got, "groups": groups}, f)
dist.destroy_process_group()
"""


def test_launcher_trains_moe_on_four_ranks_as_on_one(tmp_path, monkeypatch):
    """(c): `launch.train --arch olmoe-1b-7b --model-axis 2` on 4 gloo
    ranks (a (2, 2) mesh), float32, 4 steps: the first and last losses
    within 1e-5 relative of one rank's, whose dispatch takes the ranks'
    group count (the data axis' 2) through a duck-typed mesh of their
    shape."""
    procs = ranks(PRELUDE + _LAUNCH, tmp_path, json.dumps(LAUNCH_ARGV), tmp_path / "launch")
    monkeypatch.setattr(train_mod, "get_arch", lambda name, reduced=False: dataclasses.replace(
        get_arch(name, reduced=reduced), dtype="float32"))
    inner, one_groups = moe_lib._num_dispatch_groups, {}

    def mesh_groups(t):
        with use_mesh(FakeMesh(data=2, model=2)):
            return inner(t)

    monkeypatch.setattr(moe_lib, "_num_dispatch_groups", mesh_groups)
    record_groups(moe_lib, one_groups)
    one = train_mod.main(LAUNCH_ARGV)
    wait(procs)
    got = [json.loads((tmp_path / f"launch.{r}.json").read_text()) for r in range(WORLD)]
    for rank in got:
        assert rank["groups"] == one_groups and set(one_groups.values()) == {2}, rank
        for key in ("first_loss", "last_loss"):
            np.testing.assert_allclose(rank["run"][key], one[key], rtol=1e-5, err_msg=key)


def test_on_local_groups_takes_only_groups_over_the_data_axis():
    """`sharding.on_local_groups` on a (2, 2) mesh of a fake group of 4:
    plain tensors go to the function as they are; DTensors with G over
    ``data`` and replicated over ``model`` reach it as each rank's own
    groups and come back placed alike; G sharded over ``model``, a plain
    tensor beside a DTensor, or two group counts raise before it runs."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    mesh = make_host_mesh(2, "cpu")
    seen = []

    def fn(*xs):
        seen.append([tuple(x.shape) for x in xs])
        return xs[0] * 2

    x = torch.arange(24.0).reshape(4, 3, 2)
    assert torch.equal(sh.on_local_groups(fn, x), x * 2)
    groups = DTensor.from_local(x[:2], mesh, (Shard(0), Replicate()), run_check=False)
    out = sh.on_local_groups(fn, groups, groups)
    assert tuple(out.placements) == (Shard(0), Replicate()) and out.shape == (4, 3, 2)
    assert seen[-1] == [(2, 3, 2), (2, 3, 2)]
    calls = len(seen)
    other = DTensor.from_local(x[:1], mesh, (Shard(0), Shard(0)), run_check=False)
    fewer = DTensor.from_local(x[:1], mesh, (Shard(0), Replicate()), run_check=False)
    for args in ((groups, x), (other,), (groups, fewer)):
        with pytest.raises(ValueError, match="on_local_groups"):
            sh.on_local_groups(fn, *args)
    assert len(seen) == calls
