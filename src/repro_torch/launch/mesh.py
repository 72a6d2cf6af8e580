"""Meshes (the reference's `repro/launch/mesh.py`): functions, not
module-level constants, so importing this module never touches a
process group or a device.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` whose dims are
named as the reference's axes.  One rank drives one card, so the
world size is the device count; `make_host_mesh` starts a one-process
group itself where none exists (NCCL on ``cuda``, gloo on ``cpu``, over
an in-process store) and otherwise uses the group that exists.  What
the reference gets from ``with mesh:`` (the mesh that `maybe_constrain`
and the MoE dispatch read) is `distributed.sharding.use_mesh`.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import DeviceLike, resolve_device

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _world(device_type: str) -> int:
    """The world size, after starting a one-process group on
    ``device_type``'s backend if no group exists."""
    if not dist.is_initialized():
        dist.init_process_group(_BACKENDS[device_type], store=dist.HashStore(), rank=0,
                                world_size=1)
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """16x16 = 256 ranks a pod; ``multi_pod`` adds the 2-pod axis (512).
    Needs a process group of exactly that many ranks (the dryrun's fake
    group, or a real one); any other world size raises."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    want = 512 if multi_pod else 256
    found = dist.get_world_size() if dist.is_initialized() else 0
    if found != want:
        raise RuntimeError(f"the {'x'.join(map(str, shape))} mesh needs a process group of "
                           f"{want} ranks; found {found or 'none'}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(model_axis: int = 1, device: DeviceLike = None) -> DeviceMesh:
    """Whatever this host's process group holds, ``(n // model_axis,
    model_axis)`` over ("data", "model"); ``device`` None = "cuda"."""
    dev = resolve_device(device)
    n = _world(dev.type)
    assert n % model_axis == 0
    return init_device_mesh(dev.type, (n // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))
