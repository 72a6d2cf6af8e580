"""The §4 hash-model probe kernel (``csrc/probe.cu``): build, load and
the PyTorch wrapper.

``hash_probe_cuda`` — linear stage-0, leaf position, ``slot = int(pos *
    f32(S/n))``, primary slot compare and the overflow chain walk, one
    launch -> (B,) bool.  Replaces the reference's ``hash_probe_pallas``.

The source also holds the §5 Bloom probe (`kernels.bloom_probe`); both
wrappers load one library, declared here.  For a CUDA tensor a wrapper
launches the kernel (or raises); for a CPU tensor it runs the plain
version in `kernels.ref`.  Each launch adds one to the wrapper's count in
``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from repro_torch.kernels import nvcc, ref

SOURCE = nvcc.CSRC / "probe.cu"

# launches of the wrapper; a plain integer, bumped only where the
# kernel is launched
LAUNCHES: Dict[str, int] = {"hash_probe_cuda": 0}


def reset_launch_counts() -> None:
    LAUNCHES["hash_probe_cuda"] = 0


def build():
    """Compile the probe library unless this source hash is built;
    returns its path."""
    return nvcc.build(SOURCE)


def declare(lib) -> None:
    """Argument types of both probe launchers."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hash_probe_launch.argtypes = [
        p, i, p,                    # q, B, s0
        p, p, i, f, f,              # leaf_w/b, M, f32(M/n), f32(n-1)
        p, p, i, f,                 # slot_key, slot_next, S, f32(S/n)
        p, p, i, i,                 # ovf_key, ovf_next, O, trips
        p, p,                       # out, stream
    ]
    lib.hash_probe_launch.restype = i
    lib.bloom_probe_launch.argtypes = [p, i, p, ctypes.c_uint32, i, p, p]
    lib.bloom_probe_launch.restype = i


def hash_probe_cuda(
    q: torch.Tensor,                   # (B,) normalized float32 queries
    s0: torch.Tensor,                  # (2,) linear stage-0 (stage0_flat)
    leaf_w: torch.Tensor,              # (M,)
    leaf_b: torch.Tensor,              # (M,)
    slot_key: torch.Tensor,            # (S,) normalized f32, NaN = empty
    slot_next: torch.Tensor,           # (S,) int32
    ovf_key: torch.Tensor,             # (O,) normalized f32, O >= 1
    ovf_next: torch.Tensor,            # (O,) int32
    *,
    n: int,
    num_leaves: int,
    num_slots: int,
    trips: int,
) -> torch.Tensor:
    """Membership of each query in the hash map, bool (B,)."""
    kw = dict(n=n, num_leaves=num_leaves, num_slots=num_slots, trips=trips)
    if q.device.type == "cpu":
        return ref.hash_probe_reference(
            q, s0, leaf_w, leaf_b, slot_key, slot_next, ovf_key, ovf_next, **kw)
    dev = q.device
    if s0.numel() != 2:
        raise ValueError("the hash probe takes a linear stage-0 (two parameters)")
    if not (1 <= n and 1 <= num_leaves < 2**30 and 1 <= num_slots < 2**30):
        raise ValueError(f"need n >= 1 and 1 <= M, S < 2**30 "
                         f"(n={n}, M={num_leaves}, S={num_slots})")
    if leaf_w.shape[0] != num_leaves or leaf_b.shape[0] != num_leaves:
        raise ValueError("leaf arrays must hold num_leaves entries")
    if slot_key.shape[0] != num_slots or slot_next.shape[0] != num_slots:
        raise ValueError("slot arrays must hold num_slots entries")
    o = ovf_key.shape[0]
    if o < 1 or ovf_next.shape[0] != o or o >= 2**31:
        raise ValueError("overflow arrays must hold the same 1 <= O < 2**31 entries")
    if trips < 0:
        raise ValueError("trips must be >= 0")
    f32, i32 = torch.float32, torch.int32
    ptrs = [nvcc.check_tensor(a, nm, dt, dev) for a, nm, dt in (
        (q, "q", f32), (s0, "stage0", f32), (leaf_w, "leaf_w", f32),
        (leaf_b, "leaf_b", f32), (slot_key, "slot_key", f32),
        (slot_next, "slot_next", i32), (ovf_key, "ovf_key", f32),
        (ovf_next, "ovf_next", i32))]
    out = torch.empty(q.shape, dtype=torch.bool, device=dev)
    if q.shape[0] == 0:
        return out
    err = nvcc.load(SOURCE, declare).hash_probe_launch(
        ptrs[0], q.shape[0], ptrs[1], ptrs[2], ptrs[3], num_leaves,
        float(np.float32(num_leaves / n)), float(np.float32(n - 1)),
        ptrs[4], ptrs[5], num_slots, float(np.float32(num_slots / n)),
        ptrs[6], ptrs[7], o, trips, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    nvcc.raise_on_error(err, "hash_probe")
    LAUNCHES["hash_probe_cuda"] += 1
    return out
