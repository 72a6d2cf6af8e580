"""The §4 hash-model probe kernel (``csrc/probe.cu``): build, load and
the PyTorch wrapper.

``hash_probe_cuda`` — linear stage-0, leaf position, ``slot = int(pos *
    f32(S/n))``, primary slot compare and the overflow chain walk, one
    launch -> (B,) bool.  Replaces the reference's ``hash_probe_pallas``.

The kernel reads each pair it needs by one 8-byte load: the leaf as a
(w, b) float32 record, the slot and each overflow node as a (key bits,
next) int32 record whose key column is viewed as float32.
`ops.hash_probe_tensors` builds those records on the card and hands out
their column views, which the wrapper reads in place; other arrays are
packed into fresh records on every call.

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
        p, i, f, f,                 # leaf record, M, f32(M/n), f32(n-1)
        p, i, f,                    # slot record, S, f32(S/n)
        p, i, i,                    # overflow record, O, trips
        p, p,                       # out, stream
    ]
    lib.hash_probe_launch.restype = i
    lib.bloom_probe_launch.argtypes = [p, i, p, ctypes.c_uint32, i, p, p]
    lib.bloom_probe_launch.restype = i


def _pair_record(first, second) -> torch.Tensor:
    """Where the kernel reads the 8-byte pairs ``(first[j], second[j])``:
    the two 1-D columns of one (N, 2) record (adjacent, 8-byte aligned,
    as `ops.hash_probe_tensors` hands them out) are read in place; other
    arrays are packed into a fresh (N, 2) record of their bits."""
    p = first.data_ptr()
    if (p % 8 == 0 and second.data_ptr() == p + 4
            and first.stride(0) == second.stride(0) == 2):
        return first
    return torch.stack([first.view(torch.int32), second.view(torch.int32)], dim=1)


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
        (q, "q", f32), (s0, "stage0", f32))]
    for a, nm, dt in ((leaf_w, "leaf_w", f32), (leaf_b, "leaf_b", f32),
                      (slot_key, "slot_key", f32), (slot_next, "slot_next", i32),
                      (ovf_key, "ovf_key", f32), (ovf_next, "ovf_next", i32)):
        if a.device != dev or a.dtype != dt or a.ndim != 1:
            raise ValueError(f"{nm} must be a 1-D {dt} tensor on {dev}")
    leaves = _pair_record(leaf_w, leaf_b)
    slots = _pair_record(slot_key, slot_next)
    ovf = _pair_record(ovf_key, ovf_next)
    out = torch.empty(q.shape, dtype=torch.bool, device=dev)
    if q.shape[0] == 0:
        return out
    err = nvcc.load(SOURCE, declare).hash_probe_launch(
        ptrs[0], q.shape[0], ptrs[1], leaves.data_ptr(), num_leaves,
        float(np.float32(num_leaves / n)), float(np.float32(n - 1)),
        slots.data_ptr(), num_slots, float(np.float32(num_slots / n)),
        ovf.data_ptr(), o, trips, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    nvcc.raise_on_error(err, "hash_probe")
    LAUNCHES["hash_probe_cuda"] += 1
    return out
