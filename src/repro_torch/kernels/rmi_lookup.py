"""The fused RMI lookup kernel (``csrc/rmi_lookup.cu``): build, load
and the PyTorch wrappers.

Three wrappers share one CUDA source; the first two are one kernel,
compiled once with and once without the delta search (a template flag):

``rmi_lookup_cuda``        — the read-only §3 lookup: stage-0 MLP, leaf
    select, leaf position and error window, a first probe at the
    prediction and a fixed-trip branchless search over the base keys.
    Replaces the reference's ``rmi_lookup_pallas``.
``rmi_merged_lookup_cuda`` — the writable-index hot path (§3.3): the
    same plus a fixed-trip lower bound over the staged delta keys and
    one prefix gather, emitting ``(base_lb, merged_rank)`` from one
    launch.  Replaces ``rmi_merged_lookup_pallas``.

``rmi_sharded_merged_lookup_cuda`` — the same merged lookup of every
    query on every row of stacked shards, one thread a (shard, query).
    Replaces ``rmi_sharded_merged_lookup_pallas``.

All three read a leaf as one 16-byte float32 record (w, b, err_lo,
err_hi): `core.rmi.pack_leaves` builds an (M, 4) one and
`ops.stack_rows` an (S, M, 4) one, and callers that keep it pass its
four column views (`RMIndex.as_tree` and `ops.stack_rows` do); four
separate arrays are packed into a fresh record on every call.

For a CUDA tensor a wrapper launches the kernel (or raises); for a CPU
tensor it runs the plain version in `kernels.ref`.  Each launch adds
one to the wrapper's count in ``LAUNCHES``.

The library is built with ``nvcc`` at first use (`kernels.nvcc`) and
loaded with ctypes.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.models import pack_stage0, stage0_dims
from repro_torch.core.rmi import LEAF_FIELDS, pack_leaves
from repro_torch.core.search import _steps_for_window as _search_steps
from repro_torch.kernels import nvcc, ref

SOURCE = nvcc.CSRC / "rmi_lookup.cu"
MAX_HIDDEN = 64

# launches per wrapper; a plain integer each, bumped only where the
# kernel is launched
LAUNCHES: Dict[str, int] = {"rmi_lookup_cuda": 0, "rmi_merged_lookup_cuda": 0,
                            "rmi_sharded_merged_lookup_cuda": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def stage0_flat(params: Dict[str, np.ndarray], device) -> torch.Tensor:
    """RMIndex.stage0_params -> the one flat float32 device buffer the
    kernel takes (w_i row-major, then b_i, layer by layer)."""
    return torch.as_tensor(pack_stage0(params), device=device)


def _leaf_record(leaf_w, leaf_b, err_lo, err_hi, dev):
    """``(pointer, owner)`` of the (M, 4) record the kernel reads: the
    record whose columns the four leaf arrays are (its bytes are then
    exactly their elements; ``owner`` None), or a fresh `pack_leaves`
    of them (``owner`` keeps it alive through the launch)."""
    cols = (leaf_w, leaf_b, err_lo, err_hi)
    m = leaf_w.shape[0]
    for a, name in zip(cols, LEAF_FIELDS):
        if a.device != dev or a.dtype != torch.float32 or a.ndim != 1 or a.shape[0] != m:
            raise ValueError(f"{name} must be a 1-D float32 tensor on {dev} "
                             f"of leaf_w's length {m}")
    p = leaf_w.data_ptr()
    if (p % 16 == 0 and leaf_b.data_ptr() == p + 4 and err_lo.data_ptr() == p + 8
            and err_hi.data_ptr() == p + 12 and leaf_w.stride(0) == leaf_b.stride(0)
            == err_lo.stride(0) == err_hi.stride(0) == 4):
        return p, None
    record = pack_leaves(*cols)
    return record.data_ptr(), record


def library_path():
    return nvcc.library_path(SOURCE)


def build():
    """Compile the kernel library unless this source hash is built;
    returns its path."""
    return nvcc.build(SOURCE)


def _declare(lib) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rmi_lookup_launch.argtypes = [
        p, i, p, i, i, i,           # q, B, s0, nl, h1, h2
        p, i, f,                    # leaf record, M, ratio
        p, i, f, i,                 # keys, n, f32(n-1), steps
        p, p, i, i,                 # dkeys, dprefix, D, dsteps
        p, p, p,                    # out_base, out_merged, stream
    ]
    lib.rmi_lookup_launch.restype = i
    lib.rmi_sharded_lookup_launch.argtypes = [
        p, i, i, p, i, i, i,        # q, S, B, s0, nl, h1, h2
        p, p, p, p, i,              # leaf record, keys, dkeys, dprefix, D
        p, p, p, i, i,              # shard_n/m/ratio, steps, dsteps
        p, p, p, p,                 # row strides, out_base, out_contrib, stream
    ]
    lib.rmi_sharded_lookup_launch.restype = i


def _check_hidden(hidden) -> tuple:
    hidden = tuple(int(h) for h in hidden)
    if len(hidden) > 2 or any(h < 1 or h > MAX_HIDDEN for h in hidden):
        raise ValueError(
            f"stage-0 hidden widths {hidden}: the kernel takes at most two "
            f"hidden layers of width <= {MAX_HIDDEN}"
        )
    return hidden


def _launch(q, s0, leaf_w, leaf_b, err_lo, err_hi, sorted_keys,
            delta_keys, delta_prefix, *, hidden, n, num_leaves, max_window):
    dev = q.device
    hidden = _check_hidden(hidden)
    if not 1 <= n < 2**30 or sorted_keys.shape[0] != n:
        raise ValueError(f"need 1 <= n < 2**30 sorted keys, got n={n}")
    if leaf_w.shape[0] != num_leaves:
        raise ValueError("leaf arrays must hold num_leaves entries")
    f32, i32 = torch.float32, torch.int32
    leaves, _owner = _leaf_record(leaf_w, leaf_b, err_lo, err_hi, dev)
    args = [nvcc.check_tensor(q, "q", f32, dev), q.shape[0],
            nvcc.check_tensor(s0, "stage0", f32, dev), len(hidden) + 1,
            hidden[0] if hidden else 0, hidden[1] if len(hidden) > 1 else 0,
            leaves, num_leaves, float(np.float32(num_leaves / n)),
            nvcc.check_tensor(sorted_keys, "sorted_keys", f32, dev), n,
            float(np.float32(n - 1)), _search_steps(max_window)]
    base = torch.empty(q.shape, dtype=i32, device=dev)
    if delta_keys is None:
        args += [None, None, 0, 0, base.data_ptr(), None]
        merged = None
    else:
        d = delta_keys.shape[0]
        if d < 1 or delta_prefix.shape[0] != d + 1:
            raise ValueError("delta_prefix must hold len(delta_keys) + 1 entries")
        merged = torch.empty(q.shape, dtype=i32, device=dev)
        args += [nvcc.check_tensor(delta_keys, "delta_keys", f32, dev),
                 nvcc.check_tensor(delta_prefix, "delta_prefix", i32, dev), d,
                 _search_steps(d), base.data_ptr(), merged.data_ptr()]
    if q.shape[0] == 0:
        return base, merged
    args.append(torch.cuda.current_stream(dev).cuda_stream)
    err = nvcc.load(SOURCE, _declare).rmi_lookup_launch(*args)
    nvcc.raise_on_error(err, "rmi_lookup")
    LAUNCHES["rmi_merged_lookup_cuda" if delta_keys is not None
             else "rmi_lookup_cuda"] += 1
    return base, merged


def rmi_lookup_cuda(
    q: torch.Tensor,                   # (B,) normalized float32 queries
    s0: torch.Tensor,                  # flat stage-0 buffer (stage0_flat)
    leaf_w: torch.Tensor,              # (M,)
    leaf_b: torch.Tensor,              # (M,)
    err_lo: torch.Tensor,              # (M,)
    err_hi: torch.Tensor,              # (M,)
    sorted_keys: torch.Tensor,         # (N,)
    *,
    hidden: tuple,
    n: int,
    num_leaves: int,
    max_window: int,
) -> torch.Tensor:
    """RMI base lower bound, int32 (B,)."""
    if q.device.type == "cpu":
        return ref.rmi_lookup_reference(
            q, s0, leaf_w, leaf_b, err_lo, err_hi, sorted_keys,
            hidden=hidden, n=n, num_leaves=num_leaves, max_window=max_window,
        )
    base, _ = _launch(
        q, s0, leaf_w, leaf_b, err_lo, err_hi, sorted_keys, None, None,
        hidden=hidden, n=n, num_leaves=num_leaves, max_window=max_window,
    )
    return base


def rmi_merged_lookup_cuda(
    q: torch.Tensor,                   # (B,) normalized float32 queries
    s0: torch.Tensor,                  # flat stage-0 buffer (stage0_flat)
    leaf_w: torch.Tensor,              # (M,)
    leaf_b: torch.Tensor,              # (M,)
    err_lo: torch.Tensor,              # (M,)
    err_hi: torch.Tensor,              # (M,)
    sorted_keys: torch.Tensor,         # (N,)
    delta_keys: torch.Tensor,          # (D,) +inf-padded (combine_for_device)
    delta_prefix: torch.Tensor,        # (D+1,) int32 net +1/-1 prefix
    *,
    hidden: tuple,
    n: int,
    num_leaves: int,
    max_window: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused base+delta merged lookup: ``(base_lb, merged_rank)``, both
    int32 (B,), from one launch."""
    if q.device.type == "cpu":
        return ref.rmi_merged_lookup_reference(
            q, s0, leaf_w, leaf_b, err_lo, err_hi, sorted_keys, delta_keys,
            delta_prefix, hidden=hidden, n=n, num_leaves=num_leaves,
            max_window=max_window,
        )
    return _launch(
        q, s0, leaf_w, leaf_b, err_lo, err_hi, sorted_keys, delta_keys,
        delta_prefix, hidden=hidden, n=n, num_leaves=num_leaves,
        max_window=max_window,
    )


def _row_stride(t: torch.Tensor, name: str, dtype, dev, rows: int,
                elem_stride: int = 1) -> int:
    """Check one stacked (S, W) input: on ``dev``, of ``dtype``, ``rows``
    rows whose elements lie ``elem_stride`` apart (1: contiguous rows; 4:
    a column of an (S, M, 4) leaf record); returns its row stride (0 for
    a row broadcast with ``expand``)."""
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if (t.ndim != 2 or t.shape[0] != rows
            or (t.shape[1] > 1 and t.stride(1) not in (1, elem_stride))):
        raise ValueError(f"{name} must be ({rows}, W) with contiguous rows"
                         + (" or a column of an (S, M, 4) record" if elem_stride > 1 else ""))
    return t.stride(0)


def _stacked_leaf_record(leaf_w, leaf_b, err_lo, err_hi):
    """``(record, row_stride)`` of the (S, M, 4) leaf record the kernel
    reads, the row stride in records: the record whose columns the four
    (S, M) leaf tensors are (`ops.stack_rows` hands them out so; a row
    may be broadcast with stride 0), or a fresh pack of them."""
    p = leaf_w.data_ptr()
    m = leaf_w.shape[1]
    if (p % 16 == 0 and leaf_b.data_ptr() == p + 4 and err_lo.data_ptr() == p + 8
            and err_hi.data_ptr() == p + 12
            and (m == 1 or leaf_w.stride(1) == leaf_b.stride(1) == err_lo.stride(1)
                 == err_hi.stride(1) == 4)
            and leaf_w.stride(0) == leaf_b.stride(0) == err_lo.stride(0)
            == err_hi.stride(0) and leaf_w.stride(0) % 4 == 0
            and all(t.shape == leaf_w.shape for t in (leaf_b, err_lo, err_hi))):
        return leaf_w, leaf_w.stride(0) // 4
    return torch.stack([leaf_w, leaf_b, err_lo, err_hi], dim=2), m


def rmi_sharded_merged_lookup_cuda(
    q: torch.Tensor,                   # (S, B) per-shard normalized queries
    s0: torch.Tensor,                  # (S, P) flat stage-0 buffers
    leaf_w: torch.Tensor,              # (S, M) zero-padded
    leaf_b: torch.Tensor,              # (S, M)
    err_lo: torch.Tensor,              # (S, M)
    err_hi: torch.Tensor,              # (S, M)
    sorted_keys: torch.Tensor,         # (S, N) +inf-padded
    delta_keys: torch.Tensor,          # (S, D) +inf-padded per-shard deltas
    delta_prefix: torch.Tensor,        # (S, D+1) int32 prefix
    shard_n: torch.Tensor,             # (S,) int32 true base sizes
    shard_m: torch.Tensor,             # (S,) int32 true leaf counts
    shard_ratio: torch.Tensor,         # (S,) float32 f32(m/n), host-computed
    *,
    hidden: tuple,
    max_window: int,                   # the maximum over the shards
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sharded merged lookup: every query on every shard row, one
    launch.  Returns the per-shard ``(local_base, delta_contrib)``, both
    int32 (S, B); `ops.sharded_reassemble` turns them into global
    ranks.  Rows may be broadcast views (stride 0).  The four leaf
    tensors are read in place when they are the column views of one
    (S, M, 4) record (`ops.stack_rows`), else packed into one per call.
    The caller keeps each shard's n below its padded width and its leaf
    count below M."""
    if q.device.type == "cpu":
        return ref.rmi_sharded_merged_lookup_reference(
            q, s0, leaf_w, leaf_b, err_lo, err_hi, sorted_keys, delta_keys,
            delta_prefix, shard_n, shard_m, shard_ratio,
            hidden=hidden, max_window=max_window)
    dev = q.device
    hidden = _check_hidden(hidden)
    f32, i32 = torch.float32, torch.int32
    if q.ndim != 2:
        raise ValueError("q must be (S, B)")
    S, B = q.shape
    for t, nm in ((leaf_w, "leaf_w"), (leaf_b, "leaf_b"), (err_lo, "err_lo"),
                  (err_hi, "err_hi")):
        _row_stride(t, nm, f32, dev, S, elem_stride=4)
        if t.shape != leaf_w.shape:
            raise ValueError(f"{nm} must have leaf_w's shape {tuple(leaf_w.shape)}")
    record, leaf_stride = _stacked_leaf_record(leaf_w, leaf_b, err_lo, err_hi)
    strides = [_row_stride(t, nm, dt, dev, S) for t, nm, dt in (
        (q, "q", f32), (s0, "stage0", f32))]
    strides.append(leaf_stride)
    strides += [_row_stride(t, nm, dt, dev, S) for t, nm, dt in (
        (sorted_keys, "sorted_keys", f32), (delta_keys, "delta_keys", f32),
        (delta_prefix, "delta_prefix", i32))]
    d = delta_keys.shape[1]
    dims = stage0_dims(hidden)
    if s0.shape[1] < sum(a * b + b for a, b in zip(dims[:-1], dims[1:])):
        raise ValueError(f"stage0 rows are too short for hidden widths {hidden}")
    if d < 1 or delta_prefix.shape[1] != d + 1:
        raise ValueError("delta_prefix must hold D + 1 entries per row")
    if sorted_keys.shape[1] >= 2**30:
        raise ValueError("need shard sizes n < 2**30")
    ptrs = [nvcc.check_tensor(a, nm, dt, dev) for a, nm, dt in (
        (shard_n, "shard_n", i32), (shard_m, "shard_m", i32),
        (shard_ratio, "shard_ratio", f32))]
    if any(a.shape[0] != S for a in (shard_n, shard_m, shard_ratio)):
        raise ValueError("shard_n, shard_m and shard_ratio need one entry per shard")
    base = torch.empty((S, B), dtype=i32, device=dev)
    contrib = torch.empty((S, B), dtype=i32, device=dev)
    if S == 0 or B == 0:
        return base, contrib
    stride_buf = (ctypes.c_longlong * len(strides))(*strides)
    err = nvcc.load(SOURCE, _declare).rmi_sharded_lookup_launch(
        q.data_ptr(), S, B, s0.data_ptr(), len(hidden) + 1,
        hidden[0] if hidden else 0, hidden[1] if len(hidden) > 1 else 0,
        record.data_ptr(), sorted_keys.data_ptr(), delta_keys.data_ptr(),
        delta_prefix.data_ptr(), d, *ptrs, _search_steps(max_window),
        _search_steps(d), ctypes.addressof(stride_buf), base.data_ptr(),
        contrib.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    nvcc.raise_on_error(err, "rmi_sharded_lookup")
    LAUNCHES["rmi_sharded_merged_lookup_cuda"] += 1
    return base, contrib
