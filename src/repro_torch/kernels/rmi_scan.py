"""The merged range-scan kernels (``csrc/rmi_scan.cu``): load and the
PyTorch wrappers.

``rmi_scan_range_cuda`` — one launch ranks the endpoints of [lo, hi)
    and gathers every page of merged rows between them through the
    prefix-sum page index, a tile of `RANGE_TILE` consecutive ranks a
    block: it places each tile's first and last rank, stages the
    spans of ``ins_rank`` and ``live_prefix`` between them in shared
    memory (at most `RANGE_INS_CAP` and `RANGE_PREFIX_CAP` entries;
    a longer span is searched in device memory) and finishes each
    rank's searches there.  ``ins_rank`` and ``live_prefix`` must be
    non-decreasing, as `device_scan_slab` builds them.  Replaces the
    reference's ``rmi_scan_range_pallas``.
``rmi_sharded_scan_page_cuda`` — the same tiles over S stacked shard
    slabs in one launch, a tile of `RANGE_TILE` stream slots of one
    shard a block: each shard resolves the slots it owns, a tile that
    owns none writes masked rows and searches nothing.  Replaces
    ``rmi_sharded_scan_page_pallas``.
``rmi_scan_page_cuda``  — rank-addressed pages: a pre-pass launch
    writes each staged insert's merged rank and each tombstone's gap
    (position minus index), then a block resolves the whole pages
    that hold about `RANGE_TILE` lanes from spans of those two arrays,
    staged or searched in place as above.  ``del_pos`` must hold
    distinct sorted positions below N, then pads of N, as
    `device_scan_plan` builds it.  Replaces ``rmi_scan_page_pallas``.

For a CUDA tensor a wrapper launches the kernel (or raises); for a CPU
tensor it runs the plain version in `kernels.ref`.  Each call that
launches adds one to the wrapper's count in ``LAUNCHES``.  Outputs are
``(keys f32, vals i32, live i32)``, each (pages, page_size);
(S, pages, page_size) for the sharded kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import nvcc, ref

SOURCE = nvcc.CSRC / "rmi_scan.cu"
INT32_MAX = 2**31 - 1
RANGE_TILE = 2048          # consecutive ranks (or slots, or page lanes) a block resolves
RANGE_INS_CAP = 1024       # ins_rank / insert rank entries staged in shared memory
RANGE_PREFIX_CAP = 4096    # live_prefix / tombstone gap entries staged in shared memory

# launches per wrapper; a plain integer each, bumped only where the
# kernel is launched
LAUNCHES: Dict[str, int] = {"rmi_scan_range_cuda": 0, "rmi_scan_page_cuda": 0,
                            "rmi_sharded_scan_page_cuda": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build():
    """Compile the kernel library unless this source hash is built;
    returns its path."""
    return nvcc.build(SOURCE)


def load():
    """The loaded kernel library, built first if this source hash is not;
    raises if it does not build or load."""
    return nvcc.load(SOURCE, _declare)


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rmi_scan_range_launch.argtypes = [
        p, p, p, p, i,              # bounds, base, bvals, live_prefix, n
        p, p, p, i, i,              # ins, ivals, ins_rank, ni, lanes
        i, i, i,                    # tile, ins_rank and live_prefix caps
        p, p, p, p,                 # out keys, vals, live, stream
    ]
    lib.rmi_scan_page_launch.argtypes = [
        p, i, i, i,                 # starts, pages, page_size, pages per tile
        p, p, i, p, p, i,           # base, bvals, n, ins, ivals, ni
        p, i, p, i, i,              # del_pos, nd, end_rank, steps, dsteps
        i, i, p,                    # insert rank and gap caps, scratch (ni + nd)
        p, p, p, p,                 # out keys, vals, live, stream
    ]
    lib.rmi_sharded_scan_launch.argtypes = [
        p, p, p, i, i,              # base, bvals, live_prefix, S, n
        p, p, p, i,                 # ins, ivals, ins_rank, ni
        p, p, p, i,                 # ls0, own_lo, own_hi, lanes
        i, i, i, i, i,              # tile, ins_rank and live_prefix caps, psteps, msteps
        p, p, p, p,                 # out keys, vals, live, stream
    ]
    lib.rmi_scan_range_launch.restype = i
    lib.rmi_sharded_scan_launch.restype = i
    lib.rmi_scan_page_launch.restype = i


def _outputs(*shape: int, dev):
    return (torch.empty(shape, dtype=torch.float32, device=dev),
            torch.empty(shape, dtype=torch.int32, device=dev),
            torch.empty(shape, dtype=torch.int32, device=dev))


def _base_args(base_keys, base_vals, ins_keys, ins_vals, dev):
    n, ni = base_keys.shape[0], ins_keys.shape[0]
    if not 1 <= n < 2**30 or base_vals.shape[0] != n:
        raise ValueError(f"need 1 <= n < 2**30 base rows with one value each, got n={n}")
    if ni < 1 or ins_vals.shape[0] != ni:
        raise ValueError("ins_keys must be padded to >= 1 slot, one value each")
    f32, i32 = torch.float32, torch.int32
    return n, ni, (nvcc.check_tensor(base_keys, "base_keys", f32, dev),
                   nvcc.check_tensor(base_vals, "base_vals", i32, dev),
                   nvcc.check_tensor(ins_keys, "ins_keys", f32, dev),
                   nvcc.check_tensor(ins_vals, "ins_vals", i32, dev))


def rmi_scan_range_cuda(
    bounds: torch.Tensor,          # (2,) f32 normalized [lo, hi)
    base_keys: torch.Tensor,       # (N,) sorted normalized f32
    base_vals: torch.Tensor,       # (N,) int32
    live_prefix: torch.Tensor,     # (N+1,) int32 prefix-sum page index
    ins_keys: torch.Tensor,        # (D,) +inf-padded eff. insert keys
    ins_vals: torch.Tensor,        # (D,) int32
    ins_rank: torch.Tensor,        # (D,) int32 merged rank per insert
    *,
    page_size: int,
    max_pages: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused endpoint ranking + page gather: the rows at merged ranks
    ``r0 + [0, max_pages*page_size)``, lanes past ``r1`` masked."""
    if bounds.device.type == "cpu":
        return ref.rmi_scan_range_reference(
            bounds, base_keys, base_vals, live_prefix, ins_keys, ins_vals,
            ins_rank, page_size=page_size, max_pages=max_pages)
    dev = bounds.device
    if page_size < 1 or max_pages < 0:
        raise ValueError("need page_size >= 1 and max_pages >= 0")
    n, ni, (bk, bv, ik, iv) = _base_args(base_keys, base_vals, ins_keys,
                                         ins_vals, dev)
    if bounds.shape != (2,) or live_prefix.shape[0] != n + 1 or ins_rank.shape[0] != ni:
        raise ValueError("need bounds (2,), live_prefix (N+1,) and ins_rank (D,)")
    lanes = max_pages * page_size
    # ranks are int32: the largest lane rank, r0 + lanes, must fit
    if n + ni + lanes + 1 > INT32_MAX:
        raise ValueError(f"{lanes} lanes past {n + ni} rows overflow int32 ranks")
    out = _outputs(max_pages, page_size, dev=dev)
    if lanes == 0:
        return out
    i32 = torch.int32
    err = load().rmi_scan_range_launch(
        nvcc.check_tensor(bounds, "bounds", torch.float32, dev), bk, bv,
        nvcc.check_tensor(live_prefix, "live_prefix", i32, dev), n, ik, iv,
        nvcc.check_tensor(ins_rank, "ins_rank", i32, dev), ni, lanes,
        RANGE_TILE, RANGE_INS_CAP, RANGE_PREFIX_CAP, *(o.data_ptr() for o in out),
        torch.cuda.current_stream(dev).cuda_stream)
    nvcc.raise_on_error(err, "rmi_scan_range")
    LAUNCHES["rmi_scan_range_cuda"] += 1
    return out


def rmi_scan_page_cuda(
    starts: torch.Tensor,          # (G,) int32 page start ranks
    base_keys: torch.Tensor,       # (N,) sorted normalized f32
    base_vals: torch.Tensor,       # (N,) int32
    ins_keys: torch.Tensor,        # (Di,) +inf-padded eff. insert keys
    ins_vals: torch.Tensor,        # (Di,) int32
    del_pos: torch.Tensor,         # (Dd,) n-padded dead base positions
    end_rank: torch.Tensor,        # (1,) int32
    *,
    page_size: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rank-addressed merged pages: page g holds the rows at ranks
    ``starts[g] + [0, page_size)``; ranks outside [0, end_rank) are
    masked."""
    if starts.device.type == "cpu":
        return ref.rmi_scan_page_reference(
            starts, base_keys, base_vals, ins_keys, ins_vals, del_pos,
            end_rank, page_size=page_size)
    dev = starts.device
    if page_size < 1:
        raise ValueError("need page_size >= 1")
    n, ni, (bk, bv, ik, iv) = _base_args(base_keys, base_vals, ins_keys,
                                         ins_vals, dev)
    nd = del_pos.shape[0]
    if nd < 1 or end_rank.shape != (1,):
        raise ValueError("need del_pos padded to >= 1 slot and end_rank (1,)")
    g = starts.shape[0]
    out = _outputs(g, page_size, dev=dev)
    if g == 0:
        return out
    lanes = g * page_size
    if lanes > INT32_MAX:
        raise ValueError(f"{lanes} lanes overflow int32")
    steps, dsteps = ref.trip_counts(n, nd)
    i32 = torch.int32
    scratch = torch.empty(ni + nd, dtype=i32, device=dev)
    err = load().rmi_scan_page_launch(
        nvcc.check_tensor(starts, "starts", i32, dev), g, page_size,
        max(1, RANGE_TILE // page_size), bk, bv, n, ik, iv, ni,
        nvcc.check_tensor(del_pos, "del_pos", i32, dev), nd,
        nvcc.check_tensor(end_rank, "end_rank", i32, dev), steps, dsteps,
        RANGE_INS_CAP, RANGE_PREFIX_CAP, scratch.data_ptr(),
        *(o.data_ptr() for o in out), torch.cuda.current_stream(dev).cuda_stream)
    nvcc.raise_on_error(err, "rmi_scan_page")
    LAUNCHES["rmi_scan_page_cuda"] += 1
    return out


def rmi_sharded_scan_page_cuda(
    base_keys: torch.Tensor,       # (S, N) sorted f32, +inf padded
    base_vals: torch.Tensor,       # (S, N) int32
    live_prefix: torch.Tensor,     # (S, N+1) int32, pinned past the true n
    ins_keys: torch.Tensor,        # (S, D) +inf-padded eff. insert keys
    ins_vals: torch.Tensor,        # (S, D) int32
    ins_rank: torch.Tensor,        # (S, D) int32, big pad
    ls0: torch.Tensor,             # (S,) int32 local rank of lo per shard
    own_lo: torch.Tensor,          # (S,) int32 shard's first stream slot
    own_hi: torch.Tensor,          # (S,) int32 one past its last
    *,
    page_size: int,
    max_pages: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Owner-masked per-shard pages: shard s emits stream slots t in
    [own_lo[s], own_hi[s]) as its merged row at local rank
    ``ls0[s] + t - own_lo[s]``; every other slot is (+inf, 0, 0).
    Returns (S, max_pages, page_size) keys f32, vals i32, live i32."""
    if base_keys.device.type == "cpu":
        return ref.rmi_sharded_scan_page_reference(
            base_keys, base_vals, live_prefix, ins_keys, ins_vals, ins_rank,
            ls0, own_lo, own_hi, page_size=page_size, max_pages=max_pages)
    dev = base_keys.device
    if page_size < 1 or max_pages < 0:
        raise ValueError("need page_size >= 1 and max_pages >= 0")
    if base_keys.ndim != 2:
        raise ValueError("base_keys must be (S, N)")
    S, n = base_keys.shape
    ni = ins_keys.shape[1] if ins_keys.ndim == 2 else 0
    f32, i32 = torch.float32, torch.int32
    shapes = ((base_vals, (S, n)), (live_prefix, (S, n + 1)), (ins_vals, (S, ni)),
              (ins_rank, (S, ni)), (ls0, (S,)), (own_lo, (S,)), (own_hi, (S,)))
    if not 1 <= n < 2**30 or ni < 1 or any(tuple(a.shape) != sh for a, sh in shapes):
        raise ValueError("need (S, N) base rows with 1 <= N < 2**30, (S, N+1) "
                         "live_prefix, (S, D >= 1) insert rows and (S,) offsets")
    lanes = max_pages * page_size
    if lanes > INT32_MAX:
        raise ValueError(f"{lanes} lanes overflow int32")
    out = _outputs(S, max_pages, page_size, dev=dev)
    if lanes == 0 or S == 0:
        return out
    ptrs = [nvcc.check_tensor(a, nm, dt, dev, ndim=nd) for a, nm, dt, nd in (
        (base_keys, "base_keys", f32, 2), (base_vals, "base_vals", i32, 2),
        (live_prefix, "live_prefix", i32, 2), (ins_keys, "ins_keys", f32, 2),
        (ins_vals, "ins_vals", i32, 2), (ins_rank, "ins_rank", i32, 2),
        (ls0, "ls0", i32, 1), (own_lo, "own_lo", i32, 1), (own_hi, "own_hi", i32, 1))]
    psteps, msteps = ref.trip_counts(n + 1, ni)
    err = load().rmi_sharded_scan_launch(
        *ptrs[:3], S, n, *ptrs[3:6], ni, *ptrs[6:], lanes, RANGE_TILE, RANGE_INS_CAP,
        RANGE_PREFIX_CAP, psteps, msteps,
        *(o.data_ptr() for o in out), torch.cuda.current_stream(dev).cuda_stream)
    nvcc.raise_on_error(err, "rmi_sharded_scan")
    LAUNCHES["rmi_sharded_scan_page_cuda"] += 1
    return out
