"""The fused RMI lookup kernel (``csrc/rmi_lookup.cu``): build, load
and the PyTorch wrappers.

Two wrappers share one CUDA source, compiled once with and once without
the delta search (a template flag):

``rmi_lookup_cuda``        — the read-only §3 lookup: stage-0 MLP, leaf
    select, leaf position and error window, a first probe at the
    prediction and a fixed-trip branchless search over the base keys.
    Replaces the reference's ``rmi_lookup_pallas``.
``rmi_merged_lookup_cuda`` — the writable-index hot path (§3.3): the
    same plus a fixed-trip lower bound over the staged delta keys and
    one prefix gather, emitting ``(base_lb, merged_rank)`` from one
    launch.  Replaces ``rmi_merged_lookup_pallas``.

For a CUDA tensor a wrapper launches the kernel (or raises); for a CPU
tensor it runs the plain version in `kernels.ref`.  Each launch adds
one to the wrapper's count in ``LAUNCHES``.

The library is built with ``nvcc`` at first use into ``build/repro_torch``
under the repository root (``REPRO_TORCH_BUILD_DIR`` overrides it),
named by the hash of the source and the flags, and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.models import pack_stage0
from repro_torch.core.search import _steps_for_window as _search_steps
from repro_torch.kernels import ref

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "rmi_lookup.cu"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
MAX_HIDDEN = 64

# launches per wrapper; a plain integer each, bumped only where the
# kernel is launched
LAUNCHES: Dict[str, int] = {"rmi_lookup_cuda": 0, "rmi_merged_lookup_cuda": 0}

_LIB = None
_LIB_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def stage0_flat(params: Dict[str, np.ndarray], device) -> torch.Tensor:
    """RMIndex.stage0_params -> the one flat float32 device buffer the
    kernel takes (w_i row-major, then b_i, layer by layer)."""
    return torch.as_tensor(pack_stage0(params), device=device)


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return build_dir() / f"rmi_lookup-{digest}.so"


def build() -> pathlib.Path:
    """Compile the kernel library unless this source hash is built;
    returns its path.  The compiler's resource report (``-Xptxas -v``)
    lands beside it as ``.log``."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True, check=True,
    )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def _lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.rmi_lookup_launch.argtypes = [
                p, i, p, i, i, i,           # q, B, s0, nl, h1, h2
                p, p, p, p, i, f,           # leaf_w/b, err_lo/hi, M, ratio
                p, i, f, i,                 # keys, n, f32(n-1), steps
                p, p, i, i,                 # dkeys, dprefix, D, dsteps
                p, p, p,                    # out_base, out_merged, stream
            ]
            lib.rmi_lookup_launch.restype = i
            _LIB = lib
    return _LIB


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, device) -> int:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.ndim != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D tensor")
    return t.data_ptr()


def _launch(q, s0, leaf_w, leaf_b, err_lo, err_hi, sorted_keys,
            delta_keys, delta_prefix, *, hidden, n, num_leaves, max_window):
    dev = q.device
    hidden = tuple(int(h) for h in hidden)
    if len(hidden) > 2 or any(h < 1 or h > MAX_HIDDEN for h in hidden):
        raise ValueError(
            f"stage-0 hidden widths {hidden}: the kernel takes at most two "
            f"hidden layers of width <= {MAX_HIDDEN}"
        )
    if not 1 <= n < 2**30 or sorted_keys.shape[0] != n:
        raise ValueError(f"need 1 <= n < 2**30 sorted keys, got n={n}")
    if leaf_w.shape[0] != num_leaves:
        raise ValueError("leaf arrays must hold num_leaves entries")
    f32, i32 = torch.float32, torch.int32
    args = [_check(q, "q", f32, dev), q.shape[0],
            _check(s0, "stage0", f32, dev), len(hidden) + 1,
            hidden[0] if hidden else 0, hidden[1] if len(hidden) > 1 else 0]
    args += [_check(a, nm, f32, dev) for a, nm in (
        (leaf_w, "leaf_w"), (leaf_b, "leaf_b"),
        (err_lo, "err_lo"), (err_hi, "err_hi"))]
    args += [num_leaves, float(np.float32(num_leaves / n)),
             _check(sorted_keys, "sorted_keys", f32, dev), n,
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
        args += [_check(delta_keys, "delta_keys", f32, dev),
                 _check(delta_prefix, "delta_prefix", i32, dev), d,
                 _search_steps(d), base.data_ptr(), merged.data_ptr()]
    if q.shape[0] == 0:
        return base, merged
    args.append(torch.cuda.current_stream(dev).cuda_stream)
    err = _lib().rmi_lookup_launch(*args)
    if err != 0:
        raise RuntimeError(f"rmi_lookup kernel launch failed: cudaError {err}")
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
