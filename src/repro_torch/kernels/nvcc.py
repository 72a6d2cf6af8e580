"""Build and load the port's CUDA sources: one ``nvcc`` call per source
into a shared library with a plain C interface, loaded with ctypes.

Each library is built at first use into ``build/repro_torch`` under the
repository root (``REPRO_TORCH_BUILD_DIR`` overrides it), named by the
hash of its source and the flags, so an edited source never loads a
stale build.  Every source takes ``NVCC_FLAGS`` unless its module passes
its own (the attention source drops ``-fmad=false``: it is held to a
tolerance, the RMI sources bit for bit).  The compiler's resource report (``-Xptxas -v``) lands
beside each library as ``.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[tuple, ctypes.CDLL] = {}
_LOCK = threading.Lock()


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


def library_path(source: pathlib.Path, flags=NVCC_FLAGS) -> pathlib.Path:
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(flags).encode()
    ).hexdigest()[:16]
    return build_dir() / f"{source.stem}-{digest}.so"


def build(source: pathlib.Path, flags=NVCC_FLAGS) -> pathlib.Path:
    """Compile ``source`` with ``flags`` unless this source hash is built;
    returns the library's path."""
    out = library_path(source, flags)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *flags, "-o", str(tmp), str(source)],
        capture_output=True, text=True, check=True,
    )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load(source: pathlib.Path, declare, flags=NVCC_FLAGS) -> ctypes.CDLL:
    """The loaded library of ``source``, built with ``flags`` if needed;
    ``declare(lib)`` sets its functions' argtypes once, at first load."""
    key = (source, tuple(flags))
    with _LOCK:
        lib = _LIBS.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build(source, flags)))
            declare(lib)
            _LIBS[key] = lib
    return lib


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, device,
                 ndim: int = 1) -> int:
    """Raise unless ``t`` is a contiguous ``ndim``-D tensor of ``dtype``
    on ``device``; returns its data pointer."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.ndim != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-D tensor")
    return t.data_ptr()


def raise_on_error(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")
