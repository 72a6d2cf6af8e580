"""The flash-attention kernel (``csrc/flash_attention.cu``): build, load
and the PyTorch wrapper.

``flash_attention_cuda`` — causal or full GQA attention with an online
    softmax over (B, Hq, S, D) queries and (B, Hkv, S, D) keys and
    values, float32 or bfloat16, D in {32, 64, 128}, any S.  Replaces the
    reference's ``flash_attention`` (a Pallas kernel, which needs S to
    divide its blocks; this one masks the ragged tail itself).  The
    dtype picks the instance: bfloat16 runs on the tensor cores (wgmma
    fed by TMA, P split into two bf16 halves), float32 on the CUDA
    cores; neither stands in for the other.

For a CUDA tensor the wrapper launches the kernel (or raises); for a CPU
tensor it runs the plain version, `kernels.ref.mha_reference`.  Each
launch adds one to ``LAUNCHES["flash_attention_cuda"]``.  The kernel has
no backward: on the card, a call with grad mode on and an input that
requires grad raises rather than return an output with no graph.

The source is held to a tolerance against its twin, not bit for bit, so
it builds with the compiler's default contraction (no ``-fmad=false``,
which the RMI sources need).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from repro_torch.kernels import nvcc, ref

SOURCE = nvcc.CSRC / "flash_attention.cu"
FLAGS = tuple(f for f in nvcc.NVCC_FLAGS if f != "-fmad=false")
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches of the wrapper; a plain integer, bumped only where the
# kernel is launched
LAUNCHES: Dict[str, int] = {"flash_attention_cuda": 0}


def reset_launch_counts() -> None:
    LAUNCHES["flash_attention_cuda"] = 0


def library_path():
    return nvcc.library_path(SOURCE, FLAGS)


def build():
    """Compile the attention library unless this source hash is built;
    returns its path."""
    return nvcc.build(SOURCE, FLAGS)


def declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [
        p, p, p, p,                 # q, k, v, out
        i, i, i, i, i,              # B, Hq, Hkv, S, D
        i, ctypes.c_float, i,       # dtype, scale, causal
        p,                          # stream
    ]
    lib.flash_attention_launch.restype = i


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True) -> torch.Tensor:
    """(B, Hq, S, D) attention output in q's dtype."""
    if q.device.type == "cpu":
        return ref.mha_reference(q, k, v, causal=causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_cuda has no backward kernel: an input requires grad "
            "under grad mode (run it under torch.no_grad(), or on the CPU)")
    dev = q.device
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k and v must be 4-D (B, H, S, D)")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if k.shape != (b, hkv, s, d) or v.shape != k.shape:
        raise ValueError(f"k and v must be (B, Hkv, S, D) = {(b, hkv, s, d)}, "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"GQA requires Hq % Hkv == 0 (Hq={hq}, Hkv={hkv})")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q has dtype {q.dtype}; the kernel takes float32 or bfloat16")
    if b > 65535 or hq > 65535 or s >= 2**31 - 64:
        raise ValueError("B and Hq must be <= 65535 and S < 2**31 - 64")
    ptrs = [nvcc.check_tensor(a, nm, q.dtype, dev, ndim=4)
            for a, nm in ((q, "q"), (k, "k"), (v, "v"))]
    if any(p % 16 for p in ptrs):
        raise ValueError("q, k and v must start on a 16-byte boundary")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = nvcc.load(SOURCE, declare, FLAGS).flash_attention_launch(
        *ptrs, out.data_ptr(), b, hq, hkv, s, d, _DTYPES[q.dtype],
        1.0 / math.sqrt(d), int(bool(causal)),
        torch.cuda.current_stream(dev).cuda_stream)
    nvcc.raise_on_error(err, "flash_attention")
    LAUNCHES["flash_attention_cuda"] += 1
    return out
