"""The flash-attention kernels (``csrc/flash_attention.cu`` and its
gradient, ``csrc/flash_attention_bwd.cu``): build, load, the PyTorch
wrappers and the autograd Function that joins them.

``flash_attention_cuda`` — causal or full GQA attention with an online
    softmax over (B, Hq, Sq, D) queries and (B, Hkv, Sk, D) keys and
    values, float32 or bfloat16, D in {32, 64, 128}, any Sq and Sk
    (causal needs Sq == Sk; the full mask with Sq != Sk is
    cross-attention).  Replaces the reference's ``flash_attention`` (a
    Pallas kernel, which needs S to divide its blocks; this one masks
    the ragged tail itself).  The dtype picks the instance: bfloat16
    runs on the tensor cores (wgmma fed by TMA, P split into two bf16
    halves), float32 on the CUDA cores; neither stands in for the other.
    ``return_lse=True`` also returns each row's log-sum-exp (float32,
    (B, Hq, Sq)).
``flash_attention_bwd_cuda`` — its gradient (dq, dk, dv) from q, k, v,
    the output, the log-sum-exp and the output's gradient, for Sq == Sk
    only (a gradient at Sq != Sk raises before anything launches: ROADMAP
    queue C 13).  bfloat16 runs
    on the tensor cores (wgmma fed by TMA, P and dS split into two bf16
    halves; dK and dV per query head in float32 scratch, then summed over
    each GQA group), float32 on the CUDA cores.  The reference has no
    backward kernel: it differentiates its plain loop.

D = 16 (the reduced configs' heads) is zero-padded to 32 around either
kernel: the padded columns add exactly 0 to every dot product, and the
scale stays 1/sqrt(16).

For CUDA tensors the wrappers launch their kernel (or raise); for CPU
tensors they run the plain versions, `kernels.ref.mha_reference_lse` and
`kernels.ref.mha_backward_reference`.  With grad mode on and an input
that requires grad, `flash_attention_cuda` goes through
`FlashAttention`, whose forward saves q, k, v, the output and the
log-sum-exp and whose backward is ``flash_attention_bwd_cuda``: on the
card both are kernels, and nothing reroutes a gradient to a plain twin.
Each launch adds one to ``LAUNCHES[name]``.

The sources are held to a tolerance against their twins, not bit for
bit, so they build with the compiler's default contraction (no
``-fmad=false``, which the RMI sources need).  Each is its own library,
so the forward's build hash does not depend on the backward's source.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import nvcc, ref

SOURCE = nvcc.CSRC / "flash_attention.cu"
BWD_SOURCE = nvcc.CSRC / "flash_attention_bwd.cu"
FLAGS = tuple(f for f in nvcc.NVCC_FLAGS if f != "-fmad=false")
HEAD_DIMS = (32, 64, 128)
_PADDED = {16: 32}             # head dims run zero-padded to a kernel's
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches of the wrappers; plain integers, bumped only where a kernel
# is launched
LAUNCHES: Dict[str, int] = {"flash_attention_cuda": 0, "flash_attention_bwd_cuda": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def library_path():
    return nvcc.library_path(SOURCE, FLAGS)


def build():
    """Compile the attention library unless this source hash is built;
    returns its path."""
    return nvcc.build(SOURCE, FLAGS)


def build_backward():
    """Compile the attention-gradient library unless this source hash is
    built; returns its path."""
    return nvcc.build(BWD_SOURCE, FLAGS)


def declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [
        p, p, p, p, p,              # q, k, v, out, lse (null: not stored)
        i, i, i, i, i, i,           # B, Hq, Hkv, Sq, Sk, D
        i, ctypes.c_float, i,       # dtype, scale, causal
        p,                          # stream
    ]
    lib.flash_attention_launch.restype = i


def declare_backward(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_bwd_launch.argtypes = [
        p, p, p, p, p, p,           # q, k, v, out, d_out, lse
        p, p, p, p,                 # scratch (float32, `_bwd_scratch_floats`), dq, dk, dv
        i, i, i, i, i,              # B, Hq, Hkv, S, D
        i, ctypes.c_float, i,       # dtype, scale, causal
        p,                          # stream
    ]
    lib.flash_attention_bwd_launch.restype = i


def _check_qkv(q, k, v, causal: bool) -> Tuple[int, int, int, int, int, int]:
    """(B, Hq, Hkv, Sq, Sk, D) of a call the forward kernel takes; raises
    otherwise (causal needs Sq == Sk)."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k and v must be 4-D (B, H, S, D)")
    b, hq, s, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if k.shape != (b, hkv, sk, d) or v.shape != k.shape:
        raise ValueError(f"k and v must be (B, Hkv, Sk, D) = {(b, hkv, sk, d)}, "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    if causal and sk != s:
        raise ValueError(f"causal attention needs Sq == Sk (got Sq={s}, Sk={sk})")
    if d not in HEAD_DIMS and d not in _PADDED:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS + tuple(_PADDED)}")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"GQA requires Hq % Hkv == 0 (Hq={hq}, Hkv={hkv})")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q has dtype {q.dtype}; the kernel takes float32 or bfloat16")
    if b > 65535 or hq > 65535 or max(s, sk) >= 2**31 - 64:
        raise ValueError("B and Hq must be <= 65535 and Sq, Sk < 2**31 - 64")
    return b, hq, hkv, s, sk, d


def _check_square(q, k) -> None:
    """The backward kernel takes one length: Sq != Sk raises (ROADMAP
    queue C 13)."""
    if q.ndim == 4 and k.ndim == 4 and q.shape[2] != k.shape[2]:
        raise ValueError("the attention backward kernel takes Sq == Sk only "
                         f"(got Sq={q.shape[2]}, Sk={k.shape[2]}): ROADMAP queue C 13")


def _pointers(tensors, names, dtype, dev, ndim=4):
    ptrs = [nvcc.check_tensor(t, n, dtype, dev, ndim=ndim) for t, n in zip(tensors, names)]
    if any(p % 16 for p in ptrs):
        raise ValueError(f"{', '.join(names)} must start on a 16-byte boundary")
    return ptrs


def _padded(tensors, d: int):
    """The tensors with D zero-padded to the kernel's head dim (as they
    are when D is one of the kernel's)."""
    if d not in _PADDED:
        return tuple(tensors)
    return tuple(F.pad(t, (0, _PADDED[d] - d)) for t in tensors)


def _forward(q, k, v, causal: bool, return_lse: bool):
    """One launch of the forward kernel (its plain version on the CPU);
    ``(out, lse)`` with ``return_lse``, else ``out``."""
    if q.device.type == "cpu":
        if return_lse:
            return ref.mha_reference_lse(q, k, v, causal=causal)
        return ref.mha_reference(q, k, v, causal=causal)
    dev = q.device
    b, hq, hkv, s, sk, d = _check_qkv(q, k, v, causal)
    _pointers((q, k, v), ("q", "k", "v"), q.dtype, dev)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=dev) if return_lse else None
    if q.numel() == 0:
        out = torch.empty_like(q)
        return (out, lse) if return_lse else out
    qp, kp, vp = _padded((q, k, v), d)
    out = torch.empty_like(qp)
    err = nvcc.load(SOURCE, declare, FLAGS).flash_attention_launch(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), out.data_ptr(),
        0 if lse is None else lse.data_ptr(), b, hq, hkv, s, sk, qp.shape[3],
        _DTYPES[q.dtype], 1.0 / math.sqrt(d), int(bool(causal)),
        torch.cuda.current_stream(dev).cuda_stream)
    nvcc.raise_on_error(err, "flash_attention")
    LAUNCHES["flash_attention_cuda"] += 1
    if qp is not q:
        out = out[..., :d].contiguous()
    return (out, lse) if return_lse else out


class FlashAttention(torch.autograd.Function):
    """Attention with its gradient: the forward kernel (saving q, k, v,
    the output and the log-sum-exp), then the backward kernel; on CPU
    tensors the plain forward and the plain backward.  On the card
    Sq != Sk raises before the forward launches: the backward kernel
    takes one length (ROADMAP queue C 13)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.device.type != "cpu":
            _check_square(q, k)
        out, lse = _forward(q, k, v, bool(causal), True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = bool(causal)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, lse, d_out.contiguous(),
                                              causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, return_lse: bool = False):
    """(B, Hq, S, D) attention output in q's dtype; with ``return_lse``
    also the rows' log-sum-exp, float32 (B, Hq, S).  Under grad mode, an
    input that requires grad sends the call through `FlashAttention`,
    so the output carries the backward kernel (the plain backward on the
    CPU)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if return_lse:
            raise ValueError("return_lse is not differentiable: call it under torch.no_grad()")
        return FlashAttention.apply(q, k, v, causal)
    return _forward(q, k, v, bool(causal), return_lse)


def _bwd_scratch_floats(dtype, b: int, hq: int, s: int, d: int) -> int:
    """float32 scratch of the backward launch: each row's Di (float32);
    for bfloat16 each row's (lse log2 e, Di) pair, every head's rows
    padded to a multiple of 64, then dK and dV per query head before each
    GQA group is summed."""
    if dtype == torch.float32:
        return b * hq * s
    return 2 * b * hq * (-(-s // 64) * 64) + 2 * b * hq * s * d


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, lse: torch.Tensor, d_out: torch.Tensor, *,
                             causal: bool = True):
    """(dq, dk, dv) in q's dtype: the gradient of the attention whose
    output is ``out`` and row log-sum-exp ``lse`` (float32, (B, Hq, S)),
    given the output's gradient ``d_out``."""
    if q.device.type == "cpu":
        return ref.mha_backward_reference(q, k, v, out, lse, d_out, causal=causal)
    dev = q.device
    _check_square(q, k)
    b, hq, hkv, s, _, d = _check_qkv(q, k, v, causal)
    if out.shape != q.shape or d_out.shape != q.shape:
        raise ValueError(f"out and d_out must be {tuple(q.shape)}, got "
                         f"{tuple(out.shape)} and {tuple(d_out.shape)}")
    if lse.shape != (b, hq, s):
        raise ValueError(f"lse must be {(b, hq, s)}, got {tuple(lse.shape)}")
    _pointers((q, k, v, out, d_out), ("q", "k", "v", "out", "d_out"), q.dtype, dev)
    _pointers((lse,), ("lse",), torch.float32, dev, ndim=3)
    if q.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    qp, kp, vp, op, dop = _padded((q, k, v, out, d_out), d)
    dq, dk, dv = torch.empty_like(qp), torch.empty_like(kp), torch.empty_like(vp)
    scratch = torch.empty(_bwd_scratch_floats(q.dtype, b, hq, s, qp.shape[3]),
                          dtype=torch.float32, device=dev)
    err = nvcc.load(BWD_SOURCE, declare_backward, FLAGS).flash_attention_bwd_launch(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), op.data_ptr(), dop.data_ptr(),
        lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, hq, hkv, s, qp.shape[3], _DTYPES[q.dtype], 1.0 / math.sqrt(d),
        int(bool(causal)), torch.cuda.current_stream(dev).cuda_stream)
    nvcc.raise_on_error(err, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd_cuda"] += 1
    if qp is not q:
        dq, dk, dv = (t[..., :d].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv
