"""The §5 Bloom probe kernel (``csrc/probe.cu``): the PyTorch wrapper.

``bloom_probe_cuda`` — two `mix32` hashes of each pre-folded uint32 key
    and up to k word-gather bit tests (each query stops at its first
    clear bit), four queries a thread, one launch -> (B,) bool.
    Replaces the reference's ``bloom_probe_pallas``.

uint32 values travel as int32 tensors holding their bit patterns (torch's
uint32 supports few operations); a uint32 tensor is viewed as int32.  The
library is built and declared by `kernels.hash_probe`, which shares the
source.  For a CUDA tensor the wrapper launches the kernel (or raises);
for a CPU tensor it runs the plain version in `kernels.ref`.  Each launch
adds one to ``LAUNCHES``.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import nvcc, ref
from repro_torch.kernels.hash_probe import SOURCE, declare

LAUNCHES: Dict[str, int] = {"bloom_probe_cuda": 0}

# queries a thread, compiled into csrc/probe.cu as BLOOM_Q: keys by one
# 16-byte load, answers by one 4-byte store
QUERIES_PER_THREAD = 4


def reset_launch_counts() -> None:
    LAUNCHES["bloom_probe_cuda"] = 0


def as_u32_bits(t: torch.Tensor) -> torch.Tensor:
    """An int32 or uint32 tensor as int32 bit patterns (a view)."""
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def bloom_probe_cuda(
    queries: torch.Tensor,             # (B,) int32 / uint32 pre-folded keys
    words: torch.Tensor,               # (num_bits/32,) int32 / uint32 words
    *,
    num_bits: int,
    k: int,
) -> torch.Tensor:
    """Bloom membership of each pre-folded key, bool (B,)."""
    queries, words = as_u32_bits(queries), as_u32_bits(words)
    if not 1 <= num_bits < 2**32:
        raise ValueError(f"num_bits={num_bits}: the probe takes 1 <= num_bits < 2**32")
    if words.ndim != 1 or words.shape[0] * 32 < num_bits:
        raise ValueError(f"words must hold ceil(num_bits / 32) = "
                         f"{-(-num_bits // 32)} entries, got {tuple(words.shape)}")
    if k < 0:
        raise ValueError("k must be >= 0")
    if queries.device.type == "cpu":
        return ref.bloom_probe_reference(queries, words, num_bits=num_bits, k=k)
    dev = queries.device
    qp = nvcc.check_tensor(queries, "queries", torch.int32, dev)
    wp = nvcc.check_tensor(words, "words", torch.int32, dev)
    out = torch.empty(queries.shape, dtype=torch.bool, device=dev)
    if queries.shape[0] == 0:
        return out
    err = nvcc.load(SOURCE, declare).bloom_probe_launch(
        qp, queries.shape[0], wp, num_bits, k, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    nvcc.raise_on_error(err, "bloom_probe")
    LAUNCHES["bloom_probe_cuda"] += 1
    return out
