"""Standard Bloom filter (paper §5 baseline), bit-packed.

m bits live in a uint32 word array; the k probe positions come from
double hashing h_i(x) = h1(x) + i*h2(x) (Kirsch-Mitzenmacher).  The
host code (sizing, `_mix64`, `BloomFilter`, the string fold,
`build_bloom`) is the reference's NumPy, copied, so both packages build
the same words from the same keys.

`compile_bloom_probe` is the batched probe over pre-folded uint32 keys:
the `bloom_probe_cuda` kernel for a tensor on the card, its plain twin
for a tensor on the CPU.  It hashes with the 32-bit `_mix32`, not with
`_mix64` of the 64-bit key as `build_bloom` and `contains` do, so a
filter that `build_bloom` made is not a membership test through it —
the reference's kernel does the same (ROADMAP queue C entry 11).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict

import numpy as np
import torch


def optimal_bits_per_key(fpr: float) -> float:
    """m/n = -log2(fpr)/ln(2) ≈ 1.44 log2(1/fpr) (paper: ~14 bits at 0.1%)."""
    return -math.log(fpr) / (math.log(2) ** 2)


def optimal_num_hashes(bits_per_key: float) -> int:
    return max(1, round(bits_per_key * math.log(2)))


def _mix64(x: np.ndarray, seed: int) -> np.ndarray:
    h = np.asarray(x, np.uint64) ^ np.uint64(seed * 0x9E3779B97F4A7C15 & 0xFFFFFFFFFFFFFFFF)
    h ^= h >> np.uint64(33)
    h *= np.uint64(0xFF51AFD7ED558CCD)
    h ^= h >> np.uint64(33)
    h *= np.uint64(0xC4CEB9FE1A85EC53)
    h ^= h >> np.uint64(33)
    return h


@dataclasses.dataclass
class BloomFilter:
    num_bits: int
    num_hashes: int
    words: np.ndarray  # (num_bits/32,) uint32

    @property
    def size_bytes(self) -> int:
        return int(self.words.size) * 4

    def contains(self, keys: np.ndarray) -> np.ndarray:
        """Host-side vectorized membership probe."""
        k64 = _key_u64(keys)
        h1 = _mix64(k64, 1)
        h2 = _mix64(k64, 2) | np.uint64(1)
        out = np.ones(k64.shape[0], bool)
        nb = np.uint64(self.num_bits)
        for i in range(self.num_hashes):
            bit = (h1 + np.uint64(i) * h2) % nb
            word = (bit >> np.uint64(5)).astype(np.int64)
            mask = (np.uint32(1) << (bit & np.uint64(31)).astype(np.uint32))
            out &= (self.words[word] & mask) != 0
        return out

    def add(self, keys: np.ndarray) -> None:
        """Insert keys after construction, with the same double-hash
        probe positions as `contains`, so an added key is immediately a
        definite maybe."""
        k64 = _key_u64(keys)
        if k64.size == 0:
            return
        h1 = _mix64(k64, 1)
        h2 = _mix64(k64, 2) | np.uint64(1)
        nb = np.uint64(self.num_bits)
        for i in range(self.num_hashes):
            bit = (h1 + np.uint64(i) * h2) % nb
            word = (bit >> np.uint64(5)).astype(np.int64)
            mask = (np.uint32(1) << (bit & np.uint64(31)).astype(np.uint32))
            np.bitwise_or.at(self.words, word, mask)


def string_hash_u64(strings) -> np.ndarray:
    """FNV-1a over utf-8 bytes: the string -> u64 fold of `BloomFilter`
    string keys."""
    out = np.empty(len(strings), np.uint64)
    for i, s in enumerate(strings):
        h = np.uint64(14695981039346656037)
        for b in str(s).encode("utf-8", errors="replace"):
            h = np.uint64((int(h) ^ b) * 1099511628211 & 0xFFFFFFFFFFFFFFFF)
        out[i] = h
    return out


def _key_u64(keys: np.ndarray) -> np.ndarray:
    keys = np.asarray(keys)
    if keys.dtype.kind in "US" or keys.dtype == object:
        return string_hash_u64(keys.tolist())
    if keys.dtype.kind == "f":
        return keys.astype(np.float64).view(np.uint64)
    if keys.dtype == np.uint64:
        return keys
    return keys.astype(np.int64).view(np.uint64)


def build_bloom(
    keys: np.ndarray, *, fpr: float | None = None, num_bits: int | None = None,
    num_hashes: int | None = None,
) -> BloomFilter:
    k64 = _key_u64(keys)
    n = k64.shape[0]
    if num_bits is None:
        assert fpr is not None
        num_bits = int(math.ceil(optimal_bits_per_key(fpr) * n))
    num_bits = max(64, (num_bits + 31) // 32 * 32)
    if num_hashes is None:
        num_hashes = optimal_num_hashes(num_bits / max(1, n))
    words = np.zeros(num_bits // 32, np.uint32)
    h1 = _mix64(k64, 1)
    h2 = _mix64(k64, 2) | np.uint64(1)
    nb = np.uint64(num_bits)
    for i in range(num_hashes):
        bit = (h1 + np.uint64(i) * h2) % nb
        word = (bit >> np.uint64(5)).astype(np.int64)
        mask = (np.uint32(1) << (bit & np.uint64(31)).astype(np.uint32))
        np.bitwise_or.at(words, word, mask)
    return BloomFilter(num_bits=num_bits, num_hashes=num_hashes, words=words)


def words_tensor(bf: BloomFilter, device) -> torch.Tensor:
    """The filter's words on ``device`` as an int32 tensor holding the
    uint32 bit patterns (the view the probe takes)."""
    return torch.from_numpy(np.ascontiguousarray(bf.words).view(np.int32)).to(device)


def compile_bloom_probe(bf: BloomFilter) -> Callable[[torch.Tensor], torch.Tensor]:
    """Batched probe over pre-folded uint32 keys: ``probe(q)`` with q a
    (B,) int32 (uint32 bit patterns) or uint32 tensor returns (B,) bool,
    on q's device.  The words go to each device once, at its first
    query."""
    from repro_torch.kernels.bloom_probe import bloom_probe_cuda

    held: Dict[torch.device, torch.Tensor] = {}

    def probe(keys_u32: torch.Tensor) -> torch.Tensor:
        words = held.get(keys_u32.device)
        if words is None:
            words = held[keys_u32.device] = words_tensor(bf, keys_u32.device)
        return bloom_probe_cuda(keys_u32, words, num_bits=bf.num_bits, k=bf.num_hashes)

    return probe
