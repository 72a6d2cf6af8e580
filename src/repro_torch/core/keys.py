"""Key handling: normalization and the sorted key-set containers, scalar
and fixed-length vector (tokenized strings), the reference's
``core/keys.py`` in NumPy verbatim.

Raw keys may be int64/uint64 (timestamps, ids) or float64 (longitudes).
Model arithmetic runs in float32; correctness does not depend on
precision because the RMI error bounds are computed *post hoc* with the
same arithmetic used at lookup time (paper §2: the guarantee only covers
stored data).  Normalizing keys to [0, 1] in float64 first keeps the
float32 mantissa fully available for the interesting bits of the key.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np

ArrayLike = Union[np.ndarray, list, tuple]


@dataclasses.dataclass(frozen=True)
class KeySet:
    """A sorted, de-duplicated key set with float32-normalized view.

    Attributes:
      raw:    (N,) float64 — sorted raw keys (unique).
      norm:   (N,) float32 — (raw - lo) / (hi - lo), in [0, 1].
      lo, hi: float64 normalization constants.
    """

    raw: np.ndarray
    norm: np.ndarray
    lo: float
    hi: float

    @property
    def n(self) -> int:
        return int(self.raw.shape[0])

    @property
    def positions(self) -> np.ndarray:
        return np.arange(self.n, dtype=np.float32)

    def normalize(self, queries: ArrayLike) -> np.ndarray:
        """Normalize raw query keys with the stored constants."""
        q = np.asarray(queries, dtype=np.float64)
        return ((q - self.lo) / (self.hi - self.lo)).astype(np.float32)


def make_keyset(raw_keys: ArrayLike) -> KeySet:
    raw = np.unique(np.asarray(raw_keys, dtype=np.float64))
    if raw.size < 2:
        raise ValueError("need at least 2 unique keys")
    lo = float(raw[0])
    hi = float(raw[-1])
    if hi == lo:
        raise ValueError("degenerate key range")
    norm = ((raw - lo) / (hi - lo)).astype(np.float32)
    return KeySet(raw=raw, norm=norm, lo=lo, hi=hi)


def make_vector_keyset(vectors: np.ndarray) -> "VectorKeySet":
    """Key set for string keys tokenized to fixed-length vectors.

    Vectors must already be lexicographically sorted (see strings.py).
    Each component is normalized to [0, 1] by the global max (e.g. 255
    for ASCII).
    """
    vecs = np.asarray(vectors, dtype=np.float64)
    if vecs.ndim != 2:
        raise ValueError("expected (N, D) vectors")
    scale = max(float(vecs.max()), 1.0)
    norm = (vecs / scale).astype(np.float32)
    return VectorKeySet(raw=vecs, norm=norm, scale=scale)


@dataclasses.dataclass(frozen=True)
class VectorKeySet:
    """Sorted fixed-length-vector keys (tokenized strings)."""

    raw: np.ndarray   # (N, D) float64
    norm: np.ndarray  # (N, D) float32 in [0, 1]
    scale: float

    @property
    def n(self) -> int:
        return int(self.raw.shape[0])

    @property
    def dim(self) -> int:
        return int(self.raw.shape[1])

    @property
    def positions(self) -> np.ndarray:
        return np.arange(self.n, dtype=np.float32)

    def normalize(self, queries: np.ndarray) -> np.ndarray:
        return (np.asarray(queries, dtype=np.float64) / self.scale).astype(
            np.float32
        )
