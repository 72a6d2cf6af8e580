"""Learned shard router: a stage-0-style monotone model over shard
boundary keys.

The sharded index service partitions the raw key space into K
half-open ranges

    shard j owns [b_{j-1}, b_j)      (b_{-1} = -inf, b_{K-1} = +inf)

with K-1 strictly increasing boundary keys.  Routing a key is exactly
the RMI recipe (paper §3) shrunk to a K-entry "array": a tiny monotone
linear model predicts the shard id, the prediction is verified against
the two enclosing boundaries, and the (rare) misses fall back to an
exact ``searchsorted`` — so routing is *always* exact while the common
case costs one FMA and two comparisons per key.

The router is what makes the K-shard rank reassembly invariant hold:
because the ranges tile the whole real line with no gaps or overlaps,
every key lands in exactly one shard, all keys in lower shards compare
strictly below it, and

    global_rank(q) = sum(live_count(s) for s < route(q)) + local_rank(q)

Boundary *re-fit* (``from_keys`` on the current live key set, at
compaction/rebalance time) changes which shard serves a key but never
its global rank — the invariant only depends on the ranges being
ordered and disjoint, which any sorted boundary vector satisfies.
The port's copy of the reference's NumPy router: routes, boundaries,
weights and ``router.npz`` files are the reference's, byte for byte
(``tests/test_torch_sharded.py`` holds them against each other).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np


@dataclasses.dataclass
class LearnedRouter:
    """K-way range router: monotone linear model + exact verification.

    ``boundaries`` are raw-frame keys, strictly increasing, length K-1
    (empty for K=1).  ``weight``/``bias`` form the stage-0 model
    ``guess = clip(floor(weight * key + bias), 0, K-1)``; ``weight`` is
    always >= 0 so the guess is monotone in the key.
    """

    # Concurrency contract: owned by one ShardedIndexService; every call
    # (route/fit/stats) happens under that service's ``_lock``.
    # lixlint: thread-shared
    # lixlint: unsynchronized(all access serialized under the owning service lock)

    boundaries: np.ndarray
    weight: float = 0.0
    bias: float = 0.0

    def __post_init__(self):
        b = np.asarray(self.boundaries, np.float64)
        if b.size and not (np.diff(b) > 0).all():
            raise ValueError("boundaries must be strictly increasing")
        self.boundaries = b
        self.stats = {"routed": 0, "model_hits": 0}
        # set by the owning service so route latency lands in ITS
        # registry (the router itself stays registry-agnostic)
        self.metrics = None

    @property
    def num_shards(self) -> int:
        return int(self.boundaries.size) + 1

    # ---- construction ----------------------------------------------------
    @classmethod
    def fit(
        cls, boundaries: np.ndarray, sample_keys: Optional[np.ndarray] = None
    ) -> "LearnedRouter":
        """Least-squares monotone fit of shard-id over ``sample_keys``
        (labelled by the exact boundary rule) or, lacking a sample,
        over the boundaries themselves (b_j is the first key of shard
        j+1).  A non-positive slope (pathological spacing) degrades to
        the constant model — verification plus the exact fallback keep
        routing correct either way."""
        b = np.asarray(boundaries, np.float64)
        if b.size == 0:
            return cls(b)
        if sample_keys is not None and np.asarray(sample_keys).size >= 2:
            x = np.asarray(sample_keys, np.float64)
            y = np.searchsorted(b, x, side="right").astype(np.float64)
        else:
            x = b
            y = np.arange(1, b.size + 1, dtype=np.float64)
        xc = x - x.mean()
        denom = float((xc * xc).sum())
        w = float((xc * (y - y.mean())).sum() / denom) if denom > 0 else 0.0
        w = max(w, 0.0)  # monotone: routing must preserve key order
        c = float(y.mean() - w * x.mean())
        return cls(b, weight=w, bias=c)

    @classmethod
    def from_keys(cls, keys: np.ndarray, num_shards: int) -> "LearnedRouter":
        """Quantile boundaries over a sorted unique key set: shard fill
        stays balanced because each range holds ~n/K of the fit keys."""
        arr = np.asarray(keys, np.float64)
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        if num_shards == 1:
            return cls(np.empty(0, np.float64))
        if arr.size < 2 * num_shards:
            raise ValueError(
                f"need >= {2 * num_shards} keys to cut {num_shards} shards"
            )
        pos = (np.arange(1, num_shards) * arr.size) // num_shards
        bounds = np.unique(arr[pos])
        sample = arr[:: max(1, arr.size // (64 * num_shards))]
        return cls.fit(bounds, sample_keys=sample)

    # ---- routing ---------------------------------------------------------
    def route(self, keys) -> np.ndarray:
        """Exact shard id per key: model guess, boundary verification,
        searchsorted fallback for the misses."""
        t0 = time.perf_counter()
        q = np.atleast_1d(np.asarray(keys, np.float64))
        k = self.num_shards
        self.stats["routed"] += q.size
        if k == 1:
            self.stats["model_hits"] += q.size
            self._record(q.size, q.size, time.perf_counter() - t0)
            return np.zeros(q.shape, np.int32)
        b = self.boundaries
        guess = np.clip(
            np.floor(self.weight * q + self.bias), 0, k - 1
        ).astype(np.int64)
        lo_ok = (guess == 0) | (b[np.maximum(guess - 1, 0)] <= q)
        hi_ok = (guess == k - 1) | (q < b[np.minimum(guess, k - 2)])
        ok = lo_ok & hi_ok
        out = guess
        if not ok.all():
            miss = ~ok
            out = guess.copy()
            out[miss] = np.searchsorted(b, q[miss], side="right")
        hits = int(ok.sum())
        self.stats["model_hits"] += hits
        self._record(q.size, hits, time.perf_counter() - t0)
        return out.astype(np.int32)

    def _record(self, routed: int, hits: int, seconds: float) -> None:
        reg = self.metrics
        if reg is None:
            return
        reg.counter("router.routed").add(routed)
        reg.counter("router.model_hits").add(hits)
        reg.histogram("op.route.latency_s").observe(seconds)

    def split_points(self, sorted_keys: np.ndarray) -> np.ndarray:
        """Cut positions of a sorted array at the shard boundaries:
        (K+1,) indices with shard j's keys = arr[p[j]:p[j+1]]."""
        arr = np.asarray(sorted_keys, np.float64)
        cuts = np.searchsorted(arr, self.boundaries, side="left")
        return np.concatenate([[0], cuts, [arr.size]]).astype(np.int64)

    # ---- persistence -----------------------------------------------------
    def save(self, path: str) -> str:
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(
                f, boundaries=self.boundaries,
                weight=np.float64(self.weight), bias=np.float64(self.bias),
            )
        os.replace(tmp, path)
        return path

    @staticmethod
    def load(path: str) -> "LearnedRouter":
        with np.load(path) as z:
            return LearnedRouter(
                z["boundaries"], weight=float(z["weight"]),
                bias=float(z["bias"]),
            )

    @property
    def model_hit_rate(self) -> Optional[float]:
        n = self.stats["routed"]
        return self.stats["model_hits"] / n if n else None
