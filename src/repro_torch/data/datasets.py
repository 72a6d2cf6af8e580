"""Synthetic stand-ins for the paper's datasets (§3.6): the Maps and
Lognormal generators, copied from the reference so that both packages
produce identical keys from the same seed.

  Maps      — longitudes of world features: "relatively linear" — a
              mixture of dense population clusters over a near-uniform
              base, mildly non-linear CDF.
  Lognormal — 190M values sampled from lognormal(0, 2), scaled to ints
              up to 1B: heavy tail (paper's exact recipe, scaled down).
"""

from __future__ import annotations

import numpy as np


def gen_maps(n: int = 1_000_000, seed: int = 0) -> np.ndarray:
    """Longitude-like keys in [-180, 180] — population clusters over a
    uniform base.  The paper characterizes OSM longitudes as "relatively
    linear with few irregularities", so the mixture is mild: wide
    clusters, 40% weight, continuous values (real longitudes are not
    lattice-quantized at micro-degrees)."""
    rng = np.random.default_rng(seed)
    n_clusters = 25
    centers = rng.uniform(-180, 180, n_clusters)
    widths = rng.uniform(3.0, 20.0, n_clusters)
    weights = rng.dirichlet(np.ones(n_clusters))
    n_cluster_pts = int(n * 0.4)
    which = rng.choice(n_clusters, n_cluster_pts, p=weights)
    pts = rng.normal(centers[which], widths[which])
    base = rng.uniform(-180, 180, n - n_cluster_pts)
    keys = np.clip(np.concatenate([pts, base]), -180, 180)
    return np.unique(keys)


def gen_lognormal(n: int = 1_000_000, seed: int = 0) -> np.ndarray:
    """Paper's recipe: lognormal(μ=0, σ=2) scaled to integers up to 1B."""
    rng = np.random.default_rng(seed)
    v = rng.lognormal(0.0, 2.0, int(n * 1.1))
    v = np.round(v / v.max() * 1e9)
    v = np.unique(v)
    if v.size > n:
        v = v[np.sort(rng.choice(v.size, n, replace=False))]
    return v.astype(np.float64)
