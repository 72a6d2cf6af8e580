"""Synthetic stand-ins for the paper's datasets (§3.6): the Maps,
Weblogs and Lognormal generators, copied from the reference so that both
packages produce identical keys from the same seed.

  Maps      — longitudes of world features: "relatively linear" — a
              mixture of dense population clusters over a near-uniform
              base, mildly non-linear CDF.
  Weblogs   — timestamps with "very complex time patterns": daily /
              weekly periodicity, lunch-break dips, semester breaks,
              bursts — the paper's worst case.
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


def gen_weblogs(n: int = 1_000_000, seed: int = 0) -> np.ndarray:
    """Unix-timestamp-like keys over ~2 years with strong periodicity."""
    rng = np.random.default_rng(seed)
    start = 1_400_000_000
    days = 730
    day = np.arange(days)
    # weekly pattern: weekdays busy; semester breaks (summer/winter) quiet
    weekday = (day % 7) < 5
    week_rate = np.where(weekday, 1.0, 0.35)
    doy = day % 365
    semester = np.where((doy > 160) & (doy < 240), 0.25, 1.0)  # summer
    semester *= np.where((doy > 350) | (doy < 15), 0.3, 1.0)   # winter
    events = rng.random(days) < 0.02
    rate = week_rate * semester * np.where(events, 5.0, 1.0)
    rate /= rate.sum()
    counts = rng.multinomial(n, rate)
    # diurnal pattern within a day: bimodal (morning/afternoon), lunch dip
    keys = []
    hours = np.arange(24)
    diurnal = np.exp(-0.5 * ((hours - 10.5) / 2.5) ** 2) + 0.9 * np.exp(
        -0.5 * ((hours - 15.0) / 2.0) ** 2
    )
    diurnal[12] *= 0.55  # lunch
    diurnal[0:6] = 0.15  # overnight crawler/base traffic
    diurnal /= diurnal.sum()
    for d in range(days):
        if counts[d] == 0:
            continue
        hr = rng.choice(24, counts[d], p=diurnal)
        sec = rng.integers(0, 3600, counts[d])
        keys.append(start + d * 86400 + hr * 3600 + sec)
    out = np.concatenate(keys).astype(np.float64)
    out += rng.random(out.shape)  # sub-second uniqueness
    return np.unique(out)


def gen_lognormal(n: int = 1_000_000, seed: int = 0) -> np.ndarray:
    """Paper's recipe: lognormal(μ=0, σ=2) scaled to integers up to 1B."""
    rng = np.random.default_rng(seed)
    v = rng.lognormal(0.0, 2.0, int(n * 1.1))
    v = np.round(v / v.max() * 1e9)
    v = np.unique(v)
    if v.size > n:
        v = v[np.sort(rng.choice(v.size, n, replace=False))]
    return v.astype(np.float64)
