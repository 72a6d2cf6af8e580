"""Synthetic stand-ins for the paper's datasets (§3.6, §5.2): the Maps,
Weblogs, Lognormal, Webdocs and URL generators, copied from the
reference so that both packages produce identical keys (and strings)
from the same seed.

  Maps      — longitudes of world features: "relatively linear" — a
              mixture of dense population clusters over a near-uniform
              base, mildly non-linear CDF.
  Weblogs   — timestamps with "very complex time patterns": daily /
              weekly periodicity, lunch-break dips, semester breaks,
              bursts — the paper's worst case.
  Lognormal — 190M values sampled from lognormal(0, 2), scaled to ints
              up to 1B: heavy tail (paper's exact recipe, scaled down).
  Webdocs   — non-continuous document-ids: dense runs with gaps.
  URLs      — phishing-vs-benign URL strings for the Bloom experiments.
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


def gen_webdocs(n: int = 200_000, seed: int = 0) -> list[str]:
    """Non-continuous document-id strings of a web index: host-path-ish
    hierarchical tokens with skewed first-character distribution (the
    paper notes 3x more words start with 's' than 'e')."""
    rng = np.random.default_rng(seed)
    # skewed letter distribution approximating English word starts
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    start_p = np.array(
        [.067,.044,.072,.045,.028,.035,.027,.042,.030,.012,.009,.041,.052,
         .021,.025,.065,.007,.047,.099,.078,.025,.011,.035,.004,.006,.003]
    )
    start_p /= start_p.sum()
    mid_p = np.ones(26) / 26.0
    docs = set()
    while len(docs) < n:
        batch = n - len(docs)
        first = rng.choice(letters, batch, p=start_p)
        ln = rng.integers(4, 14, batch)
        for i in range(batch):
            rest = "".join(rng.choice(letters, ln[i], p=mid_p))
            docs.add(f"{first[i]}{rest}/{rng.integers(0, 10**6):06d}")
    return sorted(docs)


_TLDS = ["com", "net", "org", "info", "io", "ru", "cn", "biz", "top", "xyz"]
_BRANDS = ["paypal", "apple", "google", "amazon", "bank", "chase", "secure",
           "login", "account", "microsoft", "netflix", "support"]
_WORDS = ["news", "shop", "blog", "mail", "cloud", "data", "home", "web",
          "store", "portal", "media", "labs", "dev", "docs", "app"]


def gen_urls(
    n_keys: int = 20_000, n_nonkeys: int = 60_000, seed: int = 0
) -> tuple[list[str], list[str]]:
    """Phishing-like keys vs benign non-keys (paper §5.2's setting).

    Phishing URLs: brand names embedded in hyphenated/typo'd hosts on
    cheap TLDs with deep paths.  Benign: clean short hosts on major TLDs.
    The structural signal is learnable, as in the real dataset.
    """
    rng = np.random.default_rng(seed)

    def rand_str(a: int, b: int) -> str:
        ln = rng.integers(a, b)
        return "".join(chr(c) for c in rng.integers(97, 123, ln))

    keys = set()
    while len(keys) < n_keys:
        brand = _BRANDS[rng.integers(0, len(_BRANDS))]
        style = rng.integers(0, 4)
        if style == 0:
            host = f"{brand}-{rand_str(3, 8)}.{_TLDS[rng.integers(4, len(_TLDS))]}"
        elif style == 1:
            host = f"{rand_str(2, 5)}{brand}{rng.integers(0, 99)}.{_TLDS[rng.integers(4, len(_TLDS))]}"
        elif style == 2:
            host = f"{brand}.{rand_str(4, 9)}.{_TLDS[rng.integers(0, len(_TLDS))]}"
        else:
            typo = brand[: rng.integers(2, len(brand))] + rand_str(1, 3)
            host = f"{typo}-verify.{_TLDS[rng.integers(4, len(_TLDS))]}"
        path = f"/{rand_str(4, 10)}/{rand_str(3, 8)}"
        keys.add(f"http://{host}{path}")
    keys = sorted(keys)

    nonkeys = set()
    while len(nonkeys) < n_nonkeys:
        style = rng.integers(0, 3)
        if style == 0:
            host = f"{_WORDS[rng.integers(0, len(_WORDS))]}{rand_str(0, 4)}.{_TLDS[rng.integers(0, 3)]}"
        elif style == 1:
            host = f"www.{rand_str(4, 10)}.{_TLDS[rng.integers(0, 3)]}"
        else:  # whitelisted lookalikes (paper: "could be mistaken")
            host = f"{_BRANDS[rng.integers(0, len(_BRANDS))]}.com"
        path = "" if rng.random() < 0.5 else f"/{rand_str(3, 8)}"
        u = f"https://{host}{path}"
        if u not in keys:
            nonkeys.add(u)
    return keys, sorted(nonkeys)
