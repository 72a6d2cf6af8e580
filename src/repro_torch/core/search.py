"""Error-bounded search strategies (paper §3.4), batched in torch.

The reference's four fixed-trip searches, step for step: a whole batch
searches in lockstep with a trip count derived from the index's
worst-case error bound, ``ceil(log2(window))`` iterations of branchless
mid-selection.  All return the *lower bound* index: the smallest i in
[lo, hi] with sorted_keys[i] >= q, assuming that invariant holds at
entry (which the RMI error bounds guarantee for stored keys).

Float-to-int casts go through `to_index`, which clamps in float before
converting.  The reference converts with XLA's saturating cast and then
clips; clamping first gives the same integers for every non-NaN value
and never reaches the undefined out-of-range conversion of the host
CPU (or the saturating one of the card, which would differ from it).
"""

from __future__ import annotations

import math

import torch

# every rank fits in int32 with room for +1: the index asserts n < 2**30
INDEX_CLAMP = float(2**30)


def _steps_for_window(max_window: int) -> int:
    return max(1, int(math.ceil(math.log2(max(2, max_window + 1)))) + 1)


def clampf(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """min(max(x, lo), hi) with NaN -> lo, the same select the CUDA
    kernel writes as ``x > lo ? x : lo`` then ``x < hi ? x : hi``."""
    x = torch.where(x > lo, x, torch.full_like(x, lo))
    return torch.where(x < hi, x, torch.full_like(x, hi))


def to_index(x: torch.Tensor, lo: float = 0.0) -> torch.Tensor:
    """Truncating float32 -> int32 cast of ``x`` clamped to [lo, 2**30]."""
    return clampf(x, lo, INDEX_CLAMP).to(torch.int32)


def _halve(sorted_keys, q, lo, hi, steps):
    n = sorted_keys.shape[0]
    for _ in range(steps):
        mid = (lo + hi) >> 1
        km = sorted_keys[torch.clamp(mid, max=n - 1)]
        right = km < q
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(right, hi, mid)
    return lo


def window(pos, err_lo, err_hi, n: int):
    """[lo, hi] search window: clip(int(pos+err_lo), 0, n) and
    clip(int(pos+err_hi) + 1, 0, n)."""
    lo = torch.clamp(to_index(pos + err_lo), max=n)
    hi = torch.clamp(to_index(pos + err_hi, -1.0) + 1, 0, n)
    return lo, hi


def lower_bound_full(sorted_keys: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Plain full-range binary search (baseline; the delta search)."""
    n = sorted_keys.shape[0]
    lo = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    hi = torch.full_like(lo, n)
    return _halve(sorted_keys, q, lo, hi, _steps_for_window(n))


def model_binary_search(
    sorted_keys, q, pos, err_lo, err_hi, max_window: int
) -> torch.Tensor:
    """Model binary search: window = [pos+err_lo, pos+err_hi], first
    "middle" at the predicted position itself."""
    n = sorted_keys.shape[0]
    lo, hi = window(pos, err_lo, err_hi, n)
    p0 = torch.clamp(to_index(pos), max=n - 1)
    right = sorted_keys[p0] < q
    lo = torch.where(right, torch.maximum(lo, p0 + 1), lo)
    hi = torch.where(right, hi, torch.minimum(hi, p0))
    return _halve(sorted_keys, q, lo, hi, _steps_for_window(max_window))


def _sigma(sigma):
    return torch.clamp(to_index(sigma), min=1)


def biased_search(
    sorted_keys, q, pos, err_lo, err_hi, sigma, max_window: int
) -> torch.Tensor:
    """Biased search: the mid point leans σ away from the prediction
    for the first two iterations (σ, then 2σ), then plain halving."""
    n = sorted_keys.shape[0]
    lo, hi = window(pos, err_lo, err_hi, n)
    sig = _sigma(sigma)
    mid = torch.clamp(to_index(pos), max=n - 1)
    for mult in (1, 2):
        right = sorted_keys[torch.clamp(mid, 0, n - 1)] < q
        lo = torch.where(right, torch.maximum(lo, mid + 1), lo)
        hi = torch.where(right, hi, torch.minimum(hi, mid))
        step = mult * sig
        half = (lo + hi) >> 1
        mid = torch.where(
            right,
            torch.minimum(lo + step, half),
            torch.maximum(hi - step, half),
        )
        mid = torch.minimum(torch.maximum(mid, lo), torch.maximum(hi - 1, lo))
    return _halve(sorted_keys, q, lo, hi, _steps_for_window(max_window))


def biased_quaternary_search(
    sorted_keys, q, pos, err_lo, err_hi, sigma, max_window: int
) -> torch.Tensor:
    """Biased quaternary search: initial probes at pos-σ, pos, pos+σ,
    then binary search over the reduced window."""
    n = sorted_keys.shape[0]
    lo, hi = window(pos, err_lo, err_hi, n)
    sig = _sigma(sigma)
    p = torch.clamp(to_index(pos), max=n - 1)
    for pr in (torch.clamp(p - sig, 0, n - 1), p, torch.clamp(p + sig, 0, n - 1)):
        right = sorted_keys[pr] < q
        lo = torch.where(right, torch.maximum(lo, pr + 1), lo)
        hi = torch.where(right, hi, torch.minimum(hi, pr))
    return _halve(sorted_keys, q, lo, hi, _steps_for_window(max_window))


STRATEGIES = {
    "binary": model_binary_search,
    "biased": biased_search,
    "quaternary": biased_quaternary_search,
}
