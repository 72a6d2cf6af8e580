"""Plain PyTorch versions of the port's kernels (the correctness
contract).

Each function repeats its CUDA kernel's arithmetic step by step —
separately rounded multiply and add, the same clamps before every cast
and every gather, the same fixed trip counts — so on any device it
returns exactly what the kernel returns, for every query.  The CPU
tests run these; `chip_smoke.py` holds each kernel against its plain
version on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import search as search_lib
from repro_torch.core.rmi import leaf_and_pos


def _base_lower_bound(
    q, s0, leaf_w, leaf_b, err_lo, err_hi, sorted_keys, *,
    hidden: tuple, n: int, num_leaves: int, max_window: int,
) -> torch.Tensor:
    """stage-0 -> leaf FMA -> window -> first probe -> fixed-trip
    halving (the reference's `_base_lower_bound`)."""
    leaf, pos = leaf_and_pos(
        s0, hidden, leaf_w, leaf_b, q, n=n, num_leaves=num_leaves
    )
    return search_lib.model_binary_search(
        sorted_keys, q, pos, err_lo[leaf], err_hi[leaf], max_window
    )


def rmi_lookup_reference(
    q: torch.Tensor,
    s0: torch.Tensor,
    leaf_w: torch.Tensor,
    leaf_b: torch.Tensor,
    err_lo: torch.Tensor,
    err_hi: torch.Tensor,
    sorted_keys: torch.Tensor,
    *,
    hidden: tuple,
    n: int,
    num_leaves: int,
    max_window: int,
) -> torch.Tensor:
    """Plain twin of `rmi_lookup_cuda`: base lower bound, int32 (B,)."""
    return _base_lower_bound(
        q, s0, leaf_w, leaf_b, err_lo, err_hi, sorted_keys,
        hidden=hidden, n=n, num_leaves=num_leaves, max_window=max_window,
    )


def rmi_merged_lookup_reference(
    q: torch.Tensor,
    s0: torch.Tensor,
    leaf_w: torch.Tensor,
    leaf_b: torch.Tensor,
    err_lo: torch.Tensor,
    err_hi: torch.Tensor,
    sorted_keys: torch.Tensor,
    delta_keys: torch.Tensor,
    delta_prefix: torch.Tensor,
    *,
    hidden: tuple,
    n: int,
    num_leaves: int,
    max_window: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of `rmi_merged_lookup_cuda`: ``(base_lb, merged)``.

    The delta lower bound may step one past the padded length when
    nothing pads it (a power-of-two count of staged entries and a
    query above all of them); the prefix gather clamps its index, as
    the reference's XLA gather does."""
    base = _base_lower_bound(
        q, s0, leaf_w, leaf_b, err_lo, err_hi, sorted_keys,
        hidden=hidden, n=n, num_leaves=num_leaves, max_window=max_window,
    )
    d = delta_keys.shape[0]
    dlb = search_lib.lower_bound_full(delta_keys, q)
    return base, base + delta_prefix[torch.clamp(dlb, max=d)]
