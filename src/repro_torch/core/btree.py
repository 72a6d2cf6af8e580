"""Cache/vector-optimized B-Tree baseline (paper's comparison point).

An *implicit* K-ary search tree, FAST-style [Kim et al., SIGMOD'10] —
the paper's own reference for SIMD B-Trees — as batched torch gathers:

  * internal levels are packed arrays of separator keys, fanout F
    (= page_size); descent at each level is one vectorized gather of the
    node's F separators + a branchless rank computation;
  * the leaf "page" of F keys is searched with the same branchless
    compare (paper: binary search over ~100 cache-resident items is on
    par with scanning).

This is plain torch on the device the tensors live on, not the paper's
cache-optimised C++ B-Tree, so its times are no Fig. 4 comparison.

The descent counts the separators *below* the query, where the
reference counts those at or below it.  Both are exact over unique
keys; over keys with float32 ties (a separator equal to the query with
equal keys before it, at the end of the previous page) the reference's
descent lands one page late and misses the lower bound, the port's
does not (ROADMAP queue C 21).  The lookup is exact for every query,
stored or absent.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class BTreeIndex:
    page_size: int
    n: int
    levels: List[np.ndarray]  # top -> bottom, each (num_nodes * F,) separators
    depth: int

    @property
    def size_bytes(self) -> int:
        """Internal-node storage (paper's B-Tree size column counts the
        index, not the data)."""
        return sum(int(lv.size) * 4 for lv in self.levels)

    @property
    def fixed_error(self) -> int:
        return self.page_size // 2

    def as_tree(self, device) -> List[torch.Tensor]:
        """The separator levels as float32 tensors on ``device``."""
        return [torch.as_tensor(lv, device=torch.device(device)) for lv in self.levels]


def build_btree(sorted_keys: np.ndarray, page_size: int = 128) -> BTreeIndex:
    keys = np.asarray(sorted_keys, dtype=np.float32)
    n = keys.shape[0]
    f = page_size
    levels: List[np.ndarray] = []
    # bottom-up: level above the leaves holds every f-th key as separator
    seps = keys[::f]  # one separator per leaf page (its first key)
    while seps.size > 1:
        levels.append(seps.astype(np.float32))
        seps = seps[::f]
    levels.reverse()
    depth = len(levels)
    return BTreeIndex(page_size=f, n=n, levels=levels, depth=depth)


def _count_below(block: torch.Tensor, base: torch.Tensor, size: int,
                 q: torch.Tensor, page_size: int) -> torch.Tensor:
    """For each query, how many of the F entries of ``block`` (starting
    at ``base``, a level or key array of ``size`` entries) lie inside
    the array and strictly below the query."""
    offs = torch.arange(page_size, dtype=base.dtype, device=base.device)
    idx = base[:, None] + offs[None, :]
    vals = block[torch.clamp(idx, max=size - 1)]
    return ((idx < size) & (vals < q[:, None])).sum(dim=1, dtype=base.dtype)


def btree_descend(tree_levels, q: torch.Tensor, page_size: int) -> torch.Tensor:
    """Vectorized descent: returns the leaf-page index for each query.

    Each level holds, contiguous per node, F separators (the first key
    of each child); the child taken is the last one whose first key is
    below q (the first child if none is) — a branchless vector compare
    (the SIMD trick FAST uses).  Every key below q then lies in that
    child or before it, and every key before it is below q.
    """
    f = page_size
    node = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    for lv in tree_levels:
        base = node * f
        rank = _count_below(lv, base, lv.shape[0], q, f)
        node = base + torch.clamp(rank - 1, min=0)
    return node


def btree_lookup(
    tree_levels,
    sorted_keys: torch.Tensor,
    q: torch.Tensor,
    page_size: int,
) -> torch.Tensor:
    """Full lookup: descend to a leaf page, branchless search inside it.
    Returns the lower-bound index into sorted_keys (int32)."""
    n = sorted_keys.shape[0]
    base = btree_descend(tree_levels, q, page_size) * page_size
    lt = _count_below(sorted_keys, base, n, q, page_size)
    return torch.clamp(base + lt, 0, n).to(torch.int32)


def compile_btree_lookup(index: BTreeIndex, sorted_keys_norm: np.ndarray, *,
                         device=None):
    """fn: (B,) float32 normalized queries (a tensor on ``device``, None
    = "cuda") -> lower-bound indices."""
    dev = resolve_device(device)
    levels = index.as_tree(dev)
    keys = torch.as_tensor(np.asarray(sorted_keys_norm, np.float32), device=dev)
    ps = index.page_size

    def lookup(q):
        return btree_lookup(levels, keys, q, ps)

    return lookup


def btree_traversal_ops(index: BTreeIndex) -> int:
    """Arithmetic-op estimate per lookup (for the §2.1 back-of-envelope)."""
    return (index.depth + 1) * index.page_size
