"""LIF — the Learning Index Framework (paper §3.1): index synthesis.

Given an index specification (a key set + constraints), LIF grid-searches
candidate configurations, trains them, measures error/size/estimated
latency, and emits the best index as a lookup closure over tensors on
one device.  The paper's C++ code generation step maps to
`core.rmi.compile_lookup`: the weights go to the device once and the
closure holds them.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, List, Optional, Tuple, Union

import numpy as np

from repro_torch.core.keys import KeySet, VectorKeySet
from repro_torch.core.models import MLPSpec
from repro_torch.core.rmi import RMIConfig, RMIndex, build_rmi, compile_lookup
from repro_torch.device import resolve_device


@dataclasses.dataclass
class IndexSpec:
    """What the user asks for."""

    max_size_bytes: Optional[int] = None      # memory budget
    max_avg_window: Optional[float] = None    # accuracy budget
    hybrid_threshold: Optional[int] = None    # Algorithm 1 fallback
    search: str = "binary"


@dataclasses.dataclass
class Candidate:
    config: RMIConfig
    index: RMIndex
    avg_window: float
    max_window: int
    size_bytes: int
    model_flops: int
    score: float


DEFAULT_GRID = {
    "num_leaves": (10_000, 50_000, 100_000, 200_000),
    "stage0_hidden": ((), (8,), (16, 16), (32, 32)),
}


def synthesize(
    keys: Union[KeySet, VectorKeySet],
    spec: IndexSpec | None = None,
    grid: dict | None = None,
    *,
    train_steps: int = 200,
    device=None,
    verbose: bool = False,
) -> Tuple[RMIndex, Callable, List[Candidate]]:
    """Grid-search per §3.3 ("these parameters can be optimized using a
    simple grid-search").  Score = estimated lookup cost: model FLOPs/8
    (SIMD lanes, §2.1's 8-16 ops/cycle) + log2(window) * 50/log2(100)
    cycles (the measured per-probe cost), subject to the spec budgets.
    ``device`` (None = "cuda") trains every candidate and holds the
    emitted lookup.  Over string keys the lookup is `compile_lookup`'s
    first-column search, as in the reference (ROADMAP queue C 19).
    """
    dev = resolve_device(device)
    spec = spec or IndexSpec()
    grid = grid or DEFAULT_GRID
    n = keys.n
    cands: List[Candidate] = []
    in_dim = 1 if not isinstance(keys, VectorKeySet) else keys.dim

    for leaves, hidden in itertools.product(
        grid["num_leaves"], grid["stage0_hidden"]
    ):
        if leaves > n:
            continue
        cfg = RMIConfig(
            num_leaves=int(leaves),
            stage0_hidden=tuple(hidden),
            stage0_train_steps=train_steps,
            hybrid_threshold=spec.hybrid_threshold,
        )
        idx = build_rmi(keys, cfg, device=dev)
        avg_window = float(np.mean(idx.err_hi - idx.err_lo)) + 1.0
        flops = MLPSpec(in_dim=in_dim, hidden=tuple(hidden)).flops_per_query + 4
        probe_cost = np.log2(max(2.0, idx.max_window)) * (50.0 / np.log2(100))
        score = flops / 8.0 + probe_cost
        c = Candidate(
            config=cfg, index=idx, avg_window=avg_window,
            max_window=idx.max_window, size_bytes=idx.model_size_bytes,
            model_flops=flops, score=float(score),
        )
        cands.append(c)
        if verbose:
            print(
                f"  cand leaves={leaves} hidden={hidden}: window≈{avg_window:.1f} "
                f"max={idx.max_window} size={c.size_bytes/1e6:.2f}MB score={score:.1f}"
            )

    feasible = [
        c for c in cands
        if (spec.max_size_bytes is None or c.size_bytes <= spec.max_size_bytes)
        and (spec.max_avg_window is None or c.avg_window <= spec.max_avg_window)
    ]
    pool = feasible or cands
    best = min(pool, key=lambda c: c.score)
    lookup = compile_lookup(best.index, keys, strategy=spec.search, device=dev)
    if verbose:
        print(
            f"LIF picked leaves={best.config.num_leaves} "
            f"hidden={best.config.stage0_hidden} (score={best.score:.1f})"
        )
    return best.index, lookup, cands
