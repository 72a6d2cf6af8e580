"""Compactor: merge a frozen delta into the base array and publish a
new snapshot.

The merge is the LSM minor-compaction step specialized to one level:
tombstoned base keys are dropped, staged inserts are woven in (with
their values, when the index carries a payload), and the RMI is rebuilt
through the warm-start path (`refit_rmi` via `build_snapshot`) — the
trained stage-0 model is reused and only the leaves whose key content
changed are refit, so compaction cost is dominated by the O(n) merge,
not by model training.

Compaction runs on whatever thread calls it (the service wraps it in a
background worker); it touches only the frozen delta and the old
snapshot, both immutable during the run, so no locks are needed here.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np

from repro_torch import faults
from repro_torch.core.rmi import RMIConfig
from repro_torch.index_service.delta import DeltaBuffer
from repro_torch.index_service.snapshot import IndexSnapshot, build_snapshot
from repro_torch.obs import trace as obs_trace


class CompactionStall(ValueError):
    """Merging the frozen delta would leave fewer than ``min_keys``
    live keys (nearly everything deleted) — the index cannot rebuild.
    A ValueError subclass so callers treating it as invalid input keep
    working; the service catches THIS type specifically to fold the
    delta back and keep serving."""


@dataclasses.dataclass
class CompactionStats:
    version: int
    n_before: int
    n_after: int
    n_inserts: int
    n_deletes: int
    leaves_refit: int       # -1 = cold rebuild (warm path unavailable)
    seconds: float


def merge_delta(
    snap: IndexSnapshot, delta: DeltaBuffer
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(merged_keys, merged_vals): base minus tombstones, plus staged
    inserts.  Both inputs sorted; output sorted unique."""
    base = snap.keys.raw
    keep = np.ones(base.size, bool)
    if delta.del_keys.size:
        hit = np.searchsorted(delta.del_keys, base)
        hitc = np.clip(hit, 0, delta.del_keys.size - 1)
        keep = delta.del_keys[hitc] != base
    kept = base[keep]
    merged = np.concatenate([kept, delta.ins_keys])
    order = np.argsort(merged, kind="stable")
    merged = merged[order]
    vals = None
    if snap.vals is not None:
        vals = np.concatenate([snap.vals[keep], delta.ins_vals])[order]
    if merged.size:
        # a staged insert can update a key still live in the base (no
        # tombstone); the stable sort placed the base row first, so
        # keeping the LAST of each equal-key run is last-write-wins
        uniq = np.empty(merged.size, bool)
        uniq[:-1] = merged[1:] != merged[:-1]
        uniq[-1] = True
        if not uniq.all():
            merged = merged[uniq]
            if vals is not None:
                vals = vals[uniq]
    return merged, vals


class Compactor:
    """Builds successor snapshots.  ``min_keys`` guards the degenerate
    all-deleted case (an index needs >= 2 distinct keys)."""

    # Concurrency contract: configured once at construction, then
    # immutable — safe to share across service worker threads.  The
    # marker opts the class into lixlint's store analysis to keep any
    # future mutable state honest.
    # lixlint: thread-shared

    def __init__(
        self,
        *,
        config: Optional[RMIConfig] = None,
        bloom_fpr: Optional[float] = None,
        warm: bool = True,
        min_keys: int = 2,
        verbose: bool = False,
    ):
        self.config = config
        self.bloom_fpr = bloom_fpr
        self.warm = warm
        self.min_keys = min_keys
        self.verbose = verbose

    def compact(
        self, snap: IndexSnapshot, frozen: DeltaBuffer
    ) -> Tuple[IndexSnapshot, CompactionStats]:
        t0 = time.perf_counter()
        # before any work: a crash here models the worker dying with
        # the frozen stack untouched (the supervisor's retry re-merges)
        faults.maybe("compactor.crash")
        with obs_trace.span(
            "compactor.merge_delta", cat="compaction",
            inserts=frozen.num_inserts, deletes=frozen.num_deletes,
        ):
            merged, vals = merge_delta(snap, frozen)
        if merged.size < self.min_keys:
            raise CompactionStall(
                f"compaction would leave {merged.size} keys "
                f"(< {self.min_keys}); retain the delta instead"
            )
        with obs_trace.span(
            "compactor.build_snapshot", cat="compaction", n=int(merged.size),
        ):
            new, refit = build_snapshot(
                merged,
                vals=vals,
                config=self.config or snap.index.config,
                version=snap.version + 1,
                bloom_fpr=self.bloom_fpr,
                warm_from=snap if self.warm else None,
                device=snap.device,
                verbose=self.verbose,
            )
        stats = CompactionStats(
            version=new.version,
            n_before=snap.n,
            n_after=new.n,
            n_inserts=frozen.num_inserts,
            n_deletes=frozen.num_deletes,
            leaves_refit=refit,
            seconds=time.perf_counter() - t0,
        )
        return new, stats
