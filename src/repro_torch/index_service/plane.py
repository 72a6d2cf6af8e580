"""Device plane: the device-resident delta slab behind the hot read path.

Orchestration (service.py) decides WHAT state is current — it holds the
lock, captures the (snapshot, frozen, active) triple, and tells the
plane when writes or swaps retire state (`drop_*`); the plane decides
WHETHER the delta arrays need re-packing and re-upload, and owns those
tensors.  Cache checks are identity comparisons, never data reads, so a
hit costs one counter bump.  (The reference's scan slab joins this
plane with the scan path.)
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.index_service.delta import combine_for_device


class DevicePlane:
    """Device-resident read-path state for ONE IndexService: the *lookup
    slab* — the fused delta arrays `combine_for_device` packs for the
    merged lookup, on the snapshot's device, keyed on snapshot identity
    (writes drop it explicitly via `drop_lookup`, so the key never needs
    to read delta state).  Hit/miss counters land in the owning
    service's registry (``plane.lookup.*``).

    Locking contract: `lookup_slab` is called under the service lock (it
    reads/publishes one reference)."""

    def __init__(self, metrics):
        self._lookup = None  # (snap, dk, dp)
        self._ctr = {
            k: metrics.counter(f"plane.{k}")
            for k in ("lookup.hit", "lookup.miss")
        }

    def lookup_slab(self, snap, frozen, active) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device (keys, prefix) delta slab for the merged lookup over
        ``snap``; re-packed only when the snapshot changed since the
        last capture (writes invalidate via `drop_lookup`)."""
        cache = self._lookup
        if cache is None or cache[0] is not snap:
            self._ctr["lookup.miss"].add(1)
            dk, dp = combine_for_device(frozen, active, snap.keys.normalize)
            cache = (snap, torch.as_tensor(dk, device=snap.device),
                     torch.as_tensor(dp, device=snap.device))
            self._lookup = cache
        else:
            self._ctr["lookup.hit"].add(1)
        return cache[1], cache[2]

    # ---- invalidation ----------------------------------------------------
    def drop_lookup(self) -> None:
        """A write changed the delta: the lookup slab is stale."""
        self._lookup = None

    def drop(self) -> None:
        """A freeze/swap retired snapshot or delta state (also releases
        the retired arrays' device buffers)."""
        self._lookup = None
