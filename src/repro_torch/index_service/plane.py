"""Device plane: the device-resident mirrors behind the hot read path.

Orchestration (service.py) decides WHAT state is current — it holds the
lock, captures the (snapshot, frozen, active) triple, and tells the
plane when writes or swaps retire state (`drop_*`); the plane decides
WHETHER the delta arrays need re-packing and re-upload, and owns those
tensors.  Cache checks are identity/version comparisons, never data
reads, so a hit costs one counter bump.

Cache coherence keys live here too (`scan_plane_key`): snapshot and
delta-buffer identities plus delta mutation versions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.index_service.delta import combine_for_device, iter_levels
from repro_torch.index_service.scan import device_scan_slab


def scan_plane_key(snap, frozen, active) -> tuple:
    """THE cache-coherence key for device scan planes: snapshot
    identity plus (identity, mutation version) per delta level —
    ``frozen`` may be None, one buffer, or the leveled compactor's
    oldest-first stack."""
    return (snap,) + tuple(
        (lv, lv.version) for lv in iter_levels(frozen, active)
    )


def scan_plane_key_eq(a: tuple, b: tuple) -> bool:
    if len(a) != len(b) or a[0] is not b[0]:
        return False
    return all(
        x[0] is y[0] and x[1] == y[1] for x, y in zip(a[1:], b[1:])
    )


class DevicePlane:
    """Device-resident read-path state for ONE IndexService.

    Two cached surfaces on the snapshot's device, each with hit/miss
    counters in the owning service's registry (``plane.lookup.*`` /
    ``plane.scan.*``):

      * the *lookup slab* — the fused delta arrays `combine_for_device`
        packs for the merged lookup, keyed on snapshot identity (writes
        drop it explicitly via `drop_lookup`, so the key never needs to
        read delta state);
      * the *scan slab* — staged-insert arrays + the prefix-sum page
        index `device_scan_slab` builds for the one-dispatch scan, keyed
        on `scan_plane_key` (identity + delta versions, so an unchanged
        delta re-uses the upload outright).

    Locking contract: `lookup_slab` and `cached_scan_slab` are called
    under the service lock (they read/publish one reference); the O(n)
    `build_scan_slab` runs OUTSIDE the lock on an immutable pinned view,
    so writers and compaction commits never stall behind a re-pack — a
    plane made stale by a concurrent write just misses its key check on
    the next read."""

    def __init__(self, metrics):
        self._lookup = None  # (snap, dk, dp)
        self._scan = None    # (key, slab, ins_n)
        self._ctr = {
            k: metrics.counter(f"plane.{k}")
            for k in ("lookup.hit", "lookup.miss", "scan.hit", "scan.miss")
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

    # ---- fused-scan slab -------------------------------------------------
    def cached_scan_slab(self, key: tuple) -> Optional[Tuple[tuple, int]]:
        """(slab, ins_n) when the cached plane matches ``key``, else
        None (the caller then pins a view and calls `build_scan_slab`
        outside the lock)."""
        plane = self._scan
        if plane is not None and scan_plane_key_eq(plane[0], key):
            self._ctr["scan.hit"].add(1)
            return plane[1], plane[2]
        self._ctr["scan.miss"].add(1)
        return None

    def build_scan_slab(self, key: tuple, view, norm, normalize, device):
        """Pack + upload the scan plane for an immutable pinned view
        and publish it under ``key``.  Publishing is one reference
        write; concurrent builders at worst race to publish equivalent
        slabs."""
        ins, ivals, ins_rank, lp = device_scan_slab(view, norm, normalize)
        slab = tuple(torch.as_tensor(a, device=device)
                     for a in (ins, ivals, ins_rank, lp))
        self._scan = (key, slab, view.ins_keys.size)
        return slab, view.ins_keys.size

    # ---- invalidation ----------------------------------------------------
    def drop_lookup(self) -> None:
        """A write changed the delta: the lookup slab is stale."""
        self._lookup = None

    def drop(self) -> None:
        """A freeze/swap retired snapshot or delta state: drop both
        surfaces (also releases the retired arrays' device buffers)."""
        self._lookup = None
        self._scan = None
