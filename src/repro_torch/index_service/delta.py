"""Delta buffer: a small sorted staging area absorbing inserts/deletes.

LSM-/XIndex-style write path for the otherwise read-only learned
indexes: writes land in this buffer; batched lookups consult the
immutable base array (through the RMI) *and* the delta (through one
branchless padded binary search) in a single device dispatch.  The merged
lower bound of a query key q is

    rank(q) = base_lb(q) + |{staged inserts < q}| - |{tombstones < q}|

which is exactly q's lower bound in the (base - deletions + insertions)
sorted array, provided the staging invariants hold:

  * an insert is staged only for a key that is currently dead (not
    live in the levels below, or killed by one of our own tombstones);
  * a tombstone is staged only for a key that is currently live below;
  * a key may appear in *both* arrays only as tombstone-then-reinsert,
    whose +1/-1 contributions cancel for every query beyond it.

``stage_insert`` / ``stage_delete`` maintain those invariants given
``live_below`` — whether the key is live in the base snapshot plus any
frozen (compacting) delta under this one.  The service computes that
with the same layered override rule an LSM uses: the youngest level
that mentions a key decides its liveness.

For the device side, both arrays (plus an optional frozen sibling) are
fused into ONE sorted key array with a prefix-sum of +1/-1 weights, so
the merged lookup costs the RMI search plus a single
fixed-trip-count binary search and one gather — see
``combine_for_device``.  Arrays are padded with +inf to the next power
of two so device shapes change only per capacity bucket, never per write.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np

# helper signatures accept a single frozen buffer (the historical
# two-level shape), an oldest-first sequence of frozen levels (the
# leveled compactor's stack), or None
Levels = Union[None, "DeltaBuffer", Sequence["DeltaBuffer"]]


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


@dataclasses.dataclass
class DeltaBuffer:
    """Sorted staging arrays for inserts (optionally valued) and
    tombstones.  Host numpy; mutation is control-plane.  ``capacity``
    bounds ins+del entries — callers compact before it is exceeded."""

    capacity: int = 4096

    def __post_init__(self):
        self._ins = np.empty(0, np.float64)
        self._vals = np.empty(0, np.int64)
        self._del = np.empty(0, np.float64)
        self._version = 0

    # ---- introspection ---------------------------------------------------
    @property
    def version(self) -> int:
        """Monotone mutation counter: bumps on every staging call (and
        on `clear`), so device-plane caches can key a capture on
        ``(buffer identity, version)`` and re-pack only the shards
        whose delta actually changed."""
        return self._version
    @property
    def num_inserts(self) -> int:
        return int(self._ins.size)

    @property
    def num_deletes(self) -> int:
        return int(self._del.size)

    def __len__(self) -> int:
        return self.num_inserts + self.num_deletes

    @property
    def fill(self) -> float:
        return len(self) / self.capacity

    @property
    def full(self) -> bool:
        return len(self) >= self.capacity

    @property
    def ins_keys(self) -> np.ndarray:
        return self._ins

    @property
    def ins_vals(self) -> np.ndarray:
        return self._vals

    @property
    def del_keys(self) -> np.ndarray:
        return self._del

    def has_insert(self, key: float) -> bool:
        i = np.searchsorted(self._ins, key)
        return i < self._ins.size and self._ins[i] == key

    def has_tombstone(self, key: float) -> bool:
        i = np.searchsorted(self._del, key)
        return i < self._del.size and self._del[i] == key

    # ---- staging ---------------------------------------------------------
    def stage_insert(self, key: float, live_below: bool, val: int = 0) -> bool:
        """Returns True iff the logical key set changed (the key became
        live).  Re-inserting a live key only refreshes its value."""
        self._version += 1  # conservative: value refreshes count too
        i = np.searchsorted(self._ins, key)
        if i < self._ins.size and self._ins[i] == key:
            self._vals[i] = val
            return False
        if not self.has_tombstone(key) and live_below:
            return False  # already live in base/frozen, no staging needed
        if self.full:
            raise OverflowError("delta buffer full — compact first")
        # tombstone (if any) stays: tombstone+reinsert contributions cancel
        self._ins = np.insert(self._ins, i, key)
        self._vals = np.insert(self._vals, i, val)
        return True

    def stage_delete(self, key: float, live_below: bool) -> bool:
        """Returns True iff the key was live and is now dead."""
        self._version += 1
        i = np.searchsorted(self._ins, key)
        if i < self._ins.size and self._ins[i] == key:
            self._ins = np.delete(self._ins, i)
            self._vals = np.delete(self._vals, i)
            if live_below and not self.has_tombstone(key):
                if self.full:
                    raise OverflowError("delta buffer full — compact first")
                self._del = np.insert(self._del, np.searchsorted(self._del, key), key)
            return True
        if self.has_tombstone(key) or not live_below:
            return False
        if self.full:
            raise OverflowError("delta buffer full — compact first")
        self._del = np.insert(self._del, np.searchsorted(self._del, key), key)
        return True

    # ---- batched staging (one merge per batch, not per key) --------------
    def stage_insert_many(
        self,
        keys: np.ndarray,
        live_below: np.ndarray,
        vals: Optional[np.ndarray] = None,
    ) -> int:
        """Vectorized `stage_insert` over a batch (last write wins for
        in-batch duplicates).  Returns how many keys became live."""
        self._version += 1
        q = np.asarray(keys, np.float64)
        v = (np.zeros(q.shape, np.int64) if vals is None
             else np.asarray(vals, np.int64))
        lb = np.asarray(live_below, bool)
        u, last = np.unique(q[::-1], return_index=True)
        v = v[::-1][last]
        lb = lb[::-1][last]

        i = np.searchsorted(self._ins, u)
        ic = np.clip(i, 0, max(self._ins.size - 1, 0))
        exists = (self._ins[ic] == u) if self._ins.size else np.zeros(u.shape, bool)
        self._vals[ic[exists]] = v[exists]  # refresh values of staged keys
        add = ~exists & (member(self._del, u) | ~lb)
        newk, newv = u[add], v[add]
        if len(self) + newk.size > self.capacity:
            raise OverflowError("delta buffer full — compact first")
        pos = np.searchsorted(self._ins, newk)
        self._ins = np.insert(self._ins, pos, newk)
        self._vals = np.insert(self._vals, pos, newv)
        return int(add.sum())

    def stage_delete_many(self, keys: np.ndarray, live_below: np.ndarray) -> int:
        """Vectorized `stage_delete` over a batch.  Returns how many
        keys went from live to dead."""
        self._version += 1
        q = np.asarray(keys, np.float64)
        lb = np.asarray(live_below, bool)
        u, first = np.unique(q, return_index=True)
        lb = lb[first]

        i = np.searchsorted(self._ins, u)
        ic = np.clip(i, 0, max(self._ins.size - 1, 0))
        in_ins = (self._ins[ic] == u) if self._ins.size else np.zeros(u.shape, bool)
        tombstoned = member(self._del, u)
        was_live = in_ins | (lb & ~tombstoned)
        if in_ins.any():
            self._ins = np.delete(self._ins, ic[in_ins])
            self._vals = np.delete(self._vals, ic[in_ins])
        need = lb & ~tombstoned
        newd = u[need]
        if len(self) + newd.size > self.capacity:
            raise OverflowError("delta buffer full — compact first")
        self._del = np.insert(self._del, np.searchsorted(self._del, newd), newd)
        return int(was_live.sum())

    @classmethod
    def from_arrays(
        cls,
        ins_keys: np.ndarray,
        ins_vals: np.ndarray,
        del_keys: np.ndarray,
        capacity: int,
    ) -> "DeltaBuffer":
        """Rebuild a buffer from collapsed (ins, vals, del) arrays — the
        compaction-stall fold-back path.  Capacity stretches to hold the
        retained entries; normal staging room checks still apply."""
        buf = cls(capacity=max(capacity, ins_keys.size + del_keys.size))
        buf._ins = np.asarray(ins_keys, np.float64).copy()
        buf._vals = np.asarray(ins_vals, np.int64).copy()
        buf._del = np.asarray(del_keys, np.float64).copy()
        return buf

    def lookup_value(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(found_in_ins, value) for a batch of raw keys."""
        q = np.asarray(keys, np.float64)
        i = np.searchsorted(self._ins, q)
        ic = np.clip(i, 0, max(self._ins.size - 1, 0))
        found = (
            (self._ins[ic] == q) if self._ins.size else np.zeros(q.shape, bool)
        )
        vals = self._vals[ic] if self._ins.size else np.zeros(q.shape, np.int64)
        return found, np.where(found, vals, 0)

    def clear(self) -> None:
        v = self._version
        self.__post_init__()
        self._version = v + 1


def iter_levels(
    frozen: Levels, active: Optional[DeltaBuffer] = None
) -> Tuple[DeltaBuffer, ...]:
    """Flatten a ``frozen`` argument — None, one buffer, or an
    oldest-first stack of frozen buffers — plus the optional active
    buffer into the oldest-first tuple the layered-override rule walks."""
    if frozen is None:
        levels: Tuple[DeltaBuffer, ...] = ()
    elif isinstance(frozen, DeltaBuffer):
        levels = (frozen,)
    else:
        levels = tuple(frozen)
    if active is not None:
        levels += (active,)
    return levels


def live_mask(
    in_base: np.ndarray,
    frozen: Levels,
    active: Optional[DeltaBuffer],
    keys: np.ndarray,
) -> np.ndarray:
    """Layered liveness: the youngest level mentioning a key decides.
    An insert entry marks live (it overrides a same-level tombstone —
    resurrection keeps the tombstone so rank arithmetic cancels); a
    tombstone alone marks dead; an unmentioned key inherits."""
    q = np.asarray(keys, np.float64)
    live = np.asarray(in_base, bool).copy()
    for level in iter_levels(frozen, active):
        ins = member(level.ins_keys, q)
        dead = member(level.del_keys, q)
        live = np.where(ins, True, np.where(dead, False, live))
    return live


def member(sorted_arr: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Exact membership of each q in a sorted float64 array."""
    if sorted_arr.size == 0:
        return np.zeros(q.shape, bool)
    i = np.clip(np.searchsorted(sorted_arr, q), 0, sorted_arr.size - 1)
    return sorted_arr[i] == q


def count_less(
    frozen: Levels, active: Optional[DeltaBuffer], q: np.ndarray
) -> np.ndarray:
    """Exact host-side Σ(+1/-1) over all staged entries < q (float64 —
    immune to the float32 collisions the device path tolerates)."""
    q = np.asarray(q, np.float64)
    net = np.zeros(q.shape, np.int64)
    for level in iter_levels(frozen, active):
        net += np.searchsorted(level.ins_keys, q, side="left")
        net -= np.searchsorted(level.del_keys, q, side="left")
    return net


def collapse_levels(
    base_raw: np.ndarray,
    frozen: Levels,
    active: Optional[DeltaBuffer],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Collapse the (frozen, active) level stack against base liveness
    into one *effective* single-level view:

      ``eff_ins``  — keys live via a staged insert, with the youngest
                     level's value.  A key here is either absent from
                     the base or paired with an ``eff_del`` entry (the
                     tombstone-then-reinsert pattern), so eff_ins and
                     (base minus eff_del) never share a key;
      ``eff_del``  — base keys whose base row is dead or superseded by
                     a staged value.

    The net ±1 contribution below any query is identical to the raw
    level stack's (per-key cases all cancel the same way), so merged
    ranks are unchanged — but scans get an unambiguous source + value
    per merged row, with no cross-level run resolution left to do.
    Returns ``(eff_ins_keys, eff_ins_vals, eff_del_keys)``, all sorted.
    """
    from repro_torch.obs import trace as obs_trace  # local: delta stays leaf-light
    with obs_trace.span("delta.collapse_levels", cat="plane"):
        return _collapse_levels_inner(base_raw, frozen, active)


def _collapse_levels_inner(
    base_raw: np.ndarray,
    frozen: Levels,
    active: Optional[DeltaBuffer],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    levels = [lv for lv in iter_levels(frozen, active) if len(lv)]
    empty = np.empty(0, np.float64)
    if not levels:
        return empty, np.empty(0, np.int64), empty
    mentioned = empty
    for lv in levels:
        mentioned = np.union1d(mentioned, np.union1d(lv.ins_keys, lv.del_keys))
    in_base = member(base_raw, mentioned)
    live = live_mask(in_base, frozen, active, mentioned)
    vals = np.zeros(mentioned.size, np.int64)
    staged = np.zeros(mentioned.size, bool)
    for lv in levels:  # youngest (active) last: its values win
        found, v = lv.lookup_value(mentioned)
        vals = np.where(found, v, vals)
        staged |= found
    # a live mentioned key always carries an insert entry in its
    # youngest mentioning level (a bare tombstone would mark it dead)
    ins_mask = live & staged
    del_mask = in_base & (~live | staged)
    return mentioned[ins_mask], vals[ins_mask], mentioned[del_mask]


def combine_for_device(
    frozen: Levels,
    active: Optional[DeltaBuffer],
    normalize,
    *,
    min_pad: int = 64,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fuse all staged entries into (padded_keys_f32, prefix_i32) for
    the device merged lookup.

    ``padded_keys`` is the sorted union of insert and tombstone keys in
    the snapshot's normalized float32 frame, padded with +inf to a
    power-of-two length; ``prefix[i]`` = net (+inserts, -tombstones)
    among the first i entries, length len(padded)+1, so
    ``prefix[lower_bound(q)]`` is the delta contribution to q's merged
    rank.  Duplicate keys (tombstone + reinsert) are benign: both sit at
    the same position and the prefix at any lower bound sums whole
    duplicate groups.
    """
    parts, signs = [], []
    for level in iter_levels(frozen, active):
        parts += [level.ins_keys, level.del_keys]
        signs += [
            np.ones(level.ins_keys.size, np.int32),
            -np.ones(level.del_keys.size, np.int32),
        ]
    if parts:
        raw = np.concatenate(parts)
        sgn = np.concatenate(signs)
        order = np.argsort(raw, kind="stable")
        raw, sgn = raw[order], sgn[order]
    else:
        raw = np.empty(0, np.float64)
        sgn = np.empty(0, np.int32)
    pad = _next_pow2(max(min_pad, raw.size))
    keys = np.full(pad, np.inf, np.float32)
    keys[: raw.size] = normalize(raw)
    prefix = np.zeros(pad + 1, np.int32)
    np.cumsum(sgn, out=prefix[1 : raw.size + 1])
    prefix[raw.size + 1 :] = prefix[raw.size]
    return keys, prefix
