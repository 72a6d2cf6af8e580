"""Hash-Model index (paper §4): the scaled CDF as a hash function.

``h(K) = F(K) * M`` — if F is the true CDF of the key distribution the
keys spread perfectly over M slots.  The RMI is F (paper §4.1: "we can
again leverage the recursive model architecture").

The map is flat arrays with a chained overflow region (the reference's
layout); conflict and occupancy statistics — the paper's Fig. 10
metrics — are exact.  The host code (`HashMap`, `build_hashmap`,
`random_hash_u64`, `build_random_hashmap`) is the reference's NumPy,
copied.  Slots of the model hash come from the port's `leaf_and_pos`
(separately rounded multiply and add, the arithmetic of the
`hash_probe_cuda` kernel), so build-time and probe-time slots agree on
every device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.core import search as search_lib
from repro_torch.core.keys import KeySet, make_keyset
from repro_torch.core.models import pack_stage0
from repro_torch.core.rmi import RMIConfig, RMIndex, build_rmi, leaf_and_pos
from repro_torch.device import resolve_device

EMPTY = np.int64(-1)
_U32 = 0xFFFFFFFF
# uint32 products in int64 without overflow: multiply by the 16-bit
# halves of the constant and recombine modulo 2**32
_LO16 = 0xFFFF
_SLOT_CHUNK = 1 << 24  # keys per device pass of model_hash_slots


# --------------------------------------------------------------------------
# Baseline random hash: the paper's "2 multiplications, 3 bitshifts,
# 3 XORs" mix (a murmur3-style finalizer).
# --------------------------------------------------------------------------

def random_hash_u64(keys: np.ndarray, num_slots: int) -> np.ndarray:
    h = np.asarray(keys, dtype=np.uint64).copy()
    h ^= h >> np.uint64(33)
    h *= np.uint64(0xFF51AFD7ED558CCD)
    h ^= h >> np.uint64(33)
    h *= np.uint64(0xC4CEB9FE1A85EC53)
    h ^= h >> np.uint64(33)
    return (h % np.uint64(num_slots)).astype(np.int64)


def mul_u32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2**32`` for int64 ``h`` in [0, 2**32): each partial
    product stays below 2**48."""
    lo = h * (c & _LO16)
    hi = ((h * (c >> 16)) & _LO16) << 16
    return (lo + hi) & _U32


def random_hash_u32(keys: torch.Tensor, num_slots: int) -> torch.Tensor:
    """The reference's 32-bit `random_hash_u32_jax`: ``keys`` hold uint32
    values (any integer dtype; taken modulo 2**32), the uint32 wrap is
    emulated in int64.  Returns int32 slots."""
    h = keys.to(torch.int64) & _U32
    h = h ^ (h >> 16)
    h = mul_u32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = mul_u32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return (h % num_slots).to(torch.int32)


# --------------------------------------------------------------------------
# Hash map with chained overflow, array-of-structures layout.
# --------------------------------------------------------------------------

@dataclasses.dataclass
class HashMap:
    """slots: primary array of size M; overflow: chained spill area.

    slot_key[i]   — key stored at primary slot i (NaN if none)
    slot_next[i]  — index into overflow arrays, -1 if chain ends
    ovf_key/ovf_next — overflow storage
    """

    num_slots: int
    slot_key: np.ndarray
    slot_next: np.ndarray
    ovf_key: np.ndarray
    ovf_next: np.ndarray
    max_chain: int
    num_conflicts: int
    num_empty: int

    @property
    def load_stats(self) -> Dict[str, float]:
        m = self.num_slots
        return {
            "slots": m,
            "empty_frac": self.num_empty / m,
            "conflict_frac": self.num_conflicts / max(1, len(self.ovf_key)+ (self.slot_key != EMPTY).sum()),
            "max_chain": self.max_chain,
            "overflow_items": int(self.ovf_key.size),
        }


def build_hashmap(keys: np.ndarray, slots_for: np.ndarray, num_slots: int) -> HashMap:
    """Sequential insert (build time is not the benchmarked metric)."""
    keys = np.asarray(keys, dtype=np.float64)
    slot_key = np.full(num_slots, np.nan)
    slot_next = np.full(num_slots, -1, np.int64)
    order = np.argsort(slots_for, kind="stable")
    sorted_slots = slots_for[order]
    sorted_keys = keys[order]
    # first key per slot goes to the primary array
    first_mask = np.ones(len(order), bool)
    first_mask[1:] = sorted_slots[1:] != sorted_slots[:-1]
    slot_key[sorted_slots[first_mask]] = sorted_keys[first_mask]
    # the rest chain into overflow, grouped per slot
    rest = ~first_mask
    ovf_key = sorted_keys[rest]
    ovf_slot = sorted_slots[rest]
    n_ovf = int(rest.sum())
    ovf_next = np.full(n_ovf, -1, np.int64)
    if n_ovf:
        same = np.zeros(n_ovf, bool)
        same[:-1] = ovf_slot[:-1] == ovf_slot[1:]
        ovf_next[:-1][same[:-1]] = np.arange(1, n_ovf)[same[:-1]]
        firsts = np.ones(n_ovf, bool)
        firsts[1:] = ovf_slot[1:] != ovf_slot[:-1]
        slot_next[ovf_slot[firsts]] = np.arange(n_ovf)[firsts]
    # stats
    counts = np.bincount(slots_for, minlength=num_slots)
    num_empty = int((counts == 0).sum())
    num_conflicts = int(counts[counts > 1].sum() - (counts > 1).sum())
    max_chain = int(counts.max())
    return HashMap(
        num_slots=num_slots,
        slot_key=slot_key,
        slot_next=slot_next,
        ovf_key=ovf_key if n_ovf else np.zeros(1),
        ovf_next=ovf_next if n_ovf else np.full(1, -1, np.int64),
        max_chain=max_chain,
        num_conflicts=num_conflicts,
        num_empty=num_empty,
    )


def compile_hash_lookup(
    hm: HashMap, slot_fn: Callable[[torch.Tensor], torch.Tensor], device=None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Returns fn: raw keys (float64 tensor on ``device``) -> found
    (bool), in plain torch.  Walks chains with a fixed trip count =
    max chain length - 1; ``slot_fn`` maps the raw keys to slots."""
    dev = resolve_device(device)
    slot_key = torch.as_tensor(hm.slot_key, device=dev)
    slot_next = torch.as_tensor(hm.slot_next, device=dev)
    ovf_key = torch.as_tensor(hm.ovf_key, device=dev)
    ovf_next = torch.as_tensor(hm.ovf_next, device=dev)
    trips = max(0, hm.max_chain - 1)

    def lookup(raw_q: torch.Tensor) -> torch.Tensor:
        slot = slot_fn(raw_q)
        found = slot_key[slot] == raw_q
        nxt = slot_next[slot]
        for _ in range(trips):
            valid = nxt >= 0
            safe = torch.clamp(nxt, min=0)
            found = found | (valid & (ovf_key[safe] == raw_q))
            nxt = torch.where(valid, ovf_next[safe], torch.full_like(nxt, -1))
        return found

    return lookup


# --------------------------------------------------------------------------
# The two hash functions under test
# --------------------------------------------------------------------------

def model_slots(index: RMIndex, q: torch.Tensor, num_slots: int) -> torch.Tensor:
    """Slots of normalized float32 queries ``q`` (any device): the leaf
    position times ``f32(num_slots / n)`` — ONE float32 multiply by a
    host-computed constant, as the probe kernel does — truncated,
    clamped to [0, num_slots - 1].  int32."""
    dev = q.device
    s0 = torch.as_tensor(pack_stage0(index.stage0_params), device=dev)
    leaf_w = torch.as_tensor(index.leaf_w, device=dev)
    leaf_b = torch.as_tensor(index.leaf_b, device=dev)
    _, pos = leaf_and_pos(s0, index.hidden, leaf_w, leaf_b, q,
                          n=index.n, num_leaves=index.num_leaves)
    ratio = torch.tensor(np.float32(num_slots / index.n), device=dev)
    return torch.clamp(search_lib.to_index(pos * ratio), max=num_slots - 1)


def model_hash_slots(
    index: RMIndex, keys: KeySet, raw_keys: np.ndarray, num_slots: int, device=None,
) -> np.ndarray:
    """h(K) = F(K) * M with F = the RMI position estimate / N, computed
    on ``device`` (None = "cuda") in chunks of _SLOT_CHUNK keys.  int64."""
    dev = resolve_device(device)
    q = keys.normalize(raw_keys)
    out = np.empty(q.size, np.int64)
    for s in range(0, q.size, _SLOT_CHUNK):
        qt = torch.as_tensor(q[s:s + _SLOT_CHUNK], device=dev)
        out[s:s + _SLOT_CHUNK] = model_slots(index, qt, num_slots).cpu().numpy()
    return out


def build_model_hashmap(
    raw_keys: np.ndarray, num_slots: int, rmi_config: RMIConfig | None = None,
    device=None,
) -> tuple[HashMap, RMIndex, KeySet]:
    """The §4 model hash map over ``raw_keys``: an RMI with n/4 leaves
    and a linear stage-0 (unless ``rmi_config`` says otherwise), its
    slots computed on ``device`` (None = "cuda")."""
    ks = make_keyset(raw_keys)
    # n/4 leaves keeps mean|err| under ~1 key — the regime where the
    # learned CDF meaningfully beats random hashing
    cfg = rmi_config or RMIConfig(num_leaves=max(16, ks.n // 4),
                                  stage0_hidden=())
    idx = build_rmi(ks, cfg, device=device)
    slots = model_hash_slots(idx, ks, np.asarray(raw_keys, np.float64), num_slots,
                             device=device)
    hm = build_hashmap(np.asarray(raw_keys, np.float64), slots, num_slots)
    return hm, idx, ks


def build_random_hashmap(raw_keys: np.ndarray, num_slots: int) -> HashMap:
    slots = random_hash_u64(
        np.asarray(raw_keys, np.float64).view(np.uint64), num_slots
    )
    return build_hashmap(np.asarray(raw_keys, np.float64), slots, num_slots)
