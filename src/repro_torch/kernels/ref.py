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

import numpy as np
import torch

from repro_torch.core import search as search_lib
from repro_torch.core.learned_hash import mul_u32
from repro_torch.core.models import stage0_apply
from repro_torch.core.rmi import leaf_and_pos, leaf_position


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


def rmi_sharded_merged_lookup_reference(
    q: torch.Tensor,               # (S, B) per-shard normalized queries
    s0: torch.Tensor,              # (S, P) flat stage-0 buffers (pack_stage0)
    leaf_w: torch.Tensor,          # (S, M) zero-padded past each shard's m
    leaf_b: torch.Tensor,          # (S, M)
    err_lo: torch.Tensor,          # (S, M)
    err_hi: torch.Tensor,          # (S, M)
    sorted_keys: torch.Tensor,     # (S, N) +inf-padded past each shard's n
    delta_keys: torch.Tensor,      # (S, D) +inf-padded per-shard deltas
    delta_prefix: torch.Tensor,    # (S, D+1) prefix, constant on the pad tail
    shard_n: torch.Tensor,         # (S,) int32 true base sizes
    shard_m: torch.Tensor,         # (S,) int32 true leaf counts
    shard_ratio: torch.Tensor,     # (S,) float32, f32(m/n) from the host
    *,
    hidden: tuple,
    max_window: int,               # the maximum over the shards
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of `rmi_sharded_merged_lookup_cuda`: per shard, the
    single-shard body with that shard's n, m and ``shard_ratio`` (the
    position clamped to f32(n - 1)), ``steps`` from the maximum window
    over the shards, the lower bound clamped to n, and the delta prefix
    gather clamped to D.  Returns the per-shard ``(local_base,
    delta_contrib)``, both int32 (S, B).  Rows may be broadcast views."""
    d = delta_keys.shape[1]
    bases, contribs = [], []
    for s, (n, m) in enumerate(zip(shard_n.tolist(), shard_m.tolist())):
        qs = q[s]
        p0 = stage0_apply(s0[s], hidden, qs)
        leaf = torch.clamp(
            search_lib.to_index(torch.floor(p0 * shard_ratio[s])), max=m - 1)
        pos = leaf_position(leaf_w[s][leaf], leaf_b[s][leaf], qs, n)
        lb = search_lib.model_binary_search(
            sorted_keys[s, :n], qs, pos, err_lo[s][leaf], err_hi[s][leaf],
            max_window)
        dlb = search_lib.lower_bound_full(delta_keys[s], qs)
        bases.append(torch.clamp(lb, max=n))
        contribs.append(delta_prefix[s][torch.clamp(dlb, max=d)])
    return torch.stack(bases), torch.stack(contribs)


# ---------------------------------------------------------------------------
# merged range scans (`csrc/rmi_scan.cu`)
# ---------------------------------------------------------------------------
# Integer searches, compares and gathers only: the kernels equal these
# bit for bit on every lane, masked lanes included.  int32 sums wrap as
# they do in the reference.

_INF = float("inf")


def array_lower_bound(arr: torch.Tensor, q: torch.Tensor, size: int,
                      steps: int) -> torch.Tensor:
    """Branchless lower bound of each q in arr[0:size], ``steps`` fixed
    trips (the reference's `_array_lower_bound`).  Converged lanes are
    pinned with ``lo < hi``: scan queries may equal or pass every stored
    element (+inf sentinels, positions past the pad), and extra trips
    must not walk ``lo`` off the end."""
    lo = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    hi = torch.full_like(lo, size)
    for _ in range(steps):
        mid = (lo + hi) >> 1
        v = arr[torch.clamp(mid, 0, size - 1)]
        r = (v < q) & (lo < hi)
        lo = torch.where(r, mid + 1, lo)
        hi = torch.where(r, hi, mid)
    return lo


def rows_lower_bound(arr: torch.Tensor, q: torch.Tensor, size: int,
                     steps: int) -> torch.Tensor:
    """`array_lower_bound` on every row at once: ``arr`` (S, W), ``q``
    (S, K) -> (S, K) int32 lower bounds of row s's queries in
    ``arr[s, :size]``."""
    lo = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    hi = torch.full_like(lo, size)
    for _ in range(steps):
        mid = (lo + hi) >> 1
        v = arr.gather(1, torch.clamp(mid, 0, size - 1).long())
        r = (v < q) & (lo < hi)
        lo = torch.where(r, mid + 1, lo)
        hi = torch.where(r, hi, mid)
    return lo


def merged_rank_from_prefix(q, base_keys, live_prefix, ins_keys, *,
                            steps: int, isteps: int) -> torch.Tensor:
    """``live_prefix[lower_bound(base, q)] + lower_bound(ins, q)``: the
    merged lower-bound rank of each q (the reference's
    `_merged_rank_from_prefix`)."""
    bl = array_lower_bound(base_keys, q, base_keys.shape[0], steps)
    ins = array_lower_bound(ins_keys, q, ins_keys.shape[0], isteps)
    return live_prefix[bl] + ins


def _emit(t_valid, p, j, base_keys, base_vals, ins_keys, ins_vals):
    """min(base row p, insert row j) with its source's value; base wins
    a tie.  Lanes with ``t_valid`` False come back (+inf, 0, 0)."""
    n, ni = base_keys.shape[0], ins_keys.shape[0]
    inf = torch.tensor(_INF, dtype=torch.float32, device=p.device)
    a_key = torch.where((p < 0) | (p >= n), inf,
                        base_keys[torch.clamp(p, 0, n - 1)])
    a_val = base_vals[torch.clamp(p, 0, n - 1)]
    c_key = torch.where(j >= ni, inf, ins_keys[torch.clamp(j, 0, ni - 1)])
    c_val = ins_vals[torch.clamp(j, 0, ni - 1)]
    from_ins = c_key < a_key
    key = torch.where(t_valid, torch.where(from_ins, c_key, a_key), inf)
    val = torch.where(t_valid, torch.where(from_ins, c_val, a_val),
                      torch.zeros_like(a_val))
    return key, val, t_valid.to(torch.int32)


def scan_rows_from_index(t, valid, base_keys, base_vals, live_prefix,
                         ins_keys, ins_vals, ins_rank, *, psteps: int,
                         msteps: int):
    """One merged row per target rank through the prefix-sum page index
    (the reference's `_scan_rows_from_index`): ``j = lower_bound(ins_rank,
    t)`` staged inserts precede rank t, and the (t-j)-th live base row
    is ``lower_bound(live_prefix, t - j + 1) - 1``."""
    n, ni = base_keys.shape[0], ins_keys.shape[0]
    j = array_lower_bound(ins_rank, t, ni, msteps)
    p = array_lower_bound(live_prefix, t - j + 1, n + 1, psteps) - 1
    return _emit(valid, p, j, base_keys, base_vals, ins_keys, ins_vals)


def scan_page_body(t, base_keys, base_vals, ins_keys, ins_vals, del_pos,
                   end_rank, *, steps: int, isteps: int, dsteps: int):
    """One merged row per target rank by nested searches (the
    reference's `_scan_page_body`): the partition finds how many staged
    inserts precede rank t (``isteps`` trips, each a base lower bound and
    a ``del_pos`` lower bound), the select finds the (t-j)-th live base
    position (``steps`` trips, each a ``del_pos`` lower bound)."""
    n, ni, nd = base_keys.shape[0], ins_keys.shape[0], del_pos.shape[0]
    inf = torch.tensor(_INF, dtype=torch.float32, device=t.device)
    lo = torch.zeros(t.shape, dtype=torch.int32, device=t.device)
    hi = torch.full_like(lo, ni)
    for _ in range(isteps):
        mid = (lo + hi) >> 1
        ck = torch.where(mid >= ni, inf, ins_keys[torch.clamp(mid, 0, ni - 1)])
        bl = array_lower_bound(base_keys, ck, n, steps)
        dl = array_lower_bound(del_pos, bl, nd, dsteps)
        pred = mid + (bl - dl) >= t
        adv = ~pred & (lo < hi)
        lo = torch.where(adv, mid + 1, lo)
        hi = torch.where(pred, mid, hi)
    j = lo
    i = t - j
    lo = torch.zeros_like(j)
    hi = torch.full_like(j, n)
    for _ in range(steps):
        mid = (lo + hi) >> 1
        dl = array_lower_bound(del_pos, mid + 1, nd, dsteps)
        pred = (mid + 1 - dl) >= (i + 1)
        adv = ~pred & (lo < hi)
        lo = torch.where(adv, mid + 1, lo)
        hi = torch.where(pred, mid, hi)
    valid = (t >= 0) & (t < end_rank)
    return _emit(valid, lo, j, base_keys, base_vals, ins_keys, ins_vals)


def trip_counts(*sizes: int):
    """The fixed trip count of a full lower bound over each array size,
    as the reference derives the scan kernels' ``steps`` (N), ``isteps``
    (inserts), ``psteps`` (N+1), ``msteps`` (``ins_rank``) and
    ``dsteps`` (``del_pos``)."""
    return [search_lib._steps_for_window(s) for s in sizes]


def rmi_scan_range_reference(
    bounds: torch.Tensor,          # (2,) f32 normalized [lo, hi)
    base_keys: torch.Tensor,       # (N,) sorted normalized f32
    base_vals: torch.Tensor,       # (N,) int32
    live_prefix: torch.Tensor,     # (N+1,) int32 prefix-sum page index
    ins_keys: torch.Tensor,        # (D,) +inf-padded eff. insert keys
    ins_vals: torch.Tensor,        # (D,) int32
    ins_rank: torch.Tensor,        # (D,) int32 merged rank per insert
    *,
    page_size: int,
    max_pages: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of `rmi_scan_range_cuda`: the merged ranks ``(r0, r1)``
    of [lo, hi) and every row at ranks ``r0 + [0, max_pages*page_size)``
    -> ``(keys f32, vals i32, live i32)``, each (max_pages, page_size);
    lanes at or past ``max(r1, r0)`` are masked."""
    n = base_keys.shape[0]
    steps, isteps, psteps, msteps = trip_counts(
        n, ins_keys.shape[0], n + 1, ins_rank.shape[0])
    r = merged_rank_from_prefix(bounds, base_keys, live_prefix, ins_keys,
                                steps=steps, isteps=isteps)
    r0 = r[0]
    r1 = torch.maximum(r[1], r0)
    t = r0 + torch.arange(max_pages * page_size, dtype=torch.int32,
                          device=bounds.device).reshape(max_pages, page_size)
    return scan_rows_from_index(
        t, t < r1, base_keys, base_vals, live_prefix, ins_keys, ins_vals,
        ins_rank, psteps=psteps, msteps=msteps)


def rmi_scan_page_reference(
    starts: torch.Tensor,          # (G,) int32 page start ranks
    base_keys: torch.Tensor,       # (N,) sorted normalized f32
    base_vals: torch.Tensor,       # (N,) int32
    ins_keys: torch.Tensor,        # (Di,) +inf-padded eff. insert keys
    ins_vals: torch.Tensor,        # (Di,) int32
    del_pos: torch.Tensor,         # (Dd,) n-padded dead base positions
    end_rank: torch.Tensor,        # (1,) int32
    *,
    page_size: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of `rmi_scan_page_cuda`: page g holds the merged rows
    at ranks ``starts[g] + [0, page_size)`` -> ``(keys f32, vals i32,
    live i32)``, each (G, page_size); ranks outside [0, end_rank) are
    masked."""
    steps, isteps, dsteps = trip_counts(
        base_keys.shape[0], ins_keys.shape[0], del_pos.shape[0])
    t = starts[:, None] + torch.arange(page_size, dtype=torch.int32,
                                       device=starts.device)[None, :]
    return scan_page_body(t, base_keys, base_vals, ins_keys, ins_vals,
                          del_pos, end_rank[0], steps=steps, isteps=isteps,
                          dsteps=dsteps)


def rmi_sharded_scan_page_reference(
    base_keys: torch.Tensor,       # (S, N) sorted f32, +inf padded
    base_vals: torch.Tensor,       # (S, N) int32
    live_prefix: torch.Tensor,     # (S, N+1) int32, pinned past the true n
    ins_keys: torch.Tensor,        # (S, D) +inf padded
    ins_vals: torch.Tensor,        # (S, D) int32
    ins_rank: torch.Tensor,        # (S, D) int32, big pad
    ls0: torch.Tensor,             # (S,) int32 local rank of lo per shard
    own_lo: torch.Tensor,          # (S,) int32 shard's first stream slot
    own_hi: torch.Tensor,          # (S,) int32 one past its last
    *,
    page_size: int,
    max_pages: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of `rmi_sharded_scan_page_cuda`: for each shard, the
    stream slots ``t`` in [own_lo, own_hi) resolve the shard-local rank
    ``ls0 + t - own_lo`` (int32, wrapping) through the shard's
    prefix-sum page index; other slots come back (+inf, 0, 0).  Returns
    (S, max_pages, page_size) keys f32, vals i32, live i32."""
    psteps, msteps = trip_counts(base_keys.shape[1] + 1, ins_rank.shape[1])
    t_rel = torch.arange(max_pages * page_size, dtype=torch.int32,
                         device=base_keys.device).reshape(max_pages, page_size)
    rows = []
    for s in range(base_keys.shape[0]):
        owner = (t_rel >= own_lo[s]) & (t_rel < own_hi[s])
        rows.append(scan_rows_from_index(
            ls0[s] + t_rel - own_lo[s], owner, base_keys[s], base_vals[s],
            live_prefix[s], ins_keys[s], ins_vals[s], ins_rank[s],
            psteps=psteps, msteps=msteps))
    return tuple(torch.stack(parts) for parts in zip(*rows))


# ---------------------------------------------------------------------------
# §4 hash-model probe and §5 Bloom probe
# ---------------------------------------------------------------------------

def hash_probe_reference(
    q: torch.Tensor,               # (B,) normalized f32 queries
    s0: torch.Tensor,              # (2,) linear stage-0 [w, b] (stage0_flat)
    leaf_w: torch.Tensor,          # (M,)
    leaf_b: torch.Tensor,          # (M,)
    slot_key: torch.Tensor,        # (S,) normalized f32, NaN = empty
    slot_next: torch.Tensor,       # (S,) int32 first overflow node, -1 none
    ovf_key: torch.Tensor,         # (O,) normalized f32
    ovf_next: torch.Tensor,        # (O,) int32 next node, -1 ends
    *,
    n: int,
    num_leaves: int,
    num_slots: int,
    trips: int,
) -> torch.Tensor:
    """Plain twin of `hash_probe_cuda` -> (B,) bool: linear stage-0 ->
    leaf -> position clamped to [0, f32(n - 1)] -> ``slot = int(pos *
    f32(S/n))`` clamped -> primary compare -> ``trips`` fixed steps
    down the overflow chain (the reference's `_hash_kernel`).  Every
    gather index is clipped; NaN and infinite queries find nothing."""
    _, pos = leaf_and_pos(s0, (), leaf_w, leaf_b, q, n=n, num_leaves=num_leaves)
    ratio = torch.tensor(np.float32(num_slots / n), device=q.device)
    slot = torch.clamp(search_lib.to_index(pos * ratio), max=num_slots - 1)
    found = slot_key[slot] == q
    nxt = slot_next[slot]
    last = ovf_key.shape[0] - 1
    for _ in range(trips):
        valid = nxt >= 0
        safe = torch.clamp(nxt, 0, last)
        found = found | (valid & (ovf_key[safe] == q))
        nxt = torch.where(valid, ovf_next[safe], torch.full_like(nxt, -1))
    return found


def mix32(h: torch.Tensor, seed: int) -> torch.Tensor:
    """The reference's uint32 `_mix32` on int64 values in [0, 2**32)."""
    h = h ^ (seed * 0x9E3779B9 & 0xFFFFFFFF)
    h = h ^ (h >> 16)
    h = mul_u32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = mul_u32(h, 0x846CA68B)
    return h ^ (h >> 16)


def bloom_probe_reference(
    queries: torch.Tensor,         # (B,) int32 uint32 bit patterns
    words: torch.Tensor,           # (num_bits/32,) int32 uint32 bit patterns
    *,
    num_bits: int,
    k: int,
) -> torch.Tensor:
    """Plain twin of `bloom_probe_cuda` -> (B,) bool: ``h1 = mix32(q,
    1)``, ``h2 = mix32(q, 2) | 1``, and for i < k bit ``((h1 + i*h2) mod
    2**32) mod num_bits`` must be set (the reference's `_bloom_kernel`).
    The uint32 arithmetic runs in int64 masked to 32 bits."""
    q = queries.to(torch.int64) & 0xFFFFFFFF
    h1 = mix32(q, 1)
    h2 = mix32(q, 2) | 1
    hit = torch.ones(q.shape, dtype=torch.bool, device=q.device)
    for i in range(k):
        bit = ((h1 + i * h2) & 0xFFFFFFFF) % num_bits
        word = words[bit >> 5]
        hit &= ((word >> (bit & 31).to(word.dtype)) & 1) != 0
    return hit


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """(B, Hq, Sq, D) GQA attention over (B, Hkv, Sk, D) keys and values,
    float32 softmax, no tiling: the flash-attention kernel's plain
    version (the reference's `mha_reference`; it holds the (Sq, Sk)
    scores in memory).  Causal needs Sq == Sk."""
    return _attend(_masked_scores(q, k, causal), q, k, v)


def mha_reference_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True):
    """`mha_reference`'s output and each row's log-sum-exp of the scaled,
    masked scores (float32, (B, Hq, Sq)): the plain version of
    `flash_attention_cuda(..., return_lse=True)`."""
    s_ = _masked_scores(q, k, causal)
    return _attend(s_, q, k, v), torch.logsumexp(s_, dim=-1)


def _masked_scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """(B, Hq, Sq, Sk) float32 scores (q . k) / sqrt(D), masked with -1e30
    above the diagonal when causal (which needs Sq == Sk)."""
    s, d = q.shape[2], q.shape[3]
    if causal and k.shape[2] != s:
        raise ValueError(f"causal attention needs Sq == Sk (got Sq={s}, Sk={k.shape[2]})")
    kr = torch.repeat_interleave(k, q.shape[1] // k.shape[1], dim=1)
    s_ = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr.float()) / np.sqrt(d)
    if causal:
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
        s_ = torch.where(mask[None, None], s_, -1e30)
    return s_


def _attend(s_: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor) -> torch.Tensor:
    """softmax(scores) V in float32, in q's dtype."""
    vr = torch.repeat_interleave(v, q.shape[1] // k.shape[1], dim=1)
    p = torch.softmax(s_, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr.float()).to(q.dtype)


def mha_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           out: torch.Tensor, lse: torch.Tensor, d_out: torch.Tensor, *,
                           causal: bool = True):
    """(dq, dk, dv) in q's dtype, the plain version of
    `flash_attention_bwd_cuda`: the explicit formulas in float32 from the
    same inputs, with P = exp(s - lse), dV = P^T dO, dP = dO V^T,
    dS = P * (dP - rowsum(dO * O)), dQ = dS K / sqrt(D) and
    dK = dS^T Q / sqrt(D), the key and value gradients summed over each
    GQA group.  Keys may be as many as the queries or, not causal, any
    number."""
    b, hq, _, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = 1.0 / np.sqrt(d)
    p = torch.exp(_masked_scores(q, k, causal) - lse.float()[..., None])
    dof = d_out.float()
    kr = torch.repeat_interleave(k, group, dim=1).float()
    vr = torch.repeat_interleave(v, group, dim=1).float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vr)
    di = (dof * out.float()).sum(dim=-1)
    ds = p * (dp - di[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale

    def by_group(t):
        return t.reshape(b, hkv, group, sk, d).sum(dim=2)

    return dq.to(q.dtype), by_group(dk).to(k.dtype), by_group(dv).to(v.dtype)
