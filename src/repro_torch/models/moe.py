"""Mixture-of-Experts FFN with two dispatch strategies (the reference's
`repro/models/moe.py`, function for function).

`dispatch="sort"` — the standard sort-based capacity dispatch: tokens
are sorted by assigned expert, the first C per expert fill its buffer,
the rest drop.

`dispatch="cdf"` — the paper's Hash-Model index (§4) applied to MoE:
slot position inside an expert's buffer is ``⌊F̂(score)·C⌋`` where F̂ is
the per-batch empirical CDF of that expert's router scores.  Collisions
drop.  The reference sorts on the float32 key ``expert * 1e6 + score``,
in which the score rounds away from expert ~16 up, so there the slots
follow arrival order; the port forms the same key and mirrors it
(ROADMAP queue C 23).

Expert compute is a dense batched product over (G, E, C, D) buffers.
The group axis G is the reference's one group per data-parallel shard
of the active mesh (`distributed.sharding.use_mesh`); without one it is
1, and on plain tensors the reference's sharding constraints
(`maybe_constrain`) are the identity.  On DTensors (the partitioned
train step) they redistribute: each rank routes, dispatches and
combines its own data shard's group (`sharding.on_local_groups`, the
same integer routing on every model rank), the buffers go to experts
over ``model`` (a local slice), the expert products contract them with
the E-sharded expert leaves without a collective, and the expert rows
are gathered over ``model`` again for the combine.  The aux loss and
the drop fraction are global means, replicated.

Every step is deterministic on the card, so a repeat, and the recompute
under `torch.utils.checkpoint`, routes the same way: stable sorts, a
buffer with one extra row that takes the dropped slots (the reference's
out-of-range destination E·C, which a torch index op must never see),
``scatter_reduce_("amin")`` for the collision winners, and a combine that
gathers each token's K rows and adds them one after another in the
activation dtype, in the order the reference's segment sum meets them.
Nothing here reads a value back to the host.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import (
    active_mesh,
    axis_sizes,
    maybe_constrain,
    placed_like,
    replicate,
)


def moe_router_init(generator: torch.Generator, d_model: int, num_experts: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """(D, E) router weight, N(0, 1/D), drawn in float32 on the
    generator's device and cast to ``dtype``."""
    w = torch.randn((d_model, num_experts), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * (1.0 / math.sqrt(d_model))).to(dtype)


def moe_expert_init(generator: torch.Generator, num_experts: int, in_dim: int,
                    out_dim: int, dtype: torch.dtype) -> torch.Tensor:
    """(E, in, out) expert weights, N(0, 1/in): one float32 draw for the
    whole leaf, cast to ``dtype`` (the reference draws each expert with
    `init_dense`)."""
    w = torch.randn((num_experts, in_dim, out_dim), generator=generator,
                    dtype=torch.float32, device=generator.device)
    return (w * (1.0 / math.sqrt(in_dim))).to(dtype)


def _top_k(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest scores of each row and their indices, the lower
    index first among equal scores as `jax.lax.top_k` takes them
    (`torch.topk` promises no order on ties)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _segment_starts(sorted_ids: torch.Tensor) -> torch.Tensor:
    """Position of each entry within its run of equal ids (ids sorted)."""
    n = sorted_ids.shape[0]
    iota = torch.arange(n, device=sorted_ids.device)
    is_start = torch.ones(n, dtype=torch.bool, device=sorted_ids.device)
    is_start[1:] = sorted_ids[1:] != sorted_ids[:-1]
    seg_start = torch.cummax(torch.where(is_start, iota, 0), dim=0).values
    return iota - seg_start


def _token_of_entry(t: int, k: int, device) -> torch.Tensor:
    """The token of each (token, k) entry in row-major order: 0 0 .. 1 1 .."""
    return torch.arange(t, device=device)[:, None].expand(t, k).reshape(-1)


def _scatter_rows(rows: torch.Tensor, dest: torch.Tensor, slots: int) -> torch.Tensor:
    """(slots, D) buffer with ``rows[i]`` at ``dest[i]``; a destination of
    ``slots`` (a dropped entry) lands in an extra row that is cut off."""
    buf = torch.zeros((slots + 1, rows.shape[-1]), dtype=rows.dtype, device=rows.device)
    return buf.index_put((dest,), rows)[:slots]


def sort_dispatch(
    x: torch.Tensor,           # (T, D) tokens
    expert_idx: torch.Tensor,  # (T, K) chosen experts
    gate: torch.Tensor,        # (T, K) combine weights
    num_experts: int,
    capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(buffers (E, C, D), dest, st, sg): entries in a stable sort by
    expert, the first C of each expert kept; a dropped entry's ``dest``
    is E·C and its ``sg`` 0."""
    t, k = expert_idx.shape
    flat_e = expert_idx.reshape(-1)
    flat_tok = _token_of_entry(t, k, x.device)
    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], flat_tok[order], gate.reshape(-1)[order]
    pos_in_e = _segment_starts(se)
    keep = pos_in_e < capacity
    dest = torch.where(keep, se * capacity + pos_in_e, num_experts * capacity)
    buffers = _scatter_rows(x[st], dest, num_experts * capacity)
    return buffers.reshape(num_experts, capacity, x.shape[-1]), dest, st, sg * keep


def cdf_dispatch_slots(
    scores_for_expert: torch.Tensor,  # (T,) router score of each token for its expert
    expert_of: torch.Tensor,          # (T,) expert id per (token, k) slot
    num_experts: int,
    capacity: int,
    num_quantiles: int = 8,
) -> torch.Tensor:
    """Hash-Model slot assignment: slot = ⌊F̂_e(score)·C⌋ with F̂_e the
    empirical CDF of this batch's scores for expert e, clipped to
    [0, C).  ``num_quantiles`` is unused, as in the reference."""
    t = scores_for_expert.shape[0]
    # the reference's float32 key; expert * 1e6 is exact for E <= 64
    key = expert_of.to(torch.float32) * 1e6 + scores_for_expert
    order = torch.argsort(key, stable=True)
    pos_sorted = _segment_starts(expert_of[order])
    counts = torch.zeros(num_experts, dtype=torch.int64, device=expert_of.device)
    counts.scatter_add_(0, expert_of, torch.ones_like(expert_of))
    pos_in_e = torch.empty(t, dtype=torch.int64, device=expert_of.device)
    pos_in_e[order] = pos_sorted
    denom = torch.clamp(counts[expert_of], min=1).to(torch.float32)
    frac = pos_in_e.to(torch.float32) / denom
    return torch.clamp((frac * capacity).to(torch.int32), 0, capacity - 1).long()


def _num_dispatch_groups(t: int) -> int:
    """Group-local dispatch: one group per data-parallel shard, the
    product of the active mesh's pod and data dims (1 when no mesh is
    active, or when they do not divide the tokens).  The mesh is a
    `DeviceMesh` or a duck-typed one with a ``shape`` dict, as the
    sharding rules read it."""
    m = active_mesh()
    if m is None:
        return 1
    sizes = axis_sizes(m)
    g = math.prod(sizes.get(ax, 1) for ax in ("pod", "data"))
    return g if t % g == 0 else 1


def _dispatch_one_group(xt, scores, gate, eidx, *, num_experts, capacity, dispatch):
    """Dispatch for one token group: (buffers (E, C, D), dest, st, sg)."""
    t, d = xt.shape
    e, k = num_experts, eidx.shape[1]
    if dispatch != "cdf":
        return sort_dispatch(xt, eidx, gate, e, capacity)
    # paper §4: the CDF hash places each (token, k) at a learned slot;
    # the placement carries no gradient (the gate does)
    flat_e = eidx.reshape(-1)
    flat_score = torch.gather(scores, 1, eidx).reshape(-1).detach()
    slots = cdf_dispatch_slots(flat_score, flat_e, e, capacity)
    flat_tok = _token_of_entry(t, k, xt.device)
    dest = flat_e * capacity + slots
    # collision resolution: the first writer wins, the others drop
    entry = torch.arange(t * k, device=xt.device)
    winner = torch.full((e * capacity,), t * k, dtype=torch.int64, device=xt.device)
    winner.scatter_reduce_(0, dest, entry, "amin", include_self=True)
    keep = winner[dest] == entry
    dest = torch.where(keep, dest, e * capacity)
    buffers = _scatter_rows(xt[flat_tok], dest, e * capacity)
    return buffers.reshape(e, capacity, d), dest, flat_tok, gate.reshape(-1) * keep


def _scores(xt: torch.Tensor, router_w: torch.Tensor) -> torch.Tensor:
    """(T, E) float32 softmax router scores of tokens ``xt`` (T, D)."""
    return torch.softmax((xt @ router_w).to(torch.float32), dim=-1)


def _gates(scores: torch.Tensor, k: int, dtype: torch.dtype):
    """(gate (T, K) renormalised and cast to ``dtype``, expert ids (T, K))
    of each row of ``scores``."""
    gate, eidx = _top_k(scores, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    # the token<->expert exchange rides the tokens' dtype, as in the reference
    return gate.to(dtype), eidx


def _experts(buffers, w_gate, w_up, w_down) -> torch.Tensor:
    """Dense batched SwiGLU of every expert over its (G, E, C, D) buffer."""
    g = torch.einsum("gecd,edf->gecf", buffers, w_gate)
    u = torch.einsum("gecd,edf->gecf", buffers, w_up)
    return torch.einsum("gecf,efd->gecd", F.silu(g) * u, w_down)


def _combine_one(y: torch.Tensor, dest, st, sg, tokens: int) -> torch.Tensor:
    """(tokens, D): each token's kept expert rows of ``y`` (E·C, D),
    weighted by ``sg`` and added one at a time in entry order (the
    reference's segment sum); a dropped entry reads a zero row."""
    d = y.shape[-1]
    rows = torch.cat([y, y.new_zeros((1, d))])
    by_token = torch.argsort(st, stable=True).reshape(tokens, -1)   # (T, K)
    picked = rows[dest[by_token]] * sg[by_token][..., None].to(y.dtype)
    out = picked[:, 0]
    for j in range(1, picked.shape[1]):
        out = out + picked[:, j]
    return out


def _dispatch_groups(xg, scores, *, k, num_experts, capacity, dispatch):
    """Each group's routing and dispatch: tokens ``xg`` (G, Tg, D) and
    their ``scores`` (G, Tg, E) -> (buffers (G, E, C, D), dest, st, sg
    (G, Tg·K), each expert's top-1 count (G, E) in float32)."""
    out = []
    for xx, ss in zip(xg, scores):
        gate, eidx = _gates(ss, k, xx.dtype)
        top1 = eidx[:, 0]
        counts = torch.zeros(num_experts, dtype=torch.float32, device=xx.device).scatter_add_(
            0, top1, torch.ones_like(top1, dtype=torch.float32))
        out.append((*_dispatch_one_group(xx, ss, gate, eidx, num_experts=num_experts,
                                         capacity=capacity, dispatch=dispatch), counts))
    return tuple(torch.stack(column) for column in zip(*out))


def _combine_groups(y, dest, st, sg, *, tokens):
    """Each group's combine: expert rows ``y`` (G, E, C, D) -> (G·tokens,
    D), the groups' tokens in order (the rows are joined here, where the
    groups are local, so no view of a sharded dim meets the gradient)."""
    _, e, c, d = y.shape
    return torch.cat([_combine_one(yy.reshape(e * c, d), dd, tt, ss, tokens)
                      for yy, dd, tt, ss in zip(y, dest, st, sg)])


def moe_ffn(
    x: torch.Tensor,         # (B, S, D)
    router_w: torch.Tensor,  # (D, E)
    w_gate: torch.Tensor,    # (E, D, F)
    w_up: torch.Tensor,      # (E, D, F)
    w_down: torch.Tensor,    # (E, F, D)
    *,
    experts_per_token: int,
    capacity_factor: float = 1.25,
    dispatch: str = "sort",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(B, S, D) output in x's dtype and ``{"moe_aux_loss",
    "moe_drop_frac"}`` (float32 scalars on x's device)."""
    b, s, d = x.shape
    e = router_w.shape[1]
    k = experts_per_token
    t = b * s
    xt = x.reshape(t, d)
    scores = _scores(xt, router_w)

    groups = _num_dispatch_groups(t)
    tg = t // groups
    capacity = max(1, int(tg * k / e * capacity_factor))

    xg = maybe_constrain(xt.reshape(groups, tg, d), "dp", None, None)
    buffers, dest, st, sg, top1_counts = sharding.on_local_groups(
        functools.partial(_dispatch_groups, k=k, num_experts=e, capacity=capacity,
                          dispatch=dispatch),
        xg, maybe_constrain(scores.reshape(groups, tg, e), "dp", None, None), outputs=5)
    # buffers (G, E, C, D): groups over dp, experts over model (EP)
    buffers = maybe_constrain(buffers, "dp", "tp", None, None)

    y = maybe_constrain(_experts(buffers, w_gate, w_up, w_down), "dp", "tp", None, None)

    # ---- combine (per group), on every expert's rows ------------------
    y = maybe_constrain(y, "dp", None, None, None)
    out = maybe_constrain(sharding.on_local_groups(
        functools.partial(_combine_groups, tokens=tg), y, dest, st, sg), "dp", None)
    # back in the tokens' own placement (groups over data can split the
    # batch rows where they cannot: 2 rows over 4 data ranks)
    out = placed_like(out, xt)

    # aux: load-balance loss (Switch-style, top-1 density) + drop fraction,
    # global means
    density = top1_counts.sum(dim=0) / t
    router_prob = scores.mean(dim=0)
    aux_loss = e * torch.sum(density * router_prob)
    dropped = 1.0 - (sg > 0).to(torch.float32).mean()
    return out.reshape(b, s, d).to(x.dtype), {
        "moe_aux_loss": replicate(aux_loss),
        "moe_drop_frac": replicate(dropped),
    }
