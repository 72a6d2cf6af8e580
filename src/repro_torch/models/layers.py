"""Shared neural-net layers: norms, RoPE, SwiGLU, embeddings, logits,
the loss and the remat policy.

Plain functions over explicit parameter tensors, as in the reference
(`repro/models/layers.py`), with each rounding where the reference
rounds: `rmsnorm` casts back to x's dtype before the scale, and
`apply_rope` casts cos and sin to x's dtype before the multiply.  The
reference's remat policies become `torch.utils.checkpoint` around
a whole block or its two halves (`remat`).  `pin_dp` is the reference's
sharding hint at the top of every layer loop's body: the identity on a
plain tensor (every tensor on a mesh of one rank) or without an active
mesh (`distributed.sharding.maybe_constrain`).  On DTensor leaves (the
partitioned train step) the same functions run under DTensor dispatch:
`embed` and `cross_entropy` on a vocabulary sharded over ``model``,
RoPE's angles replicated on the mesh.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import is_dtensor, maybe_constrain, placed_like, unsplit_dim


def pin_dp(x: torch.Tensor) -> torch.Tensor:
    """Pin the batch dim of an activation to the data-parallel mesh axes
    (the reference's `pin_dp`): a no-op where no mesh is active."""
    return maybe_constrain(x, "dp", *([None] * (x.ndim - 1)))


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def remat_policy_of(cfg) -> str:
    """What a rematerialised block keeps (reference `remat_policy_of`):
    ``"full"`` saves nothing inside a block, ``"block_io"`` saves the
    attention and FFN outputs (the reference's names ``attn_out`` and
    ``ffn_out``)."""
    if cfg.remat_policy not in ("full", "block_io"):
        raise ValueError(f"unknown remat policy: {cfg.remat_policy}")
    return cfg.remat_policy


def remat(fn: Callable) -> Callable:
    """``fn`` recomputed in the backward pass instead of keeping its
    activations: non-reentrant `torch.utils.checkpoint`, which saves
    only ``fn``'s inputs."""
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)).to(dt) * scale


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, D); positions: (S,) or broadcastable to x's S dim."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                       # (D/2,)
    angles = positions[..., :, None].float() * freqs             # (S, D/2)
    cos = placed_like(torch.cos(angles).to(x.dtype), x)
    sin = placed_like(torch.sin(angles).to(x.dtype), x)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.stack([o1, o2], dim=-1).reshape(x.shape)


# ---------------------------------------------------------------------------
# Dense / SwiGLU
# ---------------------------------------------------------------------------

def init_dense(generator: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype) -> torch.Tensor:
    """(in, out) weight, N(0, 1/in), drawn in float32 on the generator's
    device and cast to ``dtype``."""
    w = torch.randn((in_dim, out_dim), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * (1.0 / math.sqrt(in_dim))).to(dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    return (F.silu(g) * u) @ w_down


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------

def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The table's rows at ``tokens``; a DTensor table (its vocabulary
    sharded over ``model``) is gathered whole first and read through
    `F.embedding` (the masked partial sum DTensor's rule would give has
    no way back for its gradient)."""
    if is_dtensor(table):
        return F.embedding(tokens.long(), unsplit_dim(table, 0))
    return table[tokens.long()]


def logits_from_hidden(h: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Tied output head: h (..., D) @ table^T (V, D) -> (..., V)."""
    return h @ table.T


def cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor | None = None,
    z_loss: float = 1e-4,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Stable cross-entropy in float32 with a z-loss, the mean over the
    masked tokens (the denominator clamped at 1); returns the loss and
    the ``loss`` and ``nll`` metrics.  The label's logit is a gather
    where the reference contracts with a one-hot: the one-hot sum adds
    exact zeros, so the result is the same.  DTensor logits (the
    vocabulary sharded over ``model``) take the reference's one-hot
    contraction, whose sum over shards is exact too."""
    lf = logits.float()
    mx = lf.amax(dim=-1, keepdim=True).detach()
    sumexp = torch.exp(lf - mx).sum(dim=-1)
    lse = torch.log(sumexp) + mx[..., 0]
    if is_dtensor(lf):
        vocab = placed_like(torch.arange(lf.shape[-1], device=lf.device), lf)
        ll = (lf * (labels.long()[..., None] == vocab)).sum(dim=-1)
    else:
        ll = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    per_tok = nll + z_loss * lse ** 2
    m = torch.ones_like(nll) if mask is None else mask.float()
    denom = torch.clamp(m.sum(), min=1.0)
    loss = (per_tok * m).sum() / denom
    return loss, {"loss": loss, "nll": (nll * m).sum() / denom}
