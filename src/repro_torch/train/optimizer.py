"""AdamW with float32 master weights (the reference's
`repro/train/optimizer.py`, no torch.optim).

State layout (all float32 but ``count``): ``{"m", "v", "master",
"count"}``, where m, v and master mirror the parameter tree (``blocks``
a list of dicts) and ``count`` is an int32 scalar tensor.  Parameters
stay in their dtype for compute; the master copy is the source of
truth.  The arithmetic is the reference's, operation for operation, in
float32: the same roundings, so the two agree to float32 rounding.
`adamw_update` writes the parameters and the state in place under
``torch.no_grad()`` (the reference returns new arrays); the returned
trees hold the same tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.distributed.fault_tolerance import _flatten, _unflatten
from repro_torch.distributed.sharding import is_dtensor, placed_like, replicate


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def tree_leaves(tree) -> List[Any]:
    """The leaves of a nested dict / list / tuple in JAX's order (dict
    keys sorted), the order the checkpoints store them in."""
    return [leaf for _, leaf in _flatten(tree)]


def tree_map(fn, tree):
    """``tree``'s structure with ``fn`` applied to each leaf."""
    return _unflatten(tree, map(fn, tree_leaves(tree)))


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_frac``, float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * step / max(1, cfg.warmup_steps)
    progress = torch.clamp(
        (step - cfg.warmup_steps) / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    # the cosine of the float32 angle, correctly rounded (float32 cos on
    # the CPU can be an ulp off, which 1 + cos near -1 magnifies)
    cos_angle = torch.cos((math.pi * progress).double()).float()
    cos = cfg.lr * (
        cfg.min_lr_frac
        + (1 - cfg.min_lr_frac) * 0.5 * (1 + cos_angle)
    )
    return torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params, shardings=None) -> Dict[str, Any]:
    """Zero moments, a float32 copy of every parameter, ``count`` 0, on
    the parameters' devices.  With DTensor parameters and ``shardings``
    (a parameter-shaped tree of the state's `NamedSharding`s,
    `distributed.sharding.opt_state_shardings(params, cfg, mesh)`: ZeRO-1)
    m, v and master are placed by it and ``count`` is replicated; plain
    parameters (a mesh of one) keep plain state."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    count = torch.zeros((), dtype=torch.int32, device=dev)
    return {
        "m": _placed(lambda p: torch.zeros_like(p, dtype=torch.float32), params, shardings),
        "v": _placed(lambda p: torch.zeros_like(p, dtype=torch.float32), params, shardings),
        "master": _placed(lambda p: p.detach().to(torch.float32, copy=True), params,
                          shardings),
        "count": placed_like(count, leaves[0]) if leaves else count,
    }


def _placed(fn, params, shardings):
    """``fn`` of every parameter, a DTensor result redistributed to its
    sharding's placements."""
    if shardings is None:
        return tree_map(fn, params)
    out = [fn(p) for p in tree_leaves(params)]
    out = [x.redistribute(x.device_mesh, sh.placements()) if is_dtensor(x) else x
           for x, sh in zip(out, tree_leaves(shardings))]
    return _unflatten(params, iter(out))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares;
    on DTensor leaves each sum is reduced over its shards, so the norm is
    one replicated float32 scalar."""
    sums = [replicate(torch.sum(torch.square(g.to(torch.float32)))) for g in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def adamw_update(
    cfg: OptimizerConfig, params, grads, state
) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step with global-norm clipping: (params, state,
    {"grad_norm", "lr"}), params and state updated in place.  DTensor
    gradients are first redistributed to their state's placements (a
    partial sum reduce-scattered into ZeRO-1's shards), and each new
    master back to its parameter's before the copy."""
    count = state["count"] + 1
    t = count.to(torch.float32)
    lr = lr_schedule(cfg, count)
    grads = _unflatten(grads, iter([placed_like(g, m) for g, m in zip(
        tree_leaves(grads), tree_leaves(state["m"]))]))
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    bc1 = 1 - cfg.beta1 ** t
    bc2 = 1 - cfg.beta2 ** t
    for p, g, m, v, master in zip(tree_leaves(params), tree_leaves(grads),
                                  tree_leaves(state["m"]), tree_leaves(state["v"]),
                                  tree_leaves(state["master"])):
        g = g.to(torch.float32) * scale
        m.mul_(cfg.beta1).add_((1 - cfg.beta1) * g)
        v.mul_(cfg.beta2).add_((1 - cfg.beta2) * g * g)
        step = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
        step.add_(cfg.weight_decay * master)
        master.sub_(lr * step)
        p.copy_(placed_like(master, p))
    state = {"m": state["m"], "v": state["v"], "master": state["master"], "count": count}
    return params, state, {"grad_norm": gnorm, "lr": lr}
