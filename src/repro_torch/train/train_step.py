"""Training step factory: loss -> grads -> (optional microbatch
accumulation) -> AdamW (the reference's `repro/train/train_step.py`).

Gradients are `torch.autograd.grad` of the loss with respect to
detached aliases of the parameters (no copy; the parameters themselves
never require grad).  Microbatches are a Python loop over equal slices
of the batch's leading axis that accumulates each microbatch's
gradients into ``accum_dtype`` buffers and then divides by their
number, as the reference's `lax.scan` does; the loss and metrics are
the microbatches' means.  ``compress_fn`` is the hook between
accumulation and the optimizer (for instance a closure over
`distributed.collectives.make_compressed_allreduce`).

The same function is the partitioned step on DTensor parameters and a
batch placed by `distributed.sharding.place_batch`: every op runs under
DTensor dispatch, microbatch i holds the global rows the reference's
reshape gives it (`sharding.batch_rows`), each accumulator sits in its
parameter's placements, and the optimizer moves each gradient to its
state's placements.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.distributed.fault_tolerance import _unflatten
from repro_torch.distributed.sharding import batch_rows, placed_like, replicate
from repro_torch.train.optimizer import (
    OptimizerConfig,
    adamw_update,
    tree_leaves,
    tree_map,
)


def loss_and_grads(loss_fn: Callable, params, batch):
    """(loss, metrics, grads) of ``loss_fn(params, batch)``, the
    gradients a tree shaped as ``params`` in their dtypes, everything
    detached.  On DTensor parameters the loss and metrics are
    replicated on the mesh (a partial sum reduced) and each gradient
    comes in whatever placement its backward gives (a partial sum over
    the data axis for a replicated weight)."""
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, metrics = loss_fn(_unflatten(params, iter(live)), batch)
    loss = replicate(loss)
    grads = torch.autograd.grad(loss, live)
    metrics = {k: replicate(v.detach()) for k, v in metrics.items()}
    return loss.detach(), metrics, _unflatten(params, iter(grads))


def make_train_step(
    loss_fn: Callable,
    opt_cfg: OptimizerConfig,
    *,
    microbatches: int = 1,
    accum_dtype: torch.dtype = torch.float32,
    compress_fn: Optional[Callable] = None,
) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``; ``loss_fn(params, batch) -> (loss, metrics)``.
    The parameters and the optimizer state are updated in place."""

    def train_step(params, opt_state, batch):
        if microbatches > 1:
            b = next(iter(batch.values())).shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} does not split into {microbatches} microbatches")
            n = b // microbatches
            acc = tree_map(lambda p: torch.zeros_like(p, dtype=accum_dtype), params)
            losses, metricses = [], []
            for i in range(microbatches):
                mb = {k: batch_rows(x, i * n, (i + 1) * n) for k, x in batch.items()}
                loss, metrics, grads = loss_and_grads(loss_fn, params, mb)
                for a, g in zip(tree_leaves(acc), tree_leaves(grads)):
                    a.add_(placed_like(g.to(accum_dtype), a))
                del grads
                losses.append(loss)
                metricses.append(metrics)
            for a in tree_leaves(acc):
                a.div_(microbatches)
            grads = acc
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in metricses]).mean() for k in metricses[0]}
        else:
            loss, metrics, grads = loss_and_grads(loss_fn, params, batch)

        if compress_fn is not None:
            grads = compress_fn(grads)

        params, opt_state, opt_metrics = adamw_update(opt_cfg, params, grads, opt_state)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step
