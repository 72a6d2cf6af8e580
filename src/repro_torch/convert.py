"""Carry the reference package's state across into the port.

The reference's `RMIndex` and `IndexSnapshot` hold their state in NumPy
attributes, so these converters read them by duck typing and never
import the reference.  The ``snapshot-*.npz`` and ``router.npz`` files are the
second route across: both packages write the same formats and load each
other's files (`IndexSnapshot.save` / `load`, and a sharded service's
directory through `ShardedIndexService.save` / `load`).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.keys import KeySet
from repro_torch.core.rmi import RMIConfig, RMIndex
from repro_torch.index_service.router import LearnedRouter
from repro_torch.index_service.snapshot import IndexSnapshot


def config_from_reference(cfg) -> RMIConfig:
    return RMIConfig(
        num_leaves=int(cfg.num_leaves),
        stage0_hidden=tuple(int(h) for h in cfg.stage0_hidden),
        stage0_train_steps=int(cfg.stage0_train_steps),
        stage0_sample=cfg.stage0_sample,
        stage0_lr=float(cfg.stage0_lr),
        hybrid_threshold=cfg.hybrid_threshold,
        seed=int(cfg.seed),
    )


def index_from_reference(idx) -> RMIndex:
    """A reference `RMIndex` (scalar keys) as the port's `RMIndex`."""
    if int(idx.in_dim) != 1:
        raise ValueError("the port supports scalar keys only")
    arr = lambda a, dt: np.array(a, dtype=dt)  # noqa: E731 (own copies)
    return RMIndex(
        config=config_from_reference(idx.config),
        n=int(idx.n),
        num_leaves=int(idx.num_leaves),
        in_dim=1,
        stage0_params={k: arr(v, np.float32) for k, v in idx.stage0_params.items()},
        leaf_w=arr(idx.leaf_w, np.float32),
        leaf_b=arr(idx.leaf_b, np.float32),
        err_lo=arr(idx.err_lo, np.float32),
        err_hi=arr(idx.err_hi, np.float32),
        sigma=arr(idx.sigma, np.float32),
        is_btree=arr(idx.is_btree, bool),
        seg_lo=arr(idx.seg_lo, np.int32),
        seg_hi=arr(idx.seg_hi, np.int32),
        max_window=int(idx.max_window),
    )


def keyset_from_reference(ks) -> KeySet:
    return KeySet(raw=np.array(ks.raw, np.float64),
                  norm=np.array(ks.norm, np.float32),
                  lo=float(ks.lo), hi=float(ks.hi))


def snapshot_from_reference(snap, device=None) -> IndexSnapshot:
    """A reference `IndexSnapshot` as the port's, its tensors on
    ``device`` (None = "cuda").  Snapshots with a Bloom screen are
    refused: the screen is not ported yet."""
    if getattr(snap, "bloom", None) is not None:
        raise NotImplementedError("Bloom screens are not ported yet")
    return IndexSnapshot(
        version=int(snap.version),
        keys=keyset_from_reference(snap.keys),
        index=index_from_reference(snap.index),
        vals=None if snap.vals is None else np.array(snap.vals),
        max_dup_run=int(snap.max_dup_run),
        device=device,
    )


def router_from_reference(router) -> LearnedRouter:
    """A reference `LearnedRouter` as the port's: the same boundaries,
    weight and bias (the routing statistics start afresh)."""
    return LearnedRouter(np.array(router.boundaries, np.float64),
                         weight=float(router.weight), bias=float(router.bias))
