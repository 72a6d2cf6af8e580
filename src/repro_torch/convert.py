"""Carry the reference package's state across into the port.

The reference's `RMIndex` and `IndexSnapshot` hold their state in NumPy
attributes, and its LM parameters are a pytree the caller turns into
NumPy arrays, so these converters read them by duck typing and never
import the reference.  The ``snapshot-*.npz`` and ``router.npz`` files are the
second route across: both packages write the same formats and load each
other's files (`IndexSnapshot.save` / `load`, and a sharded service's
directory through `ShardedIndexService.save` / `load`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.bloom import BloomFilter
from repro_torch.core.keys import KeySet, VectorKeySet
from repro_torch.core.learned_hash import HashMap
from repro_torch.core.rmi import RMIConfig, RMIndex
from repro_torch.device import resolve_device
from repro_torch.index_service.router import LearnedRouter
from repro_torch.index_service.snapshot import IndexSnapshot
from repro_torch.models.layers import dtype_of


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
    """A reference `RMIndex` (scalar or vector keys) as the port's
    `RMIndex`."""
    arr = lambda a, dt: np.array(a, dtype=dt)  # noqa: E731 (own copies)
    return RMIndex(
        config=config_from_reference(idx.config),
        n=int(idx.n),
        num_leaves=int(idx.num_leaves),
        in_dim=int(idx.in_dim),
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


def vector_keyset_from_reference(vks) -> VectorKeySet:
    """A reference `VectorKeySet` (tokenized strings) as the port's."""
    return VectorKeySet(raw=np.array(vks.raw, np.float64),
                        norm=np.array(vks.norm, np.float32), scale=float(vks.scale))


def gru_params_from_reference(params) -> dict:
    """A reference learned-Bloom GRU's parameters (a dict of arrays,
    `learned_bloom.gru_train`'s output) as the port's: float32 NumPy
    copies under the same names, which `learned_bloom.gru_logits` takes
    on any device."""
    return {k: np.array(v, np.float32) for k, v in params.items()}


def bloom_from_reference(bf) -> BloomFilter:
    """A reference `BloomFilter` as the port's (its own copy of the
    words)."""
    return BloomFilter(num_bits=int(bf.num_bits), num_hashes=int(bf.num_hashes),
                       words=np.array(bf.words, np.uint32))


def hashmap_from_reference(hm) -> HashMap:
    """A reference `HashMap` as the port's (its own copies of the
    arrays)."""
    return HashMap(
        num_slots=int(hm.num_slots),
        slot_key=np.array(hm.slot_key, np.float64),
        slot_next=np.array(hm.slot_next, np.int64),
        ovf_key=np.array(hm.ovf_key, np.float64),
        ovf_next=np.array(hm.ovf_next, np.int64),
        max_chain=int(hm.max_chain),
        num_conflicts=int(hm.num_conflicts),
        num_empty=int(hm.num_empty),
    )


def snapshot_from_reference(snap, device=None) -> IndexSnapshot:
    """A reference `IndexSnapshot` as the port's, its tensors on
    ``device`` (None = "cuda"), its Bloom screen carried across."""
    bloom = getattr(snap, "bloom", None)
    return IndexSnapshot(
        version=int(snap.version),
        keys=keyset_from_reference(snap.keys),
        index=index_from_reference(snap.index),
        vals=None if snap.vals is None else np.array(snap.vals),
        bloom=None if bloom is None else bloom_from_reference(bloom),
        max_dup_run=int(snap.max_dup_run),
        device=device,
    )


def router_from_reference(router) -> LearnedRouter:
    """A reference `LearnedRouter` as the port's: the same boundaries,
    weight and bias (the routing statistics start afresh)."""
    return LearnedRouter(np.array(router.boundaries, np.float64),
                         weight=float(router.weight), bias=float(router.bias))


def _lm_tensor(a, dtype, device) -> torch.Tensor:
    # bfloat16 NumPy arrays (ml_dtypes) have no torch.from_numpy route;
    # float32 holds every bfloat16 value, so the trip is exact both ways
    f32 = np.ascontiguousarray(np.asarray(a).astype(np.float32))
    return torch.from_numpy(f32).to(device=device, dtype=dtype)


def lm_params_from_reference(params, cfg, device=None) -> dict:
    """The reference's dense-LM parameter pytree (NumPy arrays, the layer
    axis first in ``blocks``) as the port's parameters: one dict per
    layer, in ``cfg.dtype`` on ``device`` (None = "cuda")."""
    dev = resolve_device(device)
    dt = dtype_of(cfg.dtype)
    blocks = params["blocks"]
    layers = int(np.asarray(blocks["wq"]).shape[0])
    if layers != cfg.num_layers:
        raise ValueError(f"{layers} stacked layers, config has {cfg.num_layers}")
    return {
        "embed": _lm_tensor(params["embed"], dt, dev),
        "blocks": [{name: _lm_tensor(np.asarray(a)[i], dt, dev)
                    for name, a in blocks.items()} for i in range(layers)],
        "final_norm": _lm_tensor(params["final_norm"], dt, dev),
    }


def opt_state_from_reference(state, cfg, device=None) -> dict:
    """The reference's AdamW state (``m``, ``v`` and ``master`` stacked as
    its parameters are, plus ``count``) as the port's: the same trees one
    dict per layer, float32 on ``device`` (None = "cuda"), and ``count``
    an int32 scalar tensor."""
    dev = resolve_device(device)
    f32 = dataclasses.replace(cfg, dtype="float32")
    out = {name: lm_params_from_reference(state[name], f32, dev)
           for name in ("m", "v", "master")}
    out["count"] = torch.tensor(int(np.asarray(state["count"])), dtype=torch.int32, device=dev)
    return out
