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
from repro_torch.models import encdec, hybrid, mamba, vlm, xlstm, xlstm_model
from repro_torch.models.layers import dtype_of
from repro_torch.models.transformer import block_param_shapes


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
    """The reference's decoder parameter pytree (NumPy arrays, the layer
    axis first in ``blocks``: (L, E, D, F) expert leaves and an (L, D, E)
    router for the moe family) as the port's parameters: one dict per
    layer, in ``cfg.dtype`` on ``device`` (None = "cuda"); the vlm
    family also carries its projector's four leaves.  The leaves and
    their shapes must be the ones ``cfg`` builds.  The hybrid and ssm
    families go through `superblock_params_from_reference`, the audio
    family through `encdec_params_from_reference`."""
    if cfg.family in ("hybrid", "ssm"):
        return superblock_params_from_reference(params, cfg, device)
    if cfg.family == "audio":
        return encdec_params_from_reference(params, cfg, device)
    dev = resolve_device(device)
    dt = dtype_of(cfg.dtype)
    blocks = params["blocks"]
    layers = int(np.asarray(blocks["wq"]).shape[0])
    if layers != cfg.num_layers:
        raise ValueError(f"{layers} stacked layers, config has {cfg.num_layers}")
    got = {name: tuple(np.shape(a)[1:]) for name, a in blocks.items()}
    if got != block_param_shapes(cfg):
        raise ValueError(f"block leaves {got}, config has {block_param_shapes(cfg)}")
    out = {
        "embed": _lm_tensor(params["embed"], dt, dev),
        "blocks": [{name: _lm_tensor(np.asarray(a)[i], dt, dev)
                    for name, a in blocks.items()} for i in range(layers)],
        "final_norm": _lm_tensor(params["final_norm"], dt, dev),
    }
    if cfg.family == "vlm":
        out.update(_carry_leaves(params, vlm.projector_shapes(cfg), dt, dev))
    return out


def _carry_leaves(tree, shapes, dt, dev) -> dict:
    """``tree``'s leaves named in ``shapes``, each checked against its
    shape, as tensors in ``dt`` on ``dev``."""
    out = {}
    for name, shape in shapes.items():
        if name not in tree:
            raise ValueError(f"leaf {name} missing, config has {tuple(shape)}")
        got = tuple(np.shape(tree[name]))
        if got != tuple(shape):
            raise ValueError(f"leaf {name}: {got}, config has {tuple(shape)}")
        out[name] = _lm_tensor(tree[name], dt, dev)
    return out


def encdec_params_from_reference(params, cfg, device=None) -> dict:
    """The reference's encoder-decoder (seamless) parameter pytree (NumPy
    arrays, the layer axis first in ``enc`` and ``dec``) as the port's:
    ``enc`` and ``dec`` one dict per layer (9 and 14 leaves), with
    ``embed``, ``frontend``, ``final_norm`` and ``enc_norm``, in
    ``cfg.dtype`` on ``device`` (None = "cuda").  The leaves and their
    shapes must be the ones ``cfg`` builds."""
    dev = resolve_device(device)
    dt = dtype_of(cfg.dtype)
    out = {}
    for key, want, layers in (("enc", encdec.enc_param_shapes(cfg), cfg.num_encoder_layers),
                              ("dec", encdec.dec_param_shapes(cfg), cfg.num_layers)):
        tree = params[key]
        if set(tree) != set(want):
            raise ValueError(f"{key} leaves {sorted(tree)}, config has {sorted(want)}")
        stacked = {int(np.shape(a)[0]) for a in tree.values()}
        if stacked != {layers}:
            raise ValueError(f"{sorted(stacked)} stacked {key} layers, config has {layers}")
        got = {name: tuple(np.shape(a)[1:]) for name, a in tree.items()}
        if got != want:
            raise ValueError(f"{key} leaves {got}, config has {want}")
        out[key] = [{name: _lm_tensor(np.asarray(tree[name])[i], dt, dev) for name in want}
                    for i in range(layers)]
    d = cfg.d_model
    out.update(_carry_leaves(params, {"embed": (cfg.padded_vocab, d),
                                      "frontend": (cfg.frontend_dim, d),
                                      "final_norm": (d,), "enc_norm": (d,)}, dt, dev))
    return out


def _superblock_spec(cfg) -> dict:
    """One superblock's leaves in the port's layout, each (shape, dtype)."""
    def leaves(shapes):
        return {n: (shape, mamba.leaf_dtype(cfg, n)) for n, shape in shapes.items()}
    if cfg.family == "hybrid":
        return {key: leaves(shapes)
                for key, shapes in hybrid.superblock_param_shapes(cfg).items()}
    return {"mlstm": [leaves(xlstm.mlstm_param_shapes(cfg))] * (cfg.xlstm_slstm_every - 1),
            "slstm": leaves(xlstm.slstm_param_shapes(cfg))}


def _ref_dtype_name(dtype) -> str:
    return {torch.bfloat16: "bfloat16", torch.float32: "float32"}[dtype]


def superblock_params_from_reference(params, cfg, device=None) -> dict:
    """The reference's hybrid (jamba) or xLSTM parameter pytree (NumPy
    arrays, the superblock axis first in ``blocks``; the xLSTM's
    ``mlstm`` leaves (NS, NM, …)) as the port's: one dict per superblock
    (``mix{i}`` / ``ffn{i}``, or an ``mlstm`` list and ``slstm``), each
    leaf in its own dtype (Mamba's ``a_log``, ``dt_bias`` and ``d_skip``
    float32, the rest ``cfg.dtype``) on ``device`` (None = "cuda").  The
    leaves, their shapes and their dtypes must be the ones ``cfg``
    builds."""
    dev = resolve_device(device)
    dt = dtype_of(cfg.dtype)
    ns = (hybrid if cfg.family == "hybrid" else xlstm_model)._n_super(cfg)
    spec = _superblock_spec(cfg)
    blocks = params["blocks"]

    def leaf(a, index, name, want):
        shape, dtype = want
        a = np.asarray(a)
        if a.shape[len(index):] != tuple(shape) or a.dtype.name != _ref_dtype_name(dtype):
            raise ValueError(f"leaf {name}: {a.dtype.name} {a.shape}, config has "
                             f"{_ref_dtype_name(dtype)} {(ns,) + tuple(shape)}")
        return _lm_tensor(a[index], dtype, dev)

    def carry(tree, want, index):
        if set(tree) != set(want):
            raise ValueError(f"leaves {sorted(tree)}, config has {sorted(want)}")
        return {n: leaf(tree[n], index, n, want[n]) for n in want}

    if set(blocks) != set(spec):
        raise ValueError(f"superblock keys {sorted(blocks)}, config has {sorted(spec)}")
    stacked = {int(np.shape(a)[0]) for sub in blocks.values() for a in sub.values()}
    if stacked != {ns}:
        raise ValueError(f"{sorted(stacked)} stacked superblocks, config has {ns}")
    out = []
    for j in range(ns):
        if cfg.family == "hybrid":
            out.append({key: carry(blocks[key], spec[key], (j,)) for key in spec})
        else:
            nm = len(spec["mlstm"])
            if {int(np.shape(a)[1]) for a in blocks["mlstm"].values()} != {nm}:
                raise ValueError(f"mLSTM layers per superblock, config has {nm}")
            out.append({"mlstm": [carry(blocks["mlstm"], spec["mlstm"][i], (j, i))
                                  for i in range(nm)],
                        "slstm": carry(blocks["slstm"], spec["slstm"], (j,))})
    return {
        "embed": _lm_tensor(params["embed"], dt, dev),
        "blocks": out,
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
