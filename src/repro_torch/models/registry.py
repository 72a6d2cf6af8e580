"""Uniform model API: `get_model(cfg)` returns a `ModelAPI` whose members
are cfg-bound functions, the surface that serving code touches (the
reference's `repro/models/registry.py`).

The port holds the training and serving paths of the dense and moe
families (both `models/transformer.py`, as in the reference), the
hybrid family (`models/hybrid.py`) and the ssm family
(`models/xlstm_model.py`).  ``device`` (None = "cuda") is where `init`
draws parameters and `init_cache` allocates the cache; the vlm and
audio families raise `NotImplementedError` naming the ROADMAP item that
ports them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import hybrid, transformer, xlstm_model

_MODULES = {"dense": transformer, "moe": transformer, "hybrid": hybrid, "ssm": xlstm_model}
_NOT_PORTED = {
    "vlm": "the vlm family (models/vlm.py), ROADMAP queue A",
    "audio": "the audio family (models/encdec.py), ROADMAP queue A",
}


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ArchConfig
    device: torch.device
    init: Callable                  # generator -> params
    loss: Callable                  # (params, batch) -> (loss, metrics)
    prefill: Callable               # (params, batch) -> (logits, cache)
    decode: Callable                # (params, cache, token) -> (logits, cache)
    init_cache: Callable            # (batch, max_len) -> cache
    batch_spec: Callable            # ShapeConfig -> {name: (shape, dtype)}


def _lm_batch_spec(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"tokens": ((b, s), torch.int32), "labels": ((b, s), torch.int32)}
    if shape.kind == "prefill":
        return {"tokens": ((b, s), torch.int32)}
    return {"token": ((b,), torch.int32)}  # decode


def get_model(cfg: ArchConfig, device: DeviceLike = None) -> ModelAPI:
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(f"{cfg.name}: {_NOT_PORTED[cfg.family]}")
    if cfg.family not in _MODULES:
        raise ValueError(f"unknown family: {cfg.family}")
    dev = resolve_device(device)
    mod = _MODULES[cfg.family]

    def init(generator: torch.Generator):
        if generator.device.type != dev.type:
            raise ValueError(f"generator on {generator.device}, model on {dev}")
        return mod.init_params(cfg, generator)

    return ModelAPI(
        cfg=cfg,
        device=dev,
        init=init,
        loss=functools.partial(mod.loss_fn, cfg),
        prefill=lambda p, b: mod.prefill(cfg, p, b["tokens"]),
        decode=functools.partial(mod.decode_step, cfg),
        init_cache=lambda batch, max_len: mod.init_cache(cfg, batch, max_len, dev),
        batch_spec=functools.partial(_lm_batch_spec, cfg),
    )
