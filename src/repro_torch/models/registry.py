"""Uniform model API: `get_model(cfg)` returns a `ModelAPI` whose members
are cfg-bound functions, the surface that serving code touches (the
reference's `repro/models/registry.py`).

The port holds the dense family's training and serving paths.
``device`` (None = "cuda") is where `init` draws parameters and
`init_cache` allocates the cache; the other families raise
`NotImplementedError` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer

_NOT_PORTED = {
    "moe": "the MoE FFN (models/moe.py), ROADMAP queue A item 5",
    "ssm": "the ssm family (models/xlstm_model.py), ROADMAP queue A",
    "hybrid": "the hybrid family (models/hybrid.py), ROADMAP queue A",
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
    if cfg.family != "dense":
        raise ValueError(f"unknown family: {cfg.family}")
    dev = resolve_device(device)
    mod = transformer

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
