"""Uniform model API: `get_model(cfg)` returns a `ModelAPI` whose members
are cfg-bound functions, the surface that serving code touches (the
reference's `repro/models/registry.py`).

The port holds the training and serving paths of every family of the
reference: dense and moe (both `models/transformer.py`, as in the
reference), hybrid (`models/hybrid.py`), ssm (`models/xlstm_model.py`),
vlm (`models/vlm.py`: the batch adds ``patches``) and audio
(`models/encdec.py`: the batch carries ``frames``; `init_cache` holds
cross KV over ``ENCDEC_DECODE_SRC_LEN`` source frames).  ``device``
(None = "cuda") is where `init` draws parameters and `init_cache`
allocates the cache.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import encdec, hybrid, transformer, vlm, xlstm_model

_MODULES = {"dense": transformer, "moe": transformer, "hybrid": hybrid, "ssm": xlstm_model,
            "vlm": vlm, "audio": encdec}

# source frames for enc-dec decode shapes (~2 min of audio at 50 fps)
ENCDEC_DECODE_SRC_LEN = 3072


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


def _vlm_batch_spec(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    ti, f = cfg.frontend_tokens, cfg.frontend_dim
    st = s - ti
    if shape.kind == "train":
        return {"tokens": ((b, st), torch.int32), "patches": ((b, ti, f), torch.bfloat16),
                "labels": ((b, st), torch.int32)}
    if shape.kind == "prefill":
        return {"tokens": ((b, st), torch.int32), "patches": ((b, ti, f), torch.bfloat16)}
    return {"token": ((b,), torch.int32)}


def _audio_batch_spec(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    f = cfg.frontend_dim
    if shape.kind == "train":
        src, tgt = s // 2, s // 2
        return {"frames": ((b, src, f), torch.bfloat16), "tokens": ((b, tgt), torch.int32),
                "labels": ((b, tgt), torch.int32)}
    if shape.kind == "prefill":
        return {"frames": ((b, s // 2, f), torch.bfloat16),
                "tokens": ((b, s // 2), torch.int32)}
    return {"token": ((b,), torch.int32)}


def get_model(cfg: ArchConfig, device: DeviceLike = None) -> ModelAPI:
    if cfg.family not in _MODULES:
        raise ValueError(f"unknown family: {cfg.family}")
    dev = resolve_device(device)
    mod = _MODULES[cfg.family]

    def init(generator: torch.Generator):
        if generator.device.type != dev.type:
            raise ValueError(f"generator on {generator.device}, model on {dev}")
        return mod.init_params(cfg, generator)

    prefill = lambda p, b: mod.prefill(cfg, p, b["tokens"])  # noqa: E731
    init_cache = lambda batch, max_len: mod.init_cache(cfg, batch, max_len, dev)  # noqa: E731
    batch_spec = _lm_batch_spec
    if cfg.family == "vlm":
        prefill = lambda p, b: vlm.prefill(cfg, p, b["tokens"], b["patches"])  # noqa: E731
        batch_spec = _vlm_batch_spec
    elif cfg.family == "audio":
        prefill = lambda p, b: encdec.prefill(cfg, p, b["frames"], b["tokens"])  # noqa: E731
        init_cache = lambda batch, max_len: encdec.init_cache(  # noqa: E731
            cfg, batch, max_len, ENCDEC_DECODE_SRC_LEN, dev)
        batch_spec = _audio_batch_spec
    return ModelAPI(
        cfg=cfg,
        device=dev,
        init=init,
        loss=functools.partial(mod.loss_fn, cfg),
        prefill=prefill,
        decode=functools.partial(mod.decode_step, cfg),
        init_cache=init_cache,
        batch_spec=functools.partial(batch_spec, cfg),
    )
