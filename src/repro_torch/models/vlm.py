"""VLM backbone (llava-next-mistral style): the decoder-only transformer
plus a patch projector (the reference's `repro/models/vlm.py`, function
for function).

The vision tower is a stub, as in the reference: the batch carries
precomputed anyres patch embeddings (B, T_img, frontend_dim), and a
two-layer MLP projector (GELU, tanh form) lifts them to d_model.  The
sequence is [image tokens ; text tokens]; the loss and the training
logits cover the text part only.  Decode is the transformer's (the
images live in the prompt's prefill).  Parameters are the transformer's
plus ``proj_w1`` (F, D), ``proj_b1`` (D,), ``proj_w2`` (D, D) and
``proj_b2`` (D,).

`prefill`'s cache has ``len`` T_img + S_text, the positions its KV
holds.  The reference returns ``d_model`` there (it reads the length off
the last position's (B, D) hidden state): ROADMAP queue C 26, fixed in
the port.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import placed_like
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

Params = Dict[str, Any]


def projector_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    d = cfg.d_model
    return {"proj_w1": (cfg.frontend_dim, d), "proj_b1": (d,), "proj_w2": (d, d),
            "proj_b2": (d,)}


def init_params(cfg, generator: torch.Generator) -> Params:
    """The transformer's random parameters, then the projector's, from
    ``generator`` on its device (other numbers than the reference's for
    the same seed; `convert` carries the reference's across)."""
    dt = L.dtype_of(cfg.dtype)
    dev = generator.device
    params = T.init_params(cfg, generator)
    params["proj_w1"] = L.init_dense(generator, cfg.frontend_dim, cfg.d_model, dt)
    params["proj_b1"] = torch.zeros((cfg.d_model,), dtype=dt, device=dev)
    params["proj_w2"] = L.init_dense(generator, cfg.d_model, cfg.d_model, dt)
    params["proj_b2"] = torch.zeros((cfg.d_model,), dtype=dt, device=dev)
    return params


def _project(params: Params, patches: torch.Tensor) -> torch.Tensor:
    """(B, T_img, F) patches -> (B, T_img, D) image tokens."""
    h = patches.to(params["proj_w1"].dtype) @ params["proj_w1"] + params["proj_b1"]
    return F.gelu(h, approximate="tanh") @ params["proj_w2"] + params["proj_b2"]


def _sequence(params: Params, tokens: torch.Tensor, patches: torch.Tensor) -> torch.Tensor:
    """[image ; text] embeddings, (B, T_img + S_text, D); on DTensors the
    image half is placed as the text half before they are joined."""
    txt = L.embed(tokens, params["embed"])
    return torch.cat([placed_like(_project(params, patches), txt), txt], dim=1)


def forward_train(cfg, params: Params, tokens: torch.Tensor,
                  patches: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S_text), patches (B, T_img, F) -> (logits over the text
    part (B, S_text, V), the total MoE aux loss: a float32 0 for the
    dense backbone)."""
    x, aux = T._forward_hidden(cfg, params, _sequence(params, tokens, patches))
    return L.logits_from_hidden(x[:, patches.shape[1]:], params["embed"]), aux


def loss_fn(cfg, params: Params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics ``loss``, ``nll``, ``aux``): the cross-entropy over
    the text tokens with its z-loss; the aux loss is reported, not added,
    as in the reference."""
    logits, aux = forward_train(cfg, params, batch["tokens"], batch["patches"])
    loss, metrics = L.cross_entropy(logits, batch["labels"], batch.get("mask"))
    metrics["aux"] = aux
    return loss, metrics


init_cache = T.init_cache
decode_step = T.decode_step


def prefill(cfg, params: Params, tokens: torch.Tensor, patches: torch.Tensor):
    """Prefill over [image ; text]: (last-position logits (B, V), cache of
    len T_img + S_text)."""
    return T._prefill_hidden(cfg, params, _sequence(params, tokens, patches))
