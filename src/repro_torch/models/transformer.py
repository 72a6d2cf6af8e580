"""Decoder-only transformer (dense GQA or MoE FFN): parameters, the
training forward and loss, prefill and the single-token decode over a
static-size KV cache.

Covers yi-6b and yi-9b (the dense family) and olmoe-1b-7b and
moonshot-v1-16b-a3b (the moe family: `models/moe.py` on every layer,
as the reference's transformer, which ignores ``moe_every``).
Parameters are a plain dict: ``embed`` (V, D), ``final_norm`` (D,) and
``blocks``, one dict per layer with the reference's (in, out) weight
layout, so ``h @ wq`` reads as in `repro/models/transformer.py`.  The
reference stacks the layers and scans over them; here a Python loop
walks the list, and `decode_step` writes each layer's new KV entry into
the cache in place.  Training (`forward_train`, `loss_fn`)
rematerialises each block as ``cfg.remat`` and ``cfg.remat_policy`` say
(`layers.remat`), and carries each layer's MoE auxiliary loss.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib

Params = Dict[str, Any]


def _head_dim(cfg) -> int:
    return cfg.head_dim or cfg.d_model // cfg.num_heads


def block_param_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """Each leaf of one layer's parameters and its shape: the dense FFN's
    ``w_gate``, ``w_up``, ``w_down``, or with experts ``router`` (D, E)
    and ``we_gate``, ``we_up`` (E, D, F) and ``we_down`` (E, F, D)."""
    hd = _head_dim(cfg)
    d = cfg.d_model
    shapes = {"ln1": (d,), "ln2": (d,), "wq": (d, cfg.num_heads * hd),
              "wk": (d, cfg.num_kv_heads * hd), "wv": (d, cfg.num_kv_heads * hd),
              "wo": (cfg.num_heads * hd, d)}
    if cfg.num_experts:
        e, f = cfg.num_experts, cfg.moe_d_ff or cfg.d_ff
        return {**shapes, "router": (d, e), "we_gate": (e, d, f), "we_up": (e, d, f),
                "we_down": (e, f, d)}
    return {**shapes, "w_gate": (d, cfg.d_ff), "w_up": (d, cfg.d_ff),
            "w_down": (cfg.d_ff, d)}


def init_block_params(cfg, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """One layer's parameters, drawn on the generator's device one leaf at
    a time (the largest float32 draw is one expert leaf)."""
    dt = L.dtype_of(cfg.dtype)
    dev = generator.device
    p = {}
    for name, shape in block_param_shapes(cfg).items():
        if name in ("ln1", "ln2"):
            p[name] = torch.ones(shape, dtype=dt, device=dev)
        elif name == "router":
            p[name] = moe_lib.moe_router_init(generator, *shape, dt)
        elif len(shape) == 3:
            p[name] = moe_lib.moe_expert_init(generator, *shape, dt)
        else:
            p[name] = L.init_dense(generator, *shape, dt)
    return p


def init_params(cfg, generator: torch.Generator) -> Params:
    """Random parameters from ``generator``, on its device.  The numbers
    differ from the reference's `jax.random` ones for the same seed; the
    tests carry the reference's parameters across with
    `convert.lm_params_from_reference`."""
    dt = L.dtype_of(cfg.dtype)
    dev = generator.device
    table = torch.randn((cfg.padded_vocab, cfg.d_model), generator=generator,
                        dtype=torch.float32, device=dev)
    return {
        "embed": (table * 0.02).to(dt),
        "blocks": [init_block_params(cfg, generator) for _ in range(cfg.num_layers)],
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
    }


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _qkv(cfg, p, x):
    hd = _head_dim(cfg)
    b, s, _ = x.shape
    h = L.rmsnorm(x, p["ln1"])
    q = (h @ p["wq"]).reshape(b, s, cfg.num_heads, hd).transpose(1, 2)
    k = (h @ p["wk"]).reshape(b, s, cfg.num_kv_heads, hd).transpose(1, 2)
    v = (h @ p["wv"]).reshape(b, s, cfg.num_kv_heads, hd).transpose(1, 2)
    return q, k, v


def _attn_train(cfg, p, x, positions):
    """Full-sequence causal attention block: (x', (k, v)) with k after
    RoPE, as the reference's `_attn_train`."""
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, p, x)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    o = attn_lib.chunked_attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
    o = o.transpose(1, 2).reshape(b, s, -1)
    return x + o @ p["wo"], (k, v)


def _ffn(cfg, p, x):
    """The FFN half of a block: (x', aux), aux the layer's MoE auxiliary
    loss (a float32 0 for the dense FFN)."""
    h = L.rmsnorm(x, p["ln2"])
    if cfg.num_experts:
        y, aux = moe_lib.moe_ffn(
            h, p["router"], p["we_gate"], p["we_up"], p["we_down"],
            experts_per_token=cfg.experts_per_token,
            capacity_factor=cfg.capacity_factor,
            dispatch=cfg.moe_dispatch,
        )
        return x + y, aux["moe_aux_loss"]
    out = x + L.swiglu(h, p["w_gate"], p["w_up"], p["w_down"])
    return out, torch.zeros((), dtype=torch.float32, device=x.device)


def block_train(cfg, p, x, positions):
    """One layer of the training forward: (x', aux)."""
    x, _ = _attn_train(cfg, p, x, positions)
    return _ffn(cfg, p, x)


def _train_block(cfg) -> Callable:
    """`block_train` under ``cfg``'s remat policy: ``"full"`` recomputes
    the whole block, ``"block_io"`` each half, keeping the attention and
    FFN outputs."""
    if not cfg.remat:
        return lambda p, x, positions: block_train(cfg, p, x, positions)
    if L.remat_policy_of(cfg) == "full":
        return L.remat(lambda p, x, positions: block_train(cfg, p, x, positions))
    attn = L.remat(lambda p, x, positions: _attn_train(cfg, p, x, positions)[0])
    ffn = L.remat(lambda p, x: _ffn(cfg, p, x))
    return lambda p, x, positions: ffn(p, attn(p, x, positions))


def _forward_hidden(cfg, params: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training layers over embeddings x (B, S, D): (the final-normed
    hidden states (B, S, D), the total MoE aux loss)."""
    positions = torch.arange(x.shape[1], device=x.device)
    block = _train_block(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in params["blocks"]:
        x, a = block(p, x, positions)
        aux = aux + a
    return L.rmsnorm(x, params["final_norm"]), aux


def forward_train(cfg, params: Params, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> logits (B, S, V); also returns the total MoE aux
    loss (float32 0 for the dense family)."""
    x, aux = _forward_hidden(cfg, params, L.embed(tokens, params["embed"]))
    return L.logits_from_hidden(x, params["embed"]), aux


def loss_fn(cfg, params: Params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics): the cross-entropy with its z-loss plus
    ``cfg.moe_aux_weight`` times the aux loss; metrics ``loss``, ``nll``
    and ``aux``."""
    logits, aux = forward_train(cfg, params, batch["tokens"])
    loss, metrics = L.cross_entropy(logits, batch["labels"], batch.get("mask"))
    total = loss + cfg.moe_aux_weight * aux
    metrics["aux"] = aux
    return total, metrics


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode over a static-size KV cache
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, device) -> Dict[str, Any]:
    dt = L.dtype_of(cfg.dtype)
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, _head_dim(cfg))
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "len": 0,
    }


def extend_cache(cache, max_len: int) -> Dict[str, Any]:
    """A prefill's ``cache`` copied into one of ``max_len`` positions, so
    that decode can go on from it; entries other than the self-attention
    KV (the audio family's cross KV) are carried as they are."""
    n = cache["len"]
    out = dict(cache)
    for name in ("k", "v"):
        t = cache[name]
        out[name] = t.new_zeros(t.shape[:3] + (max_len,) + t.shape[4:])
        out[name][:, :, :, :n] = t[:, :, :, :n]
    return out


def _prefill_hidden(cfg, params: Params, x: torch.Tensor) -> Tuple[torch.Tensor, Any]:
    """Prefill over embeddings x (B, S, D): (last-position logits (B, V),
    cache of len S)."""
    positions = torch.arange(x.shape[1], device=x.device)
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    for p in params["blocks"]:
        x, (k, v) = _attn_train(cfg, p, x, positions)
        x, _ = _ffn(cfg, p, x)
        ks.append(k)
        vs.append(v)
    x = L.rmsnorm(x[:, -1], params["final_norm"])
    logits = L.logits_from_hidden(x, params["embed"])
    cache = {"k": torch.stack(ks), "v": torch.stack(vs), "len": int(positions.shape[0])}
    return logits, cache


def prefill(cfg, params: Params, tokens: torch.Tensor) -> Tuple[torch.Tensor, Any]:
    """tokens (B, S) -> (last-position logits (B, V), cache of len S)."""
    return _prefill_hidden(cfg, params, L.embed(tokens, params["embed"]))


def block_decode_attn_only(cfg, p, x, kc, vc, pos: int):
    """The attention mixer without the FFN (the hybrid family attaches its
    own): x (B, 1, D); kc/vc (B, Hkv, S, hd), written in place at
    ``pos``.  Returns (x', kc, vc)."""
    b = x.shape[0]
    q, k, v = _qkv(cfg, p, x)
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = L.apply_rope(q, posv, cfg.rope_theta)
    k = L.apply_rope(k, posv, cfg.rope_theta)
    kc, vc = attn_lib.update_kv_cache(kc, vc, k, v, pos)
    o = attn_lib.decode_attention(q, kc, vc, pos + 1)
    o = o.transpose(1, 2).reshape(b, 1, -1)
    return x + o @ p["wo"], kc, vc


def block_decode(cfg, p, x, kc, vc, pos: int):
    """One decoder layer at decode: the attention mixer, then the FFN.
    Returns (x', kc, vc)."""
    x, kc, vc = block_decode_attn_only(cfg, p, x, kc, vc, pos)
    x, _ = _ffn(cfg, p, x)
    return x, kc, vc


def decode_step(cfg, params: Params, cache, token: torch.Tensor) -> Tuple[torch.Tensor, Any]:
    """token (B,) -> (logits (B, V), cache advanced by one position).

    The cache's tensors are updated in place, one layer at a time (the
    reference donates its cache to the same effect); the returned dict
    holds the same tensors."""
    pos = int(cache["len"])
    x = L.embed(token[:, None], params["embed"])
    for i, p in enumerate(params["blocks"]):
        x, _, _ = block_decode(cfg, p, x, cache["k"][i], cache["v"][i], pos)
    x = L.rmsnorm(x[:, 0], params["final_norm"])
    logits = L.logits_from_hidden(x, params["embed"])
    return logits, {"k": cache["k"], "v": cache["v"], "len": pos + 1}
