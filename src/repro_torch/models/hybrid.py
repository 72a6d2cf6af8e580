"""Jamba-style hybrid: superblocks of (attn_period − 1) Mamba mixers and
one GQA attention mixer, each followed by an FFN (the reference's
`repro/models/hybrid.py`, function for function).

The FFN is the MoE FFN (`models/moe.py`) on positions ``i % moe_every
== 0`` and the dense SwiGLU on the others.  Parameters are ``embed``,
``final_norm`` and ``blocks``, one dict per superblock holding
``mix{i}`` (a Mamba mixer, or the attention mixer at the last position)
and ``ffn{i}``; the reference stacks the superblocks and scans over
them, here a Python loop walks the list.  Training rematerialises each
layer as ``cfg.remat`` says, whatever ``remat_policy`` is (the Mamba
scan's chunks are rematerialised again inside it).  Decode keeps the
Mamba states, stacked (superblock, layer) as the reference stacks them,
and KV only for the attention layers, and writes both in place.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer as T

Params = Dict[str, Any]


def _n_super(cfg) -> int:
    if cfg.num_layers % cfg.attn_period:
        raise ValueError(f"{cfg.num_layers} layers are not superblocks of {cfg.attn_period}")
    return cfg.num_layers // cfg.attn_period


def _is_moe(cfg, i: int) -> bool:
    return i % cfg.moe_every == 0


def _ffn_shapes(cfg, moe: bool) -> Dict[str, Tuple[int, ...]]:
    d = cfg.d_model
    if moe:
        e, f = cfg.num_experts, cfg.moe_d_ff or cfg.d_ff
        return {"router": (d, e), "we_gate": (e, d, f), "we_up": (e, d, f),
                "we_down": (e, f, d), "ln2": (d,)}
    return {"w_gate": (d, cfg.d_ff), "w_up": (d, cfg.d_ff), "w_down": (cfg.d_ff, d),
            "ln2": (d,)}


def _attn_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    hd = T._head_dim(cfg)
    d = cfg.d_model
    return {"ln1": (d,), "wq": (d, cfg.num_heads * hd), "wk": (d, cfg.num_kv_heads * hd),
            "wv": (d, cfg.num_kv_heads * hd), "wo": (cfg.num_heads * hd, d)}


def superblock_param_shapes(cfg) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """Each leaf of one superblock and its shape, by mixer / FFN."""
    per = cfg.attn_period
    out = {}
    for i in range(per):
        out[f"mix{i}"] = M.param_shapes(cfg) if i < per - 1 else _attn_shapes(cfg)
        out[f"ffn{i}"] = _ffn_shapes(cfg, _is_moe(cfg, i))
    return out


def _init_ffn(cfg, generator: torch.Generator, moe: bool) -> Dict[str, torch.Tensor]:
    dt = L.dtype_of(cfg.dtype)
    p = {}
    for name, shape in _ffn_shapes(cfg, moe).items():
        if name == "ln2":
            p[name] = torch.ones(shape, dtype=dt, device=generator.device)
        elif name == "router":
            p[name] = moe_lib.moe_router_init(generator, *shape, dt)
        elif len(shape) == 3:
            p[name] = moe_lib.moe_expert_init(generator, *shape, dt)
        else:
            p[name] = L.init_dense(generator, *shape, dt)
    return p


def _init_attn(cfg, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    dt = L.dtype_of(cfg.dtype)
    return {name: (torch.ones(shape, dtype=dt, device=generator.device) if name == "ln1"
                   else L.init_dense(generator, *shape, dt))
            for name, shape in _attn_shapes(cfg).items()}


def init_superblock(cfg, generator: torch.Generator) -> Dict[str, Any]:
    per = cfg.attn_period
    p: Dict[str, Any] = {}
    for i in range(per):
        p[f"mix{i}"] = (M.init_mamba_params(cfg, generator) if i < per - 1
                        else _init_attn(cfg, generator))
        p[f"ffn{i}"] = _init_ffn(cfg, generator, _is_moe(cfg, i))
    return p


def init_params(cfg, generator: torch.Generator) -> Params:
    """Random parameters from ``generator``, on its device (other numbers
    than the reference's for the same seed; `convert` carries the
    reference's across)."""
    dt = L.dtype_of(cfg.dtype)
    dev = generator.device
    table = torch.randn((cfg.padded_vocab, cfg.d_model), generator=generator,
                        dtype=torch.float32, device=dev)
    return {
        "embed": (table * 0.02).to(dt),
        "blocks": [init_superblock(cfg, generator) for _ in range(_n_super(cfg))],
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
    }


def _ffn_apply(cfg, p, x, moe: bool):
    """(x', aux): the FFN half of a layer and its MoE auxiliary loss (a
    float32 0 for the dense SwiGLU)."""
    h = L.rmsnorm(x, p["ln2"])
    if moe:
        y, aux = moe_lib.moe_ffn(
            h, p["router"], p["we_gate"], p["we_up"], p["we_down"],
            experts_per_token=cfg.experts_per_token,
            capacity_factor=cfg.capacity_factor,
            dispatch=cfg.moe_dispatch,
        )
        return x + y, aux["moe_aux_loss"]
    out = x + L.swiglu(h, p["w_gate"], p["w_up"], p["w_down"])
    return out, torch.zeros((), dtype=torch.float32, device=x.device)


def _layer(cfg, i: int, p, x, positions):
    """Layer ``i`` of a superblock in the training forward: (x', aux)."""
    if i < cfg.attn_period - 1:
        x = M.mamba_train(cfg, p[f"mix{i}"], x)
    else:
        x, _ = T._attn_train(cfg, p[f"mix{i}"], x, positions)
    return _ffn_apply(cfg, p[f"ffn{i}"], x, _is_moe(cfg, i))


def superblock_train(cfg, p, x, positions):
    """Per-layer remat inside the superblock: the backward pass holds one
    layer's internals at a time."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.attn_period):
        fn = functools.partial(_layer, cfg, i)
        if cfg.remat:
            fn = L.remat(fn)
        x, aux = fn(p, x, positions)
        aux_total = aux_total + aux
    return x, aux_total


def forward_train(cfg, params: Params, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V), the total MoE aux loss)."""
    x = L.embed(tokens, params["embed"])
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in params["blocks"]:
        x, a = superblock_train(cfg, p, x, positions)
        aux = aux + a
    x = L.rmsnorm(x, params["final_norm"])
    return L.logits_from_hidden(x, params["embed"]), aux


def loss_fn(cfg, params: Params, batch):
    """(loss, metrics) as the transformer's: the cross-entropy plus
    ``cfg.moe_aux_weight`` times the aux loss; metrics ``loss``, ``nll``,
    ``aux``."""
    logits, aux = forward_train(cfg, params, batch["tokens"])
    loss, metrics = L.cross_entropy(logits, batch["labels"], batch.get("mask"))
    metrics["aux"] = aux
    return loss + cfg.moe_aux_weight * aux, metrics


# ---------------------------------------------------------------------------
# Decode: Mamba states (O(1)) + KV cache only for the attention layers
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, device) -> Dict[str, Any]:
    """{"mamba": {"h" (NS, NM, B, di, ds) float32, "conv" (NS, NM, B,
    d_conv − 1, di)}, "k", "v" (NS, B, Hkv, max_len, hd), "len"}."""
    ns, nm = _n_super(cfg), cfg.attn_period - 1
    dt = L.dtype_of(cfg.dtype)
    state = M.init_mamba_state(cfg, batch, device)
    kv = (ns, batch, cfg.num_kv_heads, max_len, T._head_dim(cfg))
    return {
        "mamba": {n: t.expand(ns, nm, *t.shape).clone() for n, t in state.items()},
        "k": torch.zeros(kv, dtype=dt, device=device),
        "v": torch.zeros(kv, dtype=dt, device=device),
        "len": 0,
    }


def decode_step(cfg, params: Params, cache, token: torch.Tensor):
    """token (B,) -> (logits (B, V), cache advanced by one position); the
    cache's tensors are written in place."""
    pos = int(cache["len"])
    x = L.embed(token[:, None], params["embed"])
    per = cfg.attn_period
    mstate = cache["mamba"]
    for j, p in enumerate(params["blocks"]):
        for i in range(per):
            if i < per - 1:
                x, st = M.mamba_decode(cfg, p[f"mix{i}"], x,
                                       {n: t[j, i] for n, t in mstate.items()})
                for n, t in st.items():
                    mstate[n][j, i] = t
            else:
                x, _, _ = T.block_decode_attn_only(cfg, p[f"mix{i}"], x, cache["k"][j],
                                                   cache["v"][j], pos)
            x, _ = _ffn_apply(cfg, p[f"ffn{i}"], x, _is_moe(cfg, i))
    x = L.rmsnorm(x[:, 0], params["final_norm"])
    logits = L.logits_from_hidden(x, params["embed"])
    return logits, {"mamba": mstate, "k": cache["k"], "v": cache["v"], "len": pos + 1}


def prefill(cfg, params: Params, tokens: torch.Tensor):
    """Parallel prefill: the training forward collecting each Mamba
    layer's final state and each attention layer's full KV."""
    s = tokens.shape[1]
    x = L.embed(tokens, params["embed"])
    positions = torch.arange(s, device=tokens.device)
    per = cfg.attn_period
    states, ks, vs = [], [], []
    for p in params["blocks"]:
        layer_states = []
        for i in range(per):
            if i < per - 1:
                x, st = M.mamba_train(cfg, p[f"mix{i}"], x, return_state=True)
                layer_states.append(st)
            else:
                x, (k, v) = T._attn_train(cfg, p[f"mix{i}"], x, positions)
                ks.append(k)
                vs.append(v)
            x, _ = _ffn_apply(cfg, p[f"ffn{i}"], x, _is_moe(cfg, i))
        states.append({n: torch.stack([st[n] for st in layer_states])
                       for n in layer_states[0]})
    x = L.rmsnorm(x[:, -1], params["final_norm"])
    logits = L.logits_from_hidden(x, params["embed"])
    cache = {"mamba": {n: torch.stack([st[n] for st in states]) for n in states[0]},
             "k": torch.stack(ks), "v": torch.stack(vs), "len": int(s)}
    return logits, cache
