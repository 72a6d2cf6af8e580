"""Encoder-decoder (seamless-m4t style): a speech encoder and a text
decoder (the reference's `repro/models/encdec.py`, function for
function).

The modality frontend is a stub, as in the reference: the batch carries
precomputed filterbank frames (B, S_src, frontend_dim), which a linear
frontend lifts to d_model.  Encoder layers attend in both directions
(`chunked_attention`, not causal); decoder layers attend causally to
themselves, then over the encoder's output (cross-attention: S_tgt
queries over S_src keys).  On the card all three go through B9
(`kernels.ops.attention_op`).  Parameters are ``embed``, ``frontend``
(F, D), ``enc`` and ``dec``, one dict per layer (the reference stacks
them and scans; here Python loops walk the lists; a decoder layer adds
``x_ln``, ``x_wq``, ``x_wk``, ``x_wv`` and ``x_wo``), ``final_norm`` and
``enc_norm``.  Decode caches the decoder's self-attention KV, written in
place, and each layer's fixed cross KV over the source; its
cross-attention is `decode_attention` over that KV, plain PyTorch as in
the reference.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

Params = Dict[str, Any]


def _hd(cfg) -> int:
    return cfg.head_dim or cfg.d_model // cfg.num_heads


def _attn_shapes(cfg, prefix: str = "") -> Dict[str, Tuple[int, ...]]:
    hd, d = _hd(cfg), cfg.d_model
    return {f"{prefix}ln": (d,), f"{prefix}wq": (d, cfg.num_heads * hd),
            f"{prefix}wk": (d, cfg.num_kv_heads * hd),
            f"{prefix}wv": (d, cfg.num_kv_heads * hd),
            f"{prefix}wo": (cfg.num_heads * hd, d)}


def _ffn_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    d = cfg.d_model
    return {"ln2": (d,), "w_gate": (d, cfg.d_ff), "w_up": (d, cfg.d_ff),
            "w_down": (cfg.d_ff, d)}


def enc_param_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """One encoder layer's leaves (9) and their shapes."""
    return {**_attn_shapes(cfg), **_ffn_shapes(cfg)}


def dec_param_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """One decoder layer's leaves (14: self-attention, cross-attention
    ``x_*``, FFN) and their shapes."""
    return {**_attn_shapes(cfg), **_attn_shapes(cfg, "x_"), **_ffn_shapes(cfg)}


def _init_leaves(cfg, generator: torch.Generator,
                 shapes: Dict[str, Tuple[int, ...]]) -> Dict[str, torch.Tensor]:
    """Norm scales at one, weights N(0, 1/in), in ``cfg.dtype`` on the
    generator's device."""
    dt = L.dtype_of(cfg.dtype)
    return {name: (torch.ones(shape, dtype=dt, device=generator.device) if len(shape) == 1
                   else L.init_dense(generator, *shape, dt))
            for name, shape in shapes.items()}


def _init_attn(cfg, generator: torch.Generator, prefix: str = "") -> Dict[str, torch.Tensor]:
    return _init_leaves(cfg, generator, _attn_shapes(cfg, prefix))


def _init_ffn(cfg, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    return _init_leaves(cfg, generator, _ffn_shapes(cfg))


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
        "frontend": L.init_dense(generator, cfg.frontend_dim, cfg.d_model, dt),
        "enc": [{**_init_attn(cfg, generator), **_init_ffn(cfg, generator)}
                for _ in range(cfg.num_encoder_layers)],
        "dec": [{**_init_attn(cfg, generator), **_init_attn(cfg, generator, "x_"),
                 **_init_ffn(cfg, generator)} for _ in range(cfg.num_layers)],
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "enc_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
    }


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _heads(cfg, x: torch.Tensor, w: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, D) @ w -> (B, heads, S, hd), split as the transformer splits
    its heads (a DTensor column split inside a head made whole first)."""
    return T._heads(cfg, x @ w, heads)


def _self_attn(cfg, p, x, positions, causal: bool, prefix: str = ""):
    """(x + attention @ wo, (k, v)), k after RoPE."""
    b, s, _ = x.shape
    h = L.rmsnorm(x, p[f"{prefix}ln"])
    q = _heads(cfg, h, p[f"{prefix}wq"], cfg.num_heads)
    k = _heads(cfg, h, p[f"{prefix}wk"], cfg.num_kv_heads)
    v = _heads(cfg, h, p[f"{prefix}wv"], cfg.num_kv_heads)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    o = attn_lib.chunked_attention(q, k, v, causal=causal, chunk=cfg.attn_chunk)
    o = o.transpose(1, 2).reshape(b, s, -1)
    return x + o @ p[f"{prefix}wo"], (k, v)


def _cross_attn(cfg, p, x, enc_kv):
    """The decoder's queries over the encoder's (k, v), not causal (Sq =
    the target length, Sk = the source length), no RoPE."""
    b, s, _ = x.shape
    k, v = enc_kv
    h = L.rmsnorm(x, p["x_ln"])
    q = _heads(cfg, h, p["x_wq"], cfg.num_heads)
    o = attn_lib.chunked_attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
    o = o.transpose(1, 2).reshape(b, s, -1)
    return x + o @ p["x_wo"]


def _ffn(cfg, p, x):
    h = L.rmsnorm(x, p["ln2"])
    return x + L.swiglu(h, p["w_gate"], p["w_up"], p["w_down"])


def _enc_block(cfg, p, h, positions):
    h, _ = _self_attn(cfg, p, h, positions, causal=False)
    return _ffn(cfg, p, h)


def encode(cfg, params: Params, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, S_src, frontend_dim) -> (B, S_src, D); each layer
    rematerialised under ``cfg.remat``."""
    x = frames.to(params["frontend"].dtype) @ params["frontend"]
    positions = torch.arange(frames.shape[1], device=frames.device)
    block = lambda p, h: _enc_block(cfg, p, h, positions)  # noqa: E731
    if cfg.remat:
        block = L.remat(block)
    for p in params["enc"]:
        x = block(p, L.pin_dp(x))
    return L.rmsnorm(x, params["enc_norm"])


def _enc_kv(cfg, p, enc_out):
    """One decoder layer's cross (k, v) over the encoder's output, each
    (B, Hkv, S_src, hd)."""
    return (_heads(cfg, enc_out, p["x_wk"], cfg.num_kv_heads),
            _heads(cfg, enc_out, p["x_wv"], cfg.num_kv_heads))


def _dec_block(cfg, p, h, enc_out, positions):
    h, _ = _self_attn(cfg, p, h, positions, causal=True)
    h = _cross_attn(cfg, p, h, _enc_kv(cfg, p, enc_out))
    return _ffn(cfg, p, h)


def forward_train(cfg, params: Params, frames: torch.Tensor,
                  tokens: torch.Tensor) -> torch.Tensor:
    """frames (B, S_src, F), tokens (B, S_tgt) -> logits (B, S_tgt, V)."""
    enc_out = encode(cfg, params, frames)
    x = L.embed(tokens, params["embed"])
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    block = lambda p, h, e: _dec_block(cfg, p, h, e, positions)  # noqa: E731
    if cfg.remat:
        block = L.remat(block)
    for p in params["dec"]:
        x = block(p, L.pin_dp(x), enc_out)
    x = L.rmsnorm(x, params["final_norm"])
    return L.logits_from_hidden(x, params["embed"])


def loss_fn(cfg, params: Params, batch):
    """(loss, metrics ``loss`` and ``nll``): the cross-entropy with its
    z-loss, as the reference's."""
    logits = forward_train(cfg, params, batch["frames"], batch["tokens"])
    return L.cross_entropy(logits, batch["labels"], batch.get("mask"))


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, src_len: int, device) -> Dict[str, Any]:
    """{"k", "v": (L, B, Hkv, max_len, hd) self-attention KV, "xk", "xv":
    (L, B, Hkv, src_len, hd) cross KV (zeros until a prefill fills
    them), "len"}."""
    dt = L.dtype_of(cfg.dtype)
    hd, nl, hkv = _hd(cfg), cfg.num_layers, cfg.num_kv_heads
    return {
        "k": torch.zeros((nl, batch, hkv, max_len, hd), dtype=dt, device=device),
        "v": torch.zeros((nl, batch, hkv, max_len, hd), dtype=dt, device=device),
        "xk": torch.zeros((nl, batch, hkv, src_len, hd), dtype=dt, device=device),
        "xv": torch.zeros((nl, batch, hkv, src_len, hd), dtype=dt, device=device),
        "len": 0,
    }


def prefill(cfg, params: Params, frames: torch.Tensor, tokens: torch.Tensor):
    """Parallel prefill: encode the source once, run the decoder over the
    prompt in its training form, and keep each layer's self KV and cross
    KV.  Returns (last-position logits (B, V), cache of len S_tgt)."""
    enc_out = encode(cfg, params, frames)
    x = L.embed(tokens, params["embed"])
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    xks: List[torch.Tensor] = []
    xvs: List[torch.Tensor] = []
    for p in params["dec"]:
        x = L.pin_dp(x)
        x, (k, v) = _self_attn(cfg, p, x, positions, causal=True)
        xk, xv = _enc_kv(cfg, p, enc_out)
        x = _cross_attn(cfg, p, x, (xk, xv))
        x = _ffn(cfg, p, x)
        ks.append(k)
        vs.append(v)
        xks.append(xk)
        xvs.append(xv)
    x = L.rmsnorm(x[:, -1], params["final_norm"])
    logits = L.logits_from_hidden(x, params["embed"])
    cache = {"k": torch.stack(ks), "v": torch.stack(vs), "xk": torch.stack(xks),
             "xv": torch.stack(xvs), "len": int(tokens.shape[1])}
    return logits, cache


def decode_step(cfg, params: Params, cache, token: torch.Tensor):
    """token (B,) -> (logits (B, V), cache advanced by one position); the
    self-attention KV is written in place, the cross KV is read only."""
    pos = int(cache["len"])
    x = L.embed(token[:, None], params["embed"])
    posv = torch.full((1,), pos, dtype=torch.int32, device=token.device)
    for i, p in enumerate(params["dec"]):
        x = L.pin_dp(x)
        kc, vc, xk, xv = cache["k"][i], cache["v"][i], cache["xk"][i], cache["xv"][i]
        hh = L.rmsnorm(x, p["ln"])
        q = L.apply_rope(_heads(cfg, hh, p["wq"], cfg.num_heads), posv, cfg.rope_theta)
        k = L.apply_rope(_heads(cfg, hh, p["wk"], cfg.num_kv_heads), posv, cfg.rope_theta)
        v = _heads(cfg, hh, p["wv"], cfg.num_kv_heads)
        attn_lib.update_kv_cache(kc, vc, k, v, pos)
        o = attn_lib.decode_attention(q, kc, vc, pos + 1)
        x = x + o.transpose(1, 2).reshape(x.shape[0], 1, -1) @ p["wo"]
        # cross-attention over the fixed encoder KV
        hh = L.rmsnorm(x, p["x_ln"])
        qx = _heads(cfg, hh, p["x_wq"], cfg.num_heads)
        ox = attn_lib.decode_attention(qx, xk, xv, xk.shape[2])
        x = x + ox.transpose(1, 2).reshape(x.shape[0], 1, -1) @ p["x_wo"]
        x = _ffn(cfg, p, x)
    x = L.rmsnorm(x[:, 0], params["final_norm"])
    logits = L.logits_from_hidden(x, params["embed"])
    return logits, {"k": cache["k"], "v": cache["v"], "xk": cache["xk"], "xv": cache["xv"],
                    "len": pos + 1}
