"""Full xLSTM LM: embedding, superblocks of (xlstm_slstm_every − 1)
mLSTM layers and one sLSTM layer, tied head (the reference's
`repro/models/xlstm_model.py`, function for function).

Parameters are ``embed``, ``final_norm`` and ``blocks``, one dict per
superblock: ``mlstm``, a list of the mLSTM layers' dicts, and
``slstm``; the reference stacks both and scans over them, here Python
loops walk the lists.  Under ``cfg.remat`` each layer is rematerialised.
Decode state is O(1) in sequence length: the mLSTM states stacked
(superblock, layer) and the sLSTM states stacked by superblock, as the
reference stacks them, written in place.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models import xlstm as X

Params = Dict[str, Any]


def _n_super(cfg) -> int:
    if cfg.num_layers % cfg.xlstm_slstm_every:
        raise ValueError(f"{cfg.num_layers} layers are not superblocks of "
                         f"{cfg.xlstm_slstm_every}")
    return cfg.num_layers // cfg.xlstm_slstm_every


def init_params(cfg, generator: torch.Generator) -> Params:
    """Random parameters from ``generator``, on its device."""
    dt = L.dtype_of(cfg.dtype)
    dev = generator.device
    nm = cfg.xlstm_slstm_every - 1            # mLSTM layers per superblock
    table = torch.randn((cfg.padded_vocab, cfg.d_model), generator=generator,
                        dtype=torch.float32, device=dev)
    blocks = [{"mlstm": [X.init_mlstm_params(cfg, generator) for _ in range(nm)],
               "slstm": X.init_slstm_params(cfg, generator)} for _ in range(_n_super(cfg))]
    return {
        "embed": (table * 0.02).to(dt),
        "blocks": blocks,
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
    }


def forward_train(cfg, params: Params, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V), a float32 0: no aux loss)."""
    x = L.embed(tokens, params["embed"])
    mblock = functools.partial(X.mlstm_train, cfg)
    sblock = functools.partial(X.slstm_train, cfg)
    if cfg.remat:
        mblock, sblock = L.remat(mblock), L.remat(sblock)
    for bp in params["blocks"]:
        for mp in bp["mlstm"]:
            x = mblock(mp, x)
        x = sblock(bp["slstm"], x)
    x = L.rmsnorm(x, params["final_norm"])
    return (L.logits_from_hidden(x, params["embed"]),
            torch.zeros((), dtype=torch.float32, device=x.device))


def loss_fn(cfg, params: Params, batch):
    """(loss, metrics ``loss`` and ``nll``): the cross-entropy with its
    z-loss, as the reference's (no aux term)."""
    logits, _ = forward_train(cfg, params, batch["tokens"])
    return L.cross_entropy(logits, batch["labels"], batch.get("mask"))


def init_cache(cfg, batch: int, max_len: int, device) -> Dict[str, Any]:
    """Recurrent state only, no KV cache: {"m": the mLSTM states (NS, NM,
    B, …), "s": the sLSTM states (NS, B, D), "len"}; ``max_len`` is
    unused, as in the reference."""
    ns, nm = _n_super(cfg), cfg.xlstm_slstm_every - 1
    mstate = X.init_mlstm_state(cfg, batch, device)
    sstate = X.init_slstm_state(cfg, batch, device)
    return {
        "m": {n: t.expand(ns, nm, *t.shape).clone() for n, t in mstate.items()},
        "s": {n: t.expand(ns, *t.shape).clone() for n, t in sstate.items()},
        "len": 0,
    }


def decode_step(cfg, params: Params, cache, token: torch.Tensor):
    """token (B,) -> (logits (B, V), cache advanced by one position); the
    cache's tensors are written in place."""
    x = L.embed(token[:, None], params["embed"])
    mstate, sstate = cache["m"], cache["s"]
    for j, bp in enumerate(params["blocks"]):
        for i, mp in enumerate(bp["mlstm"]):
            x, st = X.mlstm_decode(cfg, mp, x, {n: t[j, i] for n, t in mstate.items()})
            for n, t in st.items():
                mstate[n][j, i] = t
        x, st = X.slstm_decode(cfg, bp["slstm"], x, {n: t[j] for n, t in sstate.items()})
        for n, t in st.items():
            sstate[n][j] = t
    x = L.rmsnorm(x[:, 0], params["final_norm"])
    logits = L.logits_from_hidden(x, params["embed"])
    return logits, {"m": mstate, "s": sstate, "len": int(cache["len"]) + 1}


def prefill(cfg, params: Params, tokens: torch.Tensor):
    """Parallel prefill: the training forward collecting each layer's
    final recurrent state (a cache of O(1) size whatever the prompt)."""
    x = L.embed(tokens, params["embed"])
    m_all, s_all = [], []
    for bp in params["blocks"]:
        mstates = []
        for mp in bp["mlstm"]:
            x, st = X.mlstm_train(cfg, mp, x, return_state=True)
            mstates.append(st)
        x, st = X.slstm_train(cfg, bp["slstm"], x, return_state=True)
        m_all.append({n: torch.stack([m[n] for m in mstates]) for n in mstates[0]})
        s_all.append(st)
    x = L.rmsnorm(x[:, -1], params["final_norm"])
    logits = L.logits_from_hidden(x, params["embed"])
    cache = {"m": {n: torch.stack([m[n] for m in m_all]) for n in m_all[0]},
             "s": {n: torch.stack([s[n] for s in s_all]) for n in s_all[0]},
             "len": int(tokens.shape[1])}
    return logits, cache
