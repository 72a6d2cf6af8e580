"""Mamba (selective SSM) block, the sub-quadratic half of Jamba (the
reference's `repro/models/mamba.py`, function for function).

Training runs the selective scan chunk by chunk: the (B, di, ds) state
crosses chunk boundaries and, under ``cfg.remat``, each chunk is
recomputed in the backward pass (`layers.remat`), so the live set is
one chunk's worth plus the boundary states.  Inside a chunk the
discretised ``a_bar`` and ``b·x`` are formed for the whole chunk at once
(the reference forms them step by step; the elementwise operations are
the same), the time loop carries only ``h = a_bar·h + b·x``, and the
readout ``y = h·c`` runs over the chunk's stacked states after the loop:
a Python loop launches a few ops a step where the reference's
`lax.scan` compiles one.  Decode is a single-step state update, O(1) in
sequence length.

``a_log``, ``dt_bias`` and ``d_skip`` are float32 whatever ``cfg.dtype``
is; every other leaf is in ``cfg.dtype``.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding
from repro_torch.models import layers as L

# leaves held in float32 whatever cfg.dtype is (reference mamba.py:37-40)
F32_LEAVES = ("dt_bias", "a_log", "d_skip")


def _d_inner(cfg) -> int:
    return cfg.mamba_d_inner or 2 * cfg.d_model


def param_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """Each leaf of one Mamba mixer and its shape."""
    d, di, ds = cfg.d_model, _d_inner(cfg), cfg.mamba_d_state
    return {"ln": (d,), "in_proj": (d, 2 * di), "conv_w": (cfg.mamba_d_conv, di),
            "conv_b": (di,), "w_bcdt": (di, 2 * ds + cfg.dt_rank),
            "w_dt": (cfg.dt_rank, di), "dt_bias": (di,), "a_log": (di, ds),
            "d_skip": (di,), "out_proj": (di, d)}


def leaf_dtype(cfg, name: str) -> torch.dtype:
    return torch.float32 if name in F32_LEAVES else L.dtype_of(cfg.dtype)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) = max(x, 0) + log1p(e^-|x|) for
    every x (torch's own returns x above its threshold of 20)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def init_mamba_params(cfg, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """One mixer's parameters on the generator's device: S4D-real ``a_log``
    = log(1..ds), ``dt_bias`` = log(expm1(0.01)), ``d_skip`` = 1."""
    dt = L.dtype_of(cfg.dtype)
    dev = generator.device
    shapes = param_shapes(cfg)
    di, ds = shapes["a_log"]
    d = cfg.d_model
    conv = torch.randn(shapes["conv_w"], generator=generator, dtype=torch.float32,
                       device=dev)
    a_log = torch.log(torch.arange(1, ds + 1, dtype=torch.float32, device=dev))
    return {
        "ln": torch.ones((d,), dtype=dt, device=dev),
        "in_proj": L.init_dense(generator, *shapes["in_proj"], dt),
        "conv_w": (conv * 0.1).to(dt),
        "conv_b": torch.zeros((di,), dtype=dt, device=dev),
        "w_bcdt": L.init_dense(generator, *shapes["w_bcdt"], dt),
        "w_dt": L.init_dense(generator, *shapes["w_dt"], dt),
        "dt_bias": torch.full((di,), math.log(math.expm1(0.01)), dtype=torch.float32,
                              device=dev),
        "a_log": a_log.expand(di, ds).contiguous(),
        "d_skip": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": L.init_dense(generator, *shapes["out_proj"], dt),
    }


def _discretise(cfg, p, xc):
    """(dt (…, di) float32, b (…, ds) float32, c (…, ds) float32) from the
    conv output ``xc``."""
    ds = cfg.mamba_d_state
    bcdt = xc @ p["w_bcdt"]
    bmat, cmat, dt_low = torch.split(bcdt, [ds, ds, bcdt.shape[-1] - 2 * ds], dim=-1)
    dt = softplus((dt_low @ p["w_dt"]).float() + p["dt_bias"])
    return dt, bmat.float(), cmat.float()


def _scan_chunk(a, h0, dtc, xcc, bc, cc):
    """One chunk of the selective scan, time first: dtc, xcc (T, B, di),
    bc, cc (T, B, ds), h0 (B, di, ds).  Returns (h_T, y (T, B, di))."""
    a_bar = torch.exp(dtc[..., None] * a)                  # (T, B, di, ds)
    bx = (dtc * xcc)[..., None] * bc[:, :, None, :]
    h = h0
    hs = []
    for a_t, bx_t in zip(torch.unbind(a_bar), torch.unbind(bx)):
        h = torch.addcmul(bx_t, a_t, h)
        hs.append(h)
    y = torch.einsum("tbdn,tbn->tbd", torch.stack(hs), cc)
    return h, y


def _conv_state(xi: torch.Tensor, conv: int) -> torch.Tensor:
    """The last ``conv - 1`` rows of ``xi`` (B, S, di), left-padded with
    zeros when S < conv - 1: the history sequential decode from
    `init_mamba_state` would hold (ROADMAP queue C 25; the reference's
    ``xi[:, s - (conv - 1):]`` keeps fewer rows there)."""
    s = xi.shape[1]
    if s < conv - 1:
        xi = F.pad(xi, (0, 0, conv - 1 - s, 0))
    return xi[:, xi.shape[1] - (conv - 1):]


def _causal_conv(xi, conv_w, conv_b):
    """The causal depthwise conv over time of ``xi`` (B, S, di), in the
    activation dtype, the taps added in the reference's order, then SiLU."""
    s, conv = xi.shape[1], conv_w.shape[0]
    xpad = F.pad(xi, (0, 0, conv - 1, 0))
    return (F.silu(sum(xpad[:, i:i + s] * conv_w[i] for i in range(conv)) + conv_b),)


def _selective_scan(chunk, remat, a_log, dt, xcf, bf, cf):
    """The chunk loop of the selective scan over one block of rows and
    channels: dt, xcf (B, S, di), bf, cf (B, S, ds), a_log (di, ds).
    Returns (y (B, S, di), the final state (B, di, ds))."""
    b, s, di = dt.shape
    a = -torch.exp(a_log)
    step = L.remat(_scan_chunk) if remat else _scan_chunk
    # time first, so a chunk is a contiguous slice
    dt_t, x_t, b_t, c_t = (t.transpose(0, 1) for t in (dt, xcf, bf, cf))
    hh = torch.zeros((b, di, a.shape[-1]), dtype=torch.float32, device=dt.device)
    ys = []
    for i in range(0, s, chunk):
        hh, y = step(a, hh, *(t[i:i + chunk] for t in (dt_t, x_t, b_t, c_t)))
        ys.append(y)
    return torch.cat(ys).transpose(0, 1), hh


def mamba_train(cfg, p, x, *, chunk: int = 256, return_state: bool = False):
    """x (B, S, D) -> (B, S, D), the chunked selective scan; with
    ``return_state`` also the final {"h", "conv"} state (parallel prefill
    for serving).  On DTensors the conv and the whole scan each run in
    one `on_local_blocks` call on each rank's rows (over the dp axes) and
    channels (di over ``model``); ``B`` and ``C`` are replicated over
    ``model``, so their gradients there are partial sums, as are the
    parameters' over the dp axes.  ``w_bcdt``'s row-parallel product is
    reduced between the two calls."""
    b, s, _ = x.shape
    h = L.rmsnorm(x, p["ln"])
    xi, z = torch.chunk(h @ p["in_proj"], 2, dim=-1)     # (B, S, di)

    rows, chans = ("dp", None, None), ("dp", None, "tp")
    dp = ("dp",)
    (xc,) = sharding.on_local_blocks(_causal_conv, (xi, p["conv_w"], p["conv_b"]),
                                     (chans, (None, "tp"), ("tp",)), (chans,),
                                     grad_specs=(None, dp, dp))
    dt, bf, cf = _discretise(cfg, p, xc)
    xcf = xc.float()

    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the scan chunk {chunk}")
    y, hh = sharding.on_local_blocks(functools.partial(_selective_scan, chunk, cfg.remat),
                                     (p["a_log"], dt, xcf, bf, cf),
                                     (("tp", None), chans, chans, rows, rows),
                                     (chans, ("dp", "tp", None)),
                                     grad_specs=(dp, None, None, ("tp",), ("tp",)))
    y = y + p["d_skip"] * xcf
    y = y.to(x.dtype) * F.silu(z)
    out = x + y @ p["out_proj"]
    if return_state:
        return out, {"h": hh, "conv": _conv_state(xi, cfg.mamba_d_conv)}
    return out


def init_mamba_state(cfg, batch: int, device) -> Dict[str, torch.Tensor]:
    di = _d_inner(cfg)
    return {
        "h": torch.zeros((batch, di, cfg.mamba_d_state), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.mamba_d_conv - 1, di), dtype=L.dtype_of(cfg.dtype),
                            device=device),
    }


def mamba_decode(cfg, p, x, state) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, 1, D), O(1) state update; returns (x', new state)."""
    h = L.rmsnorm(x, p["ln"])
    xi, z = torch.chunk(h @ p["in_proj"], 2, dim=-1)     # (B, 1, di)
    hist = torch.cat([state["conv"], xi], dim=1)          # (B, conv, di)
    xc = torch.einsum("bcd,cd->bd", hist, p["conv_w"]) + p["conv_b"]
    xc = F.silu(xc)
    dt, bf, cf = _discretise(cfg, p, xc)                  # (B, di), (B, ds)
    a = -torch.exp(p["a_log"])
    a_bar = torch.exp(dt[..., None] * a)                  # (B, di, ds)
    bx = (dt * xc.float())[..., None] * bf[:, None, :]
    hnew = a_bar * state["h"] + bx
    y = torch.einsum("bdn,bn->bd", hnew, cf)
    y = y + p["d_skip"] * xc.float()
    y = y.to(x.dtype)[:, None] * F.silu(z)
    out = x + y @ p["out_proj"]
    return out, {"h": hnew, "conv": hist[:, 1:]}
