"""xLSTM blocks (Beck et al. 2024): mLSTM (matrix memory) and sLSTM (the
reference's `repro/models/xlstm.py`, function for function).

Both cells use exponential gating with the max-stabiliser m_t; the
mLSTM keeps a per-head (dk × dv) matrix state, the sLSTM a
scalar-per-unit state with a recurrent hidden connection.  Training
scans over time, the mLSTM in chunks (its state crosses chunk
boundaries; under ``cfg.remat`` each chunk is recomputed in the
backward pass); decode is a single state update.

A Python loop launches a few ops a step where the reference's
`lax.scan` compiles one, so the training scans move out of the loop
what does not need the state: the mLSTM's chunk loop carries the
stabiliser first (``m`` alone), forms both gates for the whole chunk,
then carries ``c`` and ``n`` and reads ``c·q`` each step, and divides by
the ``max(|n·q|, 1)`` denominators after the loop; the input gate
multiplies ``k`` before the outer product with ``v`` (one rounding
moved).  The sLSTM's four recurrent products run as one product with
the weights side by side.  `_mlstm_step` and `_slstm_step` are the
reference's single steps, which decode runs.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import unsplit_dim
from repro_torch.models import layers as L

M0 = -1e30          # the stabiliser's initial value


def _dims(cfg):
    d = cfg.d_model
    h = cfg.num_heads
    dv = (cfg.xlstm_proj_factor * d) // h     # value dim per head
    dk = dv // 2                              # qk dim per head (0.5 factor)
    return d, h, dk, dv


def mlstm_param_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    d, h, dk, dv = _dims(cfg)
    return {"ln": (d,), "wq": (d, h * dk), "wk": (d, h * dk), "wv": (d, h * dv),
            "wz": (d, h * dv), "wi": (d, h), "wf": (d, h), "wo": (h * dv, d),
            "out_ln": (h * dv,)}


def slstm_param_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    d = cfg.d_model
    return {"ln": (d,), **{n: (d, d) for n in ("wi", "wf", "wz", "wo_gate", "ri", "rf",
                                               "rz", "ro", "wo")}}


def _init(cfg, generator, shapes) -> Dict[str, torch.Tensor]:
    dt = L.dtype_of(cfg.dtype)
    return {name: (torch.ones(shape, dtype=dt, device=generator.device) if len(shape) == 1
                   else L.init_dense(generator, *shape, dt))
            for name, shape in shapes.items()}


def init_mlstm_params(cfg, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """``wi`` / ``wf`` are the per-head input and forget gates, ``wz`` the
    output gate path, ``out_ln`` the norm over the heads' outputs."""
    return _init(cfg, generator, mlstm_param_shapes(cfg))


def init_slstm_params(cfg, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """``r*`` are the recurrent weights (dense here, head-wise in the
    paper, as in the reference)."""
    return _init(cfg, generator, slstm_param_shapes(cfg))


def _mlstm_step(qt, kt, vt, it, ft, state):
    """One timestep. qt/kt: (B,H,dk); vt: (B,H,dv); it/ft: (B,H)."""
    c, n, m = state                           # (B,H,dk,dv), (B,H,dk), (B,H)
    m_new = torch.maximum(ft + m, it)
    i = torch.exp(it - m_new)
    f = torch.exp(ft + m - m_new)
    c = f[..., None, None] * c + i[..., None, None] * (kt[..., :, None] * vt[..., None, :])
    n = f[..., None] * n + i[..., None] * kt
    denom = torch.clamp(torch.einsum("bhk,bhk->bh", n, qt).abs(), min=1.0)
    ht = torch.einsum("bhkv,bhk->bhv", c, qt) / denom[..., None]
    return ht, (c, n, m_new)


def _mlstm_qkv(cfg, p, hin):
    """q, k / sqrt(dk), v (…, H, d) and the gates' pre-activations
    (input, forget: its log-sigmoid is taken where the state is, on
    local blocks) (…, H), all float32."""
    _, h, dk, dv = _dims(cfg)
    lead = hin.shape[:-1]

    def heads(t, d):
        return unsplit_dim(t, -1, h).reshape(*lead, h, d).float()

    q = heads(hin @ p["wq"], dk)
    k = heads(hin @ p["wk"], dk) / torch.sqrt(torch.tensor(float(dk), dtype=torch.float32))
    v = heads(hin @ p["wv"], dv)
    ig = (hin @ p["wi"]).float()
    f_pre = (hin @ p["wf"]).float()
    return q, k, v, ig, f_pre


def _mlstm_scan(c, n, m, q, k, v, ig, fg):
    """One chunk of the mLSTM scan, time first: q, k (T, B, H, dk), v
    (T, B, H, dv), ig, fg (T, B, H); state c (B, H, dk, dv), n (B, H,
    dk), m (B, H).  Returns (c, n, m, h (T, B, H, dv))."""
    m_prev = [m]
    for f_t, i_t in zip(torch.unbind(fg), torch.unbind(ig)):
        m_prev.append(torch.maximum(f_t + m_prev[-1], i_t))
    m_new = torch.stack(m_prev[1:])
    m_old = torch.stack(m_prev[:-1])
    i_gate = torch.exp(ig - m_new)
    f_gate = torch.exp(fg + m_old - m_new)
    ik = i_gate[..., None] * k
    ns, nums = [], []
    for f_t, ik_t, v_t, q_t in zip(torch.unbind(f_gate), torch.unbind(ik),
                                   torch.unbind(v), torch.unbind(q)):
        c = torch.addcmul(f_t[..., None, None] * c, ik_t[..., :, None], v_t[..., None, :])
        n = torch.addcmul(ik_t, f_t[..., None], n)
        ns.append(n)
        nums.append((q_t[..., None, :] @ c)[..., 0, :])
    denom = torch.clamp(torch.einsum("tbhk,tbhk->tbh", torch.stack(ns), q).abs(), min=1.0)
    return c, n, m_prev[-1], torch.stack(nums) / denom[..., None]


def _mlstm_chunks(chunk, remat, q, k, v, ig, f_pre):
    """The chunk loop over one block of rows and heads, time first (the
    shapes of `_mlstm_scan`, the forget gate's pre-activation in): the
    state starts at zero and crosses chunk boundaries.  Returns (h (B, T,
    H·dv), c, n, m)."""
    t, b, h, dk = q.shape
    fg = F.logsigmoid(f_pre)
    step = L.remat(_mlstm_scan) if remat else _mlstm_scan
    c = torch.zeros((b, h, dk, v.shape[-1]), dtype=torch.float32, device=q.device)
    n = torch.zeros((b, h, dk), dtype=torch.float32, device=q.device)
    m = torch.full((b, h), M0, dtype=torch.float32, device=q.device)
    hs = []
    for i in range(0, t, chunk):
        c, n, m, ht = step(c, n, m, *(x[i:i + chunk] for x in (q, k, v, ig, fg)))
        hs.append(ht)
    return torch.cat(hs).transpose(0, 1).reshape(b, t, -1), c, n, m


def mlstm_train(cfg, p, x, *, chunk: int = 256, return_state: bool = False):
    """x (B, S, D) -> (B, S, D), the chunkwise mLSTM: the (B, H, dk, dv)
    matrix state crosses chunk boundaries; with ``return_state`` also the
    final {"c", "n", "m"}.  On DTensors the whole chunk loop runs on each
    rank's rows (over the dp axes) and heads (over ``model`` where they
    divide it) in one `on_local_blocks` call; the norm over H·dv outside
    spans ranks."""
    s = x.shape[1]
    hin = L.rmsnorm(x, p["ln"])
    q, k, v, ig, f_pre = (t.transpose(0, 1) for t in _mlstm_qkv(cfg, p, hin))

    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the scan chunk {chunk}")
    heads, gates = (None, "dp", "tp", None), (None, "dp", "tp")
    hs, c, n, m = sharding.on_local_blocks(
        functools.partial(_mlstm_chunks, chunk, cfg.remat), (q, k, v, ig, f_pre),
        (heads, heads, heads, gates, gates),
        (("dp", None, "tp"), ("dp", "tp", None, None), ("dp", "tp", None), ("dp", "tp")))
    hs = L.rmsnorm(hs.to(x.dtype), p["out_ln"])
    z = F.silu(hin @ p["wz"])
    out = x + (hs * z) @ p["wo"]
    if return_state:
        return out, {"c": c, "n": n, "m": m}
    return out


def _slstm_gates(pre, state):
    """The sLSTM's pointwise step from the four float32 pre-activations
    (input, forget, cell, output) side by side in ``pre`` (B, 4D):
    (c, n, m, h float32)."""
    c, n, m = state
    it, f_pre, z_pre, o_pre = torch.chunk(pre, 4, dim=-1)
    ft = F.logsigmoid(f_pre)
    zt = torch.tanh(z_pre)
    ot = torch.sigmoid(o_pre)
    fm = ft + m
    m_new = torch.maximum(fm, it)
    i = torch.exp(it - m_new)
    f = torch.exp(fm - m_new)
    c = f * c + i * zt
    n = f * n + i
    return c, n, m_new, ot * (c / torch.clamp(n, min=1.0))


def _slstm_step(p, xt, state):
    """xt: the four (B, D) pre-activations computed outside; the
    recurrent part here.  Returns ((c, n, m, h in xt's dtype), h
    float32)."""
    c, n, m, hprev = state
    pre = torch.cat([(x + hprev @ p[r]).float()
                     for x, r in zip(xt, ("ri", "rf", "rz", "ro"))], dim=-1)
    c, n, m, h = _slstm_gates(pre, (c, n, m))
    return (c, n, m, h.to(xt[0].dtype)), h


def _slstm_loop(xs, r):
    """The sLSTM's loop over time on one block of rows with every
    channel: xs (B, S, 4D) the four input pre-activations side by side,
    r (D, 4D) the recurrent weights in the same order.  Returns (h (B, S,
    D) float32, c, n, m, h_S in xs' dtype)."""
    b, _, d4 = xs.shape
    d = d4 // 4
    c = torch.zeros((b, d), dtype=torch.float32, device=xs.device)
    n = torch.zeros((b, d), dtype=torch.float32, device=xs.device)
    m = torch.full((b, d), M0, dtype=torch.float32, device=xs.device)
    hprev = torch.zeros((b, d), dtype=xs.dtype, device=xs.device)
    hs = []
    for x_t in torch.unbind(xs, dim=1):
        c, n, m, h = _slstm_gates((x_t + hprev @ r).float(), (c, n, m))
        hprev = h.to(xs.dtype)
        hs.append(h)
    return torch.stack(hs, dim=1), c, n, m, hprev


def slstm_train(cfg, p, x, *, return_state: bool = False):
    """x (B, S, D) -> (B, S, D); with ``return_state`` also the final
    {"c", "n", "m", "h"}.  The recurrence ``h @ r`` mixes every channel
    at every step, so on DTensors the four recurrent weights are joined
    (and gathered) once a call, and the loop runs on each rank's rows
    with every channel in one `on_local_blocks` call, replicated over
    ``model``; ``r``'s gradient there is a partial sum over the dp
    axes."""
    hin = L.rmsnorm(x, p["ln"])
    xs = torch.cat([hin @ p[w] for w in ("wi", "wf", "wz", "wo_gate")], dim=-1)
    r = torch.cat([p[w] for w in ("ri", "rf", "rz", "ro")], dim=-1)   # (D, 4D)
    rows, state = ("dp", None, None), ("dp", None)
    hs, c, n, m, hprev = sharding.on_local_blocks(
        _slstm_loop, (xs, r), (rows, (None, None)), (rows, state, state, state, state),
        grad_specs=(None, ("dp",)))
    hs = hs.to(x.dtype)
    out = x + hs @ p["wo"]
    if return_state:
        return out, {"c": c, "n": n, "m": m, "h": hprev}
    return out


# ---------------------------------------------------------------------------
# Decode-time state (O(1) in sequence length)
# ---------------------------------------------------------------------------

def init_mlstm_state(cfg, batch: int, device) -> Dict[str, torch.Tensor]:
    _, h, dk, dv = _dims(cfg)
    return {
        "c": torch.zeros((batch, h, dk, dv), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, h, dk), dtype=torch.float32, device=device),
        "m": torch.full((batch, h), M0, dtype=torch.float32, device=device),
    }


def mlstm_decode(cfg, p, x, state):
    """x (B, 1, D) -> (x', new state)."""
    b = x.shape[0]
    _, h, _, dv = _dims(cfg)
    hin = L.rmsnorm(x, p["ln"])                           # (B,1,D)
    q, k, v, ig, f_pre = (t[:, 0] for t in _mlstm_qkv(cfg, p, hin))
    ht, (c, n, m) = _mlstm_step(q, k, v, ig, F.logsigmoid(f_pre),
                                (state["c"], state["n"], state["m"]))
    hs = L.rmsnorm(ht.reshape(b, 1, h * dv).to(x.dtype), p["out_ln"])
    z = F.silu(hin @ p["wz"])
    return x + (hs * z) @ p["wo"], {"c": c, "n": n, "m": m}


def init_slstm_state(cfg, batch: int, device) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    return {
        "c": torch.zeros((batch, d), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, d), dtype=torch.float32, device=device),
        "m": torch.full((batch, d), M0, dtype=torch.float32, device=device),
        "h": torch.zeros((batch, d), dtype=L.dtype_of(cfg.dtype), device=device),
    }


def slstm_decode(cfg, p, x, state):
    """x (B, 1, D) -> (x', new state)."""
    hin = L.rmsnorm(x, p["ln"])[:, 0]
    xt = tuple(hin @ p[w] for w in ("wi", "wf", "wz", "wo_gate"))
    (c, n, m, h), hs = _slstm_step(p, xt, (state["c"], state["n"], state["m"], state["h"]))
    out = x + (hs.to(x.dtype) @ p["wo"])[:, None]
    return out, {"c": c, "n": n, "m": m, "h": h}
