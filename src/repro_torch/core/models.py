"""Stage models for the RMI: closed-form linear fits and small MLPs.

The paper (§3.3) uses two model families: 0-hidden-layer nets (= linear
regression, trained optimally in closed form) and 1-2 hidden-layer ReLU
nets of width 4-32.  Inputs may be scalars (numeric keys) or
fixed-length vectors (tokenized strings, §3.5).  The closed-form fits
are the reference's NumPy, verbatim; the MLP is trained in torch with
the same hand-rolled Adam.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

# --------------------------------------------------------------------------
# Closed-form linear regression (float64, numpy): exact, fast, the
# workhorse for last-stage models.
# --------------------------------------------------------------------------

def linear_fit(x: np.ndarray, y: np.ndarray) -> tuple[float, float]:
    """Least-squares fit y ≈ slope * x + intercept.  x, y are 1-D."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = x.size
    if n == 0:
        return 0.0, 0.0
    if n == 1:
        return 0.0, float(y[0])
    sx, sy = x.sum(), y.sum()
    sxx, sxy = (x * x).sum(), (x * y).sum()
    denom = n * sxx - sx * sx
    if abs(denom) < 1e-30:
        return 0.0, float(sy / n)
    slope = (n * sxy - sx * sy) / denom
    intercept = (sy - slope * sx) / n
    return float(slope), float(intercept)


def segmented_linear_fit(
    x: np.ndarray, y: np.ndarray, seg: np.ndarray, num_segments: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized per-segment least squares.

    Fits y ≈ a[s]*x + b[s] for every segment s in [0, num_segments).
    Empty segments are interpolated from their neighbours so that the
    piecewise model stays roughly monotone across the key space.

    Returns (slope, intercept, count) each of shape (num_segments,).
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    seg = np.asarray(seg, dtype=np.int64)
    m = num_segments
    cnt = np.bincount(seg, minlength=m).astype(np.float64)
    sx = np.bincount(seg, weights=x, minlength=m)
    sy = np.bincount(seg, weights=y, minlength=m)
    sxx = np.bincount(seg, weights=x * x, minlength=m)
    sxy = np.bincount(seg, weights=x * y, minlength=m)
    denom = cnt * sxx - sx * sx
    safe = np.abs(denom) > 1e-30
    slope = np.zeros(m)
    intercept = np.zeros(m)
    np.divide(cnt * sxy - sx * sy, denom, out=slope, where=safe)
    with np.errstate(invalid="ignore"):
        mean_y = np.divide(sy, cnt, out=np.zeros(m), where=cnt > 0)
        mean_x = np.divide(sx, cnt, out=np.zeros(m), where=cnt > 0)
    intercept = np.where(safe, mean_y - slope * mean_x, mean_y)
    # Empty segments: linearly interpolate intercept from populated
    # neighbours, slope 0 — a query landing there gets a sane position
    # estimate (bounded by construction since no stored key maps there).
    empty = cnt == 0
    if empty.any() and (~empty).any():
        idx = np.arange(m)
        filled = idx[~empty]
        intercept[empty] = np.interp(idx[empty], filled, mean_y[~empty])
        slope[empty] = 0.0
    return slope, intercept, cnt


# --------------------------------------------------------------------------
# Small MLP (0-2 hidden layers, ReLU), trained with Adam in torch.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLPSpec:
    in_dim: int = 1
    hidden: tuple = ()          # e.g. () linear, (32,), (16, 16)
    dtype: torch.dtype = torch.float32

    @property
    def num_params(self) -> int:
        dims = (self.in_dim, *self.hidden, 1)
        return sum((a + 1) * b for a, b in zip(dims[:-1], dims[1:]))

    @property
    def size_bytes(self) -> int:
        return self.num_params * np.dtype(np.float32).itemsize

    @property
    def flops_per_query(self) -> int:
        dims = (self.in_dim, *self.hidden, 1)
        return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def mlp_init(
    spec: MLPSpec, generator: torch.Generator, device=None
) -> Dict[str, torch.Tensor]:
    """He-normal weights, zero biases, drawn from ``generator`` (a CPU
    generator; the tensors then move to ``device``)."""
    dims = (spec.in_dim, *spec.hidden, 1)
    params = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        w = torch.randn((a, b), generator=generator, dtype=spec.dtype)
        params[f"w{i}"] = (w * np.sqrt(2.0 / a)).to(device)
        params[f"b{i}"] = torch.zeros((b,), dtype=spec.dtype, device=device)
    return params


def mlp_apply(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """x: (B,) scalar keys or (B, D) vector keys -> (B,) predictions
    (training forward pass; lookups use the fixed-order
    `stage0_apply`)."""
    h = x[:, None] if x.ndim == 1 else x
    n_layers = len(params) // 2
    for i in range(n_layers):
        h = h @ params[f"w{i}"] + params[f"b{i}"]
        if i < n_layers - 1:
            h = torch.relu(h)
    return h[:, 0]


def mlp_train(
    spec: MLPSpec,
    x: np.ndarray,
    y: np.ndarray,
    *,
    steps: int = 400,
    lr: float = 1e-2,
    batch_size: Optional[int] = 65536,
    seed: int = 0,
    device=None,
    verbose: bool = False,
) -> Dict[str, np.ndarray]:
    """Full- or mini-batch Adam on squared error.  Targets are scaled to
    [0, 1] internally; the output layer is rescaled at the end so the
    returned params predict raw positions directly.  Returns host
    float32 arrays, as the reference does."""
    x = np.asarray(x, dtype=np.float32)
    y = np.asarray(y, dtype=np.float32)
    y_scale = max(float(y.max()), 1.0)
    yn = y / y_scale

    if not spec.hidden:
        # closed form: no need to iterate.
        if x.ndim == 1:
            slope, intercept = linear_fit(x, y)
            return {
                "w0": np.array([[slope]], np.float32),
                "b0": np.array([intercept], np.float32),
            }
        # multivariate least squares with ridge for stability
        xd = np.asarray(x, np.float64)
        a = np.concatenate([xd, np.ones((xd.shape[0], 1))], axis=1)
        ata = a.T @ a + 1e-6 * np.eye(a.shape[1])
        w = np.linalg.solve(ata, a.T @ np.asarray(y, np.float64))
        return {
            "w0": w[:-1, None].astype(np.float32),
            "b0": w[-1:].astype(np.float32),
        }

    gen = torch.Generator().manual_seed(seed)
    params = mlp_init(spec, gen, device)
    for p in params.values():
        p.requires_grad_(True)

    # hand-rolled Adam (no torch.optim, mirroring the reference)
    beta1, beta2, eps = 0.9, 0.999, 1e-8
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    xt = torch.as_tensor(x, device=device)
    yt = torch.as_tensor(yn, device=device)

    rng = np.random.default_rng(seed)
    n = x.shape[0]
    for t in range(1, steps + 1):
        if batch_size is not None and batch_size < n:
            idx = torch.as_tensor(rng.integers(0, n, batch_size), device=device)
            xb, yb = xt[idx], yt[idx]
        else:
            xb, yb = xt, yt
        loss = torch.mean((mlp_apply(params, xb) - yb) ** 2)
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                m[k] = beta1 * m[k] + (1 - beta1) * g
                v[k] = beta2 * v[k] + (1 - beta2) * g * g
                mhat = m[k] / (1 - beta1**t)
                vhat = v[k] / (1 - beta2**t)
                p -= lr * mhat / (torch.sqrt(vhat) + eps)
        if verbose and t % 100 == 0:
            print(f"  mlp step {t}: loss={float(loss):.3e}")

    out = {k: p.detach().cpu().numpy().astype(np.float32) for k, p in params.items()}
    # fold the target scale back into the last layer
    last = len(out) // 2 - 1
    out[f"w{last}"] = out[f"w{last}"] * y_scale
    out[f"b{last}"] = out[f"b{last}"] * y_scale
    return out


# --------------------------------------------------------------------------
# Stage-0 inference with a fixed rounding order (build AND lookup).
# --------------------------------------------------------------------------
# The RMI window contract needs the build-time leaf assignment and the
# lookup-time one to agree bit for bit.  Every multiply-add below is a
# separate float32 multiply and a separate float32 add, and each output
# sums over its inputs in ascending order:
#   acc = h0*w0j; acc += h1*w1j; ...; out = acc + bj
# The CUDA kernel (kernels/csrc/rmi_lookup.cu) does the same with
# __fmul_rn / __fadd_rn, so both devices agree with this function.
# Vector keys (in_dim D > 1) take the same order over their D inputs;
# the kernels take scalar keys only.

def stage0_dims(hidden: tuple, in_dim: int = 1) -> tuple:
    return (int(in_dim), *tuple(int(h) for h in hidden), 1)


def pack_stage0(params: Dict[str, np.ndarray]) -> np.ndarray:
    """{w0, b0, w1, b1, ...} -> one flat float32 array, layer by layer:
    w_i row-major (in_i, out_i), then b_i (out_i,)."""
    nl = len(params) // 2
    parts = []
    for i in range(nl):
        parts.append(np.asarray(params[f"w{i}"], np.float32).reshape(-1))
        parts.append(np.asarray(params[f"b{i}"], np.float32).reshape(-1))
    return np.concatenate(parts)


def stage0_apply(s0: torch.Tensor, hidden: tuple, q: torch.Tensor) -> torch.Tensor:
    """Stage-0 prediction p0 for (B,) float32 scalar queries or (B, D)
    vector queries (in_dim D) from the flat parameter buffer ``s0``
    (`pack_stage0`), in the fixed order above."""
    h = [q] if q.ndim == 1 else list(q.unbind(1))
    dims = stage0_dims(hidden, len(h))
    off = 0
    for i in range(len(dims) - 1):
        din, dout = dims[i], dims[i + 1]
        w = s0[off : off + din * dout].reshape(din, dout)
        off += din * dout
        b = s0[off : off + dout]
        off += dout
        out = []
        for j in range(dout):
            acc = h[0] * w[0, j]
            for k in range(1, din):
                acc = acc + h[k] * w[k, j]
            acc = acc + b[j]
            if i < len(dims) - 2:
                acc = torch.where(acc > 0, acc, torch.zeros_like(acc))
            out.append(acc)
        h = out
    return h[0]
