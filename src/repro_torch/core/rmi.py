"""The Recursive Model Index (paper §3.2), batched in torch.

Two stages (the paper's best configuration throughout §3.6):

  stage 0: one model (linear or small ReLU MLP) over the whole key space;
           its prediction picks one of M leaf models:
           ``leaf = clip(floor(f0(x) * M / N), 0, M-1)``.
  stage 1: M linear models stored structure-of-arrays — slope[M],
           intercept[M] (vector keys: W[M, D], b[M]) — plus per-leaf
           min/max residual bounds and residual σ for the biased
           searches.

The builder is the reference's host NumPy, with the stage-0 leaf
assignment computed by the same fixed-order float32 arithmetic the
lookups use (`models.stage0_apply`).  A vector key's leaf position
``Σ w·q + b`` is summed in that order too, at build and at lookup
(`leaf_dot`), where the reference sums with ``np.sum`` at build and
``jnp.sum`` at lookup.  The lookup kernels take scalar keys only; vector
keys (tokenized strings, `core.strings`) run the plain torch path.

Error-bound contract (paper §2): bounds are computed *post hoc* over the
stored keys with float32 arithmetic, separately rounded multiply and
add, exactly as at lookup time, so any stored key falls inside its
leaf's window.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import search as search_lib
from repro_torch.core.keys import KeySet, VectorKeySet
from repro_torch.core.models import (
    MLPSpec,
    mlp_train,
    pack_stage0,
    segmented_linear_fit,
    stage0_apply,
)
from repro_torch.device import resolve_device


@dataclasses.dataclass
class RMIConfig:
    """Index specification — what LIF grid-searches over."""

    num_leaves: int = 10_000
    stage0_hidden: tuple = (16, 16)   # () = linear stage-0
    stage0_train_steps: int = 300
    stage0_sample: Optional[int] = 200_000  # train stage-0 on a sample
    stage0_lr: float = 1e-2
    hybrid_threshold: Optional[int] = None  # Algorithm 1 line 13; None = pure RMI
    seed: int = 0


@dataclasses.dataclass
class RMIndex:
    """Built index: host NumPy SoA + static metadata; `as_tree(device)`
    yields the tensor view the lookups take."""

    config: RMIConfig
    n: int
    num_leaves: int
    in_dim: int
    stage0_params: Dict[str, np.ndarray]
    leaf_w: np.ndarray          # (M,) float32, or (M, D) for vector keys
    leaf_b: np.ndarray          # (M,)
    err_lo: np.ndarray          # (M,) float32 <= 0
    err_hi: np.ndarray          # (M,) float32 >= 0
    sigma: np.ndarray           # (M,) float32
    is_btree: np.ndarray        # (M,) bool — hybrid leaves (Algorithm 1)
    seg_lo: np.ndarray          # (M,) int32 first position covered by leaf
    seg_hi: np.ndarray          # (M,) int32 last position covered by leaf
    max_window: int             # static worst-case search window

    # ---- reporting ------------------------------------------------------
    @property
    def model_size_bytes(self) -> int:
        """Paper-style size: model parameters only (Fig 4-6 'Size (MB)')."""
        s0 = sum(int(p.size) for p in self.stage0_params.values()) * 4
        leaves = int(self.leaf_w.size + self.leaf_b.size) * 4
        return s0 + leaves

    @property
    def hidden(self) -> tuple:
        return tuple(self.config.stage0_hidden)

    @property
    def ratio(self) -> np.float32:
        """Leaf-select scale f32(M / n): the divide in float64, then
        one rounding — what the reference's weak-typed Python float
        does."""
        return np.float32(self.num_leaves / self.n)

    def as_tree(self, device) -> Dict[str, torch.Tensor]:
        """The lookups' tensors on ``device``.  For scalar keys the four
        leaf arrays are the column views of one `pack_leaves` record;
        for vector keys they are separate tensors."""
        dev = torch.device(device)
        t = {
            k: torch.as_tensor(getattr(self, k), device=dev)
            for k in ("sigma", "seg_lo", "seg_hi", "is_btree")
        }
        leaves = [torch.as_tensor(getattr(self, k), device=dev) for k in LEAF_FIELDS]
        if self.in_dim == 1:
            leaves = pack_leaves(*leaves).unbind(1)
        t.update(zip(LEAF_FIELDS, leaves))
        t["s0"] = torch.as_tensor(pack_stage0(self.stage0_params), device=dev)
        return t


LEAF_FIELDS = ("leaf_w", "leaf_b", "err_lo", "err_hi")


def pack_leaves(leaf_w, leaf_b, err_lo, err_hi) -> torch.Tensor:
    """The (M, 4) float32 leaf record (w, b, err_lo, err_hi) the lookup
    kernels read with one 16-byte load a query."""
    return torch.stack([leaf_w, leaf_b, err_lo, err_hi], dim=1)


def leaf_dot(w, q):
    """Row-wise ``Σ_k w[:, k] * q[:, k]`` of (B, D) float32 arrays, NumPy
    or torch: each product and each add rounded separately, in ascending
    k, the order of `models.stage0_apply`, so the build's positions and
    the lookup's agree bit for bit."""
    acc = w[:, 0] * q[:, 0]
    for k in range(1, q.shape[1]):
        acc = acc + w[:, k] * q[:, k]
    return acc


def leaf_position(w: torch.Tensor, b: torch.Tensor, q: torch.Tensor,
                  n: int) -> torch.Tensor:
    """The leaf position ``w * q + b`` clipped to [0, f32(n - 1)], with
    +inf taking f32(n - 1), the end of the key range, whatever the
    slope: on a leaf of slope 0 (keys that share one float32 value)
    ``0 * inf`` is NaN, which the clamp would send to 0 (ROADMAP queue
    C 17).  -inf and NaN clamp to 0.  Vector keys (q of shape (B, D),
    w of (B, D)) take ``leaf_dot(w, q) + b``, clipped the same way."""
    nm1 = float(np.float32(n - 1))
    if q.ndim == 2:
        return search_lib.clampf(leaf_dot(w, q) + b, 0.0, nm1)
    pos = torch.where(q == torch.inf, nm1, w * q + b)
    return search_lib.clampf(pos, 0.0, nm1)


def leaf_and_pos(
    s0: torch.Tensor, hidden: tuple, leaf_w: torch.Tensor,
    leaf_b: torch.Tensor, q: torch.Tensor, *, n: int, num_leaves: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage-0 -> leaf select -> clipped leaf position: the arithmetic
    the CUDA kernel repeats with __fmul_rn / __fadd_rn."""
    p0 = stage0_apply(s0, hidden, q)
    ratio = torch.tensor(np.float32(num_leaves / n), device=q.device)
    leaf = torch.clamp(
        search_lib.to_index(torch.floor(p0 * ratio)), max=num_leaves - 1
    )
    return leaf, leaf_position(leaf_w[leaf], leaf_b[leaf], q, n)


def rmi_predict(
    tree: Dict[str, torch.Tensor], q: torch.Tensor, *, hidden: tuple,
    n: int, num_leaves: int,
) -> Tuple[torch.Tensor, ...]:
    """queries -> (pos, lo, hi, sigma): float32 position estimates, the
    per-query float window [lo, hi] and σ for the biased searches.
    q: (B,) normalized scalar keys or (B, D) normalized vector keys."""
    leaf, pos = leaf_and_pos(
        tree["s0"], hidden, tree["leaf_w"], tree["leaf_b"], q,
        n=n, num_leaves=num_leaves,
    )
    lo_m = pos + tree["err_lo"][leaf]
    hi_m = pos + tree["err_hi"][leaf]
    # hybrid leaves (Algorithm 1): window = the leaf's full key range,
    # except for +inf, whose window stays the model's around f32(n - 1)
    # (from the last probe the search ends past every key on any leaf)
    bt = tree["is_btree"][leaf]
    if q.ndim == 1:
        bt = bt & (q != torch.inf)
    lo = torch.where(bt, tree["seg_lo"][leaf].to(torch.float32), lo_m)
    hi = torch.where(bt, tree["seg_hi"][leaf].to(torch.float32), hi_m)
    return pos, lo, hi, tree["sigma"][leaf]


def rmi_lookup(
    tree: Dict[str, torch.Tensor],
    sorted_keys: torch.Tensor,
    q: torch.Tensor,
    *,
    hidden: tuple,
    n: int,
    num_leaves: int,
    max_window: int,
    strategy: str = "binary",
) -> torch.Tensor:
    """Full lookup: predict + error-bounded search.  Returns lower-bound
    indices into `sorted_keys` (normalized float32).  For vector keys
    ``sorted_keys`` is the first column of the sorted vectors and the
    search compares the queries' first column (`_q1`), as the reference
    does (ROADMAP queue C 19); `strings.compile_string_lookup` is the
    exact string search."""
    pos, lo, hi, sig = rmi_predict(
        tree, q, hidden=hidden, n=n, num_leaves=num_leaves
    )
    err_lo = lo - pos
    err_hi = hi - pos
    fn = search_lib.STRATEGIES[strategy]
    if strategy == "binary":
        return fn(sorted_keys, _q1(q), pos, err_lo, err_hi, max_window)
    return fn(sorted_keys, _q1(q), pos, err_lo, err_hi, sig, max_window)


def _q1(q: torch.Tensor) -> torch.Tensor:
    """The search's scalar comparison key: the query itself, or a vector
    query's first component (the reference's `_q1`)."""
    return q if q.ndim == 1 else q[:, 0]


# --------------------------------------------------------------------------
# Builder (stage-wise training, Algorithm 1)
# --------------------------------------------------------------------------

def stage0_segments(
    stage0_params: Dict[str, np.ndarray], norm: np.ndarray, *, n: int,
    m: int, device=None,
) -> np.ndarray:
    """Leaf assignment for every key ((N,) scalar or (N, D) vector) with
    lookup-time arithmetic."""
    dev = resolve_device(device)
    hidden = tuple(
        int(np.shape(stage0_params[f"w{i}"])[1])
        for i in range(len(stage0_params) // 2 - 1)
    )
    s0 = torch.as_tensor(pack_stage0(stage0_params), device=dev)
    q = torch.as_tensor(np.asarray(norm, np.float32), device=dev)
    p0 = stage0_apply(s0, hidden, q)
    ratio = torch.tensor(np.float32(m / n), device=dev)
    leaf = torch.clamp(search_lib.to_index(torch.floor(p0 * ratio)), max=m - 1)
    return leaf.cpu().numpy().astype(np.int64)


def build_rmi(
    keys: Union[KeySet, VectorKeySet],
    config: RMIConfig,
    *,
    device=None,
    verbose: bool = False,
) -> RMIndex:
    """Cold build over scalar or vector keys.  ``device`` runs the
    stage-0 training and the leaf assignment (None = "cuda"); everything
    else is host NumPy."""
    dev = resolve_device(device)
    norm = keys.norm
    n = keys.n
    m = config.num_leaves
    if n >= 2**30:
        raise ValueError("the lookup kernels take n < 2**30 keys")
    y = np.arange(n, dtype=np.float32)
    in_dim = 1 if norm.ndim == 1 else norm.shape[1]

    # ---- stage 0 ---------------------------------------------------------
    spec = MLPSpec(in_dim=in_dim, hidden=tuple(config.stage0_hidden))
    if config.stage0_sample is not None and config.stage0_sample < n:
        idx = np.linspace(0, n - 1, config.stage0_sample).astype(np.int64)
        x0, y0 = norm[idx], y[idx]
    else:
        x0, y0 = norm, y
    s0 = mlp_train(
        spec, x0, y0, steps=config.stage0_train_steps, lr=config.stage0_lr,
        seed=config.seed, device=dev, verbose=verbose,
    )
    seg = stage0_segments(s0, norm, n=n, m=m, device=dev)

    # ---- stage 1: per-leaf linear fits ------------------------------------
    if in_dim == 1:
        slope, intercept, cnt = segmented_linear_fit(norm, y, seg, m)
        leaf_w = slope.astype(np.float32)
        leaf_b = intercept.astype(np.float32)
    else:
        leaf_w, leaf_b, cnt = _segmented_multivariate_fit(norm, y, seg, m)
    return _finalize_rmi(
        config, n, in_dim, s0, leaf_w.astype(np.float32),
        leaf_b.astype(np.float32), cnt, norm, y, seg, verbose=verbose,
    )


def _segmented_multivariate_fit(
    x: np.ndarray, y: np.ndarray, seg: np.ndarray, m: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-segment ridge least squares for vector keys, chunked accumulation."""
    n, d = x.shape
    da = d + 1
    ata = np.zeros((m, da, da), np.float64)
    aty = np.zeros((m, da), np.float64)
    cnt = np.bincount(seg, minlength=m).astype(np.float64)
    chunk = max(1, int(5e7 // (da * da)))
    xd = np.asarray(x, np.float64)
    yd = np.asarray(y, np.float64)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        a = np.concatenate([xd[s:e], np.ones((e - s, 1))], axis=1)
        np.add.at(ata, seg[s:e], a[:, :, None] * a[:, None, :])
        np.add.at(aty, seg[s:e], a * yd[s:e, None])
    ata += 1e-6 * np.eye(da)[None]
    sol = np.linalg.solve(ata, aty[..., None])[..., 0]
    return sol[:, :d].astype(np.float32), sol[:, d].astype(np.float32), cnt


def _segment_reduce(ufunc, init, seg: np.ndarray, vals: np.ndarray,
                    m: int, dtype) -> np.ndarray:
    """``out = full(m, init); ufunc.at(out, seg, vals)``, as one
    ``reduceat`` over the runs when ``seg`` is non-decreasing (always
    for a linear stage-0; min/max are exact, so the result is equal)."""
    out = np.full(m, init, dtype)
    if seg.size and bool((seg[1:] >= seg[:-1]).all()):
        starts = np.flatnonzero(np.r_[True, seg[1:] != seg[:-1]])
        ids = seg[starts]
        out[ids] = ufunc(out[ids], ufunc.reduceat(vals, starts))
    else:
        ufunc.at(out, seg, vals)
    return out


# float32 holds every integer position below 2**24; above it positions
# (and the lookup's float32 window ends) round to a coarser grid
F32_EXACT_POSITIONS = 2**24


def _key_window_bounds(pred1: np.ndarray, resid: np.ndarray):
    """Per-key error bounds ``(floor(resid), ceil(resid))`` as float32,
    each tightened until the lookup's own float32 window arithmetic
    covers the key's exact position k:

        int(f32(pred1 + e_lo)) <= k  and  int(f32(pred1 + e_hi)) + 1 >= k.

    Below 2**24 positions the reference's bounds already satisfy both
    and nothing changes.  Above it ``y = arange(n, float32)`` and the
    window ends round to the float32 grid, so the reference's bounds can
    miss a stored key by up to the grid spacing.  There the bounds start
    from the exact residual ``k - pred1``, and the check steps the keys
    whose float32 window end still rounds past k outward one position
    at a time."""
    if pred1.size <= F32_EXACT_POSITIONS:
        return np.floor(resid).astype(np.float32), np.ceil(resid).astype(np.float32)
    k = np.arange(pred1.size, dtype=np.int64)
    exact = k - pred1.astype(np.float64)
    e_lo = np.floor(exact).astype(np.float32)
    e_hi = np.ceil(exact).astype(np.float32)
    del exact
    bad = np.flatnonzero((pred1 + e_lo).astype(np.int64) > k)
    while bad.size:
        e_lo[bad] -= np.float32(1)
        bad = bad[(pred1[bad] + e_lo[bad]).astype(np.int64) > k[bad]]
    bad = np.flatnonzero((pred1 + e_hi).astype(np.int64) + 1 < k)
    while bad.size:
        e_hi[bad] += np.float32(1)
        bad = bad[(pred1[bad] + e_hi[bad]).astype(np.int64) + 1 < k[bad]]
    return e_lo, e_hi


def _finalize_rmi(
    config: RMIConfig,
    n: int,
    in_dim: int,
    s0: Dict[str, np.ndarray],
    leaf_w: np.ndarray,
    leaf_b: np.ndarray,
    cnt: np.ndarray,
    norm: np.ndarray,
    y: np.ndarray,
    seg: np.ndarray,
    *,
    verbose: bool = False,
) -> RMIndex:
    """Error bounds, per-leaf spans, hybrid replacement, final RMIndex.

    Always recomputed over *all* keys with the final leaf parameters, so
    the window guarantee holds no matter how the leaf parameters were
    obtained (cold fit or warm reuse in `refit_rmi`).
    """
    m = config.num_leaves
    if in_dim == 1:
        pred1 = leaf_w[seg] * norm + leaf_b[seg]
    else:
        pred1 = leaf_dot(leaf_w[seg], norm) + leaf_b[seg]
    pred1 = np.clip(pred1.astype(np.float32), 0.0, float(n - 1))

    # ---- residual bounds (the B-Tree-strength guarantee) -------------------
    resid = y - pred1
    e_lo, e_hi = _key_window_bounds(pred1, resid)
    err_lo = _segment_reduce(np.minimum, 0.0, seg, e_lo, m, np.float32)
    err_hi = _segment_reduce(np.maximum, 0.0, seg, e_hi, m, np.float32)
    # σ per leaf
    sums = np.bincount(seg, weights=resid, minlength=m)
    sqs = np.bincount(seg, weights=resid * resid, minlength=m)
    with np.errstate(invalid="ignore"):
        mean = np.divide(sums, cnt, out=np.zeros(m), where=cnt > 0)
        var = np.divide(sqs, cnt, out=np.zeros(m), where=cnt > 0) - mean**2
    sigma = np.sqrt(np.maximum(var, 0.0)).astype(np.float32)

    # ---- segment coverage (for hybrid windows) -----------------------------
    pos_idx = np.arange(n, dtype=np.int64)
    seg_lo = _segment_reduce(np.minimum, n - 1, seg, pos_idx, m, np.int64)
    seg_hi = _segment_reduce(np.maximum, 0, seg, pos_idx, m, np.int64)
    seg_lo[cnt == 0] = 0
    seg_hi[cnt == 0] = 0

    # ---- Algorithm 1 lines 11-14: hybrid replacement ------------------------
    max_abs = np.maximum(np.abs(err_lo), np.abs(err_hi))
    if config.hybrid_threshold is not None:
        is_btree = max_abs > config.hybrid_threshold
    else:
        is_btree = np.zeros(m, bool)

    window = np.where(
        is_btree, (seg_hi - seg_lo).astype(np.float32), err_hi - err_lo
    )
    max_window = int(window.max()) + 2
    if n > F32_EXACT_POSITIONS:
        # each window end rounds to the float32 spacing of the positions
        max_window += int(np.spacing(np.float32(n - 1)))

    idx = RMIndex(
        config=config,
        n=n,
        num_leaves=m,
        in_dim=in_dim,
        stage0_params={k: np.asarray(v) for k, v in s0.items()},
        leaf_w=leaf_w.astype(np.float32),
        leaf_b=leaf_b.astype(np.float32),
        err_lo=err_lo,
        err_hi=err_hi,
        sigma=sigma,
        is_btree=is_btree,
        seg_lo=seg_lo.astype(np.int32),
        seg_hi=seg_hi.astype(np.int32),
        max_window=max_window,
    )
    if verbose:
        print(
            f"RMI built: n={n} leaves={m} max_window={max_window} "
            f"hybrid_leaves={int(is_btree.sum())} "
            f"size={idx.model_size_bytes/1e6:.2f}MB"
        )
    return idx


# --------------------------------------------------------------------------
# Warm-start refit (the index_service compaction path)
# --------------------------------------------------------------------------

def _clean_leaves(cand, nlo, nhi, olo, new_raw, old_raw) -> np.ndarray:
    """For each candidate leaf (equal new and old span lengths): do its
    new span hold exactly the raw keys of its old span?  The vector form
    of the reference's per-leaf ``np.array_equal`` loop."""
    lens = nhi[cand] - nlo[cand] + 1
    total = int(lens.sum())
    owner = np.repeat(np.arange(cand.size), lens)
    first = np.zeros(cand.size, np.int64)
    first[1:] = np.cumsum(lens)[:-1]
    within = np.arange(total, dtype=np.int64) - first[owner]
    diff = new_raw[nlo[cand][owner] + within] != old_raw[olo[cand][owner] + within]
    return np.bincount(owner, weights=diff, minlength=cand.size) == 0


def refit_rmi(
    old: RMIndex,
    old_keys: KeySet,
    new_keys: KeySet,
    *,
    config: Optional[RMIConfig] = None,
    device=None,
    verbose: bool = False,
) -> Tuple[RMIndex, int]:
    """Warm-start rebuild after the key set changed (e.g. a delta-buffer
    compaction merged inserts/deletes into the base array).

    Stage 0 is reused verbatim — no gradient steps — with its input
    layer affine-rescaled for the new normalization constants and its
    output layer scaled by n_new/n_old.  Stage-1 leaves whose spans hold
    exactly the same raw keys as before (merely shifted by upstream
    inserts/deletes) keep their learned slope, with the intercept
    translated by the shift; only changed leaves get fresh fits.  Error
    bounds are recomputed over *all* keys by `_finalize_rmi`.

    Returns (index, num_leaves_refit).  The leaf count must match `old`;
    callers fall back to `build_rmi` otherwise.
    """
    cfg = config or old.config
    if old.in_dim != 1 or new_keys.norm.ndim != 1:
        raise ValueError("refit_rmi supports scalar keys only")
    if cfg.num_leaves != old.num_leaves:
        raise ValueError("refit_rmi needs an unchanged leaf count")

    norm = new_keys.norm
    n = new_keys.n
    n_old = old.n
    m = cfg.num_leaves
    y = np.arange(n, dtype=np.float32)

    # affine map between normalization frames: x_old = a * x_new + c
    span_old = old_keys.hi - old_keys.lo
    span_new = new_keys.hi - new_keys.lo
    a = span_new / span_old
    c = (new_keys.lo - old_keys.lo) / span_old

    s0 = {k: np.asarray(v, np.float64) for k, v in old.stage0_params.items()}
    n_layers = len(s0) // 2
    s0["b0"] = s0["b0"] + c * s0["w0"][0]
    s0["w0"] = s0["w0"] * a
    last = n_layers - 1
    r = n / n_old  # uniform-growth output correction
    s0[f"w{last}"] = s0[f"w{last}"] * r
    s0[f"b{last}"] = s0[f"b{last}"] * r
    s0 = {k: v.astype(np.float32) for k, v in s0.items()}

    seg = stage0_segments(s0, norm, n=n, m=m, device=device)
    cnt = np.bincount(seg, minlength=m).astype(np.float64)
    pos_idx = np.arange(n, dtype=np.int64)
    seg_lo = _segment_reduce(np.minimum, n, seg, pos_idx, m, np.int64)
    seg_hi = _segment_reduce(np.maximum, -1, seg, pos_idx, m, np.int64)

    # fresh fits everywhere (vectorized bincount passes — the cheap part),
    # then carry over clean leaves
    slope, intercept, _ = segmented_linear_fit(norm, y, seg, m)
    leaf_w = slope.astype(np.float64)
    leaf_b = intercept.astype(np.float64)

    old_lo = old.seg_lo.astype(np.int64)
    old_hi = old.seg_hi.astype(np.int64)
    live = np.nonzero(cnt > 0)[0]
    cand = live[(seg_hi[live] - seg_lo[live]) == (old_hi[live] - old_lo[live])]
    clean = cand[_clean_leaves(
        cand, seg_lo, seg_hi, old_lo, new_keys.raw, old_keys.raw)]
    # identical keys, uniformly shifted positions: rescale params
    w = old.leaf_w[clean].astype(np.float64)
    leaf_w[clean] = w * a
    leaf_b[clean] = (old.leaf_b[clean].astype(np.float64) + w * c
                     + (seg_lo[clean] - old_lo[clean]).astype(np.float64))
    num_refit = int(live.size - clean.size)

    idx = _finalize_rmi(
        cfg, n, 1, s0, leaf_w.astype(np.float32), leaf_b.astype(np.float32),
        cnt, norm, y, seg, verbose=False,
    )
    if verbose:
        print(
            f"RMI refit: n={n_old}->{n} leaves_refit={num_refit}/{m} "
            f"max_window={idx.max_window}"
        )
    return idx, num_refit


# --------------------------------------------------------------------------
# Convenience: end-to-end lookup closure (what LIF §3.1 emits)
# --------------------------------------------------------------------------

def compile_lookup(index: RMIndex, keys: Union[KeySet, VectorKeySet],
                   strategy: str = "binary", *, device=None):
    """Returns a fn: normalized float32 queries (tensor on ``device``)
    -> lower-bound indices.  Over a `VectorKeySet` it searches the first
    column only, as the reference does (ROADMAP queue C 19)."""
    dev = resolve_device(device)
    tree = index.as_tree(dev)
    sorted_np = keys.norm[:, 0] if isinstance(keys, VectorKeySet) else keys.norm
    sorted_keys = torch.as_tensor(np.ascontiguousarray(sorted_np), device=dev)
    n, m, w = index.n, index.num_leaves, index.max_window

    def lookup(q):
        return rmi_lookup(
            tree, sorted_keys, q, hidden=index.hidden, n=n, num_leaves=m,
            max_window=w, strategy=strategy,
        )

    return lookup
