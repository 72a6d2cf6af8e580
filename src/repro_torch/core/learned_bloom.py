"""Learned Bloom filter (paper §5): classifier + overflow Bloom filter.

A character-level GRU (the paper uses a W=16 GRU with E=32 char
embeddings) is trained as a binary classifier keys-vs-nonkeys with log
loss (Eq. 2).  At build time we pick the threshold τ for the target FPR
on held-out non-keys, collect the classifier's false-negative keys
K_τ^- = {x ∈ K : f(x) < τ} and build a *standard* Bloom filter over
just that subset — preserving the zero-false-negative contract while
the Bloom filter shrinks with (1 - FNR).

The GRU cell is written out by hand, as the reference writes it:
``z`` and ``r`` from ``[x, h] @ W``, the candidate from ``[x, r * h]``,
and a padding mask that holds ``h`` over zero bytes.  That is not
``torch.nn.GRU``'s formulation (which applies ``r`` after the hidden
matmul and has no mask), so ``nn.GRU`` would be another function.  The
weights come from a seeded `torch.Generator` and training is the same
hand-rolled Adam, so a port-trained GRU differs from a reference-trained
one; `convert.gru_params_from_reference` carries the latter across.
The overflow filter is the host `core.bloom` filter (`_mix64`), as in
the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.bloom import BloomFilter, build_bloom, string_hash_u64
from repro_torch.core.strings import tokenize
from repro_torch.device import resolve_device

# logits are computed in batches of exactly this many strings (the last
# one padded), so a string's logit comes out of the same matrix shapes
# whatever batch it is asked in: the τ chosen at build then holds for
# every later `contains`, one string or many (no false negative from a
# library picking another kernel for another batch size)
_EVAL_BATCH = 8192


# --------------------------------------------------------------------------
# Tiny char-GRU in torch (a loop over characters)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GRUSpec:
    vocab: int = 128
    embed: int = 32      # paper's E
    width: int = 16      # paper's W
    max_len: int = 32

    @property
    def num_params(self) -> int:
        e, w = self.embed, self.width
        return self.vocab * e + 3 * (e + w + 1) * w + (w + 1)

    @property
    def size_bytes(self) -> int:
        return self.num_params * 4


def gru_init(spec: GRUSpec, generator: torch.Generator, device=None) -> Dict[str, torch.Tensor]:
    """The reference's initialisation (scaled normals, zero biases),
    drawn from ``generator`` (a CPU generator; the tensors then move to
    ``device``)."""
    e, w = spec.embed, spec.width

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator) * scale).to(device)

    s = lambda a: 1.0 / np.sqrt(a)  # noqa: E731
    zeros = lambda k: torch.zeros((k,), device=device)  # noqa: E731
    return {
        "emb": normal((spec.vocab, e), 0.1),
        "wz": normal((e + w, w), s(e + w)), "bz": zeros(w),
        "wr": normal((e + w, w), s(e + w)), "br": zeros(w),
        "wh": normal((e + w, w), s(e + w)), "bh": zeros(w),
        "wo": normal((w, 1), s(w)), "bo": zeros(1),
    }


def gru_logits(params: Dict[str, torch.Tensor], tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, L) integer byte values -> (B,) float32 logits, on
    the tokens' device (``params`` are tensors there).

    The reference's cell, step for step: ``z = σ([x, h] @ wz + bz)``,
    ``r = σ([x, h] @ wr + br)``, ``h~ = tanh([x, r * h] @ wh + bh)``,
    ``h' = (1 - z) * h + z * h~``, and h held where the byte is 0.  Each
    ``[x, h] @ w`` is split into ``x @ w_x + h @ w_h``: the input halves
    of all three gates go through one matmul for every step at once, so
    a step launches two small matmuls (the logits then differ from the
    reference's in the last bits of float32)."""
    tokens = tokens.to(torch.int64)
    emb = params["emb"]
    # an embedding gather, whose backward sums each row's gradient in a
    # fixed order on the host (an indexing gather's backward accumulates
    # in thread order there), so host training is reproducible
    x = torch.nn.functional.embedding(torch.clamp(tokens, 0, emb.shape[0] - 1), emb)
    e, w = x.shape[-1], params["wz"].shape[1]
    wx = torch.cat([params["wz"][:e], params["wr"][:e], params["wh"][:e]], dim=1)
    gx = x @ wx + torch.cat([params["bz"], params["br"], params["bh"]])  # (B, L, 3W)
    wzr_h = torch.cat([params["wz"][e:], params["wr"][e:]], dim=1)
    wh_h = params["wh"][e:]
    keep = (tokens > 0)[:, :, None]                    # the zero-padding mask
    h = torch.zeros((x.shape[0], w), dtype=x.dtype, device=x.device)
    for t in range(x.shape[1]):
        zr = torch.sigmoid(gx[:, t, : 2 * w] + h @ wzr_h)
        z, r = zr[:, :w], zr[:, w:]
        hh = torch.tanh(gx[:, t, 2 * w :] + (r * h) @ wh_h)
        h = torch.where(keep[:, t], (1 - z) * h + z * hh, h)
    return (h @ params["wo"] + params["bo"])[:, 0]


def params_on(params: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Host parameter arrays as float32 tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in params.items()}


def gru_train(
    spec: GRUSpec,
    pos_tokens: np.ndarray,
    neg_tokens: np.ndarray,
    *,
    steps: int = 600,
    batch: int = 512,
    lr: float = 3e-3,
    seed: int = 0,
    device=None,
    verbose: bool = False,
) -> Dict[str, np.ndarray]:
    """Adam on the mean log loss, mini-batches drawn with
    ``np.random.default_rng(seed)`` as the reference draws them, on
    ``device`` (None = "cuda").  Returns host float32 arrays."""
    dev = resolve_device(device)
    params = gru_init(spec, torch.Generator().manual_seed(seed), dev)
    for p in params.values():
        p.requires_grad_(True)
    xs = torch.as_tensor(np.concatenate([pos_tokens, neg_tokens]).astype(np.int32),
                         device=dev)
    ys = torch.as_tensor(np.concatenate(
        [np.ones(len(pos_tokens)), np.zeros(len(neg_tokens))]).astype(np.float32),
        device=dev)

    # hand-rolled Adam (no torch.optim, mirroring the reference)
    beta1, beta2, eps = 0.9, 0.999, 1e-8
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    rng = np.random.default_rng(seed)
    for t in range(1, steps + 1):
        idx = torch.as_tensor(rng.integers(0, xs.shape[0], batch), device=dev)
        logits = gru_logits(params, xs[idx])
        yb = ys[idx]
        loss = torch.mean(torch.clamp(logits, min=0) - logits * yb
                          + torch.log1p(torch.exp(-torch.abs(logits))))
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                m[k] = beta1 * m[k] + (1 - beta1) * g
                v[k] = beta2 * v[k] + (1 - beta2) * g * g
                p -= lr * (m[k] / (1 - beta1**t)) / (torch.sqrt(v[k] / (1 - beta2**t)) + eps)
        if verbose and t % 200 == 0:
            print(f"  gru step {t}: loss={float(loss):.4f}")
    return {k: p.detach().cpu().numpy().astype(np.float32) for k, p in params.items()}


def _probs(params: Dict[str, torch.Tensor], tokens: np.ndarray, device) -> np.ndarray:
    """σ(logits) of (N, L) tokens as host float32, in padded batches of
    `_EVAL_BATCH`, with the reference's host arithmetic
    ``1 / (1 + exp(-z))`` on float32 z."""
    out = []
    with torch.no_grad():
        for s in range(0, len(tokens), _EVAL_BATCH):
            chunk = tokens[s : s + _EVAL_BATCH]
            tb = torch.zeros((_EVAL_BATCH, tokens.shape[1]), dtype=torch.int32)
            tb[: len(chunk)] = torch.as_tensor(chunk)
            out.append(gru_logits(params, tb.to(device)).cpu().numpy()[: len(chunk)])
    z = np.concatenate(out) if out else np.zeros(0, np.float32)
    return 1.0 / (1.0 + np.exp(-z))


# --------------------------------------------------------------------------
# The learned Bloom filter itself
# --------------------------------------------------------------------------

@dataclasses.dataclass
class LearnedBloom:
    spec: GRUSpec
    params: Dict[str, np.ndarray]
    tau: float
    overflow: BloomFilter
    fnr: float           # fraction of keys below τ (sizes the overflow)
    measured_fpr: float  # on held-out non-keys
    device: Optional[torch.device] = None   # where `contains` runs the GRU

    @property
    def size_bytes(self) -> int:
        return self.spec.size_bytes + self.overflow.size_bytes

    def contains(self, strings: Sequence[str]) -> np.ndarray:
        dev = resolve_device(self.device)
        toks = tokenize(strings, self.spec.max_len).astype(np.int32)
        probs = _probs(params_on(self.params, dev), toks, dev)
        above = probs >= self.tau
        keys_u64 = _string_hash_u64(strings)
        return above | self.overflow.contains(keys_u64)

    def add(self, strings: Sequence[str]) -> None:
        """Absorb new keys after training: the classifier stays fixed
        (re-training online would break the zero-false-negative
        contract mid-serve), so late arrivals go into the overflow
        Bloom filter — they are all "classifier false negatives" until
        the next rebuild.  Keeps `contains` exact-for-members while the
        key set grows, at standard-Bloom bits for the additions."""
        if strings:
            self.overflow.add(_string_hash_u64(strings))


# the reference's private name for the string fold (benchmarks import it)
_string_hash_u64 = string_hash_u64


def build_learned_bloom(
    key_strings: Sequence[str],
    nonkey_strings: Sequence[str],
    *,
    target_fpr: float = 0.01,
    spec: GRUSpec | None = None,
    train_steps: int = 600,
    seed: int = 0,
    verbose: bool = False,
    params: Dict[str, np.ndarray] | None = None,
    device=None,
) -> LearnedBloom:
    """Pass `params` to reuse an already-trained classifier (one model,
    many FPR targets — the Fig 13 sweep).  ``device`` (None = "cuda")
    trains and evaluates the GRU; the filter keeps it for `contains`."""
    dev = resolve_device(device)
    spec = spec or GRUSpec()
    pos = tokenize(key_strings, spec.max_len).astype(np.int32)
    rng = np.random.default_rng(seed)
    neg = list(nonkey_strings)
    rng.shuffle(neg)
    split = len(neg) // 2
    neg_train, neg_heldout = neg[:split], neg[split:]
    negt = tokenize(neg_train, spec.max_len).astype(np.int32)

    if params is None:
        params = gru_train(
            spec, pos, negt, steps=train_steps, seed=seed, device=dev, verbose=verbose
        )
    tparams = params_on(params, dev)

    # τ for the target FPR on held-out non-keys (paper §5.1.1)
    ho = tokenize(neg_heldout, spec.max_len).astype(np.int32)
    p_ho = _probs(tparams, ho, dev)
    tau = float(np.quantile(p_ho, 1.0 - target_fpr)) if len(p_ho) else 0.5
    tau = min(max(tau, 1e-6), 1.0 - 1e-9)

    p_keys = _probs(tparams, pos, dev)
    fn_mask = p_keys < tau
    fnr = float(fn_mask.mean())
    fn_keys = _string_hash_u64([key_strings[i] for i in np.where(fn_mask)[0]])
    if len(fn_keys) == 0:
        fn_keys = np.zeros(1, np.uint64)
    overflow = build_bloom(fn_keys, fpr=target_fpr)
    measured_fpr = float((p_ho >= tau).mean()) if len(p_ho) else 0.0
    lb = LearnedBloom(
        spec=spec, params=params, tau=tau, overflow=overflow,
        fnr=fnr, measured_fpr=measured_fpr, device=dev,
    )
    if verbose:
        print(
            f"learned bloom: τ={tau:.4f} FNR={fnr:.3f} FPR={measured_fpr:.4f} "
            f"model={spec.size_bytes/1e6:.3f}MB overflow={overflow.size_bytes/1e6:.3f}MB"
        )
    return lb
