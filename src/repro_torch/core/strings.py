"""String keys (paper §3.5): tokenization + exact lexicographic search.

Tokenization: an n-length string becomes x ∈ R^N with x_i = the byte
value, truncated/zero-padded to a maximum length N (the paper's scheme
verbatim).  The RMI stage models consume the normalized vector.

The final error-bounded search must compare *lexicographically*; a
scalar projection of the vector loses order at ties.  We pack 4 bytes
per int32 word and run the branchless fixed-trip binary search with a
vectorized lexicographic compare over the packed words — exact for
prefixes up to N bytes (beyond-N ties are resolved to the first match,
the same contract as the paper's truncation).

Scope of exactness: a *stored* string lands at its exact position under
every strategy, because the RMI window is a guarantee over the stored
keys (paper §2) and the port computes a query's normalization and leaf
position with the build's own float32 arithmetic.  An absent string may
fall outside its leaf's window; it then gets the window end nearest its
true rank, as in the reference.

torch's ``uint32`` has few CUDA ops, so the unsigned word compare widens
the int32 carrier to int64 and masks it with 0xFFFFFFFF.  The host
helpers (`tokenize`, `pack_words`, `sort_strings`) are the reference's
NumPy, verbatim.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

from repro_torch.core import search as search_lib
from repro_torch.device import resolve_device

_U32 = 0xFFFFFFFF


def tokenize(strings: Sequence[str], max_len: int) -> np.ndarray:
    """(N,) strings -> (N, max_len) float64 byte values, zero padded."""
    out = np.zeros((len(strings), max_len), np.float64)
    for i, s in enumerate(strings):
        b = s.encode("utf-8", errors="replace")[:max_len]
        out[i, : len(b)] = np.frombuffer(b, np.uint8)
    return out


def pack_words(tokens: np.ndarray) -> np.ndarray:
    """(N, L) byte values -> (N, ceil(L/4)) int32, big-endian per word so
    unsigned word comparison == lexicographic byte comparison."""
    n, length = tokens.shape
    w = math.ceil(length / 4)
    padded = np.zeros((n, w * 4), np.uint32)
    padded[:, :length] = tokens.astype(np.uint32)
    words = (
        (padded[:, 0::4] << 24)
        | (padded[:, 1::4] << 16)
        | (padded[:, 2::4] << 8)
        | padded[:, 3::4]
    )
    return words.astype(np.int64).astype(np.int32)  # two's complement carrier


def pack_words_torch(tokens: torch.Tensor) -> torch.Tensor:
    """(B, L) byte values (any real dtype, on any device) -> (B,
    ceil(L/4)) int32 words, the tensor twin of `pack_words` (the
    reference's ``pack_words_jax``)."""
    b, length = tokens.shape
    wlen = math.ceil(length / 4)
    t = tokens.to(torch.int64)
    pad = wlen * 4 - length
    if pad:
        t = torch.nn.functional.pad(t, (0, pad))
    words = (t[:, 0::4] << 24) | (t[:, 1::4] << 16) | (t[:, 2::4] << 8) | t[:, 3::4]
    # the int32 two's complement carrier of the uint32 word
    return torch.where(words > 0x7FFFFFFF, words - (1 << 32), words).to(torch.int32)


pack_words_jax = pack_words_torch   # the reference's name


def _u(x: torch.Tensor) -> torch.Tensor:
    """int32 carrier -> its uint32 value, held in int64."""
    return x.to(torch.int64) & _U32


def lex_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise a < b for packed-word matrices (B, W), unsigned
    lexicographic: the first word where they differ decides."""
    au, bu = _u(a), _u(b)
    less = torch.zeros(au.shape[0], dtype=torch.bool, device=au.device)
    for j in range(au.shape[1] - 1, -1, -1):
        less = (au[:, j] < bu[:, j]) | ((au[:, j] == bu[:, j]) & less)
    return less


def lower_bound_lex(
    packed_keys: torch.Tensor,  # (N, W) packed sorted strings
    q: torch.Tensor,            # (B, W) packed queries
    lo: torch.Tensor,
    hi: torch.Tensor,
    max_window: int,
) -> torch.Tensor:
    """Error-bounded lower-bound search with lexicographic compare, in
    the reference's fixed trip count ``ceil(log2(max_window + 1)) + 1``."""
    n = packed_keys.shape[0]
    steps = max(1, int(math.ceil(math.log2(max(2, max_window + 1)))) + 1)
    for _ in range(steps):
        mid = (lo + hi) >> 1
        km = packed_keys[torch.clamp(mid, 0, n - 1)]
        right = lex_less(km, q)
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(right, hi, mid)
    return lo


def normalize_tokens(tok_q: torch.Tensor, scale: float) -> torch.Tensor:
    """Byte values -> float32 ``f32(b) / f32(scale)``, one IEEE float32
    divide on the queries' device, as the reference normalizes on its
    device.  For integer byte values and an integer scale up to 255 it
    equals `VectorKeySet.normalize`'s float64 divide rounded to float32,
    so a stored string's query equals its build-time key."""
    return tok_q.to(torch.float32) / torch.tensor(
        np.float32(scale), device=tok_q.device)


def compile_string_lookup(index, keys, strategy: str = "binary", *, device=None):
    """fn: (B, L) tokenized queries (a tensor on ``device``, None =
    "cuda") -> lower-bound indices.

    `index` is an RMIndex built over a VectorKeySet; the window comes
    from the RMI, the compare from packed words.  The strategy picks how
    the window is pre-shrunk before the lexicographic binary phase:
    'binary' uses the raw window; 'biased'/'quaternary' first probe at
    pos±σ (vectorized) to shrink it — the §3.4 strategies transplanted
    onto exact string compare.
    """
    from repro_torch.core.rmi import rmi_predict

    dev = resolve_device(device)
    tree = index.as_tree(dev)
    packed = torch.as_tensor(pack_words(keys.raw), device=dev)
    n, m = index.n, index.num_leaves
    w = index.max_window
    hidden = index.hidden
    scale = keys.scale

    def lookup(tok_q: torch.Tensor) -> torch.Tensor:  # (B, L) raw byte values
        qn = normalize_tokens(tok_q, scale)
        pos, flo, fhi, sig = rmi_predict(tree, qn, hidden=hidden, n=n, num_leaves=m)
        lo = torch.clamp(search_lib.to_index(flo), max=n)
        hi = torch.clamp(search_lib.to_index(fhi, -1.0) + 1, 0, n)
        pq = pack_words_torch(tok_q)
        if strategy in ("biased", "quaternary"):
            p = torch.clamp(search_lib.to_index(pos), max=n - 1)
            s = torch.clamp(search_lib.to_index(sig), min=1)
            probes = (torch.clamp(p - s, 0, n - 1), p, torch.clamp(p + s, 0, n - 1))
            if strategy == "biased":
                probes = (p,)
            for pr in probes:
                right = lex_less(packed[pr], pq)
                lo = torch.where(right, torch.maximum(lo, pr + 1), lo)
                hi = torch.where(right, hi, torch.minimum(hi, pr))
        return lower_bound_lex(packed, pq, lo, hi, w)

    return lookup


def sort_strings(strings: List[str]) -> List[str]:
    return sorted(set(strings))
