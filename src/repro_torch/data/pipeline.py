"""Token data pipeline with a learned-index document lookup.

Training corpora are packed token streams; sampling step k needs the
mapping global-token-offset -> (document id, local offset) over ~10^7
document boundaries — a sorted-array lookup executed per sequence, per
step.  The RMI replaces binary search here (paper §3 in the data path).

`lookup_documents` takes the RMI's lower bound as a guess and finishes
with a gallop over the int64 document starts, so its answer is exact
whatever the guess.  The reference finishes with a ±1 repair around the
guess and calls that exact, but the RMI window is a guarantee for
stored keys only (paper §2) and an offset is almost never a document
start: at 10M tokens, offset 3,139,430 gets document 0 there, where it
lies in document 3,323 (ROADMAP queue C 20).  The port's answer equals
the reference's wherever the reference's is right.

The pipeline itself is deterministic-shardable: `batch_at(step)`
derives every sequence from (seed, step, index), so any host can
compute any shard — restart/elastic-friendly by construction (no
iterator state in checkpoints).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.core.keys import make_keyset
from repro_torch.core.rmi import RMIConfig, build_rmi, compile_lookup
from repro_torch.device import resolve_device


def gallop_last_le(starts: torch.Tensor, off: torch.Tensor,
                   guess: torch.Tensor) -> torch.Tensor:
    """For each offset, the index of the last of the sorted ``starts``
    that is <= it (0 when none is), found from ``guess`` by a gallop
    (steps 1, 2, 4, ... away from the guess, on the side the guess's
    start says) and then a halving of the bracket, each in a fixed
    ``ceil(log2(n + 1)) + 1`` trips, so the answer is exact whatever
    the guess."""
    n = starts.shape[0]
    trips = int(math.ceil(math.log2(n + 1))) + 1
    g = torch.clamp(guess.to(torch.int64), 0, n - 1)
    up = starts[g] <= off
    # the bracket: starts[lo] <= off < starts[hi], with -1 and n as the
    # ends past the array
    lo = torch.where(up, g, -1)
    hi = torch.where(up, n, g)
    open_ = torch.ones_like(up)
    step = 1
    for _ in range(trips):
        probe = torch.where(up, g + step, g - step)
        inside = (probe >= 0) & (probe < n)
        le = starts[torch.clamp(probe, 0, n - 1)] <= off
        go = open_ & inside
        lo = torch.where(go & le, probe, lo)
        hi = torch.where(go & ~le, probe, hi)
        # keep galloping while the probe stays on the guess's side
        open_ = go & (le == up)
        step *= 2
    for _ in range(trips):
        active = hi - lo > 1
        mid = (lo + hi) >> 1
        le = starts[torch.clamp(mid, 0, n - 1)] <= off
        lo = torch.where(active & le, mid, lo)
        hi = torch.where(active & ~le, mid, hi)
    return torch.clamp(lo, min=0)


@dataclasses.dataclass
class PackedCorpus:
    """Synthetic packed corpus: document boundaries + a token generator.
    ``device`` (None = "cuda") builds the RMI and runs the lookups."""

    total_tokens: int
    doc_starts: np.ndarray          # (num_docs,) sorted int64
    vocab_size: int
    seed: int = 0
    device: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        ks = make_keyset(self.doc_starts.astype(np.float64))
        cfg = RMIConfig(
            num_leaves=max(16, len(self.doc_starts) // 32),
            stage0_hidden=(),
            stage0_train_steps=0,
        )
        self._keys = ks
        self._rmi = build_rmi(ks, cfg, device=self.device)
        self._lookup = compile_lookup(self._rmi, ks, device=self.device)
        self._starts = torch.as_tensor(ks.raw.astype(np.int64), device=self.device)

    def lookup_documents(self, offsets: np.ndarray) -> np.ndarray:
        """Batched offset -> document id: the last document start <=
        the offset (document 0 for an offset before every start).

        The RMI's float32 lower bound is the guess; `gallop_last_le`
        over the int64 starts makes the answer exact."""
        offsets = np.asarray(offsets, np.int64)
        qn = torch.as_tensor(self._keys.normalize(offsets.astype(np.float64)),
                             device=self.device)
        guess = self._lookup(qn)
        off = torch.as_tensor(offsets, device=self.device)
        return gallop_last_le(self._starts, off, guess).cpu().numpy()

    def tokens_at(self, offsets: np.ndarray, length: int) -> np.ndarray:
        """Deterministic synthetic tokens with *learnable* structure:
        within a document, tokens advance arithmetically from a
        doc-specific seed with occasional hash 'typos' — so a model can
        actually reduce loss (pure hash noise would already sit at the
        entropy floor), while remaining recomputable from (doc, pos)."""
        docs = self.lookup_documents(offsets)
        pos = offsets[:, None] + np.arange(length)[None, :]
        doc_seed = (
            docs[:, None].astype(np.uint64) * np.uint64(0xC2B2AE3D27D4EB4F)
            + np.uint64(self.seed)
        )
        base = (doc_seed + pos.astype(np.uint64) * np.uint64(7)) % np.uint64(
            self.vocab_size
        )
        h = pos.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15) + doc_seed
        h ^= h >> np.uint64(29)
        h *= np.uint64(0xBF58476D1CE4E5B9)
        h ^= h >> np.uint64(32)
        noise = (h % np.uint64(self.vocab_size)).astype(np.int64)
        use_noise = (h >> np.uint64(48)) % np.uint64(10) == 0  # 10% typos
        return np.where(use_noise, noise, base.astype(np.int64)).astype(np.int32)


def make_synthetic_corpus(
    total_tokens: int = 10_000_000, mean_doc_len: int = 700,
    vocab_size: int = 32000, seed: int = 0, device=None,
) -> PackedCorpus:
    rng = np.random.default_rng(seed)
    n_docs = max(2, total_tokens // mean_doc_len)
    lens = rng.lognormal(np.log(mean_doc_len), 0.8, n_docs).astype(np.int64)
    lens = np.maximum(lens, 16)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    starts = starts[starts < total_tokens - 1]
    return PackedCorpus(
        total_tokens=total_tokens,
        doc_starts=np.unique(starts),
        vocab_size=vocab_size,
        seed=seed,
        device=device,
    )


@dataclasses.dataclass
class DataPipeline:
    """Deterministic sharded batches over a PackedCorpus."""

    corpus: PackedCorpus
    global_batch: int
    seq_len: int
    shard_index: int = 0
    num_shards: int = 1

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Any shard of any step is recomputable from (seed, step)."""
        b = self.global_batch // self.num_shards
        rng = np.random.default_rng(
            (self.corpus.seed * 1_000_003 + step) & 0xFFFFFFFF
        )
        offsets = rng.integers(
            0, self.corpus.total_tokens - self.seq_len - 1, self.global_batch
        )
        mine = offsets[self.shard_index * b : (self.shard_index + 1) * b]
        toks = self.corpus.tokens_at(mine, self.seq_len + 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
