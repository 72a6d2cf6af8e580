#!/usr/bin/env python3
"""The single-shard lookups (B1, B2), the sharded merged lookup (B4), the
§4 hash probe (B7) and the §5 Bloom probe (B8) of this tree against an
earlier tree's kernels, in turns, in one process on one card.

    python3 lookup_pair.py --parent DIR            # the Maps scale: 200M keys
    python3 lookup_pair.py --parent DIR --n 2000000

DIR holds an earlier checkout (``git archive beb32c9`` unpacked) whose
``src/repro_torch/kernels/csrc/{rmi_lookup,probe}.cu`` have this tree's
launch signatures.  They are built with this tree's nvcc flags and
declared by this tree's modules.  The parent's B1, B2, B4 and B7 run
through this tree's wrappers with the parent's library swapped in; both
Bloom probes are launched bare through ctypes (their times would
otherwise carry the wrapper's host time), this tree's also through its
wrapper.

Inputs, made from ``--seed``: the Maps key set (gen_maps(n)) with an RMI
of n/64 leaves, a delta of `chip_smoke.BIG_DELTA` staged entries and
1<<20 stored queries (B1, B2); the service's Bloom filter
(`build_bloom(keys, fpr=0.01)`) probed by 1<<20 and 1<<24 float32 bit
patterns, half stored keys and half uniform (B8, as `chip_smoke.py`'s
phase 4), with four diagnostics: k forced to 1, all k probes with no
early exit (`DIAG_SOURCE`), the same queries on the filter's first 32 MB
(which fits in L2), and a bare gather of R random words a thread; the
cut K = 4 cell of `chip_smoke.py` (`ShardedIndexService(num_shards=4,
strategy="sharded_fused")` over every 8th key with `chip_smoke.write_set`'s
inserts and deletes, its staged plan, 1<<20 stored, absent and edge
queries) and the same with eight shards (B4); the §4 map over all n keys
with S = n slots, probed by 1<<20 and 1<<24 stored keys (B7).  Every
output is held against the plain twin bit for bit; times are CUDA events
over 20 launches, the kernels in turns (parent, change, change, parent).
The ptxas report of this tree's kernels is printed first.  Prints JSON
lines; the last is ``{"ok": true, ...}``.  Without a card it exits
non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys

import numpy as np

import chip_smoke as cs
from scan_pair import emit, in_turns

_P, _I, _U32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
PARENT_SOURCES = ("rmi_lookup.cu", "probe.cu")
BATCH = 1 << 20
HASH_BATCHES = (1 << 20, 1 << 24)
GATHER_WIDTHS = (1, 2)          # random words a thread in the bare gather
SMALL_FILTER_WORDS = 1 << 23    # 32 MB of the filter: fits in the 50 MB L2

# The diagnostics' kernels, built beside the libraries, never part of
# the port: the Bloom probe with all k probes and no early exit (one
# query a thread, `%`), and R independent gathers of one random word a
# thread (index mix32(i, r + 1) mod the word count), every load issued
# before any is used.
DIAG_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ uint32_t mix32(uint32_t h, uint32_t s) {
  h ^= s; h ^= h >> 16; h *= 0x7FEB352Du; h ^= h >> 15; h *= 0x846CA68Bu; h ^= h >> 16;
  return h;
}
__global__ void __launch_bounds__(256) bloom_all_k(const uint32_t* __restrict__ q, int B,
    const uint32_t* __restrict__ words, uint32_t num_bits, int k, bool* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  uint32_t h1 = mix32(q[i], 0x9E3779B9u), h2 = mix32(q[i], 0x3C6EF372u) | 1u;
  bool hit = true;
  for (int j = 0; j < k; ++j) {
    uint32_t bit = (h1 + (uint32_t)j * h2) % num_bits;
    hit &= (bool)((__ldg(words + (bit >> 5)) >> (bit & 31u)) & 1u);
  }
  out[i] = hit;
}
template <int R>
__global__ void __launch_bounds__(256) gather_words(const uint32_t* __restrict__ words,
    uint32_t nwords, int B, bool* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  uint32_t w[R], acc = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) w[r] = __ldg(words + mix32((uint32_t)i, 0x9E3779B9u * (r + 1)) % nwords);
#pragma unroll
  for (int r = 0; r < R; ++r) acc ^= w[r];
  out[i] = acc & 1u;
}
extern "C" int bloom_all_k_launch(const uint32_t* q, int B, const uint32_t* words,
    uint32_t num_bits, int k, bool* out, void* stream) {
  bloom_all_k<<<(B + 255) / 256, 256, 0, (cudaStream_t)stream>>>(q, B, words, num_bits, k, out);
  return (int)cudaGetLastError();
}
extern "C" int gather_words_launch(const uint32_t* words, uint32_t nwords, int B, int R,
    bool* out, void* stream) {
  dim3 g((B + 255) / 256);
  cudaStream_t s = (cudaStream_t)stream;
  if (R == 1) gather_words<1><<<g, 256, 0, s>>>(words, nwords, B, out);
  else gather_words<2><<<g, 256, 0, s>>>(words, nwords, B, out);
  return (int)cudaGetLastError();
}
"""


def load_parent(source: pathlib.Path, declare):
    """``source`` built with this tree's flags, declared by this tree's
    ``declare``."""
    from repro_torch.kernels import nvcc
    lib = ctypes.CDLL(str(nvcc.build(source)))
    declare(lib)
    return lib


def through(module, lib, fn):
    """``fn`` run with ``lib`` in place of ``module``'s own library, so
    its wrapper launches ``lib``'s kernels."""
    from repro_torch.kernels import nvcc
    key = (module.SOURCE, tuple(nvcc.NVCC_FLAGS))

    def call():
        mine = nvcc._LIBS.get(key)
        nvcc._LIBS[key] = lib
        try:
            return fn()
        finally:
            if mine is None:
                del nvcc._LIBS[key]
            else:
                nvcc._LIBS[key] = mine
    return call


def load_diag():
    from repro_torch.kernels import nvcc
    src = nvcc.build_dir() / "bloom_diag.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(DIAG_SOURCE)
    lib = ctypes.CDLL(str(nvcc.build(src)))
    lib.bloom_all_k_launch.argtypes = [_P, _I, _P, _U32, _I, _P, _P]
    lib.gather_words_launch.argtypes = [_P, _U32, _I, _I, _P, _P]
    return lib


def run_single(lib, ks, rng, dev):
    """B1 and B2 on the Maps key set, this tree's wrappers launching
    the parent's library, then their own."""
    import torch
    from repro_torch.core import RMIConfig, build_rmi
    from repro_torch.kernels import ref, rmi_lookup
    idx = build_rmi(ks, RMIConfig(num_leaves=ks.n // 64, stage0_hidden=(),
                                  stage0_train_steps=0), device=dev)
    tree = idx.as_tree(dev)
    dk, dp = (torch.as_tensor(a, device=dev) for a in cs._big_delta(ks, rng, cs.BIG_DELTA))
    q = torch.as_tensor(ks.norm[rng.choice(ks.n, BATCH)], device=dev)
    args = (q, tree["s0"], *(tree[k] for k in ("leaf_w", "leaf_b", "err_lo", "err_hi")),
            torch.as_tensor(ks.norm, device=dev))
    kw = dict(hidden=idx.hidden, n=idx.n, num_leaves=idx.num_leaves, max_window=idx.max_window)
    rows = []
    for name, fn, plain, mismatch in (
            ("rmi_merged_lookup_cuda", lambda: rmi_lookup.rmi_merged_lookup_cuda(*args, dk, dp, **kw),
             lambda: ref.rmi_merged_lookup_reference(*args, dk, dp, **kw), cs.lookup_mismatch),
            ("rmi_lookup_cuda", lambda: rmi_lookup.rmi_lookup_cuda(*args, **kw),
             lambda: ref.rmi_lookup_reference(*args, **kw),
             lambda g, w: int((g != w).sum()))):
        row = {"kernel": name, "n": int(ks.n), "batch": BATCH, "max_window": int(idx.max_window),
               "delta_padded": int(dk.shape[0])}
        row.update(in_turns(through(rmi_lookup, lib, fn), fn, plain, mismatch))
        emit(row)
        rows.append(row)
    return rows


def run_bloom(lib, diag, ks, rng, dev):
    """B8 on the service's filter: the parent's kernel and this tree's,
    bare, in turns, then this tree's through its wrapper, and the
    diagnostics."""
    import torch
    from repro_torch.core.bloom import build_bloom, words_tensor
    from repro_torch.kernels import bloom_probe, hash_probe, nvcc, ref
    bf = build_bloom(ks.raw, fpr=0.01)
    words = words_tensor(bf, dev)
    nb, k = bf.num_bits, bf.num_hashes
    mine = nvcc.load(hash_probe.SOURCE, hash_probe.declare)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731

    def bare(which):
        def launch(q, num_bits, kk, out):
            cs.check(which.bloom_probe_launch(q.data_ptr(), q.numel(), words.data_ptr(),
                                              num_bits, kk, out.data_ptr(), stream()) == 0,
                     "bloom launch")
            return out
        return launch

    parent, change = bare(lib), bare(mine)

    def all_k(q, out):
        cs.check(diag.bloom_all_k_launch(q.data_ptr(), q.numel(), words.data_ptr(), nb, k,
                                         out.data_ptr(), stream()) == 0, "all-k launch")
        return out

    def gather(r, batch, out):
        cs.check(diag.gather_words_launch(words.data_ptr(), words.numel(), batch, r,
                                          out.data_ptr(), stream()) == 0, "gather launch")
        return out

    def gathered(r, batch):
        i = torch.arange(batch, device=dev, dtype=torch.int64)
        acc = torch.zeros_like(i)
        for j in range(r):
            acc ^= words[ref.mix32(i, j + 1) % words.numel()].to(torch.int64)
        return (acc & 1) != 0

    def same(g, w):
        return int((g != w).sum())

    small = min(SMALL_FILTER_WORDS, words.numel()) * 32
    rows = []
    for batch in cs.PROBE_BATCHES:
        stored = ks.raw[rng.choice(ks.n, batch // 2)]
        absent = rng.uniform(ks.raw[0], ks.raw[-1], batch - stored.size)
        q = cs.u32_tensor(np.concatenate([stored, absent]).astype(np.float32).view(np.uint32),
                          dev)
        out = torch.empty(q.shape, dtype=torch.bool, device=dev)
        sectors = cs.bloom_sectors(q, words, nb, k)
        row = {"kernel": "bloom_probe_cuda", "n": int(ks.n), "batch": batch, "num_bits": nb,
               "k": k, "sectors": sectors, "bound_ms": cs.probe_bound_ms(batch, sectors)}
        row.update(in_turns(lambda: parent(q, nb, k, out), lambda: change(q, nb, k, out),
                            lambda: ref.bloom_probe_reference(q, words, num_bits=nb, k=k), same))
        wrap = lambda: bloom_probe.bloom_probe_cuda(q, words, num_bits=nb, k=k)  # noqa: E731
        cs.check(same(wrap(), ref.bloom_probe_reference(q, words, num_bits=nb, k=k)) == 0,
                 "bloom wrapper != plain twin")
        row["wrapper_ms"] = cs.time_ms(wrap)
        diags = {}
        for label, kk, num_bits in (("k1", 1, nb), ("filter_32mb", k, small)):
            want = lambda kk=kk, num_bits=num_bits: ref.bloom_probe_reference(  # noqa: E731
                q, words, num_bits=num_bits, k=kk)
            d = {"sectors": cs.bloom_sectors(q, words, num_bits, kk)}
            d.update(in_turns(lambda kk=kk, num_bits=num_bits: parent(q, num_bits, kk, out),
                              lambda kk=kk, num_bits=num_bits: change(q, num_bits, kk, out),
                              want, same))
            diags[label] = d
        want = ref.bloom_probe_reference(q, words, num_bits=nb, k=k)
        cs.check(same(all_k(q, out), want) == 0, "all-k probe != plain twin")
        diags["all_k_no_early_exit"] = {"probes": batch * k,
                                        "ms": cs.time_ms(lambda: all_k(q, out))}
        for r in GATHER_WIDTHS:
            cs.check(same(gather(r, batch, out), gathered(r, batch)) == 0, "bare gather")
            diags[f"gather_r{r}"] = {"probes": batch * r,
                                     "ms": cs.time_ms(lambda r=r: gather(r, batch, out))}
        row["diagnostics"] = diags
        emit(row)
        rows.append(row)
    return rows


def run_sharded(lib, raw, rng, dev, shards):
    import torch
    from repro_torch.index_service import ServiceConfig, ShardedIndexService
    from repro_torch.kernels import ref, rmi_lookup
    from repro_torch.kernels.rmi_lookup import rmi_sharded_merged_lookup_cuda
    base = raw[::cs.SHARDED_STRIDE].copy()
    svc = ShardedIndexService(
        base, ServiceConfig(num_shards=shards, strategy="sharded_fused",
                            delta_capacity=1 << 20),
        vals=np.zeros(base.size, np.int64), device=dev)
    ins, ivals, dels = cs.write_set(base, rng, min(cs.N_WRITES, base.size // 4))
    svc.insert(ins, ivals)
    svc.delete(dels)
    svc.lookup_batch(base[:8])
    plan = svc._device_plan()
    absent = cs._absent(base, rng.uniform(base[0], base[-1], BATCH // 8))
    edges = np.array([base[0] - 1, base[-1] + 1, -1e30, 1e30])
    qraw = rng.permutation(np.concatenate([
        base[rng.choice(base.size, BATCH - absent.size - edges.size)], absent, edges]))
    qs = torch.as_tensor(np.stack([norm(qraw) for norm in plan.q_normalizers]), device=dev)
    args = (qs, plan.stage0, plan.leaf_w, plan.leaf_b, plan.err_lo, plan.err_hi, plan.keys,
            plan.dkeys, plan.dprefix, plan.shard_n, plan.shard_m, plan.shard_ratio)
    kw = dict(hidden=plan.hidden, max_window=plan.max_window)
    row = {"kernel": "rmi_sharded_merged_lookup_cuda", "n": int(base.size), "shards": shards,
           "batch": BATCH, "max_window": int(plan.max_window),
           "delta_padded": int(plan.dkeys.shape[1])}
    fn = lambda: rmi_sharded_merged_lookup_cuda(*args, **kw)  # noqa: E731
    row.update(in_turns(through(rmi_lookup, lib, fn), fn,
                        lambda: ref.rmi_sharded_merged_lookup_reference(*args, **kw),
                        cs.lookup_mismatch))
    emit(row)
    return row


def run_hash(lib, raw, rng, dev):
    import torch
    from repro_torch.core import build_model_hashmap
    from repro_torch.kernels import hash_probe, ops, ref
    from repro_torch.kernels.hash_probe import hash_probe_cuda
    hm, idx, ks = build_model_hashmap(raw, raw.size, device=dev)
    tabs = ops.hash_probe_tensors(hm, idx, ks, dev)
    kw = cs.hash_kwargs(hm, idx)
    rows = []
    for batch in HASH_BATCHES:
        q = torch.as_tensor(ks.norm[rng.choice(ks.n, batch)], device=dev)
        row = {"kernel": "hash_probe_cuda", "n": int(ks.n), "batch": batch,
               "max_chain": int(hm.max_chain)}
        fn = lambda: hash_probe_cuda(q, *tabs, **kw)  # noqa: E731
        row.update(in_turns(through(hash_probe, lib, fn), fn,
                            lambda: ref.hash_probe_reference(q, *tabs, **kw),
                            lambda g, w: int((g != w).sum())))
        emit(row)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, required=True,
                    help="root of the earlier checkout")
    ap.add_argument("--n", type=int, default=cs.PAPER_N)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("lookup_pair: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.core import make_keyset
    from repro_torch.data import gen_maps
    from repro_torch.kernels import hash_probe, rmi_lookup

    csrc = args.parent / "src/repro_torch/kernels/csrc"
    if not all((csrc / src).is_file() for src in PARENT_SOURCES):
        print(f"lookup_pair: no parent sources under {csrc}", file=sys.stderr)
        return 2
    dev = torch.device(cs.DEVICE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    parent_lookup, parent_probe = (
        load_parent(csrc / src, declare)
        for src, declare in zip(PARENT_SOURCES, (rmi_lookup._declare, hash_probe.declare)))
    rmi_lookup.build()
    hash_probe.build()
    diag = load_diag()
    emit({"phase": "build", "ptxas": {
        **cs.ptxas_resources(rmi_lookup, ("rmi_lookup_kernel", "rmi_sharded_lookup_kernel")),
        **cs.ptxas_resources(hash_probe, ("hash_probe_kernel", "bloom_probe_kernel"))}})
    rng = np.random.default_rng((args.seed, 3))
    raw = gen_maps(args.n, seed=args.seed)
    ks = make_keyset(raw)
    rows = run_single(parent_lookup, ks, rng, dev)
    torch.cuda.empty_cache()
    rows += run_bloom(parent_probe, diag, ks, rng, dev)
    del ks
    torch.cuda.empty_cache()
    rows += [run_sharded(parent_lookup, raw, rng, dev, k) for k in (4, 8)]
    torch.cuda.empty_cache()
    rows += run_hash(parent_probe, raw, rng, dev)
    print(smi, flush=True)
    emit({"ok": True, "card": smi, "torch": torch.__version__,
          "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()},
          "rows": rows})
    return 0


if __name__ == "__main__":
    sys.exit(main())
