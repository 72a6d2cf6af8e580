#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # the paper's Maps scale: 200M keys
    python3 chip_smoke.py --n 2000000   # a quick rehearsal of every phase

Phases, each printing JSON lines; any mismatch raises and the exit code
is non-zero:

  1. card    — the card's name and power limit (nvidia-smi), the five
               kernel libraries built in parallel and their compiler
               resource reports (the bf16 D = 128 attention instance must
               spill nothing);
  2. kernels — each CUDA kernel against its plain PyTorch version on the
               card: flash attention within the reference's tolerances
               (f32 2e-5, bf16 2e-2) at the reference's four test shapes,
               S = 48, 1000 and 1 and yi-6b's heads at S = 1000, both
               dtypes, causal and not, and cross-attention (full mask,
               Sq != Sk: seamless's 256 over 3,072, 77 over 300, 1,000
               over 130), both dtypes; the rest bit for bit: the lookups at n = 50k (linear and
               (16,16) MLP stage-0, and a duplicate-heavy key set) and on
               the full service index (stored, absent, leaf-boundary,
               duplicate-run and out-of-range queries, batches of 1, 777
               and 1<<20, an empty delta and one of 1<<20 entries); the
               scans at n = 50k (float32 ties between staged inserts and
               base keys, NaN / inverted / out-of-span bounds, negative
               and wrapping page starts, unpadded power-of-two deltas, a
               tombstone run and an insert cluster longer than the range
               kernel's shared-memory buffers; for the page kernel also
               pages past the live count, a page across the int32 wrap
               and a single page); the sharded lookup and
               scan at S in {1, 3, 4} unequal shards (empty, staged and
               unpadded deltas, stride-0 rows, page sizes 256 / 160 / 1,
               and for the scan raw owners whose tiles wrap int32 or own
               nothing, and a tombstone run over half of each of three
               shards with an insert cluster); the §4 hash probe on Maps,
               Lognormal and Weblogs maps at 50k keys and slot ratios
               0.75 / 1.0 / 1.25 and a map with no overflow (stored,
               absent, float32-equal, NaN, infinite and out-of-span
               queries); the §5 Bloom probe on oracle filters of
               (num_bits, k) = (2^14, 3), (2^16, 7), (2^18, 10) and
               num_bits above 2^31 (ragged and unaligned batches too);
               and ROADMAP queue C 17: +inf on a leaf of slope 0
               through both lookups and the sharded one (n + 1, n);
               then the failover (`failover_injected`, n = 50k): two
               injected ``kernel.dispatch`` faults reroute B1 (a
               `cuda_fused` service) and B4 (a K = 4 `sharded_fused`
               one) to their plain twins with bit-identical answers, 1
               failover and 2 errors, and the 64th call re-probes,
               recovers and launches the kernel again;
  LM phase   — yi-6b at full width and depth (bf16, random weights from a
               seeded generator on the card): `prefill` of 2 x 4,096
               tokens, each call launching the attention kernel once a
               layer (32) and no plain attention; layer 0's q, k, v
               through the kernel against the plain twin (bf16 2e-2, a
               relative L2 error of 1e-2, and within one bf16 rounding of
               the float32 twin); the kernel, its
               twin and scaled_dot_product_attention (timed only) at that
               shape against the bound max(operations / 989 TFLOP/s,
               bytes / 3.35 TB/s); prefill against 256 sequential
               `decode_step`s (bf16 at 32 layers: the same top-1 token,
               max |Δlogit| <= 0.05 max |logit|; float32 at 4 layers:
               allclose at 1e-3); a `ServeEngine` run whose page table is
               held against the binary baseline midway; and
               `launch.serve` (16 requests of 32 new tokens, 8 slots,
               max_len 512).  The model is released before lm_train;
  lm_train   — the training path: (a) the attention backward kernel
               against `ref.mha_backward_reference` (float32 and bf16 x
               D 32/64/128 x causal and full x S 1/77/1000 x GQA groups
               1/4/8, and the training shape; max |Δ| <= 1e-4 (f32) or
               2e-2 (bf16, and a relative L2 of 1e-2) x max |twin|), two
               launches bit-identical, the forward's log-sum-exp
               against its twin and its output bits unchanged; the
               kernel, its twin and SDPA's backward (timed only) at the
               training shape; (b) the reduced yi-6b's loss and
               gradients on the card (float32, TF32 off) against the
               CPU (1e-5 relative, 1e-4 x each leaf's max); (c) yi-6b at
               full width (bf16, remat "full"), cut to 8 of 32 layers,
               through `get_model`, `adamw_init`, `make_train_step` and
               `DataPipeline`: 8 steps of 2 x 4,096 tokens in 2
               microbatches, every loss and grad norm finite, the loss
               falling, 32 forward and 16 backward attention launches a
               step, step seconds, tokens/s, the forward + backward and
               optimizer split (CUDA events) and peak memory; (d)
               `launch.train` on the reduced yi-6b, 12 steps
               checkpointed every 5, then resumed to 16.  Released
               before lm_moe;
  lm_moe     — the MoE family at full width (bf16, random weights from a
               seeded generator on the card), each model released before
               the next: (a) olmoe-1b-7b (16 layers, 64 experts top-8,
               the `cdf` dispatch), `prefill` of 2 x 4,096 tokens three
               times (one attention launch a layer, no plain attention),
               tokens/s and peak memory; (b) layer 0's dispatch at that
               shape, `cdf` and `sort`, on the card against the CPU from
               the same routing (buffers, dest, st, keep bit for bit),
               `moe_ffn` within 2e-2 x max and a relative L2 of 1e-2 of
               the float32 products under the same dispatch, and
               bit-identical on a repeat; (c) prefill against 64
               sequential `decode_step`s at full depth with capacity
               factor E/k (nothing drops; ROADMAP queue C 24): same top-1,
               max |Δlogit| <= 0.05 max |logit|; (d) each layer's drop
               fraction under `cdf` and `sort` on olmoe's own scores, and
               `benchmarks/moe_dispatch.py`'s table (E 32, K 4, T 65,536;
               sort, cdf, random) through the port's `cdf_dispatch_slots`
               on the card; (e) `launch.serve --arch olmoe-1b-7b` (16
               requests of 32 new tokens, 8 slots, max_len 512; the page
               table held against the binary baseline at tick 20); (f)
               moonshot-v1-16b-a3b (48 layers, 64 experts top-6, `sort`)
               prefill as (a); (g) the reduced olmoe's loss, aux loss and
               gradients on the card against the CPU (float32);
  lm_recurrent — the recurrent families, the failover guard around
               both.  lm_ssm: (a) xlstm-1.3b at full width and depth
               (bf16, 48 layers, 1.74B parameters), a warm-up prefill of
               2 x 256 then a timed one of 2 x 2,048 tokens (cut from
               4,096 for the time limit), peak memory;
               (b) prefill against 64 sequential decode steps (bf16 and
               float32 at full depth reported: the random-init stack
               amplifies bf16 rounding to ~max |logit|, as the
               reference's does; float32 at one superblock of 8 layers:
               allclose at 1e-3; the first mLSTM and the sLSTM alone in
               bf16: within a relative L2 of 1e-2 of float32 and of
               their 64 decode steps); (c)
               `launch.serve --arch xlstm-1.3b` (16 requests of 32 new
               tokens, 8 slots, max_len 512); (d) the reduced xlstm card
               against CPU (float32: prefill and 6 decode steps' logits
               within 1e-4 x max, the loss 1e-5 relative, every
               gradient 1e-4 x its max).  lm_hybrid: (a)
               jamba-1.5-large's four layer kinds alone at its published
               width (d_model 8,192, bf16, 2 x 4,096 tokens): the Mamba
               mixer (bf16 against float32 within a relative L2 of 1e-2,
               prefill against 64 `mamba_decode` steps in float32), the
               attention mixer (one B9 launch, no plain attention;
               `block_decode_attn_only` over 64 steps against
               `_attn_train` in float32), one MoE FFN (16 experts top-2,
               19.3 GB; bf16 within 2e-2 x max and a relative L2 of
               1e-2 of the float32 products under the same dispatch) and
               one dense FFN, each timed; and the superblock's size (88.3
               GB in bf16: no whole-model jamba runs at that width on one
               card); (b) the reduced jamba card against CPU as lm_ssm
               (d), its attention through B9's forward and backward
               kernels; (c) `launch.serve` on the reduced jamba;
  lm_multimodal — the vlm and audio families, the failover guard around
               them: (a) B9 at seamless's cross shape (bf16, 256 queries
               over 3,072 keys), its twin and SDPA (timed only) beside
               the bound, and causal or grad-requiring calls at
               Sq != Sk refused before any launch; (b)
               llava-next-mistral-7b at full width and depth (bf16,
               7.13B parameters): prefill of 2 x (576 image + 3,520
               text) tokens twice (32 B9 launches a call), the prompt
               less its last 8 tokens then 8 decode steps against it
               (bf16: max |Δ| <= 0.05 max |logit|, the top-1 reported
               beside each row's margin; float32 at full depth: same
               top-1, allclose 1e-3; one layer in bf16 within a relative
               L2 of 1e-2 of float32), `launch.serve` (the yi-6b call's
               arguments); (c) seamless-m4t-large-v2 at full width and
               depth (bf16, 24 + 24 layers): prefill of 2 x 3,072 frames
               and 2 x 256 tokens twice (72 B9 launches a call: encoder,
               decoder self and cross), prefill against 64 decode steps
               on a cache from `encode` and `_enc_kv` (same top-1, max
               |Δ| <= 0.05 max |logit|), one encoder and one decoder
               layer in bf16 against float32; (d) the reduced llava and
               seamless card against CPU (float32: logits 1e-4 x max,
               loss 1e-5, gradients 1e-4 x max) and through
               `launch.serve`; (e) no plain attention or SDPA over (b)
               and (c);
  distributed — the mesh, the sharding rules, the int8 all-reduce, the
               dry run and the partitioned train step, the failover
               guard after it: (a) `make_host_mesh(1)` (an NCCL world of
               one) and yi-6b's 8-layer state placed through the rules,
               every leaf the same card tensor; (b) the int8 all-reduce
               on a 6.6 GB gradient tree held to its one-rank identities
               bit for bit; (c) the dry-run cells started after the
               build, read back; then the partitioned train step on the
               mesh of one, every parameter and state leaf a DTensor,
               each part's losses within `PARTITIONED_LOSS_RTOL` of its
               plain step's (bit equality reported), finite grad norms,
               exact B9 forward and backward launches and
               `on_local_heads` / `on_local_groups` / `on_local_blocks`
               calls a step, no
               plain attention: (d) `lm_train` (c)'s yi-6b model, seed
               and batches against (c); (e) olmoe-1b-7b at full width
               cut to 4 layers and (f) llava-next-mistral-7b cut to 8
               (lm_train's memory cut), 2 x 4,096 tokens (llava's 576
               of them image patches) in 2 microbatches, each after its
               plain step on the same model, seed and batches; (g)
               seamless-m4t-large-v2 at full size on `lm_multimodal`
               (e)'s model, seed and batch, against its losses, every
               cross-attention at Sq != Sk on the local heads; (h)
               xlstm-1.3b at full width cut to one superblock (7 mLSTM +
               1 sLSTM), 2 x 512 tokens in one microbatch, after its
               plain step, every scan on local blocks
               (`on_local_blocks` calls counted); (i)
               jamba-1.5-large-398b's Mamba mixer at the published width
               on 2 x 4,096 tokens, forward and backward, partitioned
               against plain (outputs and gradients within 2e-2 x max,
               bit equality reported), then the reduced jamba's whole
               partitioned step against its plain step (Mamba scans,
               B9 on local heads, the MoE on local groups); (j) the
               process group destroyed;
  3. main path — `IndexService(strategy="cuda_fused", bloom_fpr=0.01)`
               over gen_maps(n) with a zero payload: every stored key at
               its float32 lower bound, then 300k inserts (values
               1..300k) + 300k deletes checked through get / lookup_batch
               / range_lookup / contains against NumPy oracles (and the
               Bloom screen: no live key screened out, absent keys
               screened, the false-positive rate in a band), the
               snapshot's `sharded_fused` strategy against `cuda_fused`,
               ~30 range scans through scan_batch / scan_page_fn / scan,
               a warm compaction (flush) and the same checks again; the
               Bloom kernel on the service's own filter and on an oracle
               filter of its own hash family over 20M keys.  Then the §4
               hash index at full size: `build_model_hashmap` over the
               same keys (S = n), every stored key through the kernel,
               4M float32-absent keys, and the random-hash map (every
               16th key in as many slots: a cut of depth for the time
               limit) through the plain chain walk.  Then, with those released,
               `ShardedIndexService(num_shards=4,
               strategy="sharded_fused")` over every 8th of those keys
               (24.4M; a cut of depth that keeps the run inside its time
               limit): the same number of writes routed across the
               shards, every read and scan check staged and after a
               flush, one dispatch per warm read; and a 2M-key sharded
               service with per-shard Bloom screens (bloom_fpr=0.02)
               through a rebalance to three shards.  Each path runs with
               the launch counts zeroed just before and read just after,
               and the sticky reroutes forgotten before and read after
               (`failover_guard`: any disabled pair or kernel error fails
               the run).  After phase 4's times the single service also
               serves eight tenant threads through a started
               `IndexFrontend` (`frontend`: get / contains of 1-64 keys,
               range_lookup and their own inserts and deletes then reads
               of them; the first scan after those writes, timed as the
               scan-slab rebuild it stalls on; a timed window of 1,000
               reads a tenant (get, contains, range_lookup, scans of
               1-10,000 rows), p50 / p99 over all of its requests; every
               answer against NumPy; then one `pump()` round on this
               thread, one dispatch per read kind; its launches stay in
               its own line); the K = 4 service is checkpointed while
               its writes are staged and restored on the card
               (`checkpoint`: the restored service's get, contains,
               lookup_batch and scan_batch equal the live one's), and a
               torn save on the 2M-key service falls back to the step
               before it;
  4. times   — kernel, plain version and torch.searchsorted (the
               paper's binary-search yardstick, timed only) with CUDA
               events, the bound from bytes over 3.35 TB/s, lookup_batch
               queries/s end to end; both scan kernels and their plain
               versions at 1<<20 and 1<<22 rows, scan_batch rows/s and
               the host build of the scan slab (`scan.pack_slab`); the
               sharded lookup at S = 4 x 1<<20 queries and the sharded
               scan at 1<<20 and 1<<22 rows, on the staged sharded index;
               the page kernel also at a single page (G = 1), held
               against its plain version at both shapes;
               both probes at 1<<20 and 1<<24 queries (bound: the 32-byte
               sectors their gathers touch), screened contains keys/s;
               the attention kernel's row comes from the LM phase;
  5. paper_structures — the paper's other structures, plain torch on
               the card (no kernel of theirs; they launch none of the
               nine, except the reduced model's attention in the last):
               the B-Tree baseline over the compacted main-path key set
               (inside phase 3-4's service, no second key set) at every
               `BTREE_PAGE_SIZES` page, 1<<20 stored and 1<<20 absent
               queries against np.searchsorted, its size beside the
               RMI's; after the sharded services, the §3.5 string index
               over gen_webdocs(100k) at 16 bytes (linear and (8,)
               stage-0, three strategies, every stored string exact);
               the §5.1 learned Bloom filter (the paper's E 32, W 16
               GRU, 600 steps, gen_urls(4k, 12k): no false negative,
               held-out FPR <= 0.05, beside a plain filter at the same
               target); LIF over gen_maps(1M) on a four-candidate grid
               (stored keys exact); the pipeline's document lookup at
               10M and 1e9 tokens (1<<20 offsets each against the
               oracle); and `launch.serve --prefix-bloom` on the reduced
               yi-6b (the reference test's argv).

The last line is ``{"ok": true, "device": {...}}``.  Without a card the
script exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import pathlib
import re
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM published memory rate
PAPER_N = 200_000_000          # paper §3.6 Maps: 200M longitudes
SMALL_N = 50_000
BIG_BATCH = 1 << 20            # largest batch held against the plain version
BIG_DELTA = 1 << 20            # staged entries of the large delta
N_WRITES = 300_000             # inserts, and deletes, on the main path
# the checks' depth is cut so the whole run fits its time limit (PERF.md §4)
N_GET = 500_000
N_LOOKUP = 2_000_000
SCAN_PAGE_SIZES = (256, 160, 1)
SHARDED_STRIDE = 8              # the K = 4 service holds every 8th key
RANDOM_HASH_STRIDE = 16         # the §4 random-hash baseline holds every 16th key
SCAN_WIDTHS = (1, 2, 3, 10, 100, 1_000, 4_097, 10_000, 65_536, 100_000)
BIG_SCANS = (1 << 20, 1 << 22)  # rows of the two timed ranges
HOST_SCAN_ROWS = 20_000         # host `scan` checked on ranges up to this wide
DEVICE = "cuda"


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line, stamped with the seconds since the script began."""
    print(json.dumps({**obj, "t_s": round(time.perf_counter() - T_START, 1)}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _dup_heavy(rng, n):
    """Distinct float64 keys that collapse into runs of ~64 equal
    float32 normalized values."""
    runs = max(2, n // 64)
    bases = np.sort(rng.uniform(0.0, 1e12, runs))
    return np.repeat(bases, 64)[:n] + np.tile(np.arange(64), runs)[:n] * 1e-4


def _absent(raw, cand):
    """The candidates that are not stored keys (raw sorted)."""
    i = np.clip(np.searchsorted(raw, cand), 0, raw.size - 1)
    return np.unique(cand[raw[i] != cand])


def _boundary_queries(index, ks, device, count=2000):
    """Normalized queries within a few ulps of the stage-0 leaf
    boundaries (where one ulp decides the leaf): the midpoint between
    the two stored keys on either side of a boundary and its float32
    neighbours."""
    import torch
    from repro_torch.core.models import pack_stage0, stage0_apply
    s0 = torch.as_tensor(pack_stage0(index.stage0_params), device=device)
    p = torch.floor(stage0_apply(s0, index.hidden, torch.as_tensor(
        ks.norm, device=device)) * torch.tensor(index.ratio, device=device))
    edges = torch.nonzero(p[1:] != p[:-1]).flatten().cpu().numpy()
    del p
    edges = edges[np.linspace(0, edges.size - 1, min(count, edges.size)).astype(np.int64)]
    mid = ((ks.norm[edges].astype(np.float64) + ks.norm[edges + 1]) / 2).astype(np.float32)
    return np.concatenate([mid, np.nextafter(mid, np.float32(-1)),
                           np.nextafter(mid, np.float32(2))])


def _query_sets(ks, index, rng, device):
    absent = ks.normalize(rng.uniform(ks.raw[0], ks.raw[-1], 20000))
    span = ks.hi - ks.lo
    oor = np.concatenate([
        ks.normalize(np.array([ks.lo - 1, ks.hi + 1, ks.lo, ks.hi])),
        np.array([-1e30, 1e30], np.float32),
        ks.normalize(ks.lo - span * np.array([1e-9, 1e-3, 1.0])),
        ks.normalize(ks.hi + span * np.array([1e-9, 1e-3, 1.0])),
    ]).astype(np.float32)
    return {
        "stored": ks.norm[rng.choice(ks.n, 20000)],
        "absent": absent.astype(np.float32),
        "leaf_boundary": _boundary_queries(index, ks, device),
        "out_of_range": oor,
    }


def _big_delta(ks, rng, entries):
    """A delta of exactly `entries` staged entries: tombstones of stored
    keys plus fresh inserts (exactly a power of two, so nothing pads it)."""
    from repro_torch.index_service.delta import DeltaBuffer, combine_for_device
    n_del = min(ks.n // 4, entries // 2)
    dels = np.sort(rng.choice(ks.raw, n_del, replace=False))
    ins = _absent(ks.raw, rng.uniform(ks.raw[0], ks.raw[-1], entries))
    ins = np.sort(rng.choice(ins, entries - n_del, replace=False))
    buf = DeltaBuffer.from_arrays(ins, np.zeros(ins.size, np.int64), dels, entries)
    return combine_for_device(None, buf, ks.normalize)


def compare_kernels(label, ks, index, rng, big_batch, device, record, sorted_keys=None):
    """Both kernels against their plain versions on the card, bit for
    bit, across query sets, batch sizes and deltas.  Returns the max
    |kernel - plain| over everything (must be 0)."""
    import torch
    from repro_torch.index_service.delta import combine_for_device
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmi_lookup import (
        rmi_lookup_cuda, rmi_merged_lookup_cuda, stage0_flat)

    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    arrs = (stage0_flat(index.stage0_params, device), t(index.leaf_w),
            t(index.leaf_b), t(index.err_lo), t(index.err_hi),
            sorted_keys if sorted_keys is not None else t(ks.norm))
    kw = dict(hidden=index.hidden, n=index.n, num_leaves=index.num_leaves,
              max_window=index.max_window)
    sets = _query_sets(ks, index, rng, device)
    if index.n == ks.n and "dup" in label:
        sets["dup_runs"] = ks.norm[rng.choice(ks.n, 20000)]
    pool = np.concatenate(list(sets.values()))
    sets["batch_1"] = pool[:1]
    sets["batch_777"] = rng.choice(pool, 777)
    sets[f"batch_{big_batch}"] = rng.choice(pool, big_batch)
    deltas = {"empty": combine_for_device(None, None, ks.normalize),
              "big": _big_delta(ks, rng, BIG_DELTA)}
    worst = 0
    for dname, (dk, dp) in deltas.items():
        dkt, dpt = t(dk), t(dp)
        for qname, qs in sets.items():
            q = t(np.ascontiguousarray(qs, np.float32))
            kb, km = rmi_merged_lookup_cuda(q, *arrs, dkt, dpt, **kw)
            pb, pm = ref.rmi_merged_lookup_reference(q, *arrs, dkt, dpt, **kw)
            bb = rmi_lookup_cuda(q, *arrs, **kw)
            pbb = ref.rmi_lookup_reference(q, *arrs, **kw)
            torch.cuda.synchronize()
            err = max(int((kb - pb).abs().max()), int((km - pm).abs().max()),
                      int((bb - pbb).abs().max())) if q.numel() else 0
            worst = max(worst, err)
            record.append({"index": label, "queries": qname, "delta": dname,
                           "batch": int(q.numel()), "max_abs_err": err})
            check(err == 0, f"kernel != plain: {label}/{qname}/{dname}")
    # the plain version on the host gives the card's answers too
    q = sets["batch_777"]
    dk, dp = deltas["big"]
    cpu = ref.rmi_merged_lookup_reference(
        torch.as_tensor(q), *(a.cpu() for a in arrs), torch.as_tensor(dk),
        torch.as_tensor(dp), **kw)
    kb, km = rmi_merged_lookup_cuda(t(q), *arrs, t(dk), t(dp), **kw)
    check(bool((kb.cpu() == cpu[0]).all() and (km.cpu() == cpu[1]).all()),
          f"card != host plain version: {label}")
    return worst


def compare_flat_leaf_kernels(device, record):
    """ROADMAP queue C 17 on the card: the 16-key index whose last eight
    keys share one float32 value (leaf 1 of slope 0), and a K = 2 stack
    of it.  B1, B2 and B4 bit for bit against their plain twins on
    +inf, huge, in-range, -inf and NaN queries; +inf ranks past every
    key, n + 1 single-shard and n sharded.  Returns the max |kernel -
    plain| of the single-shard lookups and of the sharded one."""
    import torch
    from repro_torch.core import RMIConfig, build_rmi, make_keyset
    from repro_torch.core.rmi import LEAF_FIELDS
    from repro_torch.index_service.delta import combine_for_device
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.rmi_lookup import (
        rmi_lookup_cuda, rmi_merged_lookup_cuda, rmi_sharded_merged_lookup_cuda)

    ks = make_keyset(np.concatenate([np.arange(8.0), 100.0 + np.arange(8) * 1e-9]))
    idx = build_rmi(ks, RMIConfig(num_leaves=2, stage0_hidden=(), stage0_train_steps=0),
                    device=device)
    check(idx.leaf_w[1] == 0.0, "flat leaf: leaf 1 has a slope")
    n = ks.n
    q = torch.tensor([np.inf, 1e30, 1.0, -np.inf, np.nan, 0.5], dtype=torch.float32,
                     device=device)
    tree = idx.as_tree(device)
    args = (q, tree["s0"], *(tree[k] for k in LEAF_FIELDS),
            torch.as_tensor(ks.norm, device=device))
    kw = dict(hidden=(), n=n, num_leaves=2, max_window=idx.max_window)
    dk, dp = (torch.as_tensor(a, device=device)
              for a in combine_for_device(None, None, ks.normalize))
    st = ops.stack_shard_arrays([idx, idx], [ks.norm, ks.norm], device)
    sargs = (torch.stack([q, q]), st["stage0"], *(st[k] for k in LEAF_FIELDS), st["keys"],
             torch.stack([dk, dk]), torch.stack([dp, dp]), st["shard_n"], st["shard_m"],
             st["shard_ratio"])
    skw = dict(hidden=(), max_window=st["max_window"])
    worst = {}
    for name, got, want, inf_rank in (
            ("rmi_lookup_cuda", (rmi_lookup_cuda(*args, **kw),),
             (ref.rmi_lookup_reference(*args, **kw),), n + 1),
            ("rmi_merged_lookup_cuda", rmi_merged_lookup_cuda(*args, dk, dp, **kw),
             ref.rmi_merged_lookup_reference(*args, dk, dp, **kw), n + 1),
            ("rmi_sharded_merged_lookup_cuda", rmi_sharded_merged_lookup_cuda(*sargs, **skw),
             ref.rmi_sharded_merged_lookup_reference(*sargs, **skw), n)):
        err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
        worst[name] = err
        inf_ok = bool((got[0][..., 0] == inf_rank).all())
        record.append({"index": "flat_leaf16", "kernel": name, "max_abs_err": err,
                       "inf_rank": got[0][..., 0].tolist(), "n": n})
        check(err == 0, f"flat leaf: {name} != plain")
        check(inf_ok, f"flat leaf: {name} gives +inf {got[0][..., 0].tolist()}, "
                      f"not {inf_rank}")
    return (max(worst["rmi_lookup_cuda"], worst["rmi_merged_lookup_cuda"]),
            worst["rmi_sharded_merged_lookup_cuda"])


# ---------------------------------------------------------------------------
# phase 3 oracles (raw float64 and float32 frames)
# ---------------------------------------------------------------------------

class Oracle:
    """Exact answers for base + staged inserts - staged deletes, with
    dels a subset of base and ins disjoint from it."""

    def __init__(self, base, ins, dels):
        self.base, self.ins, self.dels = base, np.sort(ins), np.sort(dels)

    def rank(self, q):
        return (np.searchsorted(self.base, q) + np.searchsorted(self.ins, q)
                - np.searchsorted(self.dels, q))

    def live(self, q):
        def has(a, x):
            if a.size == 0:
                return np.zeros(x.shape, bool)
            i = np.clip(np.searchsorted(a, x), 0, a.size - 1)
            return a[i] == x
        return (has(self.base, q) & ~has(self.dels, q)) | has(self.ins, q)

    def rank_f32(self, norm, normalize, qn):
        return (np.searchsorted(norm, qn)
                + np.searchsorted(normalize(self.ins), qn)
                - np.searchsorted(normalize(self.dels), qn))


def check_reads(svc, oracle, rng, tag, n_get, n_batch, f32_ranks=None, stored=None):
    """get / lookup_batch / range_lookup / contains against the oracle,
    each warm read one dispatch.  lookup_batch is checked on keys stored
    in the base (``stored``, default the oracle's base: the window
    contract's domain); ``f32_ranks(q)`` gives its float32 merged ranks
    (default: the single service's snapshot frame)."""
    from repro_torch.kernels import ops
    if f32_ranks is None:
        snap = svc._mgr.current()

        def f32_ranks(qb):
            return oracle.rank_f32(snap.keys.norm, snap.keys.normalize,
                                   snap.keys.normalize(qb))
    base = oracle.base
    live_pick = np.concatenate([rng.choice(base, n_get // 4), oracle.ins[
        rng.integers(0, max(1, oracle.ins.size), n_get // 4)] if oracle.ins.size
        else rng.choice(base, n_get // 4)])
    dead = (oracle.dels[rng.integers(0, oracle.dels.size, n_get // 4)]
            if oracle.dels.size else rng.choice(base, n_get // 4))
    absent = rng.uniform(base[0] - 1, base[-1] + 1, n_get - live_pick.size - dead.size)
    q = rng.permutation(np.concatenate([live_pick, dead, absent]))
    rank, live = svc.get(q)
    check(bool((rank == oracle.rank(q)).all()), f"{tag}: get ranks")
    check(bool((live == oracle.live(q)).all()), f"{tag}: get presence")
    cont = svc.contains(q)
    check(bool((cont == oracle.live(q)).all()), f"{tag}: contains")
    for lo, hi in np.sort(rng.uniform(base[0] - 1, base[-1] + 1, (100, 2)), axis=1):
        want = tuple(int(x) for x in oracle.rank(np.array([lo, hi])))
        check(svc.range_lookup(lo, hi) == want, f"{tag}: range_lookup")
    # lookup_batch over stored base keys (the window contract's domain)
    qb = rng.choice(base if stored is None else stored, n_batch)
    got = svc.lookup_batch(qb).cpu().numpy()
    check(bool((got == f32_ranks(qb)).all()), f"{tag}: lookup_batch f32 merged ranks")
    # warm reads: one dispatch each (unmentioned keys, so contains
    # reaches the device)
    qa = absent[:1000]
    for name, call in (("get", lambda: svc.get(qa)), ("contains", lambda: svc.contains(qa)),
                       ("range_lookup", lambda: svc.range_lookup(qa[0], qa[1])),
                       ("lookup_batch", lambda: svc.lookup_batch(qa))):
        with ops.count_dispatches() as nd:
            call()
            check(nd() == 1, f"{tag}: warm {name} is one dispatch, not {nd()}")
    return {"get": n_get, "contains": n_get, "range_lookup": 100, "lookup_batch": n_batch}


def scan_bound_bytes(rows, lanes, *, index_bytes, delta_bytes):
    """Least bytes a scan must move: per live row its base key, base
    value and (range kernel) `live_prefix` entry read, every output lane
    its key, value and live flag written, and the delta arrays read
    once."""
    return rows * (8 + index_bytes) + lanes * 12 + delta_bytes


# ---------------------------------------------------------------------------
# scans: kernels against plain versions, and the main path's scan checks
# ---------------------------------------------------------------------------

def scan_mismatch(got, want):
    """0.0 when the two (keys, vals, live) triples are bit-identical,
    else the largest |difference| over keys, values and flags (inf where
    only the bit patterns differ, e.g. -0.0 against 0.0)."""
    import torch
    (gk, gv, gl), (wk, wv, wl) = got, want
    if (torch.equal(gk.view(torch.int32), wk.view(torch.int32))
            and torch.equal(gv, wv) and torch.equal(gl.int(), wl.int())):
        return 0.0
    kd = torch.nan_to_num((gk.double() - wk.double()).abs(), nan=float("inf"))
    kd = torch.where(gk == wk, torch.zeros_like(kd), kd)
    err = max(float(kd.max()), float((gv.long() - wv.long()).abs().max()),
              float((gl.int() - wl.int()).abs().max()))
    return err or float("inf")


def _pin_arrays(raw, bvals, ins, ivals, dels):
    from repro_torch.index_service.delta import DeltaBuffer
    from repro_torch.index_service.scan import pin_view
    snap = types.SimpleNamespace(keys=types.SimpleNamespace(raw=raw), vals=bvals)
    buf = DeltaBuffer.from_arrays(ins, ivals, dels, ins.size + dels.size + 1)
    return pin_view(snap, None, buf)


def compare_scan_kernels(rng, device, record):
    """Both scan kernels against their plain versions on the card, bit
    for bit, at n = 50k: a Maps key set and a duplicate-heavy one,
    staged inserts that tie base keys in float32, tombstones, an empty
    delta and unpadded power-of-two delta arrays, a tombstone run longer
    than the range kernel's `live_prefix` buffer and an insert cluster
    longer than its `ins_rank` buffer (ranges over them cross many of its
    tiles); NaN, inverted, infinite and out-of-span bounds; page starts
    that are negative, past the end or wrap int32, consecutive pages over
    every live rank (tiles of the page kernel inside the tombstone run
    and the insert cluster), pages past the live count under an end
    rank past it, a page across the int32 wrap and a single page (G = 1)
    in the cluster.  Returns the max |kernel - plain|."""
    import torch
    from repro_torch.core import make_keyset
    from repro_torch.data import gen_maps
    from repro_torch.index_service.scan import device_scan_plan, device_scan_slab
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmi_scan import (RANGE_INS_CAP, RANGE_PREFIX_CAP,
                                              rmi_scan_page_cuda, rmi_scan_range_cuda)

    t = lambda a: torch.as_tensor(np.asarray(a), device=device)  # noqa: E731
    worst = 0.0
    for label, raw in (("maps50k", gen_maps(SMALL_N, seed=4)),
                       ("dup50k", np.unique(_dup_heavy(rng, SMALL_N)))):
        ks = make_keyset(raw)
        bvals = rng.integers(-(1 << 40), 1 << 40, ks.n)
        fresh = _absent(raw, rng.uniform(raw[0], raw[-1], 3000))
        # raw keys a hair above stored ones: distinct, same float32 key
        ties = _absent(raw, raw[rng.choice(ks.n, 500)] * (1 + 1e-13) + 1e-9)
        # a tombstone run from a tenth of the way in, and an insert
        # cluster between two neighbouring keys further on
        a, c = ks.n // 10, ks.n * 7 // 10
        deltas = {
            "staged": (np.unique(np.concatenate([fresh[:1500], ties])),
                       np.sort(rng.choice(raw, 2000, replace=False))),
            "tombstones": (np.empty(0), np.sort(rng.choice(raw, 4096, replace=False))),
            "empty": (np.empty(0), np.empty(0)),
            "pow2": (np.sort(fresh[:1024]), np.sort(rng.choice(raw, 1024, replace=False))),
            "dense": (np.unique(np.concatenate([fresh[:300], _absent(raw, raw[c] + rng.uniform(
                0, raw[c + 1] - raw[c], 2 * RANGE_INS_CAP))])),
                      raw[a:a + min(2 * RANGE_PREFIX_CAP, ks.n // 2)]),
        }
        for dname, (ins, dels) in deltas.items():
            ivals = rng.integers(1, 1 << 31, ins.size)
            view = _pin_arrays(raw, bvals, ins, ivals, dels)
            base = t(ks.norm)
            bv = t(np.clip(bvals, -2**31, 2**31 - 1).astype(np.int32))
            si, sv, sr, lp = device_scan_slab(view, ks.norm, ks.normalize)
            pi, pv, dp = device_scan_plan(view, ks.normalize)
            if dname == "pow2":  # no pad slot: the searches run to the end
                k = ins.size
                si, sv, sr = si[:k], sv[:k], sr[:k]
                pi, pv, dp = si, sv, view.del_pos.astype(np.int32)
            slab = (t(lp), t(si), t(sv), t(sr))
            plan = (t(pi), t(pv), t(dp))
            live = view.live_count
            n = ks.n
            bounds = [[ks.norm[10], ks.norm[n - 10]], [ks.norm[n // 3], ks.norm[n // 3 + 700]],
                      [ks.norm[500], ks.norm[100]], [np.nan, ks.norm[77]],
                      [ks.norm[77], np.nan], [-np.inf, np.inf], [-2.0, -1.0], [1.5, 3.0],
                      [ks.normalize(ties[:1])[0], ks.normalize(ties[-1:])[0]],
                      [ks.norm[a - 10], ks.norm[n - a]]]
            starts = np.array([-7, 0, 1, live // 2, live - 3, live, live + 99,
                               2**31 - 9], np.int32)
            # the page kernel's cases: (starts, end_rank).  The edge starts,
            # then consecutive pages over every live rank (its tiles cross
            # the dense delta's tombstone run and insert cluster); pages
            # past the live count under an end rank past it; a page across
            # the int32 wrap under end rank INT32_MAX; one page (G = 1)
            # inside the insert cluster
            cluster = int(view.rank(raw[c:c + 1])[0])
            for page_size in SCAN_PAGE_SIZES:
                run = (page_size * np.arange(-(-live // page_size) + 2)).astype(np.int64)
                page_cases = {
                    "edges_and_run": (np.concatenate([starts, run]), live),
                    "past_live": (live - 5 + page_size * np.arange(-(-3005 // page_size) + 1),
                                  live + 3000),
                    "int32_wrap": (np.array([2**31 - 100, -page_size // 2, 2**31 - 9]),
                                   2**31 - 1),
                    "one_page": (np.array([cluster - page_size // 2]), live),
                }
                for pname, (pstarts, end) in page_cases.items():
                    st = t(np.asarray(pstarts).astype(np.int32))
                    endt = t(np.array([end], np.int32))
                    got = rmi_scan_page_cuda(st, base, bv, *plan, endt, page_size=page_size)
                    want = ref.rmi_scan_page_reference(st, base, bv, *plan, endt,
                                                       page_size=page_size)
                    err = scan_mismatch(got, want)
                    worst = max(worst, err)
                    check(err == 0,
                          f"scan_page kernel != plain: {label}/{dname}/{pname}/{page_size}")
                endt = t(np.array([live], np.int32))
                empty = rmi_scan_page_cuda(t(np.empty(0, np.int32)), base, bv, *plan, endt,
                                           page_size=page_size)
                check(all(tuple(e.shape) == (0, page_size) for e in empty), "G = 0 pages")
                pages = min(-(-live // page_size) + 2, 4096)
                for b in bounds:
                    bt = t(np.asarray(b, np.float32))
                    kw = dict(page_size=page_size, max_pages=pages)
                    got = rmi_scan_range_cuda(bt, base, bv, *slab, **kw)
                    want = ref.rmi_scan_range_reference(bt, base, bv, *slab, **kw)
                    err = scan_mismatch(got, want)
                    worst = max(worst, err)
                    check(err == 0, f"scan_range kernel != plain: {label}/{dname}/{b}/{page_size}")
            torch.cuda.synchronize()
            record.append({"index": label, "delta": dname, "staged_ins": int(ins.size),
                           "tombstones": int(dels.size), "max_abs_err": worst})
    return worst


class ScanState:
    """The exact state one scan window checks against: the base (raw,
    float32 normalized, payload) with staged inserts (values) and
    tombstones, and the float32-frame merge the device scans."""

    def __init__(self, snap, ins, ins_vals, dels):
        order = np.argsort(ins)
        self.raw, self.norm, self.normalize = snap.keys.raw, snap.keys.norm, snap.keys.normalize
        self.bvals = snap.vals
        self.ins, self.ivals = ins[order], np.asarray(ins_vals, np.int64)[order]
        self.ins_n = self.normalize(self.ins)
        self.dpos = np.searchsorted(self.raw, np.sort(dels))

    def rank_f32(self, qn):
        b = np.searchsorted(self.norm, qn)
        return b - np.searchsorted(self.dpos, b) + np.searchsorted(self.ins_n, qn)

    def _base(self, a, b):
        keep = np.ones(max(0, b - a), bool)
        d0, d1 = np.searchsorted(self.dpos, [a, b])
        keep[self.dpos[d0:d1] - a] = False
        vals = (np.zeros(keep.size, np.int64) if self.bvals is None
                else np.asarray(self.bvals[a:b], np.int64))
        return keep, vals

    def rows_f32(self, lo_n, hi_n):
        """(keys f32, vals, from_insert) of the live rows with float32
        keys in [lo_n, hi_n), base rows before inserts on equal keys."""
        a, b = np.searchsorted(self.norm, [lo_n, hi_n])
        b = max(a, b)
        keep, bv = self._base(a, b)
        c, d = np.searchsorted(self.ins_n, [lo_n, hi_n])
        d = max(c, d)
        keys = np.concatenate([self.norm[a:b][keep], self.ins_n[c:d]])
        vals = np.concatenate([bv[keep], self.ivals[c:d]])
        src = np.concatenate([np.zeros(int(keep.sum()), bool), np.ones(d - c, bool)])
        order = np.argsort(keys, kind="stable")
        return keys[order], vals[order], src[order]

    def rows_f64(self, lo, hi):
        """Exact float64 (keys, vals) of the live rows in [lo, hi)."""
        a, b = np.searchsorted(self.raw, [lo, hi])
        b = max(a, b)
        keep, bv = self._base(a, b)
        c, d = np.searchsorted(self.ins, [lo, hi])
        d = max(c, d)
        keys = np.concatenate([self.raw[a:b][keep], self.ins[c:d]])
        vals = np.concatenate([bv[keep], self.ivals[c:d]])
        order = np.argsort(keys, kind="stable")
        return keys[order], vals[order]


def _mixed_groups(keys, src):
    """Rows in groups of equal float32 keys that hold both a base row and
    a staged insert: there the device emits the base row twice and never
    the insert's value (ROADMAP queue C)."""
    if keys.size == 0:
        return np.zeros(0, bool)
    gid = np.concatenate([[0], np.cumsum(keys[1:] != keys[:-1])])
    n_ins = np.bincount(gid, weights=src)
    size = np.bincount(gid)
    return ((n_ins > 0) & (n_ins < size))[gid]


def scan_ranges(raw, norm, ins, dels, rng):
    """About 30 raw [lo, hi) ranges over the staged state: widths from 1
    to 100k rows, the two timed ranges, endpoints on staged inserts, on
    tombstoned keys and inside float32 duplicate runs, and empty,
    inverted, below-span and above-span ranges."""
    n = raw.size
    out = {}
    for name, w in [(f"w{w}", w) for w in SCAN_WIDTHS] + [(f"r{w}", w) for w in BIG_SCANS]:
        w = min(w, n // 2)  # a rehearsal's smaller key set
        s = int(rng.integers(0, n - w))
        out[name] = (raw[s], raw[s + w])
    ins_s = np.sort(ins)
    k = int(rng.integers(0, ins_s.size - 40))
    out["on_inserts"] = (ins_s[k], ins_s[k + 37])
    out["lo_on_insert"] = (ins_s[k + 5], raw[min(n - 1, np.searchsorted(raw, ins_s[k + 5]) + 3000)])
    d = np.sort(dels)
    k = int(rng.integers(0, d.size - 40))
    out["on_tombstones"] = (d[k], d[k + 23])
    out["hi_on_tombstone"] = (raw[max(0, np.searchsorted(raw, d[k + 30]) - 500)], d[k + 30])
    run = np.flatnonzero((norm[2:] == norm[1:-1]) & (norm[1:-1] == norm[:-2]))
    i = int(run[rng.integers(0, run.size)]) if run.size else n // 2
    out["inside_dup_run"] = (raw[i + 1], raw[i + 2])
    out["from_dup_run"] = (raw[i + 1], raw[min(n - 1, i + 1500)])
    m = n // 2
    out["empty"] = (raw[m], raw[m])
    out["inverted"] = (raw[m + 100], raw[m])
    out["below_span"] = (raw[0] - 10.0, raw[0] - 1.0)
    out["above_span"] = (raw[-1] + 1.0, raw[-1] + 10.0)
    out["low_end"] = (raw[0] - 1.0, raw[50])
    out["high_end"] = (raw[-50], raw[-1] + 1.0)
    return out


def check_scans(svc, state, ranges, tag, device):
    """Checks 1-6 of the scan path on every range and page size; returns
    (rows, max |kernel - plain|, summary)."""
    import torch
    from repro_torch.index_service.scan import device_scan_plan
    from repro_torch.kernels import ops, ref

    t = lambda a: torch.as_tensor(np.asarray(a), device=device)  # noqa: E731
    snap = svc._mgr.current()
    view = svc._pin()
    plan = tuple(t(a) for a in device_scan_plan(view, snap.keys.normalize))
    page_fn = {p: snap.scan_page_fn("cuda_fused", p) for p in SCAN_PAGE_SIZES}
    base_norm, bvals = snap._device_base()
    rows, worst = [], 0.0
    t0 = time.perf_counter()
    svc.scan_batch(*ranges["w1"], SCAN_PAGE_SIZES[0])   # cold: packs the slab
    cold_s = time.perf_counter() - t0
    for name, (lo, hi) in ranges.items():
        lo_n, hi_n = (float(x) for x in snap.keys.normalize(np.array([lo, hi])))
        r0 = int(state.rank_f32(np.float32(lo_n)))
        r1 = max(int(state.rank_f32(np.float32(hi_n))), r0)
        want_k, want_v, src = state.rows_f32(lo_n, hi_n)
        mixed = _mixed_groups(want_k, src)
        for page_size in SCAN_PAGE_SIZES:
            with ops.count_dispatches() as nd:
                keys, vals, live = svc.scan_batch(lo, hi, page_size)
                check(nd() == 1, f"{tag}/{name}: scan_batch is one dispatch")
            # 1. the kernel's pages equal the plain version's
            _, (ins, ivals, ins_rank, lp), _ = svc._scan_plane_cached()
            bounds = t(snap.keys.normalize(np.array([lo, hi])))
            plain = ref.rmi_scan_range_reference(
                bounds, base_norm, bvals, lp, ins, ivals, ins_rank,
                page_size=page_size, max_pages=keys.shape[0])
            err = scan_mismatch((keys, vals, live), plain)
            worst = max(worst, err)
            check(err == 0, f"{tag}/{name}/{page_size}: scan_batch != plain version")
            m = live.flatten()
            count = int(m.sum())
            # 2. the live count is the float32 merged ranks' difference
            check(count == r1 - r0, f"{tag}/{name}: {count} rows, ranks say {r1 - r0}")
            check(count == 0 or bool(m[:count].all()), f"{tag}/{name}: live rows not a prefix")
            got_k = keys.flatten()[:count].cpu().numpy()
            got_v = vals.flatten()[:count].cpu().numpy()
            # 3. the keys are the float32 merge of the live rows in range
            check(bool(np.array_equal(got_k, want_k)), f"{tag}/{name}: scan keys")
            # 4. values, wherever no staged insert ties a base key
            check(bool(np.array_equal(got_v[~mixed], want_v[~mixed].astype(np.int32))),
                  f"{tag}/{name}: scan values")
            # 5. rank-addressed pages at the same ranks hold the same rows
            g = -(-count // page_size) + 1
            starts = t((r0 + page_size * np.arange(g)).astype(np.int32))
            end = t(np.array([r1], np.int32))
            pk, pv, pl = page_fn[page_size](starts, *plan, end)
            pplain = ref.rmi_scan_page_reference(starts, base_norm, bvals, *plan, end,
                                                 page_size=page_size)
            err = scan_mismatch((pk, pv, pl), pplain)
            worst = max(worst, err)
            check(err == 0, f"{tag}/{name}/{page_size}: scan_page_fn != plain version")
            pm = pl.flatten()
            check(int(pm.sum()) == count and torch.equal(pk.flatten()[pm], keys.flatten()[:count])
                  and torch.equal(pv.flatten()[pm], vals.flatten()[:count]),
                  f"{tag}/{name}/{page_size}: scan_page_fn rows != scan_batch rows")
        # 6. the exact host scan on the narrower ranges
        host = None
        if r1 - r0 <= HOST_SCAN_ROWS:
            pages = list(svc.scan(lo, hi, SCAN_PAGE_SIZES[0]))
            hk = np.concatenate([p.keys[p.live_mask] for p in pages]) if pages else np.empty(0)
            hv = (np.concatenate([p.vals[p.live_mask] for p in pages]) if pages
                  else np.empty(0, np.int64))
            ek, ev = state.rows_f64(lo, hi)
            check(bool(np.array_equal(hk, ek) and np.array_equal(hv, ev)),
                  f"{tag}/{name}: host scan != float64 oracle")
            host = int(hk.size)
        rows.append({"range": name, "rows": r1 - r0, "tied_rows": int(mixed.sum()),
                     "host_rows": host})
    _, slab, ins_n = svc._scan_plane_cached()
    return rows, worst, {"cold_scan_batch_s": cold_s, "plan": plan, "slab": slab,
                         "ins_n": ins_n, "base": (base_norm, bvals), "view": view}


# ---------------------------------------------------------------------------
# phase 4: timing
# ---------------------------------------------------------------------------

def time_ms(fn, reps=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bound_bytes(batch, steps, dsteps, d, merged, s0_bytes):
    """Least bytes the lookup must move: each query reads its key, its
    leaf's four parameters, its first probe and `steps` halving probes
    (4 B each), writes its outputs; the delta search reads `dsteps`
    delta keys per query (at most the whole padded delta) and one
    prefix entry; the stage-0 buffer is read once."""
    per_q = 4 + 16 + 4 * (1 + steps) + 4 * (2 if merged else 1)
    total = batch * per_q + s0_bytes
    if merged:
        total += min(batch * dsteps, d) * 4 + min(batch, d + 1) * 4
    return total


def sharded_bound_bytes(batch, shards, steps, dsteps, d, s0_bytes):
    """Least bytes the sharded lookup must move.  Each query's bounded
    search reaches device memory only on the row of the shard that owns
    it, where it costs what `bound_bytes` charges a query.  On each of
    the other S - 1 rows it clamps to that shard's first or last leaf
    and position, lines that all such lanes share, so there it costs
    only its key read and its two outputs.  The stacked delta (``d``
    entries in all) is read at most once."""
    return (bound_bytes(batch, steps, dsteps, d, True, s0_bytes)
            + (shards - 1) * batch * 12)


def ptxas_resources(module, kernels):
    """Registers, spill stores and loads and stack bytes of each named
    kernel, from the ``-Xptxas -v`` report `kernels.nvcc` writes beside
    ``module``'s library."""
    from repro_torch.kernels import nvcc
    log = nvcc.library_path(module.SOURCE).with_suffix(".log")
    out, cur = {}, None
    for ln in (log.read_text().splitlines() if log.exists() else []):
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:   # Itanium mangling: the name's length, then the name
            cur = next((k for k in kernels if f"{len(k)}{k}" in m.group(1)), None)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            out.setdefault(cur, {}).update(stack_bytes=int(m[1]), spill_stores=int(m[2]),
                                           spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.setdefault(cur, {})["registers"] = int(m[1])
    return out


def lookup_mismatch(got, want):
    """0 when both (base, merged) pairs are bit-identical, else the
    largest |difference|."""
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def host_profile(fn, reps, top=12):
    """cProfile of ``reps`` calls of ``fn``: total seconds and each of
    the ``top`` functions' share of it, by own time and by cumulative
    time."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(reps):
        fn()
    prof.disable()
    stats = pstats.Stats(prof).stats
    total = sum(tt for _, _, tt, _, _ in stats.values())

    def name(f):
        return f"{pathlib.Path(f[0]).name}:{f[1]}({f[2]})"

    def ranked(i):
        rows = sorted(stats.items(), key=lambda kv: -kv[1][i])[:top]
        return [{"fn": name(f), "share": v[i] / total} for f, v in rows]

    return {"total_s": total, "reps": reps, "by_own": ranked(2), "by_cumulative": ranked(3)}


# ---------------------------------------------------------------------------
# the sharded kernels against their plain versions (phase 2)
# ---------------------------------------------------------------------------

SHARD_SIZES = {1: (50_000,), 3: (9_000, 26_000, 15_000), 4: (9_000, 21_000, 14_000, 6_000)}
# the lookup's cases add five and eight shard rows
LOOKUP_SHARD_SIZES = {**SHARD_SIZES, 5: (9_000, 4_000, 17_000, 12_000, 8_000),
                      8: (7_000, 3_000, 9_000, 5_000, 11_000, 4_000, 6_000, 5_000)}
SHARD_LEAF_DIV = (48, 64, 30, 100, 40, 56, 72, 20)


def _stacked_delta_rows(rows):
    """Per-shard (dk, dp) pairs stacked as the sharded service stacks
    them: keys +inf-padded to the widest row, prefixes repeating their
    last value."""
    d = max(dk.size for dk, _ in rows)
    dks = np.full((len(rows), d), np.inf, np.float32)
    dps = np.zeros((len(rows), d + 1), np.int32)
    for s, (dk, dp) in enumerate(rows):
        dks[s, : dk.size] = dk
        dps[s, : dp.size] = dp
        dps[s, dp.size:] = dp[-1]
    return dks, dps


def compare_sharded_lookup_kernel(rng, device, record):
    """`rmi_sharded_merged_lookup_cuda` against its plain version on the
    card, bit for bit: S in {1, 3, 4, 5, 8} shards of unequal sizes and
    leaf counts (Maps keys and a duplicate-heavy key set), an empty, a
    staged and an unpadded power-of-two delta, stored / absent / duplicate-run queries
    and queries above and below every key, batches of 777 and 1<<20,
    query and delta rows broadcast with stride 0, and the leaf record's
    column views `stack_rows` hands out (read in place) against four
    separate arrays (packed per call)."""
    import torch
    from repro_torch.core import RMIConfig, build_rmi, make_keyset
    from repro_torch.data import gen_maps
    from repro_torch.index_service.delta import DeltaBuffer, combine_for_device
    from repro_torch.kernels import ops, ref, rmi_lookup
    from repro_torch.kernels.rmi_lookup import rmi_sharded_merged_lookup_cuda

    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)  # noqa: E731
    worst = 0
    for label, raw in (("maps", gen_maps(SMALL_N, seed=5)),
                       ("dup", np.unique(_dup_heavy(rng, SMALL_N)))):
        for S, sizes in LOOKUP_SHARD_SIZES.items():
            cuts = np.concatenate([[0], np.cumsum(sizes)]) * raw.size // sum(sizes)
            shards = []
            for s in range(S):
                ks = make_keyset(raw[cuts[s]:cuts[s + 1]])
                shards.append((ks, build_rmi(ks, RMIConfig(
                    num_leaves=max(16, ks.n // SHARD_LEAF_DIV[s]), stage0_hidden=(),
                    stage0_train_steps=0), device=device)))
            st = ops.stack_shard_arrays([i for _, i in shards], [k.norm for k, _ in shards],
                                        device)
            deltas = {"empty": [combine_for_device(None, None, k.normalize) for k, _ in shards]}
            staged, pow2 = [], []
            for s, (ks, _) in enumerate(shards):
                ins = _absent(ks.raw, rng.uniform(ks.raw[0], ks.raw[-1], 1200))
                dels = np.sort(rng.choice(ks.raw, min(700, ks.n // 4), replace=False))
                buf = DeltaBuffer.from_arrays(ins, np.zeros(ins.size, np.int64), dels,
                                              ins.size + dels.size)
                staged.append(combine_for_device(None, buf, ks.normalize))
                k = 1024 if s == 0 else 300    # row 0 exactly 1024 staged: no pad
                buf = DeltaBuffer.from_arrays(np.sort(ins[:k // 2]), np.zeros(k // 2, np.int64),
                                              dels[:k - k // 2], k)
                pow2.append(combine_for_device(None, buf, ks.normalize, min_pad=1))
            deltas["staged"], deltas["pow2"] = staged, pow2
            edges = np.array([raw[0] - 1.0, raw[0], raw[-1], raw[-1] + 1.0, -1e300, 1e300])
            qraw = {"stored": rng.choice(raw, 20_000),
                    "absent": rng.uniform(raw[0], raw[-1], 20_000), "edges": edges}
            pool = np.concatenate(list(qraw.values()))
            qraw["batch_777"] = rng.choice(pool, 777)
            qraw["batch_1M"] = rng.choice(pool, BIG_BATCH)
            sizes_t = (st["shard_n"], st["shard_m"], st["shard_ratio"])
            leaves = {"record": tuple(st[k] for k in ("leaf_w", "leaf_b", "err_lo", "err_hi"))}
            check(rmi_lookup._stacked_leaf_record(*leaves["record"])[0] is leaves["record"][0],
                  f"sharded lookup: S{S} leaf tensors are not one record")
            leaves["separate"] = tuple(a.contiguous() for a in leaves["record"])
            kw = dict(hidden=st["hidden"], max_window=st["max_window"])
            for dname, rows in deltas.items():
                dks, dps = _stacked_delta_rows(rows)
                dkt, dpt = t(dks), t(dps)
                for qname, q in qraw.items():
                    qs = t(np.stack([k.normalize(q) for k, _ in shards]))
                    views = [(qs, dkt, dpt, "record")]
                    if qname in ("edges", "batch_1M"):  # four arrays, packed per call
                        views.append((qs, dkt, dpt, "separate"))
                    if qname == "batch_777":  # broadcast rows, read in place
                        views.append((qs[:1].expand(S, -1), dkt[:1].expand(S, -1),
                                      dpt[:1].expand(S, -1), "record"))
                    for vq, vdk, vdp, layout in views:
                        stacked = (st["stage0"], *leaves[layout], st["keys"])
                        kb, kc = rmi_sharded_merged_lookup_cuda(vq, *stacked, vdk, vdp,
                                                                *sizes_t, **kw)
                        pb, pc = ref.rmi_sharded_merged_lookup_reference(
                            vq, *stacked, vdk, vdp, *sizes_t, **kw)
                        torch.cuda.synchronize()
                        err = max(int((kb - pb).abs().max()), int((kc - pc).abs().max()))
                        worst = max(worst, err)
                        record.append({"keys": label, "S": S, "delta": dname, "queries": qname,
                                       "broadcast": vq.stride(0) == 0, "leaves": layout,
                                       "batch": int(vq.shape[1]), "max_abs_err": err})
                        check(err == 0, f"sharded lookup kernel != plain: {label}/S{S}/"
                                        f"{dname}/{qname}")
                    # stored keys at each shard's own float32 lower bound
                    if qname == "stored":
                        for s, (ks, _) in enumerate(shards):
                            qn = ks.normalize(q)
                            mine = np.isin(qn, ks.norm)
                            want = np.searchsorted(ks.norm, qn[mine])
                            check(bool((kb[s].cpu().numpy()[mine] == want).all()),
                                  f"sharded lookup: stored keys of shard {s} off their bound")
    return worst


def compare_sharded_scan_kernel(rng, device, record):
    """`rmi_sharded_scan_page_cuda` against its plain version on the
    card, bit for bit, through the op (rank pre-pass, kernel, reduction)
    and raw (adversarial owners, an int32-wrapping local rank): S in
    {1, 3, 4} shard slabs with staged inserts (some tying base keys in
    float32) and tombstones; NaN, inverted, infinite and out-of-span
    bounds; page sizes 256, 160 and 1; raw owners whose tiles wrap
    int32, start mid-tile or own nothing; and S = 3 again with a run of
    tombstones over half of each shard and an insert cluster longer than
    a tile's `ins_rank` buffer."""
    import torch
    from repro_torch.data import gen_maps
    from repro_torch.index_service.scan import stack_scan_slabs
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.rmi_scan import RANGE_INS_CAP, rmi_sharded_scan_page_cuda

    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)  # noqa: E731
    raw = gen_maps(SMALL_N, seed=6)
    worst = 0.0
    for S, sizes, dense in [(S, sizes, False) for S, sizes in SHARD_SIZES.items()] + [
            (3, SHARD_SIZES[3], True)]:
        cuts = np.concatenate([[0], np.cumsum(sizes)]) * raw.size // sum(sizes)
        views = []
        for s in range(S):
            part = raw[cuts[s]:cuts[s + 1]]
            fresh = _absent(part, rng.uniform(part[0], part[-1], 800))
            ties = _absent(part, part[rng.choice(part.size, 60)] * (1 + 1e-13) + 1e-9)
            ins = np.unique(np.concatenate([fresh, ties]))
            dels = (part[part.size // 4:part.size * 3 // 4] if dense
                    else np.sort(rng.choice(part, 500, replace=False)))
            if dense:   # and an insert cluster longer than a tile's ins_rank buffer
                c = part.size * 7 // 8
                ins = np.union1d(ins, _absent(part, part[c] + rng.uniform(
                    0, part[c + 1] - part[c], 2 * RANGE_INS_CAP)))
            views.append(_pin_arrays(part, rng.integers(-(1 << 40), 1 << 40, part.size), ins,
                                     rng.integers(1, 1 << 31, ins.size), dels))
        p = stack_scan_slabs(views)
        slabs = [t(p[k]) for k in ("base", "bvals", "live_prefix", "ins", "ivals", "ins_rank")]
        nb = p["base"]
        live = sum(v.live_count for v in views)
        bounds = [(nb[0, 10], nb[-1, 100]), (nb[0, 500], nb[0, 100]), (np.nan, nb[0, 77]),
                  (nb[0, 77], np.nan), (-np.inf, np.inf), (-2.0, -1.0), (1.5, 3.0),
                  (nb[S // 2, 3], nb[S // 2, (cuts[S // 2 + 1] - cuts[S // 2]) * 3 // 4])]
        for page_size in SCAN_PAGE_SIZES:
            pages = min(-(-live // page_size) + 2, 4096)
            for lo, hi in bounds:
                b = t(np.array([lo, hi], np.float32))
                kw = dict(page_size=page_size, max_pages=pages)
                got = ops.rmi_sharded_scan_page_op(b, *slabs, **kw)
                want = ops.rmi_sharded_scan_page_op(b, *slabs, use_kernel=False, **kw)
                err = scan_mismatch(got, want)
                worst = max(worst, err)
                check(err == 0, f"sharded scan kernel != plain: S{S}/{(lo, hi)}/{page_size}")
            # raw owners: local ranks that wrap int32 inside a tile (in the
            # first tile, and from slot 3,000 on), one just above INT32_MIN
            # (t - j + 1 would wrap), a negative first slot, an inverted
            # span, spans owned from mid-tile
            kw = dict(page_size=page_size, max_pages=-(-6000 // page_size))
            for raw_owners in (([0, 2**31 - 5, 7, live // 2], [0, 300, 600, 900],
                                [300, 600, 900, 2**31 - 1]),
                               ([-2**31 + 2, 2**31 - 3000, 2**31 - 40, 0],
                                [-50, 0, 200, 901], [333, 5000, 901, 5000]),
                               ([11, 0, 5, 0], [333, 0, 2**31 - 1, 100], [200, 4000, 0, 6000])):
                owners = [t(np.array(a, np.int32)[:S]) for a in raw_owners]
                err = scan_mismatch(rmi_sharded_scan_page_cuda(*slabs, *owners, **kw),
                                    ref.rmi_sharded_scan_page_reference(*slabs, *owners, **kw))
                worst = max(worst, err)
                check(err == 0, f"raw sharded scan kernel != plain: S{S}/{page_size}/"
                                f"{raw_owners[0][:S]}")
        torch.cuda.synchronize()
        record.append({"S": S, "dense_tombstones": dense, "live": int(live),
                       "max_abs_err": worst})
    return worst


# ---------------------------------------------------------------------------
# the sharded main path (phases 3-4)
# ---------------------------------------------------------------------------

def check_snapshot_sharded(snap, dk, dp, rng, device, batch=BIG_BATCH):
    """`IndexSnapshot.merged_lookup_fn("sharded_fused")` on the staged
    index: equal to `cuda_fused` on stored keys (both outputs, and the
    float32 lower bound), and bit-identical to its plain version (the
    twin on the same broadcast rows, routed and reassembled) on stored
    and absent queries.  Absent queries have no window guarantee under
    either strategy's RMIs, so there the two may differ; the count of
    absent queries each one places off the float32 lower bound is
    reported."""
    import torch
    from repro_torch.kernels import ops, ref

    ks = snap.keys
    t0 = time.perf_counter()
    plan = snap._sharded_plan()
    out = {"plan_s": time.perf_counter() - t0, "S": plan["S"],
           "shard_n": plan["shard_n"].tolist(), "max_window": plan["max_window"]}
    fn, cf = snap.merged_lookup_fn("sharded_fused"), snap.merged_lookup_fn("cuda_fused")
    S = plan["S"]
    stacked = [plan[k] for k in ("stage0", "leaf_w", "leaf_b", "err_lo", "err_hi", "keys")]
    sizes = (plan["shard_n"], plan["shard_m"], plan["shard_ratio"])
    for name, qn in (("stored", ks.norm[rng.choice(ks.n, batch)]),
                     ("absent", ks.normalize(rng.uniform(ks.raw[0], ks.raw[-1], batch)))):
        q = torch.as_tensor(np.ascontiguousarray(qn, np.float32), device=device)
        b, m = fn(q, dk, dp)
        lb, ct = ref.rmi_sharded_merged_lookup_reference(
            q.expand(S, -1), *stacked, dk.expand(S, -1), dp.expand(S, -1), *sizes,
            hidden=plan["hidden"], max_window=plan["max_window"])
        pb, pm = ops.sharded_reassemble(lb, ct, torch.searchsorted(plan["starts"], q, right=True),
                                        plan["base_off"], plan["base_off"])
        check(bool(torch.equal(b, pb) and torch.equal(m, pm)),
              f"snapshot sharded_fused ({name}): kernel path != plain version")
        cb, cm = cf(q, dk, dp)
        b, m, cb, cm = (x.cpu().numpy() for x in (b, m, cb, cm))
        want = np.searchsorted(ks.norm, qn)
        if name == "stored":
            check(bool(np.array_equal(b, cb) and np.array_equal(m, cm)),
                  "snapshot sharded_fused != cuda_fused on stored keys")
            check(bool(np.array_equal(b, want)), "snapshot sharded_fused off the f32 lower bound")
        else:
            hit = (b == want) & (cb == want)
            check(bool(np.array_equal(m[hit], cm[hit])), "sharded_fused merged != cuda_fused")
            out["absent_off_bound"] = {"sharded_fused": int((b != want).sum()),
                                       "cuda_fused": int((cb != want).sum()),
                                       "differ": int((b != cb).sum()), "of": int(batch)}
    return out


def sharded_lookup_oracle(svc, oracle):
    """lookup_batch's float32 ranks on the sharded service: per routed
    shard, the count of live keys (the global oracle's, cut at the
    router's boundaries) whose float32 key in that shard's own frame
    lies below the query's, plus the live keys of the lower shards."""
    edges = np.concatenate([[-np.inf], svc.router.boundaries, [np.inf]])
    shards = [sh._mgr.current().keys.normalize for sh in svc.shards]
    lives = []
    for s in range(len(shards)):
        a, b = np.searchsorted(oracle.base, edges[s:s + 2])
        part = oracle.base[a:b]
        d0, d1 = np.searchsorted(oracle.dels, edges[s:s + 2])
        keep = np.ones(part.size, bool)
        keep[np.searchsorted(part, oracle.dels[d0:d1])] = False
        i0, i1 = np.searchsorted(oracle.ins, edges[s:s + 2])
        kept, ins = part[keep], oracle.ins[i0:i1]
        lives.append(shards[s](np.insert(kept, np.searchsorted(kept, ins), ins)))
    offs = np.concatenate([[0], np.cumsum([lv.size for lv in lives])])

    def f32_ranks(qb):
        route = svc.router.route(qb)
        out = np.zeros(qb.size, np.int64)
        for s, lv in enumerate(lives):
            m = route == s
            out[m] = offs[s] + np.searchsorted(lv, shards[s](qb[m]))
        return out
    return f32_ranks


def sharded_scan_state(svc, oracle):
    """The float32-frame scan oracle of the sharded service: the shards'
    bases (concatenated: their ranges tile the key space) with their
    staged inserts and tombstones, in the scan plane's shared frame.
    The staged entries come from the shards' delta buffers and must make
    up exactly the global oracle's live set."""
    plane = svc._scan_plane()
    snaps, ins, ivals, dels = [], [], [], []
    for sh in svc.shards:
        snap, frozen, active = sh._state()
        check(frozen is None, "scan oracle: a shard holds a frozen delta level")
        snaps.append(snap)
        ins.append(active.ins_keys)
        ivals.append(active.ins_vals)
        dels.append(active.del_keys)
    raw = np.concatenate([sn.keys.raw for sn in snaps])
    vals = np.concatenate([sn.vals for sn in snaps])
    ins, ivals, dels = np.concatenate(ins), np.concatenate(ivals), np.concatenate(dels)
    want = oracle.base.size + oracle.ins.size - oracle.dels.size
    check(raw.size + ins.size - dels.size == want, "scan oracle: live count")
    fake = types.SimpleNamespace(keys=types.SimpleNamespace(
        raw=raw, norm=plane.normalize(raw), normalize=plane.normalize), vals=vals)
    return ScanState(fake, ins, ivals, dels)


def check_sharded_scans(svc, state, ranges, tag, device):
    """The scan checks of `check_scans` on the sharded service: each
    scan_batch one dispatch, bit-identical to the plain op on the same
    plane, its count the float32 rank difference, its keys the float32
    merge in the plane's frame, its values equal outside tied float32
    groups; the host `scan` equal to the float64 merge up to
    HOST_SCAN_ROWS rows."""
    import torch
    from repro_torch.kernels import ops

    rows, worst = [], 0.0
    plane = svc._scan_plane()
    slabs = (plane.base, plane.bvals, plane.live_prefix, plane.ins, plane.ivals, plane.ins_rank)
    for name, (lo, hi) in ranges.items():
        lo_n, hi_n = (np.float32(x) for x in plane.normalize(np.array([lo, hi])))
        r0 = int(state.rank_f32(lo_n))
        r1 = max(int(state.rank_f32(hi_n)), r0)
        want_k, want_v, src = state.rows_f32(lo_n, hi_n)
        mixed = _mixed_groups(want_k, src)
        for page_size in SCAN_PAGE_SIZES:
            with ops.count_dispatches() as nd:
                keys, vals, live = svc.scan_batch(lo, hi, page_size)
                check(nd() == 1, f"{tag}/{name}: sharded scan_batch is one dispatch")
            plain = ops.rmi_sharded_scan_page_op(
                torch.as_tensor(np.array([lo_n, hi_n]), device=device), *slabs,
                page_size=page_size, max_pages=keys.shape[0], use_kernel=False,
                strategy="plain_check")
            err = scan_mismatch((keys, vals, live), plain)
            worst = max(worst, err)
            check(err == 0, f"{tag}/{name}/{page_size}: sharded scan_batch != plain version")
            m = live.flatten()
            count = int(m.sum())
            check(count == r1 - r0, f"{tag}/{name}: {count} rows, ranks say {r1 - r0}")
            check(count == 0 or bool(m[:count].all()), f"{tag}/{name}: live rows not a prefix")
            got_k = keys.flatten()[:count].cpu().numpy()
            got_v = vals.flatten()[:count].cpu().numpy()
            check(bool(np.array_equal(got_k, want_k)), f"{tag}/{name}: sharded scan keys")
            check(bool(np.array_equal(got_v[~mixed], want_v[~mixed].astype(np.int32))),
                  f"{tag}/{name}: sharded scan values")
        host = None
        if r1 - r0 <= HOST_SCAN_ROWS:
            pages = list(svc.scan(lo, hi, SCAN_PAGE_SIZES[0]))
            hk = np.concatenate([p.keys[p.live_mask] for p in pages]) if pages else np.empty(0)
            hv = (np.concatenate([p.vals[p.live_mask] for p in pages]) if pages
                  else np.empty(0, np.int64))
            ek, ev = state.rows_f64(lo, hi)
            check(bool(np.array_equal(hk, ek) and np.array_equal(hv, ev)),
                  f"{tag}/{name}: sharded host scan != float64 oracle")
            host = int(hk.size)
        rows.append({"range": name, "rows": r1 - r0, "tied_rows": int(mixed.sum()),
                     "host_rows": host})
    return rows, worst, {"plane": plane}


SHARDED_PATHS = {"sharded_lookup": ("rmi_sharded_merged_lookup_cuda",),
                 "sharded_scan": ("rmi_sharded_scan_page_cuda",)}


def write_set(base, rng, n_writes):
    """``n_writes`` absent keys in ``base``'s span to insert, sorted, with
    values 1..n_writes, and ``n_writes`` stored keys to delete, sorted."""
    ins = _absent(base, rng.uniform(base[0], base[-1], n_writes * 11 // 10))
    ins = np.sort(rng.choice(ins, n_writes, replace=False))
    dels = np.sort(rng.choice(base, n_writes, replace=False))
    return ins, 1 + np.arange(ins.size, dtype=np.int64), dels


def drive_sharded(svc, base, rng, device, tag, n_writes, n_get, n_lookup, windows,
                  rebalance_to=None, staged_hook=None):
    """Writes, reads and scans on a sharded service over ``base`` (zero
    payload): ``n_writes`` inserts (values 1..n) and deletes routed
    across the shards, then get / contains / range_lookup / lookup_batch
    and the scan ranges against the oracles (then
    ``staged_hook(svc, oracle, ranges)``, while the writes are staged);
    optionally a rebalance to ``rebalance_to`` shards; a flush; and all
    the checks again.  Each path's launch counts go to ``windows``.
    Returns the staged plan and plane (for the times), the oracle state
    and a summary."""
    ins, ins_vals, dels = write_set(base, rng, n_writes)
    t0 = time.perf_counter()
    check(svc.insert(ins, ins_vals) == ins.size, f"{tag}: insert applied count")
    check(svc.delete(dels) == dels.size, f"{tag}: delete applied count")
    summary = {"write_s": time.perf_counter() - t0}
    oracle = Oracle(base, ins, dels)
    ranges = None
    kept = None
    states = []
    staged = {}
    for step in ("staged", "rebalanced", "compacted"):
        if step == "rebalanced":
            if rebalance_to is None:
                continue
            t0 = time.perf_counter()
            svc.rebalance(rebalance_to)
            summary["rebalance_s"] = time.perf_counter() - t0
            check(svc.num_shards == rebalance_to, f"{tag}: rebalance to {rebalance_to} shards")
        if step == "compacted":
            t0 = time.perf_counter()
            svc.flush()
            summary["flush_s"] = time.perf_counter() - t0
            check(all(len(sh._active) == 0 and sh.num_delta_levels == 0 for sh in svc.shards),
                  f"{tag}: a shard kept staged entries through flush")
            kept = np.ones(base.size, bool)
            kept[np.searchsorted(base, dels)] = False
            live = np.insert(base[kept], np.searchsorted(base[kept], ins), ins)
            raw = np.concatenate([sh._mgr.current().keys.raw for sh in svc.shards])
            check(bool(np.array_equal(raw, live)), f"{tag}: compacted key set")
            vals = np.concatenate([sh._mgr.current().vals for sh in svc.shards])
            want = np.zeros(live.size, np.int64)
            want[np.searchsorted(live, ins)] = ins_vals
            check(bool(np.array_equal(vals, want)), f"{tag}: compacted payload")
            oracle = Oracle(live, np.empty(0), np.empty(0))
        reset_counts()
        t0 = time.perf_counter()
        checked = check_reads(
            svc, oracle, rng, f"{tag}/{step}", n_get, n_lookup,
            f32_ranks=sharded_lookup_oracle(svc, oracle),
            stored=np.concatenate([sh._mgr.current().keys.raw for sh in svc.shards]))
        windows.append(("sharded_lookup", read_counts()))
        if step == "staged":
            staged["plan"] = svc._device_plan()
        read_s = time.perf_counter() - t0
        reset_counts()
        t0 = time.perf_counter()
        svc._scan_plane()   # cold: packs and uploads the stacked scan plane
        plane_s = time.perf_counter() - t0
        state = sharded_scan_state(svc, Oracle(base, ins, dels) if step != "compacted"
                                   else oracle)
        if ranges is None:
            ranges = scan_ranges(state.raw, state.norm, ins, dels, rng)
        rows, err, info = check_sharded_scans(svc, state, ranges, f"{tag}/{step}", device)
        windows.append(("sharded_scan", read_counts()))
        if step == "staged":
            staged.update(plane=info["plane"], state=state)
        summary[step] = {"checked": checked, "read_s": read_s,
                         "scan_s": time.perf_counter() - t0,
                         "scan_plane_build_s": plane_s,
                         "scan_max_abs_err": err, "ranges": rows,
                         "shards": svc.num_shards,
                         "shard_live_keys": svc.stats_summary()["shard_live_keys"]}
        states.append(err)
        if step == "staged" and staged_hook is not None:
            summary["staged_hook"] = staged_hook(svc, oracle, ranges)
    summary["scan_max_abs_err"] = max(states)
    return staged, ranges, summary


def _scan_rows(out):
    keys, vals, live = out
    m = live.flatten()
    return keys.flatten()[m], vals.flatten()[m]


def run_checkpoint(svc, oracle, ranges, rng, dev):
    """`IndexCheckpointer.save` of the sharded service while its writes
    are staged, `restore()` on the card, and the restored service's
    sharded lookup_batch (B4), get, contains and scan_batch (B5) equal
    to the live service's on a query set and the phase's scan windows.
    The checkpoint goes to a temporary directory removed after."""
    import shutil
    import tempfile
    import torch
    from repro_torch.distributed import IndexCheckpointer

    base = oracle.base
    q = rng.permutation(np.concatenate([
        rng.choice(base, N_GET // 2), oracle.ins[rng.integers(0, oracle.ins.size, N_GET // 8)],
        oracle.dels[rng.integers(0, oracle.dels.size, N_GET // 8)],
        rng.uniform(base[0] - 1, base[-1] + 1, N_GET // 4)]))
    qb = rng.choice(base, BIG_BATCH)
    page = SCAN_PAGE_SIZES[0]
    live = {"get": svc.get(q), "contains": svc.contains(q), "lookup": svc.lookup_batch(qb),
            "scans": {k: _scan_rows(svc.scan_batch(lo, hi, page)) for k, (lo, hi) in
                      ranges.items()}}
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        ckpt = IndexCheckpointer(root)
        t0 = time.perf_counter()
        path = ckpt.save(1, svc)
        save_s = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in pathlib.Path(path).rglob("*") if f.is_file())
        t0 = time.perf_counter()
        back, step = ckpt.restore(svc.config, device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(step == 1 and back.num_shards == svc.num_shards, "checkpoint: restored step")
        staged = [len(s._active) for s in back.shards]
        check(sum(staged) > 0, "checkpoint: the restored shards hold no staged writes")
        reset_counts()
        t0 = time.perf_counter()
        check(all(np.array_equal(a, b) for a, b in zip(back.get(q), live["get"])),
              "checkpoint: restored get != live")
        check(bool(np.array_equal(back.contains(q), live["contains"])),
              "checkpoint: restored contains != live")
        check(torch.equal(back.lookup_batch(qb), live["lookup"]),
              "checkpoint: restored lookup_batch != live")
        for k, (lo, hi) in ranges.items():
            got = _scan_rows(back.scan_batch(lo, hi, page))
            check(all(torch.equal(a, b) for a, b in zip(got, live["scans"][k])),
                  f"checkpoint: restored scan_batch != live on {k}")
        torch.cuda.synchronize()
        verify_s = time.perf_counter() - t0
        counts = read_counts()
        launches = {k: counts[k] for k in ("rmi_sharded_merged_lookup_cuda",
                                           "rmi_sharded_scan_page_cuda")}
        check(all(v > 0 for v in launches.values()),
              f"checkpoint: the restored reads launched {launches}")
        del back
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {"save_s": save_s, "restore_s": restore_s, "verify_s": verify_s, "bytes": size,
           "staged_per_shard": staged, "queries": int(q.size), "lookup_batch": int(qb.size),
           "windows": len(ranges), "launches": launches}
    emit({"phase": "checkpoint", "service": "sharded", **out})
    return out


def run_torn_checkpoint(svc, rng, dev):
    """A save under ``ckpt.write.torn`` is quarantined and `restore()`
    falls back to the intact step before it."""
    import os
    import shutil
    import tempfile
    from repro_torch import faults
    from repro_torch.distributed import IndexCheckpointer

    root = tempfile.mkdtemp(prefix="chip_smoke_torn_")
    try:
        ckpt = IndexCheckpointer(root)
        ckpt.save(1, svc)
        raw = np.concatenate([sh._mgr.current().keys.raw for sh in svc.shards])
        extra = _absent(raw, rng.uniform(raw[0], raw[-1], 1_000))
        svc.insert(extra)
        with faults.inject(faults.FaultSchedule({"ckpt.write.torn": 1})) as sched:
            ckpt.save(2, svc)
        check(sched.fired["ckpt.write.torn"] == 1, "torn checkpoint: the fault did not fire")
        back, step = ckpt.restore(svc.config, device=dev)
        check(step == 1 and os.path.isdir(os.path.join(root, "step_0000000002.quarantine")),
              f"torn checkpoint: restored step {step}")
        sample = raw[rng.integers(0, raw.size, 20_000)]
        check(bool(back.contains(sample).all()) and not bool(back.contains(extra).any()),
              "torn checkpoint: the restored service is not step 1's")
        svc.delete(extra)
        del back
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"restored_step": step, "quarantined": 2}


def run_sharded(args, base, rng, dev, card):
    """The sharded main path at scale: `ShardedIndexService(num_shards=4,
    strategy="sharded_fused")` over ``base`` (zero payload), staged and
    compacted, then its times."""
    import torch
    from repro_torch.index_service import ServiceConfig, ShardedIndexService
    from repro_torch.index_service.scan import scan_page_bound
    from repro_torch.kernels import ops, ref, rmi_lookup
    from repro_torch.kernels.rmi_lookup import rmi_sharded_merged_lookup_cuda
    from repro_torch.kernels.rmi_scan import rmi_sharded_scan_page_cuda

    t0 = time.perf_counter()
    svc = ShardedIndexService(
        base, ServiceConfig(num_shards=4, strategy="sharded_fused", delta_capacity=1 << 20),
        vals=np.zeros(base.size, np.int64), device=dev)
    emit({"phase": "sharded_build", "n": int(base.size), "build_s": time.perf_counter() - t0,
          "shard_n": [sh._mgr.current().n for sh in svc.shards],
          "num_leaves": [sh._mgr.current().index.num_leaves for sh in svc.shards],
          "max_window": [sh._mgr.current().index.max_window for sh in svc.shards]})
    guard = start_failover_guard()
    ops.reset_dispatch_stats()
    windows = []
    t_main = time.perf_counter()
    # the --n rehearsal's cut base holds fewer keys than N_WRITES deletes
    staged, ranges, summary = drive_sharded(
        svc, base, rng, dev, "sharded", min(N_WRITES, base.size // 4), N_GET, N_LOOKUP,
        windows, staged_hook=lambda s, o, r: run_checkpoint(s, o, r, rng, dev))
    launches = {k: 0 for ks in SHARDED_PATHS.values() for k in ks}
    for path, counts in windows:
        for k in SHARDED_PATHS[path]:
            launches[k] += counts[k]
    ledger = ops.dispatch_summary()
    emit({"phase": "sharded_main_path", "seconds": time.perf_counter() - t_main,
          "launches": launches, "windows": windows, "dispatch_rows": ledger["rows"],
          **summary})
    for op in ("rmi_sharded_routed_lookup", "rmi_sharded_scan_page"):
        rows = [r for r in ledger["rows"] if r["op"] == op and r["strategy"] == "sharded_fused"]
        check(bool(rows) and all(r["path"] == "kernel" for r in rows),
              f"{op} rows must all be on path kernel")
    check(all(v > 0 for v in launches.values()), f"a sharded kernel never launched: {launches}")
    failover_guard("sharded", guard)

    # ---- phase 4: times on the staged sharded index ---------------------
    plan = staged["plan"]
    S = int(plan.keys.shape[0])
    # stored keys, absent keys, and keys on and past both ends of the span
    span = base[-1] - base[0]
    edges = np.concatenate([[base[0] - 1, base[-1] + 1, base[0], base[-1], -1e30, 1e30],
                            base[0] - span * np.array([1e-9, 1e-3, 1.0]),
                            base[-1] + span * np.array([1e-9, 1e-3, 1.0])])
    absent = _absent(base, rng.uniform(base[0], base[-1], BIG_BATCH // 8))
    qraw = rng.permutation(np.concatenate([
        base[rng.choice(base.size, BIG_BATCH - absent.size - edges.size)], absent, edges]))
    qs = torch.as_tensor(np.stack([norm(qraw) for norm in plan.q_normalizers]), device=dev)
    args_l = (qs, plan.stage0, plan.leaf_w, plan.leaf_b, plan.err_lo, plan.err_hi, plan.keys,
              plan.dkeys, plan.dprefix, plan.shard_n, plan.shard_m, plan.shard_ratio)
    kw = dict(hidden=plan.hidden, max_window=plan.max_window)
    steps = rmi_lookup._search_steps(plan.max_window)
    d = int(plan.dkeys.shape[1])
    dsteps = rmi_lookup._search_steps(d)
    look = {"S": S, "batch": BIG_BATCH, "absent": int(absent.size), "edges": int(edges.size),
            "steps": steps, "dsteps": dsteps, "delta_padded": d}
    look["ms"] = time_ms(lambda: rmi_sharded_merged_lookup_cuda(*args_l, **kw))
    look["plain_ms"] = time_ms(lambda: ref.rmi_sharded_merged_lookup_reference(*args_l, **kw),
                               reps=3, warmup=1)
    look["max_abs_err"] = lookup_mismatch(rmi_sharded_merged_lookup_cuda(*args_l, **kw),
                                          ref.rmi_sharded_merged_lookup_reference(*args_l, **kw))
    check(look["max_abs_err"] == 0,
          f"phase 4: sharded lookup kernel != plain version ({look['max_abs_err']})")
    look["searchsorted_ms"] = time_ms(lambda: torch.searchsorted(plan.keys, qs))
    look["bound_ms"] = sharded_bound_bytes(BIG_BATCH, S, steps, dsteps, S * d,
                                           int(plan.stage0.numel()) * 4) / HBM_BYTES_PER_S * 1e3
    raw_q = base[rng.choice(base.size, BIG_BATCH)]
    for batch in (65_536, BIG_BATCH):
        svc.lookup_batch(raw_q[:batch])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            svc.lookup_batch(raw_q[:batch])
        torch.cuda.synchronize()
        look[f"lookup_batch_qps_{batch}"] = batch * 10 / (time.perf_counter() - t0)
    # where lookup_batch's host time goes (cProfile slows it; the rates above are without it)
    look["host_profile"] = host_profile(lambda: svc.lookup_batch(raw_q), reps=5)

    plane, state0 = staged["plane"], staged["state"]
    slabs = (plane.base, plane.bvals, plane.live_prefix, plane.ins, plane.ivals, plane.ins_rank)
    page = SCAN_PAGE_SIZES[0]
    scans = []
    for w in BIG_SCANS:
        lo, hi = ranges[f"r{w}"]
        qn = plane.normalize(np.array([lo, hi]))
        r0 = int(state0.rank_f32(qn[0]))
        rows = max(int(state0.rank_f32(qn[1])), r0) - r0
        pages = scan_page_bound([plane.base_np[s, : r["n"]] for s, r in enumerate(plane.rows)],
                                plane.ins_total, *qn, page)
        owners = ops.sharded_scan_owners(torch.as_tensor(qn, device=dev), plane.base,
                                         plane.live_prefix, plane.ins)
        skw = dict(page_size=page, max_pages=pages)
        row = {"rows": rows, "page_size": page, "lanes": S * pages * page}
        row["ms"] = time_ms(lambda: rmi_sharded_scan_page_cuda(*slabs, *owners, **skw))
        row["plain_ms"] = time_ms(
            lambda: ref.rmi_sharded_scan_page_reference(*slabs, *owners, **skw),
            reps=2, warmup=1)
        row["max_abs_err"] = scan_mismatch(
            rmi_sharded_scan_page_cuda(*slabs, *owners, **skw),
            ref.rmi_sharded_scan_page_reference(*slabs, *owners, **skw))
        check(row["max_abs_err"] == 0.0,
              f"phase 4: sharded scan kernel != plain version at {w} rows")
        delta_bytes = 12 * int(plane.ins.numel()) + 12 * S
        row["bound_ms"] = scan_bound_bytes(rows, S * pages * page, index_bytes=4,
                                           delta_bytes=delta_bytes) / HBM_BYTES_PER_S * 1e3
        svc.scan_batch(lo, hi, page)   # the service as it stands (compacted), warm
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(5):
            out = svc.scan_batch(lo, hi, page)
        torch.cuda.synchronize()
        row["scan_batch_rows_per_s"] = int(out[2].sum()) * 5 / (time.perf_counter() - t1)
        scans.append(row)
    emit({"phase": "sharded_times", "card": card, "n": int(base.size), "lookup": look,
          "scans": scans,
          "ptxas": ptxas_resources(rmi_lookup, ("rmi_sharded_lookup_kernel",))})
    return {"launches": launches, "lookup": look, "scans": scans,
            "scan_max_abs_err": max([summary["scan_max_abs_err"]]
                                    + [r["max_abs_err"] for r in scans])}


def run_rebalance(args, rng, dev, n=2_000_000):
    """A 2M-key sharded service (K = 4): staged writes, a rebalance to
    three shards, a flush, and every read and scan check after each."""
    from repro_torch.data import gen_maps
    from repro_torch.index_service import ServiceConfig, ShardedIndexService

    base = gen_maps(n, seed=args.seed + 7)
    svc = ShardedIndexService(
        base, ServiceConfig(num_shards=4, strategy="sharded_fused", delta_capacity=1 << 16,
                            bloom_fpr=0.02),
        vals=np.zeros(base.size, np.int64), device=dev)
    windows = []
    guard = start_failover_guard()
    _, _, summary = drive_sharded(svc, base, rng, dev, "rebalance", 20_000, 100_000, 200_000,
                                  windows, rebalance_to=3)
    counts = {k: sum(c[k] for path, c in windows if k in SHARDED_PATHS[path])
              for ks in SHARDED_PATHS.values() for k in ks}
    check(all(v > 0 for v in counts.values()), f"rebalance path: a kernel never launched {counts}")
    check(all(sh._mgr.current().bloom is not None for sh in svc.shards),
          "rebalance path: a shard without its Bloom screen")
    screen = svc.stats_summary()["contains"]
    check(screen["bloom_screened"] > 0, "rebalance path: the per-shard screens screened nothing")
    failover_guard("rebalance", guard)
    t0 = time.perf_counter()
    torn = run_torn_checkpoint(svc, rng, dev)
    emit({"phase": "checkpoint", "service": "rebalance", "torn": torn,
          "seconds": time.perf_counter() - t0})
    return {"n": int(base.size), "launches": counts, "bloom_screened": screen["bloom_screened"],
            "bloom_fp": screen["bloom_fp"], **summary}


# ---------------------------------------------------------------------------
# §4 / §5 probes: both kernels against their plain versions (phase 2), the
# hash-model index at scale, and the Bloom kernel on the service's filter
# ---------------------------------------------------------------------------

PROBE_DISTS = ("gen_maps", "gen_lognormal", "gen_weblogs")
SLOT_RATIOS = (0.75, 1.0, 1.25)
# the last filter has num_bits above 2**31, so h1 + i*h2 wraps at 2**32
BLOOM_SHAPES = ((1 << 14, 3), (1 << 16, 7), (1 << 18, 10), ((1 << 31) + 96, 7))
N_ABSENT_F32 = 4_000_000       # float32-absent queries of the hash index
ORACLE_KEYS = 20_000_000       # folded keys of the kernel-family oracle filter
HASH_BATCH = 1 << 27           # stored keys per hash_probe_op call
PROBE_BATCHES = (1 << 20, 1 << 24)  # queries of the timed probe launches
FPR_BAND = (0.0085, 0.0115)    # contains' false-positive rate on absent keys at fpr 0.01
ORACLE_BAND = (0.95, 1.05)     # measured / (1 - e^{-kn/m})^k for the oracle filter


def f32_twins(ks, stored):
    """Raw keys absent from the key set whose float32 normalization
    equals a stored key's: the next float64 above each of the ``stored``
    keys, where that collides."""
    up = np.nextafter(stored, np.inf)
    return _absent(ks.raw, up[ks.normalize(up) == ks.normalize(stored)])


def f32_absent(ks, cand):
    """The raw candidates whose float32 normalization no stored key has."""
    cn = ks.normalize(cand)
    i = np.clip(np.searchsorted(ks.norm, cn), 0, ks.n - 1)
    return cand[ks.norm[i] != cn]


def f32_absent_queries(ks, rng, count):
    """``count`` raw keys absent in the float32 frame: uniform keys over
    the span, then (where stored keys fill the float32 grid: its upper
    half holds 2**23 values, fewer than the keys stored there at 195M)
    float32 values drawn uniformly over their bit patterns in [0, 1),
    mapped back to raw keys."""
    out = [f32_absent(ks, rng.uniform(ks.raw[0], ks.raw[-1], count))]
    while sum(a.size for a in out) < count:
        f = rng.integers(0, 0x3F800000, count, dtype=np.uint32).view(np.float32)
        out.append(f32_absent(ks, ks.lo + f.astype(np.float64) * (ks.hi - ks.lo)))
    return np.concatenate(out)[:count]


def hash_query_pool(raw, ks, rng, n):
    """Stored, absent (in the float32 frame), float32-equal, NaN,
    infinite and out-of-span raw queries for the hash probe."""
    span = raw[-1] - raw[0]
    return {
        "stored": raw[rng.choice(raw.size, n)],
        "absent": f32_absent(ks, rng.uniform(raw[0], raw[-1], n)),
        "f32_equal": f32_twins(ks, raw[rng.choice(raw.size, n)]),
        "edges": np.array([np.nan, np.inf, -np.inf, raw[0] - span, raw[-1] + span,
                           raw[0] - 1e-9 * span, raw[-1] + 1e-9 * span, -1e300, 1e300]),
    }


def hash_kwargs(hm, idx):
    return dict(n=idx.n, num_leaves=idx.num_leaves, num_slots=hm.num_slots,
                trips=max(0, hm.max_chain - 1))


def compare_hash_kernel(label, hm, idx, ks, rng, device, record):
    """`hash_probe_cuda` against its plain twin on the card, bit for bit,
    over every query set and batches of 1, 777 and BIG_BATCH on the
    record views `ops.hash_probe_tensors` hands out (read in place), and
    on the stored, edge and largest sets also on separate arrays (packed
    per call); the host twin gives the card's answers too.  Returns the
    mismatch count."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.hash_probe import hash_probe_cuda

    tabs = ops.hash_probe_tensors(hm, idx, ks, device)
    layouts = {"record": tabs, "separate": tuple(a.contiguous() for a in tabs)}
    kw = hash_kwargs(hm, idx)
    sets = hash_query_pool(ks.raw, ks, rng, 20_000)
    pool = np.concatenate(list(sets.values()))
    sets.update(batch_1=pool[:1], batch_777=rng.choice(pool, 777),
                **{f"batch_{BIG_BATCH}": rng.choice(pool, BIG_BATCH)})
    worst = 0
    for name, qs in sets.items():
        q = torch.as_tensor(ks.normalize(qs), device=device)
        for layout, lt in layouts.items():
            if layout != "record" and name not in ("stored", "edges", f"batch_{BIG_BATCH}"):
                continue
            got = hash_probe_cuda(q, *lt, **kw)
            err = int((got != ref.hash_probe_reference(q, *lt, **kw)).sum())
            worst = max(worst, err)
            record.append({"map": label, "queries": name, "tables": layout,
                           "batch": int(q.numel()), "mismatches": err, "found": int(got.sum())})
            check(err == 0, f"hash kernel != plain: {label}/{name}/{layout}")
            if name in ("stored", "f32_equal"):
                check(bool(got.all()), f"{label}: a {name} key not found")
            if name == "absent":
                check(not bool(got.any()), f"{label}: an absent key found")
    q = ks.normalize(sets["batch_777"])
    host = ref.hash_probe_reference(torch.as_tensor(q), *(a.cpu() for a in tabs), **kw)
    check(torch.equal(hash_probe_cuda(torch.as_tensor(q, device=device), *tabs, **kw).cpu(),
                      host), f"{label}: card != host plain version")
    return worst


def family_words(keys_u32, num_bits, k):
    """An oracle filter in NumPy: every probe bit of ``keys_u32`` set
    under the kernels' own double hashing (uint32 `mix32`, ``h1 + i*h2``
    wrapping at 2**32)."""
    def mix32(h, seed):
        h = h ^ np.uint32(seed * 0x9E3779B9 & 0xFFFFFFFF)
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x7FEB352D)
        h ^= h >> np.uint32(15)
        h *= np.uint32(0x846CA68B)
        h ^= h >> np.uint32(16)
        return h

    words = np.zeros(-(-num_bits // 32), np.uint32)
    h = np.asarray(keys_u32, np.uint32)
    h1, h2 = mix32(h, 1), mix32(h, 2) | np.uint32(1)
    for i in range(k):
        bit = (h1 + np.uint32(i) * h2) % np.uint32(num_bits)
        np.bitwise_or.at(words, (bit >> np.uint32(5)).astype(np.int64),
                         np.uint32(1) << (bit & np.uint32(31)))
    return words


def u32_tensor(a, device):
    """uint32 values as an int32 tensor of their bit patterns."""
    import torch
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32)).to(device)


def compare_bloom_kernel(rng, device, record):
    """`bloom_probe_cuda` against its plain twin on the card, bit for
    bit, on an oracle filter of each shape: members, random uint32 keys,
    0 and 0xFFFFFFFF, batches of 1, 3, 5, 777, BIG_BATCH and BIG_BATCH +
    3 (the kernel takes four queries a thread: ragged tails), and a view
    one element in (not 16-byte aligned: keys and answers one by one).
    Every member must be found.  Returns the mismatch count."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.bloom_probe import bloom_probe_cuda

    worst = 0
    for num_bits, k in BLOOM_SHAPES:
        members = rng.integers(0, 1 << 32, min(4_000, num_bits // 16), dtype=np.uint32)
        words = u32_tensor(family_words(members, num_bits, k), device)
        edge = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
        pool = np.concatenate([members, rng.integers(0, 1 << 32, 20_000, dtype=np.uint32),
                               edge])
        sets = {"members": members, "edges": edge, "batch_1": pool[:1],
                "batch_3": rng.choice(pool, 3), "batch_5": rng.choice(pool, 5),
                "batch_777": rng.choice(pool, 777),
                f"batch_{BIG_BATCH}": rng.choice(pool, BIG_BATCH),
                f"batch_{BIG_BATCH + 3}": rng.choice(pool, BIG_BATCH + 3),
                "unaligned_777": rng.choice(pool, 778)}
        for name, qs in sets.items():
            q = u32_tensor(qs, device)
            if name.startswith("unaligned"):
                q = q[1:]
            got = bloom_probe_cuda(q, words, num_bits=num_bits, k=k)
            err = int((got != ref.bloom_probe_reference(q, words, num_bits=num_bits,
                                                        k=k)).sum())
            worst = max(worst, err)
            record.append({"num_bits": num_bits, "k": k, "queries": name,
                           "batch": int(q.numel()), "mismatches": err, "hits": int(got.sum())})
            check(err == 0, f"bloom kernel != plain: {num_bits}/{k}/{name}")
            if name == "members":
                check(bool(got.all()), f"bloom {num_bits}/{k}: a member not found")
    return worst


def compare_probe_kernels(rng, device, record):
    """Phase 2 for the probes: hash maps of three distributions at 50k
    keys and three slot ratios, a map with no overflow, and the Bloom
    shapes.  Returns (hash mismatches, Bloom mismatches)."""
    from repro_torch import data
    from repro_torch.core import build_model_hashmap

    worst = 0
    for dist in PROBE_DISTS:
        raw = getattr(data, dist)(SMALL_N, seed=4)
        for ratio in SLOT_RATIOS:
            hm, idx, ks = build_model_hashmap(raw, int(raw.size * ratio), device=device)
            worst = max(worst, compare_hash_kernel(
                f"{dist}/{ratio}/max_chain{hm.max_chain}", hm, idx, ks, rng, device, record))
    raw = data.gen_maps(400, seed=5)
    hm, idx, ks = build_model_hashmap(raw, 1 << 20, device=device)
    check(hm.max_chain == 1 and hm.ovf_next.tolist() == [-1], "the sparse map overflows")
    worst = max(worst, compare_hash_kernel("maps400/no_overflow", hm, idx, ks, rng, device,
                                           record))
    return worst, compare_bloom_kernel(rng, device, record)


def distinct_sectors(ix, elems=8):
    """Distinct 32-byte sectors that gathering 4-byte elements at ``ix``
    touches (each read once)."""
    import torch
    return int(torch.unique(ix.to(torch.int64) // elems).numel())


def hash_gathers(idx, tabs, q, kw):
    """The leaf, slot and overflow-node indices the hash probe of ``q``
    gathers: its leaf and slot, and the nodes it walks until the key is
    found or its chain ends."""
    import torch
    from repro_torch.core.learned_hash import model_slots
    from repro_torch.core.rmi import leaf_and_pos
    s0, leaf_w, leaf_b, slot_key, slot_next, ovf_key, ovf_next = tabs
    leaf, _ = leaf_and_pos(s0, (), leaf_w, leaf_b, q, n=kw["n"], num_leaves=kw["num_leaves"])
    slot = model_slots(idx, q, kw["num_slots"])
    found = slot_key[slot] == q
    nxt = slot_next[slot]
    walked = []
    for _ in range(kw["trips"]):
        active = ~found & (nxt >= 0)
        safe = torch.clamp(nxt, 0, ovf_key.shape[0] - 1)
        walked.append(safe[active])
        found = found | (active & (ovf_key[safe] == q))
        nxt = torch.where(active, ovf_next[safe], torch.full_like(nxt, -1))
    return leaf, slot, torch.cat(walked) if walked else slot[:0]


def hash_sectors(gathers):
    """Distinct 32-byte sectors the hash probe must read in the layout
    the main path hands it: one 8-byte record a leaf (w, b), slot (key,
    link) or overflow node it gathers or walks, four to a sector (each
    table's sectors counted once).  The bound's yardstick."""
    return sum(distinct_sectors(ix, elems=4) for ix in gathers)


def hash_separate_sectors(gathers):
    """The same gathers' distinct sectors as separate arrays lay them
    out, two sectors a pair: the yardstick of the rows before the
    records, kept beside the bound so those rows stay comparable."""
    return 2 * sum(distinct_sectors(ix) for ix in gathers)


def bloom_sectors(q, words, num_bits, k):
    """Distinct 32-byte sectors of ``words`` the Bloom probe of ``q``
    must read: the words of its probes up to and including the first
    clear bit (k for a hit)."""
    import torch
    from repro_torch.kernels.ref import mix32
    h = q.to(torch.int64) & 0xFFFFFFFF
    h1, h2 = mix32(h, 1), mix32(h, 2) | 1
    alive = torch.ones(q.shape, dtype=torch.bool, device=q.device)
    read = []
    for i in range(k):
        bit = ((h1 + i * h2) & 0xFFFFFFFF) % num_bits
        read.append((bit >> 5)[alive])
        alive &= ((words[bit >> 5] >> (bit & 31).to(torch.int32)) & 1) != 0
    return distinct_sectors(torch.cat(read))


def probe_bound_ms(batch, sectors):
    """Each query's key read (4 B) and bool written (1 B), plus 32 B per
    distinct sector gathered, over the card's memory rate."""
    return (batch * 5 + 32 * sectors) / HBM_BYTES_PER_S * 1e3


def mean_walk(hm):
    """Mean overflow nodes a stored key's probe walks (its place in its
    chain, less one): the build's chain lengths."""
    starts = np.sort(hm.slot_next[hm.slot_next >= 0])
    if starts.size == 0:
        return 0.0
    lens = np.diff(np.append(starts, hm.ovf_next.size))
    return float((lens * (lens + 1) // 2).sum() / (hm.num_slots - hm.num_empty + lens.sum()))


def check_screen(svc, oracle, rng, tag, n=1_000_000):
    """The single service's Bloom screen: no live key is screened out
    (base keys, which reach the filter, and staged inserts), absent keys
    are screened, and ``bloom_fp`` over the absent keys that pass the
    screen is a rate within FPR_BAND (the filter's target is 0.01)."""
    stats = svc.stats
    s0, f0 = int(stats["bloom_screened"]), int(stats["bloom_fp"])
    base_live = oracle.base[rng.choice(oracle.base.size, n)]
    base_live = base_live[oracle.live(base_live)]
    check(bool(svc.contains(base_live).all()), f"{tag}: a live key screened out")
    if oracle.ins.size:
        check(bool(svc.contains(oracle.ins).all()), f"{tag}: a staged insert screened out")
    check(int(stats["bloom_screened"]) == s0, f"{tag}: the screen dropped live keys")
    absent = _absent(oracle.base, rng.uniform(oracle.base[0], oracle.base[-1], n))
    if oracle.ins.size:
        absent = _absent(oracle.ins, absent)
    check(not bool(svc.contains(absent).any()), f"{tag}: an absent key reported present")
    screened = int(stats["bloom_screened"]) - s0
    fp = int(stats["bloom_fp"]) - f0
    check(screened > 0 and screened + fp == absent.size,
          f"{tag}: absent keys neither screened nor counted")
    rate = fp / absent.size
    check(FPR_BAND[0] <= rate <= FPR_BAND[1], f"{tag}: false-positive rate {rate} off the band")
    bloom = svc._mgr.current().bloom
    return {"live_checked": int(base_live.size + oracle.ins.size), "absent": int(absent.size),
            "bloom_screened": screened, "bloom_fp": fp, "fp_rate": rate,
            "num_bits": bloom.num_bits, "num_hashes": bloom.num_hashes,
            "bloom_mb": bloom.size_bytes / 1e6}


def bloom_on_service_filter(snap, rng, device, batch=BIG_BATCH):
    """The Bloom kernel on the service's own filter through
    `ops.bloom_probe_op`: the float32 bit patterns of stored and absent
    keys.  Returns the queries, the kernel's answers, and how many of
    the stored keys it reports absent (the kernel hashes a uint32 fold
    with `mix32`, the filter was built with `_mix64` of the float64 key:
    ROADMAP queue C entry 11)."""
    from repro_torch.kernels import ops
    raw = snap.keys.raw
    stored = raw[rng.choice(raw.size, batch // 2)]
    absent = _absent(raw, rng.uniform(raw[0], raw[-1], batch - stored.size))
    q = u32_tensor(np.concatenate([stored, absent]).astype(np.float32).view(np.uint32), device)
    got = ops.bloom_probe_op(snap.bloom, q)
    return q, got, {"stored": int(stored.size), "absent": int(absent.size),
                    "stored_reported_absent": int((~got[:stored.size]).sum()),
                    "absent_reported_present": int(got[stored.size:].sum())}


def bloom_oracle(rng, device, n=None):
    """The kernel against its own hash family's contract: an oracle
    filter over ``n`` (default ORACLE_KEYS) distinct folded keys at the
    service's sizing (`build_bloom`'s m and k for fpr 0.01); every member
    found, and the false-positive rate on 4M non-members within
    ORACLE_BAND of (1 - e^{-kn/m})^k."""
    from repro_torch.core.bloom import BloomFilter, optimal_bits_per_key, optimal_num_hashes
    from repro_torch.kernels import ops
    n = ORACLE_KEYS if n is None else n
    t0 = time.perf_counter()
    # distinct folded keys without a sort: an odd multiplier permutes the
    # uint32 values, so members and non-members never meet
    mult, add = np.uint64(rng.integers(1 << 20, 1 << 31) * 2 + 1), np.uint64(rng.integers(1 << 32))
    keys = ((np.arange(n + 4_000_000, dtype=np.uint64) * mult + add)
            & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    members, others = keys[:n], keys[n:]
    split = {"keys_s": time.perf_counter() - t0}
    num_bits = (int(math.ceil(optimal_bits_per_key(0.01) * members.size)) + 31) // 32 * 32
    k = optimal_num_hashes(num_bits / members.size)
    t0 = time.perf_counter()
    bf = BloomFilter(num_bits=num_bits, num_hashes=k, words=family_words(members, num_bits, k))
    split["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    found = sum(int(ops.bloom_probe_op(bf, u32_tensor(members[s:s + (1 << 23)], device)).sum())
                for s in range(0, members.size, 1 << 23))
    rate = float(ops.bloom_probe_op(bf, u32_tensor(others, device)).float().mean())
    split["probe_s"] = time.perf_counter() - t0
    check(found == members.size, f"oracle filter: {members.size - found} members not found")
    theory = (1 - math.exp(-k * members.size / num_bits)) ** k
    check(ORACLE_BAND[0] <= rate / theory <= ORACLE_BAND[1],
          f"oracle filter: false-positive rate {rate} against {theory}")
    return {"members": int(members.size), "num_bits": num_bits, "k": k,
            "false_negatives": int(members.size - found), "non_members": int(others.size),
            "fp_rate": rate, "fp_theory": theory, **split}


def fig10(m):
    """The paper's Fig. 10 statistics of a hash map."""
    return {"empty_pct": 100.0 * m.num_empty / m.num_slots, "max_chain": m.max_chain,
            "overflow": int(m.ovf_key.size) if m.max_chain > 1 else 0,
            "conflicts": m.num_conflicts, "mean_walk": mean_walk(m)}


def run_hash_index(args, base, rng, dev, card):
    """The paper's §4 at full size: `build_model_hashmap` over ``base``
    with S = n slots (n/4 leaves, slots computed on the card); every
    stored key probed through `ops.hash_probe_op` on the kernel, 4M
    float32-absent queries, the kernel against its twin on 1<<20 mixed
    queries, the kernel's times; then the random-hash map through the
    plain `compile_hash_lookup`, and Fig. 10's statistics of both.  The
    random-hash map holds every RANDOM_HASH_STRIDE-th key in as many
    slots (a cut of depth: the whole run must fit its time limit, and a
    random hash's statistics at S = n do not depend on n)."""
    import torch
    from repro_torch.core import build_model_hashmap, build_random_hashmap, compile_hash_lookup
    from repro_torch.core.learned_hash import random_hash_u64
    from repro_torch.kernels import hash_probe, ops, ref
    from repro_torch.kernels.hash_probe import hash_probe_cuda

    t0 = time.perf_counter()
    hm, idx, ks = build_model_hashmap(base, base.size, device=dev)
    build_s = time.perf_counter() - t0
    n = ks.n
    model_stats = fig10(hm)
    emit({"phase": "hash_build", "n": n, "slots": hm.num_slots, "num_leaves": idx.num_leaves,
          "build_s": build_s, **model_stats})

    # -- the main path: counts zeroed just before, read just after -------
    guard = start_failover_guard()
    reset_counts()
    t0 = time.perf_counter()
    found = sum(int(ops.hash_probe_op(hm, idx, ks, ks.raw[s:s + HASH_BATCH], device=dev).sum())
                for s in range(0, n, HASH_BATCH))
    check(found == n, f"hash index: {n - found} stored keys not found")
    absent = f32_absent_queries(ks, rng, N_ABSENT_F32)
    absent_found = int(ops.hash_probe_op(hm, idx, ks, absent, device=dev).sum())
    check(absent_found == 0, f"hash index: {absent_found} float32-absent keys found")
    launches = read_counts()["hash_probe_cuda"]
    main_s = time.perf_counter() - t0
    check(launches > 0, "hash_probe_cuda never launched on the main path")
    failover_guard("hash_index", guard)

    # the kernel against its twin, then its times
    tabs = ops.hash_probe_tensors(hm, idx, ks, dev)
    kw = hash_kwargs(hm, idx)
    pool = np.concatenate(list(hash_query_pool(ks.raw, ks, rng, BIG_BATCH // 2).values()))
    q = torch.as_tensor(ks.normalize(rng.choice(pool, BIG_BATCH)), device=dev)
    mism = int((hash_probe_cuda(q, *tabs, **kw) != ref.hash_probe_reference(q, *tabs, **kw))
               .sum())
    check(mism == 0, f"hash index: kernel != plain on {mism} of {BIG_BATCH} queries")
    times = []
    for batch in PROBE_BATCHES:
        qt = torch.as_tensor(ks.norm[rng.choice(n, batch)], device=dev)
        gathers = hash_gathers(idx, tabs, qt, kw)
        row = {"batch": batch,
               "ms": time_ms(lambda: hash_probe_cuda(qt, *tabs, **kw)),
               "plain_ms": time_ms(lambda: ref.hash_probe_reference(qt, *tabs, **kw),
                                   reps=3, warmup=1),
               "sectors": hash_sectors(gathers),
               "separate_arrays_sectors": hash_separate_sectors(gathers)}
        row["bound_ms"] = probe_bound_ms(batch, row["sectors"])
        row["separate_arrays_bound_ms"] = probe_bound_ms(batch, row["separate_arrays_sectors"])
        row["max_abs_err"] = int((hash_probe_cuda(qt, *tabs, **kw)
                                  != ref.hash_probe_reference(qt, *tabs, **kw)).sum())
        check(row["max_abs_err"] == 0, f"hash index: kernel != plain at {batch} stored keys")
        times.append(row)
    del tabs, q, qt, hm, idx
    gc.collect()
    torch.cuda.empty_cache()

    # the random-hash baseline through the plain chain walk
    rkeys = ks.raw[::RANDOM_HASH_STRIDE].copy()
    rn = int(rkeys.size)
    t0 = time.perf_counter()
    rnd = build_random_hashmap(rkeys, rn)
    random_build_s = time.perf_counter() - t0
    random_stats = {"n": rn, **fig10(rnd)}
    lookup = compile_hash_lookup(rnd, lambda rq: torch.as_tensor(
        random_hash_u64(rq.cpu().numpy().view(np.uint64), rn), device=dev), device=dev)
    sample = rkeys[rng.choice(rn, N_ABSENT_F32)]
    check(bool(lookup(torch.as_tensor(sample, device=dev)).all()),
          "random hash map: a stored key not found")
    miss = _absent(rkeys, rng.uniform(rkeys[0], rkeys[-1], N_ABSENT_F32))
    check(not bool(lookup(torch.as_tensor(miss, device=dev)).any()),
          "random hash map: an absent key found")
    del rnd, lookup, rkeys
    gc.collect()
    torch.cuda.empty_cache()
    out = {"n": n, "build_s": build_s, "random_build_s": random_build_s,
           "launches": launches, "main_path_s": main_s, "stored_found": found,
           "f32_absent": int(absent.size), "f32_absent_found": absent_found,
           "mismatches": max([mism] + [r["max_abs_err"] for r in times]),
           "model": model_stats, "random": random_stats, "times": times,
           "ptxas": ptxas_resources(hash_probe, ("hash_probe_kernel",))}
    emit({"phase": "hash_index", "card": card, **out})
    return out


# ---------------------------------------------------------------------------
# the LM substrate: flash attention, prefill, decode and serving (yi-6b)
# ---------------------------------------------------------------------------

LM_ARCH = "yi-6b"
LM_BATCH, LM_SEQ = 2, 4096      # prefill: two prompts at yi-6b's trained context
LM_CHECK_SEQ = 256              # prefill against sequential decode
LM_F32_LAYERS = 4               # depth of the float32 prefill/decode check
ATTN_SHAPES = ((1, 4, 2, 128, 32), (2, 8, 8, 128, 64), (1, 8, 1, 256, 64),
               (2, 4, 4, 64, 128),  # the reference's test shapes (B, Hq, Hkv, S, D)
               (2, 4, 2, 48, 128), (1, 8, 2, 1000, 64),  # ragged tails
               (1, 8, 2, 1, 64),
               (1, 32, 4, 1000, 128))  # yi-6b's heads, GQA group 8, ragged tail
# cross-attention (full mask, Sq != Sk): (B, Hq, Hkv, Sq, Sk, D)
ATTN_CROSS_SHAPES = ((2, 16, 16, 256, 3072, 64),   # seamless's, over 3,072 source frames
                     (2, 4, 2, 77, 300, 64),       # ragged in both lengths
                     (1, 8, 2, 1000, 130, 64))     # Sq > Sk
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py:83
# beside ATTN_TOL, which is as wide as a typical output element once Sk
# runs to thousands: the output's L2 error relative to the twin's (one
# bf16 rounding is 2^-9), and the log-sum-exp within ATTN_LSE_TOL
ATTN_REL_L2 = 1e-2
# layer 0 at the prefill shape: one bf16 rounding of the float32 twin
# (2^-8 relative, with room for float32 summation order), and an L2 error
# relative to the bf16 twin
LAYER0_RTOL, LAYER0_ATOL, LAYER0_REL_L2 = 5e-3, 1e-5, 1e-2
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core rate
# B9's bf16 design, and the time at the prefill shape of the CUDA-core
# design it replaced (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6)
ATTN_DESIGN = "wgmma"
ATTN_EARLIER_MS = 22.09
# lm_train (a): the backward kernel against its twin (max |Δ| <= tol x max
# |twin|; bf16 also a relative L2 error), the forward's log-sum-exp
ATTN_BWD_SEQS = (1, 77, 1000)
ATTN_BWD_DIMS = (32, 64, 128)
ATTN_BWD_GROUPS = (1, 4, 8)
ATTN_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
ATTN_BWD_REL_L2 = 1e-2
# the bf16 design's own bound: with P and dS split into bf16 halves every
# gradient stays within ~1e-4 relative L2 of the twin (a single bf16 P
# and dS lands at ~2.6e-3; tests/test_torch_attention.py)
ATTN_BWD_SPLIT_REL_L2 = 1e-3
# B9's backward at the training shape before its tensor-core design (the
# CUDA-core kernel; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6)
ATTN_BWD_EARLIER_MS = 16.16
ATTN_LSE_TOL = 1e-5
TRAIN_ATTN_SHAPE = (1, 32, 4, 4096, 128)   # (B, Hq, Hkv, S, D) of one training microbatch
# lm_train (a): the backward at cross-attention shapes (full mask, Sq != Sk),
# (B, Hq, Hkv, Sq, Sk, D), both dtypes; the first is timed
ATTN_BWD_CROSS_SHAPES = ((2, 16, 16, 256, 3072, 64),  # seamless's, over 3,072 source frames
                         (1, 4, 2, 77, 1000, 64),     # ragged in both lengths
                         (2, 8, 2, 1000, 130, 128))   # GQA, Sq > Sk
SERVE_ARGV = ["--arch", LM_ARCH, "--requests", "16", "--max-new", "32",
              "--batch-slots", "8", "--max-len", "512"]


def attention_bound(b, hq, hkv, s, d, elem_bytes, causal=True, sk=None):
    """The least time for the attention of S queries over Sk keys (Sk =
    S unless given; causal needs Sk = S): max(operations / bf16 peak,
    bytes / memory rate), with 4·B·Hq·S·Sk·D operations for the two
    products ((S+1)/(2S) of them under the causal mask), q read and o
    written over S rows, k and v read over Sk."""
    sk = s if sk is None else sk
    flops = 4 * b * hq * s * sk * d * ((s + 1) / (2 * s) if causal else 1.0)
    moved = elem_bytes * d * b * (2 * hq * s + 2 * hkv * sk)
    flops_ms = flops / BF16_FLOPS_PER_S * 1e3
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    return {"flops": flops, "bytes": moved, "bound_ms": max(flops_ms, bytes_ms),
            "bound_by": "operations" if flops_ms >= bytes_ms else "bytes"}


def compare_attention_kernel(dev, seed, record):
    """`flash_attention_cuda` against `ref.mha_reference_lse` on the card
    at the reference's test shapes and ragged ones, both dtypes, causal
    and not, and at the cross-attention shapes (full mask, Sq != Sk): the
    output within ATTN_TOL and ATTN_REL_L2, the log-sum-exp within
    ATTN_LSE_TOL (a key tile left out, or a zero-filled key past Sk left
    unmasked, moves it by ~1e-2), and the output the same bits as the
    call that stores no log-sum-exp (the main path's); returns the
    largest |difference|."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    g = torch.Generator(device=dev).manual_seed(seed)
    worst = 0.0
    cases = [((b, hq, hkv, s, s, d), (True, False)) for b, hq, hkv, s, d in ATTN_SHAPES]
    cases += [(shape, (False,)) for shape in ATTN_CROSS_SHAPES]
    for (b, hq, hkv, sq, sk, d), masks in cases:
        shape = [b, hq, hkv, sq, d] if sq == sk else [b, hq, hkv, sq, sk, d]
        for name, tol in ATTN_TOL.items():
            dt = getattr(torch, name)
            q = torch.randn((b, hq, sq, d), generator=g, device=dev).to(dt)
            k, v = (torch.randn((b, hkv, sk, d), generator=g, device=dev).to(dt)
                    for _ in range(2))
            for causal in masks:
                got, lse = flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
                plain_call = flash_attention_cuda(q, k, v, causal=causal)
                want, want_lse = ref.mha_reference_lse(q, k, v, causal=causal)
                torch.cuda.synchronize()
                check(got.dtype == dt and got.shape == q.shape,
                      f"attention {shape} {name}: wrong output")
                row = {"shape": shape, "dtype": name, "causal": causal,
                       "max_abs_err": float((got.float() - want.float()).abs().max()),
                       "rel_l2": _rel_l2(got.float(), want.float()),
                       "lse_max_abs_err": float((lse - want_lse).abs().max()),
                       "out_bits_equal": bool(torch.equal(got, plain_call))}
                row["within_tol"] = (
                    row["out_bits_equal"]
                    and bool(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol))
                    and row["rel_l2"] <= ATTN_REL_L2
                    and bool(torch.allclose(lse, want_lse, atol=ATTN_LSE_TOL,
                                            rtol=ATTN_LSE_TOL)))
                record.append(row)
                check(row["within_tol"], f"attention {shape} {name} causal={causal}: {row} "
                                         f"over tol {tol}, {ATTN_REL_L2}, {ATTN_LSE_TOL}")
                worst = max(worst, row["max_abs_err"])
    return worst


def ptxas_entries(log_path):
    """Registers and spills of every entry function in an ``-Xptxas -v``
    report, by mangled name (one entry a template instance)."""
    out, cur = {}, None
    for ln in (log_path.read_text().splitlines() if log_path.exists() else []):
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and cur:
            out.setdefault(cur, {}).update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur:
            out.setdefault(cur, {})["registers"] = int(m[1])
    return out


def _bwd_instance(mangled):
    """`attention_dkdv_bf16_kernel<128>`, `attention_group_sum` ... of a
    mangled entry name: the name after its length, up to the nested
    name's end or its int template argument."""
    m = re.search(r"\d(attention_[a-z0-9_]+)(?:ILi(\d+)E)?", mangled)
    if not m:
        return mangled
    return f"{m[1]}<{m[2]}>" if m[2] else m[1]


def attention_ptxas():
    """ptxas's report on the two attention libraries: every instance's
    registers and spills (``backward``: the gradient's, by instance), the
    bf16 D = 128 forward's (168 registers, no spills, before its
    log-sum-exp output) and the bf16 D = 128 backward kernels'."""
    from repro_torch.kernels import flash_attention as fa, nvcc
    entries = {}
    for src in (fa.SOURCE, fa.BWD_SOURCE):
        entries.update(ptxas_entries(nvcc.library_path(src, fa.FLAGS).with_suffix(".log")))
    fwd = next((v for k, v in entries.items()
                if "flash_attention_bf16_kernelILi128E" in k), None)
    backward = {_bwd_instance(k): v for k, v in entries.items() if "attention_bwd_cu" in k}
    bwd = {k: v for k, v in backward.items() if "bf16_kernel<128>" in k}
    return {"entries": entries, "backward": backward, "bf16_d128_forward": fwd,
            "bf16_d128_backward": bwd}


def attention_bwd_bound(b, hq, hkv, s, d, elem_bytes, causal=True, sk=None):
    """The least time for the attention gradient of S queries over Sk
    keys (Sk = S unless given): its operations, 2.5x the forward's (five
    products of the forward's two sizes), over the bf16 peak, against its
    bytes (q, o, dO and lse read once over S rows, k and v over Sk; dq
    written over S rows, dk and dv over Sk) over the memory rate."""
    sk = s if sk is None else sk
    fwd = attention_bound(b, hq, hkv, s, d, elem_bytes, causal, sk=sk)
    flops = 2.5 * fwd["flops"]
    moved = elem_bytes * d * b * (4 * hq * s + 4 * hkv * sk) + 4 * b * hq * s
    flops_ms = flops / BF16_FLOPS_PER_S * 1e3
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    return {"flops": flops, "bytes": moved, "bound_ms": max(flops_ms, bytes_ms),
            "bound_by": "operations" if flops_ms >= bytes_ms else "bytes"}


def _bwd_errors(got, want, s, name):
    """Each gradient's max |kernel - twin| against tol x max |twin| (and,
    for bf16, its relative L2 error, against ATTN_BWD_REL_L2 and the
    split design's ATTN_BWD_SPLIT_REL_L2).  At S = 1 dq and dk are zero by
    construction (one key: the scores' gradient vanishes) and both sides
    hold only rounding noise, so they are held against the scale of dv."""
    tol = ATTN_BWD_TOL[name]
    out = {}
    for tag, g, w in zip(("dq", "dk", "dv"), got, want):
        ref_t = want[2] if (s == 1 and tag != "dv") else w
        g, w, ref_t = g.float(), w.float(), ref_t.float()
        err = float((g - w).abs().max())
        scale = float(ref_t.abs().max())
        row = {"max_abs_err": err, "max_abs_twin": scale, "ok": err <= tol * scale}
        if name == "bfloat16":
            row["rel_l2"] = float((g - w).norm() / max(float(ref_t.norm()), 1e-30))
            row["split_ok"] = row["rel_l2"] <= ATTN_BWD_SPLIT_REL_L2
            row["ok"] = row["ok"] and row["rel_l2"] <= ATTN_BWD_REL_L2 and row["split_ok"]
        out[tag] = row
    return out


def compare_attention_backward(dev, seed, record):
    """(a) of `lm_train`: the backward kernel against
    `ref.mha_backward_reference` on the card (float32 and bf16 x D 32 /
    64 / 128 x causal and full x S 1 / 77 / 1000 x GQA groups 1 / 4 / 8,
    plus the training shape in bf16, and `ATTN_BWD_CROSS_SHAPES`, full
    mask at Sq != Sk, in both dtypes), two launches bit-identical; the
    forward with ``return_lse=True`` bit-identical to the inference call
    and its log-sum-exp against `ref.mha_reference_lse`.  Returns the
    largest error over tol x scale seen (<= 1 everywhere passes)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
    g = torch.Generator(device=dev).manual_seed(seed)
    cases = [(1, 2 * grp, 2, s, s, d, name, causal)
             for s in ATTN_BWD_SEQS for d in ATTN_BWD_DIMS for grp in ATTN_BWD_GROUPS
             for name in ATTN_BWD_TOL for causal in (True, False)]
    b, hq, hkv, s, d = TRAIN_ATTN_SHAPE
    cases.append((b, hq, hkv, s, s, d, "bfloat16", True))
    cases += [(*shape, name, False) for shape in ATTN_BWD_CROSS_SHAPES for name in ATTN_BWD_TOL]
    worst = 0.0
    for b, hq, hkv, s, sk, d, name, causal in cases:
        dt = getattr(torch, name)
        q, k, v = (torch.randn((b, h, n, d), generator=g, device=dev).to(dt)
                   for h, n in ((hq, s), (hkv, sk), (hkv, sk)))
        with torch.no_grad():
            plain_out = flash_attention_cuda(q, k, v, causal=causal)
            out, lse = flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
            _, lse_twin = ref.mha_reference_lse(q, k, v, causal=causal)
            d_out = torch.randn(out.shape, generator=g, device=dev).to(dt)
            got = flash_attention_bwd_cuda(q, k, v, out, lse, d_out, causal=causal)
            again = flash_attention_bwd_cuda(q, k, v, out, lse, d_out, causal=causal)
            want = ref.mha_backward_reference(q, k, v, out, lse, d_out, causal=causal)
        torch.cuda.synchronize()
        row = {"shape": [b, hq, hkv, s, d] if sk == s else [b, hq, hkv, s, sk, d],
               "dtype": name, "causal": causal,
               "out_bits_equal": bool(torch.equal(out, plain_out)),
               "lse_max_abs_err": float((lse - lse_twin).abs().max()),
               "repeat_bits_equal": all(torch.equal(x, y) for x, y in zip(got, again)),
               **_bwd_errors(got, want, s, name)}
        row["lse_ok"] = bool(torch.allclose(lse, lse_twin, atol=ATTN_LSE_TOL, rtol=ATTN_LSE_TOL))
        row["within_tol"] = (row["out_bits_equal"] and row["lse_ok"] and row["repeat_bits_equal"]
                             and all(row[t]["ok"] for t in ("dq", "dk", "dv")))
        record.append(row)
        check(row["within_tol"], f"attention backward {b, hq, hkv, s, sk, d} {name} "
                                 f"causal={causal}: {row}")
        worst = max([worst] + [row[t]["max_abs_err"] / max(row[t]["max_abs_twin"], 1e-30)
                               / ATTN_BWD_TOL[name] for t in ("dq", "dk", "dv")])
        del q, k, v, out, lse, lse_twin, d_out, got, again, want, plain_out
    torch.cuda.empty_cache()
    return worst


def time_attention_backward(dev, seed):
    """The backward kernel, its twin and SDPA's backward (timed only,
    never called by the port: autograd.grad through
    `scaled_dot_product_attention(..., enable_gqa=True)` less its forward)
    at the training shape, and the forward kernel with and without its
    log-sum-exp there; beside the bound, the bf16 design's floor (ten
    products where the bound counts five) and the CUDA-core kernel's
    time it replaced.  Under ``cross`` the same three at seamless's cross
    shape (`ATTN_BWD_CROSS_SHAPES[0]`) beside its bound."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
    b, hq, hkv, s, d = TRAIN_ATTN_SHAPE
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((b, h, s, d), generator=g, device=dev).to(torch.bfloat16)
               for h in (hq, hkv, hkv))
    with torch.no_grad():
        out, lse = flash_attention_cuda(q, k, v, causal=True, return_lse=True)
        d_out = torch.randn(out.shape, generator=g, device=dev).to(torch.bfloat16)
        row = {"shape": [b, hq, hkv, s, d], "dtype": "bfloat16", "causal": True,
               "ms": time_ms(lambda: flash_attention_bwd_cuda(q, k, v, out, lse, d_out),
                             reps=5, warmup=1),
               "plain_ms": time_ms(lambda: ref.mha_backward_reference(
                   q, k, v, out, lse, d_out), reps=2, warmup=1),
               "forward_ms": time_ms(lambda: flash_attention_cuda(q, k, v), reps=10),
               "forward_lse_ms": time_ms(lambda: flash_attention_cuda(
                   q, k, v, return_lse=True), reps=10)}
    library, backend = _sdpa_backward_ms(q, k, v, d_out, True)
    bound = attention_bwd_bound(b, hq, hkv, s, d, 2)
    row.update(library_ms=library, library_backend=backend, **bound,
               design_floor_ms=max(2 * bound["flops"] / BF16_FLOPS_PER_S * 1e3,
                                   bound["bound_ms"]),
               earlier_ms=ATTN_BWD_EARLIER_MS)
    del q, k, v, out, lse, d_out

    # seamless's cross shape (full mask, Sq != Sk)
    b, hq, hkv, sq, sk, d = ATTN_BWD_CROSS_SHAPES[0]
    q = torch.randn((b, hq, sq, d), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((b, hkv, sk, d), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    with torch.no_grad():
        out, lse = flash_attention_cuda(q, k, v, causal=False, return_lse=True)
        d_out = torch.randn(out.shape, generator=g, device=dev).to(torch.bfloat16)
        cross = {"shape": [b, hq, hkv, sq, sk, d], "dtype": "bfloat16", "causal": False,
                 "ms": time_ms(lambda: flash_attention_bwd_cuda(q, k, v, out, lse, d_out,
                                                                causal=False), reps=20),
                 "plain_ms": time_ms(lambda: ref.mha_backward_reference(
                     q, k, v, out, lse, d_out, causal=False), reps=3, warmup=1)}
    cross["library_ms"], cross["library_backend"] = _sdpa_backward_ms(q, k, v, d_out, False)
    cross.update(attention_bwd_bound(b, hq, hkv, sq, d, 2, causal=False, sk=sk))
    row["cross"] = cross
    del q, k, v, out, lse, d_out
    torch.cuda.empty_cache()
    return row


def _sdpa_backward_ms(q, k, v, d_out, causal):
    """SDPA's backward time (timed only, never called by the port): the
    first backend that takes the call, its forward-and-backward less its
    forward; (ms, backend name)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([be]):
                def fwd():
                    return F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                                          enable_gqa=True)

                def fwd_bwd():
                    torch.autograd.grad(fwd(), (qs, ks, vs), d_out)

                both = time_ms(fwd_bwd, reps=5, warmup=1)
                with torch.no_grad():
                    alone = time_ms(fwd, reps=5, warmup=1)
            return both - alone, be.name
        except RuntimeError:
            continue
    return None, None


def _lm_tokens(rng, cfg, b, s, dev):
    import torch
    return torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)), dtype=torch.int32,
                           device=dev)


def _param_count(params):
    from repro_torch.train.optimizer import tree_leaves
    return sum(t.numel() for t in tree_leaves(params))


def _prefill_vs_decode(api, params, tokens):
    """Prefill's last-position logits and those after feeding the same
    tokens one decode_step at a time."""
    import torch
    b, s = tokens.shape
    lp, _ = api.prefill(params, {"tokens": tokens})
    cache = api.init_cache(b, s + 4)
    for t in range(s):
        ld, cache = api.decode(params, cache, tokens[:, t])
    torch.cuda.synchronize()
    return lp.float(), ld.float()


def check_translate(engine, tag):
    """Every live (request, logical page) through the allocator's learned
    page table equals the binary baseline and the pages the allocator
    handed out."""
    kv = engine.kv
    rid = np.array([r for r, pages in kv._per_req.items() for _ in pages], np.int64)
    lp = np.array([i for pages in kv._per_req.values() for i in range(len(pages))],
                  np.int64)
    want = np.array([pg for pages in kv._per_req.values() for pg in pages], np.int64)
    out = {"live_pages": int(rid.size)}
    for strategy in ("binary", "cuda_fused"):
        kv.strategy = strategy
        got = kv.translate(rid, lp)
        check(np.array_equal(got, kv.translate_binary(rid, lp)) and np.array_equal(got, want),
              f"{tag}: translate ({strategy}) != the allocator's pages")
        out[strategy] = True
    kv.strategy = "binary"
    return out


def run_lm(args, dev, card):
    """The LM substrate's serving path at full width: yi-6b prefill
    (every layer's attention through the kernel), prefill against
    sequential decode in bf16 at full depth and in float32 at 4 layers,
    and `launch.serve` through `ServeEngine`."""
    import dataclasses
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.launch import serve
    from repro_torch.models import get_model, layers, transformer
    from repro_torch.serve.engine import Request, ServeEngine

    # a float32 reference runs in float32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_arch(LM_ARCH, reduced=args.lm_reduced)
    b = LM_BATCH
    s = LM_SEQ if not args.lm_reduced else 128
    s_check = LM_CHECK_SEQ if not args.lm_reduced else 32
    rng = np.random.default_rng((args.seed, 2))
    api = get_model(cfg, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device=dev).manual_seed(args.seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = _param_count(params)
    tokens = _lm_tokens(rng, cfg, b, s, dev)

    # ---- the main path: prefill, every layer through the kernel --------
    torch.cuda.reset_peak_memory_stats()
    ops.reset_dispatch_stats()
    reset_counts()
    times = []
    calls = 3
    for _ in range(calls):
        t0 = time.perf_counter()
        logits, cache = api.prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = read_counts()["flash_attention_cuda"]
    attn_rows = [r for r in ops.dispatch_summary()["rows"] if r["op"] == "attention"]
    check(launches == calls * cfg.num_layers,
          f"prefill launched the attention kernel {launches} times, "
          f"want {calls} x {cfg.num_layers}")
    check(all(r["path"] == "kernel" for r in attn_rows),
          f"prefill reached plain attention: {attn_rows}")
    peak = torch.cuda.max_memory_allocated()
    check(tuple(logits.shape) == (b, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all()), "prefill logits not finite")
    check(tuple(cache["k"].shape) == (cfg.num_layers, b, cfg.num_kv_heads, s,
                                      transformer._head_dim(cfg))
          and cache["len"] == s, "prefill cache shape")
    emit({"phase": "lm_prefill", "card": card, "arch": cfg.name, "params": n_params,
          "init_s": init_s, "batch": b, "seq": s, "prefill_s": times,
          "prefill_tok_per_s": b * s / min(times), "peak_mem_gb": peak / 1e9,
          "attention_launches": launches})
    del logits, cache

    # ---- layer 0's q, k, v at the prefill shape: kernel against twin ---
    p0 = params["blocks"][0]
    positions = torch.arange(s, device=dev)
    q, k, v = transformer._qkv(cfg, p0, layers.embed(tokens, params["embed"]))
    q = layers.apply_rope(q, positions, cfg.rope_theta).contiguous()
    k = layers.apply_rope(k, positions, cfg.rope_theta).contiguous()
    v = v.contiguous()
    got = flash_attention_cuda(q, k, v, causal=True).float()
    want = ref.mha_reference(q, k, v, causal=True).float()
    tol = ATTN_TOL["bfloat16"]
    layer0_err = float((got - want).abs().max())
    # Here the outputs are small (about N(0, 1/row) under random weights),
    # so 2e-2 is as large as a typical output: hold the kernel also to
    # the float32 twin on the same (exactly widened) inputs, within one
    # bf16 rounding of each output (2^-8 relative, plus float32 slack),
    # and to a relative L2 error against the bf16 twin.
    want32 = ref.mha_reference(q.float(), k.float(), v.float(), causal=True)
    layer0 = {"max_abs_err": layer0_err, "mean_abs_out": float(want.abs().mean()),
              "rel_l2_err": float((got - want).norm() / want.norm()),
              "max_abs_err_f32": float((got - want32).abs().max()),
              "tol": tol, "rounding_rtol": LAYER0_RTOL, "rounding_atol": LAYER0_ATOL,
              "rel_l2_max": LAYER0_REL_L2}
    layer0["ok"] = (bool(torch.allclose(got, want, atol=tol, rtol=tol))
                    and bool(torch.allclose(got, want32, atol=LAYER0_ATOL,
                                            rtol=LAYER0_RTOL))
                    and layer0["rel_l2_err"] <= LAYER0_REL_L2)
    emit({"phase": "lm_layer0_attention", **layer0})
    check(layer0["ok"], f"layer 0 attention: kernel against its twins: {layer0}")
    del got, want, want32
    kernel_ms = time_ms(lambda: flash_attention_cuda(q, k, v, causal=True), reps=5, warmup=1)
    plain_ms = time_ms(lambda: ref.mha_reference(q, k, v, causal=True), reps=3, warmup=1)
    sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), reps=10)
    hq, hkv, d = q.shape[1], k.shape[1], q.shape[3]
    bound = attention_bound(b, hq, hkv, s, d, q.element_size())
    timing = {"shape": [b, hq, hkv, s, d], "dtype": "bfloat16", "causal": True,
              "ms": kernel_ms, "plain_ms": plain_ms, "sdpa_ms": sdpa_ms, **bound,
              "tflops": bound["flops"] / kernel_ms / 1e9, "layer0_max_abs_err": layer0_err,
              "design": ATTN_DESIGN, "earlier_ms": ATTN_EARLIER_MS}
    emit({"phase": "lm_attention_times", "card": card, **timing})
    del q, k, v
    torch.cuda.empty_cache()

    # ---- prefill against sequential decode ------------------------------
    lp, ld = _prefill_vs_decode(api, params, _lm_tokens(rng, cfg, b, s_check, dev))
    bf16 = {"layers": cfg.num_layers, "top1_prefill": lp.argmax(-1).tolist(),
            "top1_decode": ld.argmax(-1).tolist(),
            "max_abs_diff": float((lp - ld).abs().max()),
            "max_abs_logit": float(lp.abs().max())}
    emit({"phase": "lm_prefill_vs_decode", "dtype": "bfloat16", "seq": s_check, **bf16})
    check(bf16["top1_prefill"] == bf16["top1_decode"],
          "bf16 prefill and sequential decode disagree on a top-1 token")
    check(bf16["max_abs_diff"] <= 0.05 * bf16["max_abs_logit"],
          "bf16 prefill against sequential decode past 0.05 x max |logit|")
    cfg32 = dataclasses.replace(cfg, dtype="float32", num_layers=min(LM_F32_LAYERS,
                                                                    cfg.num_layers))
    api32 = get_model(cfg32, dev)
    params32 = {"embed": params["embed"].float(), "final_norm": params["final_norm"].float(),
                "blocks": [{n: w.float() for n, w in blk.items()}
                           for blk in params["blocks"][:cfg32.num_layers]]}
    lp, ld = _prefill_vs_decode(api32, params32, _lm_tokens(rng, cfg, b, s_check, dev))
    f32 = {"layers": cfg32.num_layers, "max_abs_diff": float((lp - ld).abs().max()),
           "max_abs_logit": float(lp.abs().max()),
           "allclose_1e-3": bool(torch.allclose(lp, ld, atol=1e-3, rtol=1e-3))}
    emit({"phase": "lm_prefill_vs_decode", "dtype": "float32", "seq": s_check, **f32})
    check(f32["allclose_1e-3"], "float32 prefill against sequential decode past 1e-3")
    del params32, api32, lp, ld

    # ---- serving: a short admit/tick run with the page table held ------
    engine = ServeEngine(api, params, batch_slots=8, max_len=256)
    reqs = [Request(uid=i, prompt=[int(t) for t in rng.integers(0, cfg.vocab_size, 8 + i)],
                    max_new_tokens=24) for i in range(12)]
    queue = list(reqs)
    translated = None
    for tick in range(2_000):
        while queue and engine.admit(queue[0]):
            queue.pop(0)
        engine.tick()
        if tick == 20:
            translated = check_translate(engine, "engine tick 20")
        if not queue and not engine._active:
            break
    check(translated is not None and translated["live_pages"] > 0,
          "no live pages to translate midway")
    check(all(r.done and not r.truncated and len(r.generated) == 24 for r in reqs),
          "admit/tick run left a request unfinished")
    check(engine.kv.num_allocated == 0, "admit/tick run leaked pages")
    emit({"phase": "lm_engine_translate", "ticks": tick + 1, **translated})
    del engine, params, api, tokens
    gc.collect()
    torch.cuda.empty_cache()

    # ---- serving through the entry point a user calls -------------------
    argv = SERVE_ARGV + (["--reduced"] if args.lm_reduced else []) + [
        "--seed", str(args.seed), "--device", str(dev)]
    out = serve.main(argv)
    check(out["completed"] == 16 and out["tokens"] == 16 * 32, f"serve: {out}")
    check(out["kv_pages_in_use"] == 0 and out["truncated"] == 0, f"serve: {out}")
    emit({"phase": "lm_serve", "card": card, "argv": argv, **out})
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "timing": timing, "layer0_err": layer0_err,
            "layer0_ok": layer0["ok"],
            "prefill_tok_per_s": b * s / min(times), "serve": out}


# ---------------------------------------------------------------------------
# lm_train: the training path (yi-6b at full width, cut in depth)
# ---------------------------------------------------------------------------

TRAIN_LAYERS = 8             # of yi-6b's 32: 20 B a parameter of AdamW state fits 80 GB
TRAIN_SEQ = 4096             # train_4k's sequence
TRAIN_BATCH, TRAIN_MICRO = 2, 2   # of train_4k's global batch of 256: one card's time
TRAIN_STEPS = 8
TRAIN_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=8)
TRAIN_CORPUS_TOKENS = 2_000_000   # the launcher's synthetic corpus
LAUNCH_TRAIN_ARGV = ["--arch", LM_ARCH, "--reduced", "--global-batch", "2", "--seq", "32",
                     "--warmup", "2", "--checkpoint-every", "5"]


@contextlib.contextmanager
def count_plain_attention():
    """Counts the calls, while open, of the attention twins
    (`ref.mha_reference`, `ref.mha_reference_lse`,
    `ref.mha_backward_reference`) and of PyTorch's own attention
    (`F.scaled_dot_product_attention`); yields the counts by name."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    counts = {}
    originals = [(mod, name, getattr(mod, name)) for mod, name in (
        (ref, "mha_reference"), (ref, "mha_reference_lse"),
        (ref, "mha_backward_reference"), (F, "scaled_dot_product_attention"))]

    def wrap(name, fn):
        def call(*a, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **kw)
        return call
    for mod, name, fn in originals:
        setattr(mod, name, wrap(name, fn))
    try:
        yield counts
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)


def check_model_gradient(dev, seed, arch=LM_ARCH, frames=None):
    """(b): the reduced ``arch``'s loss and gradients (float32, TF32 off)
    on the card, through both attention kernels, against the CPU's plain
    loop: the loss within 1e-5 relative, the MoE aux loss within 1e-6
    relative (0 for a family without one), each leaf within 1e-4 x its
    max; two forward launches (the remat recompute) and one backward
    launch of B9 an attention (`_attention_calls`).  The vlm's batch
    carries patches, the audio family's as many frames as tokens (the
    registry's train spec) unless ``frames`` gives another count (the
    cross-attention's backward then at Sq != Sk)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import get_model
    from repro_torch.train.optimizer import tree_leaves, tree_map
    from repro_torch.train.train_step import loss_and_grads
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_arch(arch, reduced=True), dtype="float32")
    rng = np.random.default_rng((seed, 3))
    toks = rng.integers(0, cfg.vocab_size, (4, 65))
    extra = _modality(cfg, rng, 4, frames or 64, "cpu", torch.float32)
    params = get_model(cfg, "cpu").init(torch.Generator().manual_seed(seed))
    got = {}
    reset_counts()
    for where in ("cpu", dev):
        batch = {"tokens": torch.as_tensor(toks[:, :-1], dtype=torch.int32, device=where),
                 "labels": torch.as_tensor(toks[:, 1:], dtype=torch.int32, device=where),
                 **tree_map(lambda x: x.to(where), extra)}
        loss, metrics, grads = loss_and_grads(get_model(cfg, where).loss,
                                              tree_map(lambda t: t.to(where), params), batch)
        got[str(where)] = (float(loss), [g.float().cpu() for g in tree_leaves(grads)],
                           float(metrics.get("aux", 0.0)))
    launches = read_counts()
    (loss_cpu, grads_cpu, aux_cpu), (loss_card, grads_card, aux_card) = (got["cpu"],
                                                                         got[str(dev)])
    leaf_err = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(grads_card, grads_cpu))
    out = {"arch": cfg.name, "dtype": "float32", "tf32": False, "frames": frames,
           "loss_cpu": loss_cpu,
           "loss_card": loss_card, "loss_rel_err": abs(loss_card - loss_cpu) / abs(loss_cpu),
           "max_leaf_err_over_max": leaf_err, "aux_cpu": aux_cpu, "aux_card": aux_card,
           "aux_rel_err": abs(aux_card - aux_cpu) / max(abs(aux_cpu), 1e-30),
           "attention_launches": launches["flash_attention_cuda"],
           "attention_bwd_launches": launches["flash_attention_bwd_cuda"]}
    attn = _attention_calls(cfg)
    out["ok"] = (out["loss_rel_err"] <= 1e-5 and leaf_err <= 1e-4
                 and out["aux_rel_err"] <= 1e-6
                 and out["attention_launches"] == 2 * attn
                 and out["attention_bwd_launches"] == attn)
    return out


def run_full_width_training(args, dev, card):
    """(c): yi-6b at full width (d_model 4,096, 32/4 heads of 128, d_ff
    11,008, vocabulary 64,000, bf16, remat "full"), cut to TRAIN_LAYERS
    layers, through `get_model`, `adamw_init`, `make_train_step` and
    `DataPipeline`: TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens
    in TRAIN_MICRO microbatches.  Each step's attention launches are
    counted; the optimizer's share is timed with CUDA events around
    `adamw_update` inside the step."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataPipeline, make_synthetic_corpus
    from repro_torch.kernels import ops
    from repro_torch.models import get_model
    from repro_torch.train import OptimizerConfig, adamw_init, make_train_step
    from repro_torch.train import train_step as ts
    full = get_arch(LM_ARCH, reduced=args.lm_reduced)
    cfg = dataclasses.replace(full, num_layers=min(TRAIN_LAYERS, full.num_layers))
    seq = TRAIN_SEQ if not args.lm_reduced else 64
    check(cfg.remat and cfg.remat_policy == "full" and cfg.dtype == "bfloat16",
          f"training config: {cfg}")
    api = get_model(cfg, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device=dev).manual_seed(args.seed))
    state = adamw_init(params)
    corpus = make_synthetic_corpus(total_tokens=TRAIN_CORPUS_TOKENS,
                                   vocab_size=cfg.vocab_size, device=dev)
    pipeline = DataPipeline(corpus, global_batch=TRAIN_BATCH, seq_len=seq)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = _param_count(params)

    opt_events = []
    real_update = ts.adamw_update

    def timed_update(*a, **kw):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = real_update(*a, **kw)
        ev[1].record()
        opt_events.append(ev)
        return out

    step_fn = make_train_step(api.loss, OptimizerConfig(**TRAIN_OPT), microbatches=TRAIN_MICRO)
    steps = []
    torch.cuda.reset_peak_memory_stats()
    ops.reset_dispatch_stats()
    ts.adamw_update = timed_update
    try:
        with count_plain_attention() as plain_calls:
            for step in range(TRAIN_STEPS):
                batch = {k: torch.as_tensor(v, device=dev)
                         for k, v in pipeline.batch_at(step).items()}
                reset_counts()
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                a.record()
                params, state, metrics = step_fn(params, state, batch)
                b.record()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = read_counts()
                step_ms = a.elapsed_time(b)
                opt_ms = opt_events[-1][0].elapsed_time(opt_events[-1][1])
                steps.append({"step": step, "loss": float(metrics["loss"]),
                              "grad_norm": float(metrics["grad_norm"]), "lr": float(metrics["lr"]),
                              "step_s": wall, "fwd_bwd_ms": step_ms - opt_ms, "opt_ms": opt_ms,
                              "attention_launches": launches["flash_attention_cuda"],
                              "attention_bwd_launches": launches["flash_attention_bwd_cuda"],
                              "other_launches": sum(v for k, v in launches.items()
                                                    if not k.startswith("flash_attention"))})
    finally:
        ts.adamw_update = real_update
    peak = torch.cuda.max_memory_allocated()
    attn_rows = [r for r in ops.dispatch_summary()["rows"] if r["op"] == "attention"]
    per_step_fwd = cfg.num_layers * TRAIN_MICRO * 2
    per_step_bwd = cfg.num_layers * TRAIN_MICRO
    for r in steps:
        check(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]),
              f"training step {r['step']}: loss or grad norm not finite: {r}")
        check(r["attention_launches"] == per_step_fwd
              and r["attention_bwd_launches"] == per_step_bwd and r["other_launches"] == 0,
              f"training step {r['step']}: launches {r}, want {per_step_fwd} forward and "
              f"{per_step_bwd} backward")
    check(all(r["path"] == "kernel" for r in attn_rows) and not plain_calls,
          f"training reached plain or library attention: {attn_rows}, {plain_calls}")
    check(steps[-1]["loss"] < steps[0]["loss"],
          f"training loss did not fall: {[r['loss'] for r in steps]}")
    warm = steps[1:] or steps
    step_s = float(np.median([r["step_s"] for r in warm]))
    out = {"arch": cfg.name, "layers": cfg.num_layers, "params": n_params,
           "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads],
           "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "dtype": cfg.dtype,
           "remat": cfg.remat_policy, "seq": seq, "global_batch": TRAIN_BATCH,
           "microbatches": TRAIN_MICRO, "steps": TRAIN_STEPS, "opt": TRAIN_OPT,
           "cuts": {"layers": f"{cfg.num_layers} of {full.num_layers}: AdamW's 20 B a "
                              "parameter at full depth exceeds 80 GB",
                    "global_batch": f"{TRAIN_BATCH} of train_4k's 256: one card's time"},
           "init_s": init_s, "step_s_median": step_s,
           "tok_per_s": TRAIN_BATCH * seq / step_s,
           "fwd_bwd_ms_median": float(np.median([r["fwd_bwd_ms"] for r in warm])),
           "opt_ms_median": float(np.median([r["opt_ms"] for r in warm])),
           "peak_mem_gb": peak / 1e9, "plain_or_library_attention_calls": plain_calls,
           "per_step": steps,
           "launches": {"flash_attention_cuda": sum(r["attention_launches"] for r in steps),
                        "flash_attention_bwd_cuda": sum(r["attention_bwd_launches"]
                                                        for r in steps)}}
    del params, state, api, corpus, pipeline
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_train_launcher(dev):
    """(d): `launch.train.main` with the reduced yi-6b on the card: 12
    steps checkpointed every 5, then 16, resuming (latest step 16)."""
    import shutil
    import tempfile
    from repro_torch.distributed import latest_step
    from repro_torch.launch import train
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        argv = LAUNCH_TRAIN_ARGV + ["--checkpoint-dir", root, "--device", str(dev)]
        first = train.main(argv + ["--steps", "12"])
        at12 = latest_step(root)
        second = train.main(argv + ["--steps", "16"])
        at16 = latest_step(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {"argv": LAUNCH_TRAIN_ARGV, "first": first, "second": second,
           "latest_after_12": at12, "latest_after_16": at16}
    out["ok"] = (at12 == 12 and at16 == 16
                 and all(np.isfinite(o[k]) for o in (first, second)
                         for k in ("first_loss", "last_loss")))
    return out


def run_lm_train(args, dev, card):
    """The training phase: (a) the backward kernel against its twin and
    its times, (b) the reduced model's gradient on the card against the
    CPU, (c) yi-6b at full width through the training entry points, (d)
    `launch.train` resuming from its checkpoint."""
    import torch
    t_phase = time.perf_counter()
    record = []
    worst = compare_attention_backward(dev, args.seed, record)
    emit({"phase": "lm_train", "part": "attention_backward_vs_plain",
          "worst_err_over_tol": worst, "cases": len(record),
          "rows": record, "seconds": time.perf_counter() - t_phase})
    timing = time_attention_backward(dev, args.seed)
    emit({"phase": "lm_train", "part": "attention_times", "card": card, **timing})
    t0 = time.perf_counter()
    grad = check_model_gradient(dev, args.seed)
    emit({"phase": "lm_train", "part": "model_gradient_card_vs_cpu", **grad,
          "seconds": time.perf_counter() - t0})
    check(grad["ok"], f"model gradient on the card against the CPU: {grad}")
    t0 = time.perf_counter()
    full = run_full_width_training(args, dev, card)
    emit({"phase": "lm_train", "part": "full_width", "card": card, **full,
          "attention_ms": timing["forward_lse_ms"], "attention_bwd_ms": timing["ms"],
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    launcher = run_train_launcher(dev)
    emit({"phase": "lm_train", "part": "launch_train", **launcher,
          "seconds": time.perf_counter() - t0})
    check(launcher["ok"], f"launch.train did not resume: {launcher}")
    torch.cuda.empty_cache()
    return {"worst": worst, "record_ok": all(r["within_tol"] for r in record),
            "max_abs_err": max(r[t]["max_abs_err"] for r in record for t in ("dq", "dk", "dv")),
            "timing": timing, "full": full, "seconds": time.perf_counter() - t_phase}


# ---------------------------------------------------------------------------
# lm_moe: the MoE family (olmoe-1b-7b, moonshot-v1-16b-a3b) at full width
# ---------------------------------------------------------------------------

MOE_ARCH, MOE_BIG_ARCH = "olmoe-1b-7b", "moonshot-v1-16b-a3b"
MOE_CHECK_SEQ = 64               # (c): prompts fed to sequential decode
MOE_REL_L2 = 1e-2                # (b): bf16 against the float32 products, same dispatch
MOE_SYNTH = dict(e=32, k=4, t=65_536, capacity_factors=(1.0, 1.25, 1.5))  # (d)
MOE_SERVE_ARGV = ["--arch", MOE_ARCH] + SERVE_ARGV[2:]


def moe_prefill(api, params, tokens, calls=3):
    """`calls` prefills with the launch counts and the dispatch ledger
    zeroed first: (seconds, attention launches, ledger rows that reached
    plain attention, peak bytes, logits, cache)."""
    import torch
    from repro_torch.kernels import ops
    torch.cuda.reset_peak_memory_stats()
    ops.reset_dispatch_stats()
    reset_counts()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        logits, cache = api.prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    plain = [r for r in ops.dispatch_summary()["rows"]
             if r["op"] == "attention" and r["path"] != "kernel"]
    return (times, read_counts()["flash_attention_cuda"], plain,
            torch.cuda.max_memory_allocated(), logits, cache)


def check_moe_prefill(cfg, b, s, out, tag):
    """The prefill's checks: one attention launch a layer a call, no plain
    attention, finite logits, the cache's shape."""
    import torch
    from repro_torch.models import transformer
    times, launches, plain, _, logits, cache = out
    check(launches == len(times) * cfg.num_layers,
          f"{tag}: {launches} attention launches, want {len(times)} x {cfg.num_layers}")
    check(not plain, f"{tag}: prefill reached plain attention: {plain}")
    check(tuple(logits.shape) == (b, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all()), f"{tag}: prefill logits not finite")
    check(tuple(cache["k"].shape) == (cfg.num_layers, b, cfg.num_kv_heads, s,
                                      transformer._head_dim(cfg))
          and cache["len"] == s, f"{tag}: prefill cache shape")


def _layer0_routing(cfg, params, tokens):
    """Layer 0's FFN input (T, D) and its routing (scores, gate, ids)."""
    import torch
    from repro_torch.models import layers, moe, transformer
    p0 = params["blocks"][0]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x, _ = transformer._attn_train(cfg, p0, layers.embed(tokens, params["embed"]), positions)
    h = layers.rmsnorm(x, p0["ln2"]).reshape(-1, cfg.d_model)
    scores = moe._scores(h, p0["router"])
    return (h, scores, *moe._gates(scores, cfg.experts_per_token, h.dtype))


def moe_dispatch_card_vs_cpu(cfg, params, tokens):
    """(b): layer 0's dispatch at the prefill shape, `cdf` and `sort`, on
    the card against the CPU from the same (scores, gate, ids): dest, st,
    keep and the buffers bit for bit; `moe_ffn` in bf16 within 2e-2 x max
    and a relative L2 of 1e-2 of the float32 products and combine under
    the same dispatch (TF32 off), and bit-identical on a repeat that runs
    with any host synchronisation an error."""
    import torch
    from repro_torch.models import moe
    torch.backends.cuda.matmul.allow_tf32 = False
    p0 = params["blocks"][0]
    h, scores, gate, eidx = _layer0_routing(cfg, params, tokens)
    t, e, k = h.shape[0], cfg.num_experts, cfg.experts_per_token
    capacity = max(1, int(t * k / e * cfg.capacity_factor))
    cpu_in = [a.cpu() for a in (h, scores, gate, eidx)]
    weights = [p0[n] for n in ("we_gate", "we_up", "we_down")]
    out = {"tokens": t, "capacity": capacity}
    for dispatch in ("cdf", "sort"):
        kw = dict(num_experts=e, capacity=capacity, dispatch=dispatch)
        card = moe._dispatch_one_group(h, scores, gate, eidx, **kw)
        host = moe._dispatch_one_group(*cpu_in, **kw)
        equal = {n: bool(torch.equal(a.cpu(), b_)) for n, a, b_ in
                 zip(("buffers", "dest", "st", "sg"), card, host)}
        equal["keep"] = bool(torch.equal((card[3] != 0).cpu(), host[3] != 0))
        buf, dest, st, sg = card
        y, aux = moe.moe_ffn(h[None], p0["router"], *weights, experts_per_token=k,
                             capacity_factor=cfg.capacity_factor, dispatch=dispatch)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")    # no read-back to the host inside
        try:
            y2, aux2 = moe.moe_ffn(h[None], p0["router"], *weights, experts_per_token=k,
                                   capacity_factor=cfg.capacity_factor, dispatch=dispatch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        y32 = moe._experts(buf[None].float(), *(w.float() for w in weights))[0]
        y32 = moe._combine_one(y32.reshape(e * capacity, -1), dest, st, sg.float(), t)
        diff = y[0].float() - y32
        row = {"equal": equal, "drop_frac": float(aux["moe_drop_frac"]),
               "max_abs_err": float(diff.abs().max()), "max_abs_f32": float(y32.abs().max()),
               "rel_l2_err": float(diff.norm() / y32.norm()),
               "repeat_bits": bool(torch.equal(y, y2)) and all(
                   bool(torch.equal(aux[n], aux2[n])) for n in aux)}
        row["ok"] = (all(equal.values()) and row["repeat_bits"]
                     and row["max_abs_err"] <= ATTN_TOL["bfloat16"] * row["max_abs_f32"]
                     and row["rel_l2_err"] <= MOE_REL_L2)
        out[dispatch] = row
        del card, host, y, y2, y32, diff
    return out


def moe_layer_drops(cfg, params, tokens):
    """(d): each layer's drop fraction under `cdf` and `sort` on olmoe's
    own router scores at the prefill shape (the model's hidden states,
    its own dispatch carrying them to the next layer)."""
    import torch
    from repro_torch.models import layers, moe, transformer
    x = layers.embed(tokens, params["embed"])
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    t, e, k = x.shape[0] * x.shape[1], cfg.num_experts, cfg.experts_per_token
    capacity = max(1, int(t * k / e * cfg.capacity_factor))
    drops = {"cdf": [], "sort": []}
    for p in params["blocks"]:
        x, _ = transformer._attn_train(cfg, p, x, positions)
        h = layers.rmsnorm(x, p["ln2"]).reshape(t, -1)
        scores = moe._scores(h, p["router"])
        gate, eidx = moe._gates(scores, k, h.dtype)
        for dispatch in drops:
            sg = moe._dispatch_one_group(h, scores, gate, eidx, num_experts=e,
                                         capacity=capacity, dispatch=dispatch)[3]
            drops[dispatch].append(sg)
        x, _ = transformer._ffn(cfg, p, x)
    drops = {n: [1.0 - float((sg > 0).float().mean()) for sg in v] for n, v in drops.items()}
    return {"capacity_factor": cfg.capacity_factor, "capacity": capacity, "per_layer": drops,
            "mean": {n: sum(v) / len(v) for n, v in drops.items()}}


def _collision_drop(dest, slots):
    """Share of entries that lose their slot to an earlier one."""
    import torch
    entry = torch.arange(dest.numel(), device=dest.device)
    winner = torch.full((slots,), dest.numel(), dtype=torch.int64, device=dest.device)
    winner.scatter_reduce_(0, dest, entry, "amin", include_self=True)
    return 1.0 - float((winner[dest] == entry).double().mean())


def moe_synthetic_drops(dev):
    """(d): `benchmarks/moe_dispatch.py`'s table (E 32, K 4, T 65,536; a
    Zipf-skewed router, seed 0), `cdf` slots from the port's
    `cdf_dispatch_slots` on the card (equal to the CPU's), sort's
    capacity overflow, and the benchmark's random-hash placement."""
    import torch
    from repro_torch.models import moe
    e, k, t = MOE_SYNTH["e"], MOE_SYNTH["k"], MOE_SYNTH["t"]
    rng = np.random.default_rng(0)
    popularity = 1.0 / (np.arange(e) + 1.0) ** 0.7
    logits = rng.normal(0, 1, (t, e)) + np.log(popularity)[None]
    scores = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    top = np.argsort(-scores, axis=1)[:, :k]
    flat_e = torch.as_tensor(top.reshape(-1), device=dev)
    flat_s = torch.as_tensor(np.take_along_axis(scores, top, axis=1).reshape(-1)
                             .astype(np.float32), device=dev)
    h = np.arange(flat_e.numel(), dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    h ^= h >> np.uint64(31)
    counts = torch.bincount(flat_e, minlength=e)
    rows = []
    for cf in MOE_SYNTH["capacity_factors"]:
        capacity = int(t * k / e * cf)
        slots = moe.cdf_dispatch_slots(flat_s, flat_e, e, capacity)
        host = moe.cdf_dispatch_slots(flat_s.cpu(), flat_e.cpu(), e, capacity)
        rand = torch.as_tensor((h % np.uint64(capacity)).astype(np.int64), device=dev)
        row = {"capacity_factor": cf, "capacity": capacity,
               "sort": float(torch.clamp(counts - capacity, min=0).sum()) / flat_e.numel(),
               "cdf": _collision_drop(flat_e * capacity + slots, e * capacity),
               "random": _collision_drop(flat_e * capacity + rand, e * capacity),
               "cdf_card_equals_cpu": bool(torch.equal(slots.cpu(), host))}
        row["cdf_vs_random"] = (row["random"] - row["cdf"]) / max(row["random"], 1e-9)
        rows.append(row)
    return rows


@contextlib.contextmanager
def watch_engine(at_tick=20):
    """While open, every `ServeEngine.tick` is counted and timed, and the
    page table is held against the binary baseline at tick ``at_tick``;
    yields {"ticks", "tick_s", "translate"}."""
    import torch
    from repro_torch.serve.engine import ServeEngine
    seen = {"ticks": 0, "tick_s": 0.0, "translate": None}
    tick = ServeEngine.tick

    def watched(self):
        t0 = time.perf_counter()
        out = tick(self)
        torch.cuda.synchronize()
        seen["tick_s"] += time.perf_counter() - t0
        seen["ticks"] += 1
        if seen["ticks"] == at_tick:
            seen["translate"] = check_translate(self, f"engine tick {at_tick}")
        return out
    ServeEngine.tick = watched
    try:
        yield seen
    finally:
        ServeEngine.tick = tick


def run_lm_moe(args, dev, card):
    """The MoE family at full width (bf16, random weights from a seeded
    generator on the card): (a) olmoe-1b-7b prefill, (b) its layer-0
    dispatch card against CPU, (c) prefill against sequential decode,
    (d) drop fractions, (e) `launch.serve`, (f) moonshot-v1-16b-a3b
    prefill, (g) the reduced olmoe's gradient card against CPU.  Each
    model is released before the next."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import get_model
    t_phase = time.perf_counter()
    cfg = get_arch(MOE_ARCH, reduced=args.lm_reduced)
    b = LM_BATCH
    s = LM_SEQ if not args.lm_reduced else 128
    s_check = MOE_CHECK_SEQ if not args.lm_reduced else 16
    rng = np.random.default_rng((args.seed, 4))
    parts = {}

    # ---- (a) olmoe prefill, every layer's attention through B9 ----------
    t0 = time.perf_counter()
    api = get_model(cfg, dev)
    params = api.init(torch.Generator(device=dev).manual_seed(args.seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = _lm_tokens(rng, cfg, b, s, dev)
    pre = moe_prefill(api, params, tokens)
    check_moe_prefill(cfg, b, s, pre, MOE_ARCH)
    times, launches, _, peak = pre[:4]
    del pre
    n_params = _param_count(params)
    parts["a"] = {"arch": cfg.name, "dispatch": cfg.moe_dispatch, "params": n_params,
                  "param_gb": 2 * n_params / 1e9, "init_s": init_s, "batch": b,
                  "seq": s, "prefill_s": times, "prefill_tok_per_s": b * s / min(times),
                  "peak_mem_gb": peak / 1e9, "attention_launches": launches,
                  "seconds": time.perf_counter() - t0}
    emit({"phase": "lm_moe", "part": "a_prefill", "card": card, **parts["a"]})

    # ---- (b) layer 0's dispatch, card against CPU -----------------------
    t0 = time.perf_counter()
    parts["b"] = {**moe_dispatch_card_vs_cpu(cfg, params, tokens),
                  "seconds": time.perf_counter() - t0}
    emit({"phase": "lm_moe", "part": "b_dispatch_card_vs_cpu", **parts["b"]})
    check(parts["b"]["cdf"]["ok"] and parts["b"]["sort"]["ok"],
          f"lm_moe (b): dispatch or moe_ffn: {parts['b']}")

    # ---- (c) prefill against sequential decode, no slot dropped ---------
    t0 = time.perf_counter()
    cf = cfg.num_experts / cfg.experts_per_token
    api_c = get_model(dataclasses.replace(cfg, capacity_factor=cf), dev)
    lp, ld = _prefill_vs_decode(api_c, params, _lm_tokens(rng, cfg, b, s_check, dev))
    parts["c"] = {"layers": cfg.num_layers, "capacity_factor": cf, "seq": s_check,
                  "top1_prefill": lp.argmax(-1).tolist(), "top1_decode": ld.argmax(-1).tolist(),
                  "max_abs_diff": float((lp - ld).abs().max()),
                  "max_abs_logit": float(lp.abs().max()), "seconds": time.perf_counter() - t0}
    emit({"phase": "lm_moe", "part": "c_prefill_vs_decode", "dtype": "bfloat16", **parts["c"]})
    check(parts["c"]["top1_prefill"] == parts["c"]["top1_decode"],
          "lm_moe (c): prefill and sequential decode disagree on a top-1 token")
    check(parts["c"]["max_abs_diff"] <= 0.05 * parts["c"]["max_abs_logit"],
          "lm_moe (c): prefill against sequential decode past 0.05 x max |logit|")
    del api_c, lp, ld

    # ---- (d) drop fractions: olmoe's own scores, then the synthetic table
    t0 = time.perf_counter()
    parts["d"] = {"model": moe_layer_drops(cfg, params, tokens),
                  "synthetic": moe_synthetic_drops(dev), "seconds": time.perf_counter() - t0}
    emit({"phase": "lm_moe", "part": "d_drop_fractions", **parts["d"]})
    check(all(r["cdf_card_equals_cpu"] for r in parts["d"]["synthetic"]),
          "lm_moe (d): cdf slots on the card != the CPU's")
    del params, api, tokens
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (e) the serving entry point ------------------------------------
    t0 = time.perf_counter()
    argv = MOE_SERVE_ARGV + (["--reduced"] if args.lm_reduced else []) + [
        "--seed", str(args.seed), "--device", str(dev)]
    with watch_engine() as seen:
        out = serve.main(argv)
    check(out["completed"] == 16 and out["tokens"] == 16 * 32, f"lm_moe serve: {out}")
    check(out["kv_pages_in_use"] == 0 and out["truncated"] == 0, f"lm_moe serve: {out}")
    check(seen["translate"] is not None and seen["translate"]["live_pages"] > 0,
          "lm_moe serve: no live pages to translate midway")
    parts["e"] = {"argv": argv, **out, "ticks": seen["ticks"],
                  "ticks_per_s": seen["ticks"] / seen["tick_s"], "translate": seen["translate"],
                  "seconds": time.perf_counter() - t0}
    emit({"phase": "lm_moe", "part": "e_serve", "card": card, **parts["e"]})
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (f) moonshot prefill at full size -------------------------------
    t0 = time.perf_counter()
    big = get_arch(MOE_BIG_ARCH, reduced=args.lm_reduced)
    api = get_model(big, dev)
    params = api.init(torch.Generator(device=dev).manual_seed(args.seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pre = moe_prefill(api, params, _lm_tokens(rng, big, b, s, dev))
    check_moe_prefill(big, b, s, pre, MOE_BIG_ARCH)
    times, big_launches, _, peak = pre[:4]
    n_params = _param_count(params)
    parts["f"] = {"arch": big.name, "dispatch": big.moe_dispatch,
                  "params": n_params, "param_gb": 2 * n_params / 1e9,
                  "init_s": init_s, "batch": b, "seq": s, "prefill_s": times,
                  "prefill_tok_per_s": b * s / min(times), "peak_mem_gb": peak / 1e9,
                  "attention_launches": big_launches, "seconds": time.perf_counter() - t0}
    del pre, params, api
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "lm_moe", "part": "f_prefill", "card": card, **parts["f"]})

    # ---- (g) the reduced olmoe's gradient, card against CPU --------------
    t0 = time.perf_counter()
    parts["g"] = {**check_model_gradient(dev, args.seed, MOE_ARCH),
                  "seconds": time.perf_counter() - t0}
    emit({"phase": "lm_moe", "part": "g_model_gradient_card_vs_cpu", **parts["g"]})
    check(parts["g"]["ok"], f"lm_moe (g): gradient on the card against the CPU: {parts['g']}")
    seconds = time.perf_counter() - t_phase
    emit({"phase": "lm_moe", "part": "all", "card": card, "seconds": seconds,
          "parts_s": {n: p["seconds"] for n, p in parts.items()}})
    return {"launches": launches + big_launches, "parts": parts, "seconds": seconds}


# ---------------------------------------------------------------------------
# lm_ssm, lm_hybrid: the recurrent families (xlstm-1.3b, jamba-1.5-large)
# ---------------------------------------------------------------------------

SSM_ARCH, HYBRID_ARCH = "xlstm-1.3b", "jamba-1.5-large-398b"
RECURRENT_SEQ = 4096             # tokens a prompt of jamba's layer calls
# xlstm-1.3b's timed prefill: cut from 4,096 (its Python scans took
# 23-32 s there, over the phase's 60 s; PERF.md §4)
SSM_PREFILL_SEQ = 2048
RECURRENT_WARMUP_SEQ = 256       # the xLSTM's warm-up prefill
RECURRENT_CHECK_SEQ = 64         # prompts fed to sequential decode
RECURRENT_REL_L2 = 1e-2          # bf16 against float32: Mamba mixer, MoE FFN
SSM_SERVE_ARGV = ["--arch", SSM_ARCH] + SERVE_ARGV[2:]
HYBRID_SERVE_ARGV = ["--arch", HYBRID_ARCH, "--reduced"] + SERVE_ARGV[2:]


def _attention_calls(cfg):
    """B9 launches in one prefill or training forward: a layer's
    self-attention (the hybrid's attention layers only, none for the
    ssm), and for the audio family also each encoder layer's and each
    cross-attention."""
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_period
    if cfg.family == "audio":
        return cfg.num_encoder_layers + 2 * cfg.num_layers
    return 0 if cfg.family == "ssm" else cfg.num_layers


def _modality(cfg, rng, b, s, dev, dtype):
    """The batch's non-text input, unit normal: llava's anyres patch
    embeddings (B, T_img, F), seamless's filterbank frames (B, s, F),
    nothing for a text-only family (``rng`` then draws nothing)."""
    import torch
    if cfg.family == "vlm":
        shape = (b, cfg.frontend_tokens, cfg.frontend_dim)
    elif cfg.family == "audio":
        shape = (b, s, cfg.frontend_dim)
    else:
        return {}
    name = "patches" if cfg.family == "vlm" else "frames"
    return {name: torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                                  device=dev).to(dtype)}


def check_model_serving(dev, seed, arch):
    """The reduced ``arch`` (float32, TF32 off) served on the card against
    the CPU: prefill's logits and those of 6 decode steps within 1e-4 x
    max |CPU logit| (decode goes on from the prefill's KV cache, the
    recurrent families' from a fresh cache); the card's B9 launches
    (`_attention_calls`) and no plain attention."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import get_model, transformer
    from repro_torch.train.optimizer import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch(arch, reduced=True), dtype="float32")
    rng = np.random.default_rng((seed, 6))
    toks = rng.integers(0, cfg.vocab_size, (2, 24))
    extra = _modality(cfg, rng, 2, 24, "cpu", torch.float32)
    params = get_model(cfg, "cpu").init(torch.Generator().manual_seed(seed))
    got = {}
    for where in ("cpu", dev):
        api = get_model(cfg, where)
        p = tree_map(lambda t: t.to(where), params)
        t = torch.as_tensor(toks, dtype=torch.int32, device=where)
        reset_counts()
        with count_plain_attention() as plain:
            lp, cache = api.prefill(p, {"tokens": t, **tree_map(lambda x: x.to(where), extra)})
            launches = read_counts()["flash_attention_cuda"]
            if cfg.family in ("ssm", "hybrid"):
                cache = api.init_cache(2, 8)
            else:
                cache = transformer.extend_cache(cache, cache["len"] + 8)
            steps = []
            for i in range(6):
                ld, cache = api.decode(p, cache, t[:, i])
                steps.append(ld)
        got[str(where)] = [lp.cpu()] + [ld.cpu() for ld in steps]
    errs = [float((a - b).abs().max()) / float(b.abs().max())
            for a, b in zip(got[str(dev)], got["cpu"])]
    out = {"arch": cfg.name, "dtype": "float32", "tf32": False, "prefill_seq": 24,
           "decode_steps": 6, "prefill_err_over_max": errs[0],
           "decode_err_over_max": max(errs[1:]), "attention_launches": launches,
           "plain_attention": dict(plain)}
    out["ok"] = (max(errs) <= 1e-4 and launches == _attention_calls(cfg) and not plain)
    return out


def _rel_l2(got, want):
    return float((got - want).norm() / want.norm())


def xlstm_layer_bf16(cfg, block, name, rng, dev, s):
    """One xLSTM layer of ``block`` (the first mLSTM or the sLSTM) in
    bf16 on 2 x ``s`` tokens of unit-normal input: its output against the
    same layer in float32, and its prefill against ``s`` sequential
    decode steps, each within a relative L2 of RECURRENT_REL_L2."""
    import dataclasses
    import torch
    from repro_torch.models import xlstm
    from repro_torch.train.optimizer import tree_map
    p = block["mlstm"][0] if name == "mlstm" else block["slstm"]
    train, decode = getattr(xlstm, f"{name}_train"), getattr(xlstm, f"{name}_decode")
    x = torch.as_tensor(rng.standard_normal((2, s, cfg.d_model)), dtype=torch.float32,
                        device=dev).to(torch.bfloat16)
    y = train(cfg, p, x).float()
    y32 = train(dataclasses.replace(cfg, dtype="float32"), tree_map(lambda t: t.float(), p),
                x.float())
    state = getattr(xlstm, f"init_{name}_state")(cfg, 2, dev)
    steps = []
    for i in range(s):
        yi, state = decode(cfg, p, x[:, i:i + 1], state)
        steps.append(yi)
    dec = torch.cat(steps, dim=1).float()
    out = {"rel_l2_bf16_vs_f32": _rel_l2(y, y32), "rel_l2_decode_vs_prefill": _rel_l2(dec, y)}
    out["ok"] = max(out.values()) <= RECURRENT_REL_L2
    return out


def run_lm_ssm(args, dev, card):
    """The ssm family: (a) xlstm-1.3b at full width and depth (bf16,
    random weights from a seeded generator on the card), a warm-up
    prefill then a timed one; (b) prefill against sequential decode
    (reported in bf16 and float32 at full depth; held in float32 at one
    superblock, and in bf16 layer by layer); (c) `launch.serve --arch
    xlstm-1.3b`; (d) the reduced xlstm card against CPU (serving, then
    the loss and gradients)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import get_model, xlstm
    from repro_torch.train.optimizer import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    cfg = get_arch(SSM_ARCH, reduced=args.lm_reduced)
    b = LM_BATCH
    s = SSM_PREFILL_SEQ if not args.lm_reduced else 64
    s_warm = RECURRENT_WARMUP_SEQ if not args.lm_reduced else 16
    s_check = RECURRENT_CHECK_SEQ if not args.lm_reduced else 16
    rng = np.random.default_rng((args.seed, 5))
    parts = {}

    # ---- (a) init, warm-up, the timed prefill ----------------------------
    t0 = time.perf_counter()
    api = get_model(cfg, dev)
    params = api.init(torch.Generator(device=dev).manual_seed(args.seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = _param_count(params)
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    api.prefill(params, {"tokens": _lm_tokens(rng, cfg, b, s_warm, dev)})
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    logits, cache = api.prefill(params, {"tokens": _lm_tokens(rng, cfg, b, s, dev)})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated()
    ns, nm = cfg.num_layers // cfg.xlstm_slstm_every, cfg.xlstm_slstm_every - 1
    _, h, dk, dv = xlstm._dims(cfg)
    check(tuple(logits.shape) == (b, cfg.padded_vocab) and bool(torch.isfinite(logits).all()),
          "lm_ssm (a): prefill logits not finite")
    check(tuple(cache["m"]["c"].shape) == (ns, nm, b, h, dk, dv)
          and tuple(cache["s"]["h"].shape) == (ns, b, cfg.d_model) and cache["len"] == s,
          "lm_ssm (a): prefill cache shape")
    parts["a"] = {"arch": cfg.name, "params": n_params, "param_gb": 2 * n_params / 1e9,
                  "layers": cfg.num_layers, "init_s": init_s, "batch": b,
                  "warmup_seq": s_warm, "warmup_s": warm_s, "seq": s,
                  "prefill_s": prefill_s, "prefill_tok_per_s": b * s / prefill_s,
                  "peak_mem_gb": peak / 1e9, "seconds": time.perf_counter() - t0}
    emit({"phase": "lm_ssm", "part": "a_prefill", "card": card, **parts["a"]})
    del logits, cache

    # ---- (b) prefill against sequential decode ---------------------------
    # Under random weights the 48-layer stack amplifies a rounding ~1e4
    # times (float32: 7e-5 of max |logit| at one superblock, 2.5e-3 at
    # six), so in bf16 the whole model's prefill and decode part by about
    # max |logit|, as the reference's own bf16 prefill parts from its
    # float32 one (PERF.md §6).  The whole model is held in float32; bf16
    # is held layer by layer, where no depth amplifies it.
    t0 = time.perf_counter()
    check_tokens = _lm_tokens(rng, cfg, b, s_check, dev)
    lp, ld = _prefill_vs_decode(api, params, check_tokens)
    params32 = tree_map(lambda t: t.float(), params)
    api32 = get_model(dataclasses.replace(cfg, dtype="float32"), dev)
    lp32, ld32 = _prefill_vs_decode(api32, params32, check_tokens)
    bf16 = {"layers": cfg.num_layers, "top1_prefill": lp.argmax(-1).tolist(),
            "top1_decode": ld.argmax(-1).tolist(), "max_abs_diff": float((lp - ld).abs().max()),
            "max_abs_logit": float(lp.abs().max()),
            "prefill_vs_f32_prefill": float((lp - lp32).abs().max())}
    full32 = {"layers": cfg.num_layers, "max_abs_diff": float((lp32 - ld32).abs().max()),
              "max_abs_logit": float(lp32.abs().max())}
    cfg32 = dataclasses.replace(cfg, dtype="float32", num_layers=cfg.xlstm_slstm_every)
    lp, ld = _prefill_vs_decode(get_model(cfg32, dev), {**params32, "blocks": params32[
        "blocks"][:1]}, check_tokens)
    f32 = {"layers": cfg32.num_layers, "max_abs_diff": float((lp - ld).abs().max()),
           "max_abs_logit": float(lp.abs().max()),
           "allclose_1e-3": bool(torch.allclose(lp, ld, atol=1e-3, rtol=1e-3))}
    del params32, api32, lp, ld, lp32, ld32
    layers = {name: xlstm_layer_bf16(cfg, params["blocks"][0], name, rng, dev, s_check)
              for name in ("mlstm", "slstm")}
    parts["b"] = {"seq": s_check, "bfloat16": bf16, "float32_full_depth": full32,
                  "float32": f32, "layers_bf16": layers, "seconds": time.perf_counter() - t0}
    emit({"phase": "lm_ssm", "part": "b_prefill_vs_decode", **parts["b"]})
    check(f32["allclose_1e-3"], "lm_ssm (b): float32 prefill against sequential decode")
    check(all(r["ok"] for r in layers.values()),
          f"lm_ssm (b): a layer in bf16 against float32 or its decode steps: {layers}")
    del params, api
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (c) the serving entry point --------------------------------------
    t0 = time.perf_counter()
    argv = SSM_SERVE_ARGV + (["--reduced"] if args.lm_reduced else []) + [
        "--seed", str(args.seed), "--device", str(dev)]
    with watch_engine() as seen:
        out = serve.main(argv)
    check(out["completed"] == 16 and out["tokens"] == 16 * 32, f"lm_ssm serve: {out}")
    check(out["kv_pages_in_use"] == 0 and out["truncated"] == 0, f"lm_ssm serve: {out}")
    parts["c"] = {"argv": argv, **out, "ticks": seen["ticks"],
                  "ticks_per_s": seen["ticks"] / seen["tick_s"],
                  "seconds": time.perf_counter() - t0}
    emit({"phase": "lm_ssm", "part": "c_serve", "card": card, **parts["c"]})
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (d) the reduced model, card against CPU --------------------------
    t0 = time.perf_counter()
    parts["d"] = {"serving": check_model_serving(dev, args.seed, SSM_ARCH),
                  "gradient": check_model_gradient(dev, args.seed, SSM_ARCH),
                  "seconds": time.perf_counter() - t0}
    emit({"phase": "lm_ssm", "part": "d_reduced_card_vs_cpu", **parts["d"]})
    check(parts["d"]["serving"]["ok"] and parts["d"]["gradient"]["ok"],
          f"lm_ssm (d): the reduced model on the card against the CPU: {parts['d']}")
    seconds = time.perf_counter() - t_phase
    emit({"phase": "lm_ssm", "part": "all", "card": card, "seconds": seconds,
          "parts_s": {n: p["seconds"] for n, p in parts.items()}})
    return {"parts": parts, "seconds": seconds}


def jamba_superblock(cfg):
    """One superblock's parameters and bytes in cfg.dtype, by layer kind,
    and the embedding's."""
    from repro_torch.models import hybrid
    elem = 2 if cfg.dtype == "bfloat16" else 4
    kinds = {"mamba": 0, "attention": 0, "moe_ffn": 0, "dense_ffn": 0}
    for key, leaves in hybrid.superblock_param_shapes(cfg).items():
        n = sum(int(np.prod(s)) for s in leaves.values())
        if key.startswith("mix"):
            kinds["attention" if "wq" in leaves else "mamba"] += n
        else:
            kinds["moe_ffn" if "router" in leaves else "dense_ffn"] += n
    total = sum(kinds.values())
    embed = cfg.padded_vocab * cfg.d_model
    return {"superblock_layers": cfg.attn_period, "params_by_kind": kinds,
            "superblock_params": total, "superblock_gb": elem * total / 1e9,
            "embed_gb": elem * embed / 1e9,
            "superblocks": cfg.num_layers // cfg.attn_period}


def _moe_ffn_vs_float32(cfg, p, x):
    """(bf16 output, aux, its float32 twin): `moe_ffn` on the FFN's
    normalised input, and the float32 expert products and combine under
    the same dispatch, one expert at a time."""
    import torch
    from repro_torch.models import layers, moe
    h = layers.rmsnorm(x, p["ln2"])
    e, k = cfg.num_experts, cfg.experts_per_token
    weights = [p[n] for n in ("we_gate", "we_up", "we_down")]
    y, aux = moe.moe_ffn(h, p["router"], *weights, experts_per_token=k,
                         capacity_factor=cfg.capacity_factor, dispatch=cfg.moe_dispatch)
    ht = h.reshape(-1, cfg.d_model)
    t = ht.shape[0]
    scores = moe._scores(ht, p["router"])
    gate, eidx = moe._gates(scores, k, ht.dtype)
    capacity = max(1, int(t * k / e * cfg.capacity_factor))
    buf, dest, st, sg = moe._dispatch_one_group(ht, scores, gate, eidx, num_experts=e,
                                                capacity=capacity, dispatch=cfg.moe_dispatch)
    y32 = torch.cat([moe._experts(buf[None, i:i + 1].float(),
                                  *(w[i:i + 1].float() for w in weights))[0]
                     for i in range(e)])
    y32 = moe._combine_one(y32.reshape(e * capacity, -1), dest, st, sg.float(), t)
    return y.reshape(t, -1).float(), aux, y32


def run_jamba_layers(args, dev, card):
    """(a) jamba-1.5-large's four layer kinds alone at its published
    width (bf16, 2 x RECURRENT_SEQ tokens of unit-normal hidden state):
    the Mamba mixer (bf16 against float32, prefill against sequential
    decode in float32), the attention mixer through B9 (one launch, no
    plain attention; `block_decode_attn_only` against `_attn_train` in
    float32), one MoE FFN (bf16 against the float32 products under the
    same dispatch) and one dense FFN; each released before the next."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import hybrid, mamba, transformer
    from repro_torch.train.optimizer import tree_map
    cfg = get_arch(HYBRID_ARCH, reduced=args.lm_reduced)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    b = LM_BATCH
    s = RECURRENT_SEQ if not args.lm_reduced else 64
    s_check = RECURRENT_CHECK_SEQ if not args.lm_reduced else 16
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    out = {"d_model": cfg.d_model, "batch": b, "seq": s}

    # ---- the Mamba mixer --------------------------------------------------
    t0 = time.perf_counter()
    p = mamba.init_mamba_params(cfg, gen)
    sec = time_ms(lambda: mamba.mamba_train(cfg, p, x), reps=3, warmup=1) / 1e3
    y = mamba.mamba_train(cfg, p, x)
    p32 = tree_map(lambda t: t.float(), p)
    y32 = mamba.mamba_train(cfg32, p32, x.float())
    # the layer's output against float32, and (for the record) what the
    # mixer adds to its input: the bf16 sum with the residual rounds it
    # at 2^-9 of |x|, ~3% of the mixer's share under random weights
    mixer_err = _rel_l2((y - x).float(), y32 - x.float())
    y = y.float()
    x64 = x[:, :s_check].float()
    pre, st = mamba.mamba_train(cfg32, p32, x64, return_state=True)
    state = mamba.init_mamba_state(cfg32, b, dev)
    steps = []
    for i in range(s_check):
        yi, state = mamba.mamba_decode(cfg32, p32, x64[:, i:i + 1], state)
        steps.append(yi)
    dec = torch.cat(steps, dim=1)
    row = {"params": sum(t.numel() for t in p.values()), "seconds_per_call": sec,
           "tok_per_s": b * s / sec, "rel_l2_bf16_vs_f32": _rel_l2(y, y32),
           "mixer_rel_l2_bf16_vs_f32": mixer_err,
           "decode_max_abs_diff": float((dec - pre).abs().max()),
           "decode_allclose_1e-3": bool(torch.allclose(dec - x64, pre - x64, atol=1e-3,
                                                       rtol=1e-3))
           and bool(torch.allclose(state["h"], st["h"], atol=1e-3, rtol=1e-3)),
           "seconds": time.perf_counter() - t0}
    row["ok"] = row["rel_l2_bf16_vs_f32"] <= RECURRENT_REL_L2 and row["decode_allclose_1e-3"]
    out["mamba"] = row
    del p, p32, y, y32, pre, st, state, steps, dec
    torch.cuda.empty_cache()

    # ---- the attention mixer through B9 -----------------------------------
    t0 = time.perf_counter()
    p = hybrid._init_attn(cfg, gen)
    positions = torch.arange(s, device=dev)
    ops.reset_dispatch_stats()
    reset_counts()
    with count_plain_attention() as plain:
        transformer._attn_train(cfg, p, x, positions)
        torch.cuda.synchronize()
        launches = read_counts()["flash_attention_cuda"]
    rows = [r for r in ops.dispatch_summary()["rows"] if r["op"] == "attention"]
    sec = time_ms(lambda: transformer._attn_train(cfg, p, x, positions), reps=3,
                  warmup=1) / 1e3
    p32 = tree_map(lambda t: t.float(), p)
    pre, _ = transformer._attn_train(cfg32, p32, x64, positions[:s_check])
    hd = transformer._head_dim(cfg)
    kc = torch.zeros((b, cfg.num_kv_heads, s_check, hd), device=dev)
    vc = torch.zeros_like(kc)
    steps = []
    for i in range(s_check):
        yi, kc, vc = transformer.block_decode_attn_only(cfg32, p32, x64[:, i:i + 1], kc, vc, i)
        steps.append(yi)
    dec = torch.cat(steps, dim=1)
    row = {"params": sum(t.numel() for t in p.values()), "heads": cfg.num_heads,
           "kv_heads": cfg.num_kv_heads, "head_dim": hd, "seconds_per_call": sec,
           "tok_per_s": b * s / sec, "attention_launches": launches,
           "plain_attention": dict(plain), "dispatch_rows": rows,
           "decode_max_abs_diff": float((dec - pre).abs().max()),
           "decode_allclose_1e-3": bool(torch.allclose(dec - x64, pre - x64, atol=1e-3,
                                                       rtol=1e-3)),
           "seconds": time.perf_counter() - t0}
    row["ok"] = (launches == 1 and not plain and all(r["path"] == "kernel" for r in rows)
                 and row["decode_allclose_1e-3"])
    out["attention"] = row
    del p, p32, pre, kc, vc, steps, dec
    torch.cuda.empty_cache()

    # ---- one MoE FFN --------------------------------------------------------
    t0 = time.perf_counter()
    p = hybrid._init_ffn(cfg, gen, moe=True)
    sec = time_ms(lambda: hybrid._ffn_apply(cfg, p, x, True), reps=3, warmup=1) / 1e3
    y, aux, y32 = _moe_ffn_vs_float32(cfg, p, x)
    row = {"params": sum(t.numel() for t in p.values()),
           "gb": sum(t.numel() * t.element_size() for t in p.values()) / 1e9,
           "experts": cfg.num_experts, "top_k": cfg.experts_per_token,
           "d_ff": cfg.moe_d_ff, "dispatch": cfg.moe_dispatch,
           "capacity_factor": cfg.capacity_factor, "seconds_per_call": sec,
           "tok_per_s": b * s / sec, "drop_frac": float(aux["moe_drop_frac"]),
           "max_abs_err": float((y - y32).abs().max()), "max_abs_f32": float(y32.abs().max()),
           "rel_l2_err": _rel_l2(y, y32), "seconds": time.perf_counter() - t0}
    row["ok"] = (row["max_abs_err"] <= ATTN_TOL["bfloat16"] * row["max_abs_f32"]
                 and row["rel_l2_err"] <= RECURRENT_REL_L2)
    out["moe_ffn"] = row
    del p, y, y32, aux
    gc.collect()
    torch.cuda.empty_cache()

    # ---- one dense FFN ------------------------------------------------------
    t0 = time.perf_counter()
    p = hybrid._init_ffn(cfg, gen, moe=False)
    sec = time_ms(lambda: hybrid._ffn_apply(cfg, p, x, False), reps=3, warmup=1) / 1e3
    out["dense_ffn"] = {"params": sum(t.numel() for t in p.values()), "d_ff": cfg.d_ff,
                        "seconds_per_call": sec, "tok_per_s": b * s / sec, "ok": True,
                        "seconds": time.perf_counter() - t0}
    del p, x
    torch.cuda.empty_cache()
    return out


def run_lm_hybrid(args, dev, card):
    """The hybrid family: (a) jamba-1.5-large's layer kinds alone at its
    published width (`run_jamba_layers`) and its superblock's size, which
    is why no whole-model phase runs at that width; (b) the reduced jamba
    card against CPU (serving, the loss and gradients through B9's
    forward and backward kernels); (c) `launch.serve` on the reduced
    jamba."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    t_phase = time.perf_counter()
    parts = {}
    t0 = time.perf_counter()
    parts["a"] = {**run_jamba_layers(args, dev, card), "seconds": time.perf_counter() - t0}
    layers_ok = {k: parts["a"][k]["ok"] for k in ("mamba", "attention", "moe_ffn", "dense_ffn")}
    emit({"phase": "lm_hybrid", "part": "a_layers", "card": card, **parts["a"]})
    # why no whole-model jamba runs at the published width on one card
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    emit({"phase": "lm_hybrid", "part": "a_superblock", "card_gb": card_gb,
          **jamba_superblock(get_arch(HYBRID_ARCH, reduced=args.lm_reduced))})
    check(all(layers_ok.values()), f"lm_hybrid (a): layer kinds at full width: {layers_ok}")
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    parts["b"] = {"serving": check_model_serving(dev, args.seed, HYBRID_ARCH),
                  "gradient": check_model_gradient(dev, args.seed, HYBRID_ARCH),
                  "seconds": time.perf_counter() - t0}
    emit({"phase": "lm_hybrid", "part": "b_reduced_card_vs_cpu", **parts["b"]})
    check(parts["b"]["serving"]["ok"] and parts["b"]["gradient"]["ok"],
          f"lm_hybrid (b): the reduced model on the card against the CPU: {parts['b']}")

    t0 = time.perf_counter()
    argv = HYBRID_SERVE_ARGV + ["--seed", str(args.seed), "--device", str(dev)]
    with watch_engine() as seen:
        out = serve.main(argv)
    check(out["completed"] == 16 and out["tokens"] == 16 * 32, f"lm_hybrid serve: {out}")
    check(out["kv_pages_in_use"] == 0 and out["truncated"] == 0, f"lm_hybrid serve: {out}")
    parts["c"] = {"argv": argv, **out, "ticks": seen["ticks"],
                  "ticks_per_s": seen["ticks"] / seen["tick_s"],
                  "seconds": time.perf_counter() - t0}
    emit({"phase": "lm_hybrid", "part": "c_serve", "card": card, **parts["c"]})
    seconds = time.perf_counter() - t_phase
    emit({"phase": "lm_hybrid", "part": "all", "card": card, "seconds": seconds,
          "parts_s": {n: p["seconds"] for n, p in parts.items()}})
    launches = (parts["a"]["attention"]["attention_launches"]
                + parts["b"]["serving"]["attention_launches"]
                + parts["b"]["gradient"]["attention_launches"])
    return {"launches": launches,
            "bwd_launches": parts["b"]["gradient"]["attention_bwd_launches"],
            "parts": parts, "seconds": seconds}


def run_lm_recurrent(args, dev, card):
    """lm_ssm then lm_hybrid, the failover guard around both."""
    guard = start_failover_guard()
    ssm = run_lm_ssm(args, dev, card)
    hyb = run_lm_hybrid(args, dev, card)
    failover_guard("lm_recurrent", guard)
    return {"ssm": ssm, "hybrid": hyb, "launches": hyb["launches"]}


# ---------------------------------------------------------------------------
# lm_multimodal: the vlm (llava-next-mistral-7b) and audio
# (seamless-m4t-large-v2) families
# ---------------------------------------------------------------------------

VLM_ARCH, AUDIO_ARCH = "llava-next-mistral-7b", "seamless-m4t-large-v2"
VLM_CHECK_TAIL = 8               # text tokens decoded after the shortened prompt's prefill
AUDIO_TGT = 256                  # target tokens of seamless's prefill
AUDIO_CHECK_SEQ = 64             # target tokens fed to sequential decode
AUDIO_TRAIN_STEPS = 3            # (e): full-width seamless training steps (the first warms up)
AUDIO_TRAIN_OPT = dict(lr=3e-4, warmup_steps=1, total_steps=8)   # (e), distributed (g)
AUDIO_GRAD_FRAMES = 96           # (d): the reduced seamless's frames under 64 tokens
MULTIMODAL_PREFILLS = 2          # prefill calls a model (the first warms up)
MULTIMODAL_REL_L2 = 1e-2         # bf16 against float32, layer by layer
VLM_SERVE_ARGV = ["--arch", VLM_ARCH] + SERVE_ARGV[2:]
REDUCED_MULTIMODAL_SERVE = {arch: ["--arch", arch, "--reduced"] + SERVE_ARGV[2:]
                            for arch in (VLM_ARCH, AUDIO_ARCH)}


def multimodal_prefill(api, params, batch, calls=MULTIMODAL_PREFILLS):
    """``calls`` prefills of ``batch``, timed each; B9's launches over
    them, the dispatch ledger's attention rows, peak memory."""
    import torch
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_dispatch_stats()
    reset_counts()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        logits, cache = api.prefill(params, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = read_counts()["flash_attention_cuda"]
    rows = [r for r in ops.dispatch_summary()["rows"] if r["op"] == "attention"]
    return logits, cache, times, launches, rows, torch.cuda.max_memory_allocated()


def _check_prefill(cfg, tag, logits, cache, launches, rows, calls, length):
    check(launches == calls * _attention_calls(cfg),
          f"{tag}: {launches} B9 launches in {calls} prefills, want "
          f"{calls} x {_attention_calls(cfg)}")
    check(rows and all(r["path"] == "kernel" for r in rows),
          f"{tag}: prefill reached plain attention: {rows}")
    check(tuple(logits.shape) == (cache["k"].shape[1], cfg.padded_vocab)
          and bool(logits.float().isfinite().all()), f"{tag}: prefill logits")
    check(cache["len"] == length and cache["k"].shape[3] == length, f"{tag}: cache length")


def _agreement(lp, ld):
    """Prefill's last logits against decode's: top-1 and max |Δ| against
    max |logit| (the bf16 bound 0.05 of yi-6b's check), and each row's
    margin between the prefill's two leading logits."""
    lp, ld = lp.float(), ld.float()
    top2 = lp.topk(2, dim=-1).values
    out = {"top1_prefill": lp.argmax(-1).tolist(), "top1_decode": ld.argmax(-1).tolist(),
           "max_abs_diff": float((lp - ld).abs().max()), "max_abs_logit": float(lp.abs().max()),
           "top2_margin": (top2[:, 0] - top2[:, 1]).tolist()}
    out["ok"] = (out["top1_prefill"] == out["top1_decode"]
                 and out["max_abs_diff"] <= 0.05 * out["max_abs_logit"])
    return out


def _prefill_tail_vs_decode(api, params, batch, tail):
    """The whole prompt's prefill logits against the prompt less its last
    ``tail`` text tokens prefilled, then those tokens decoded one at a
    time on the cache padded with headroom; and the cache's length after
    them."""
    import torch
    from repro_torch.models import transformer
    lp, _ = api.prefill(params, batch)
    _, short = api.prefill(params, {**batch, "tokens": batch["tokens"][:, :-tail]})
    full = transformer.extend_cache(short, short["len"] + tail + 8)
    del short
    s = batch["tokens"].shape[1]
    for t in range(s - tail, s):
        ld, full = api.decode(params, full, batch["tokens"][:, t])
    torch.cuda.synchronize()
    return lp, ld, full["len"]


def vlm_layer_bf16(cfg, p, rng, dev, s):
    """One llava layer (attention through B9, then the FFN) in bf16 on 2 x
    ``s`` unit-normal hidden states against the same layer in float32
    (relative L2)."""
    import dataclasses
    import torch
    from repro_torch.models import transformer
    x = torch.as_tensor(rng.standard_normal((2, s, cfg.d_model)), dtype=torch.float32,
                        device=dev).to(torch.bfloat16)
    pos = torch.arange(s, device=dev)
    got = transformer.block_train(cfg, p, x, pos)[0].float()
    want = transformer.block_train(dataclasses.replace(cfg, dtype="float32"),
                                   {n: w.float() for n, w in p.items()}, x.float(), pos)[0]
    out = {"rel_l2_bf16_vs_f32": _rel_l2(got, want)}
    out["ok"] = out["rel_l2_bf16_vs_f32"] <= MULTIMODAL_REL_L2
    return out


def time_cross_attention(dev, seed):
    """(a): B9 at seamless's cross shape (bf16, full mask, 256 queries
    over 3,072 keys), its twin and SDPA (`enable_gqa`, timed only) beside
    the bound; causal at Sq != Sk raises before anything launches, and a
    gradient at Sq != Sk is taken (one forward and one backward launch
    through `FlashAttention`)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    b, hq, hkv, sq, sk, d = ATTN_CROSS_SHAPES[0]
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, hq, sq, d), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((b, hkv, sk, d), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    reset_counts()
    refused = {}
    try:
        flash_attention_cuda(q, k, v, causal=True)
        refused["causal"] = False
    except ValueError:
        refused["causal"] = True
    refused["launches"] = sum(read_counts().values())
    qg = q.clone().requires_grad_(True)
    flash_attention_cuda(qg, k, v, causal=False).sum().backward()
    torch.cuda.synchronize()
    refused["grad_launches"] = {k: v for k, v in read_counts().items() if "attention" in k}
    refused["grad_finite"] = bool(torch.isfinite(qg.grad).all())
    check(refused["causal"] and refused["launches"] == 0,
          f"lm_multimodal (a): causal at Sq != Sk not refused before a launch: {refused}")
    check(refused["grad_launches"] == {"flash_attention_cuda": 1,
                                       "flash_attention_bwd_cuda": 1}
          and refused["grad_finite"],
          f"lm_multimodal (a): a gradient at Sq != Sk did not go through B9: {refused}")
    del qg
    row = {"shape": [b, hq, hkv, sq, sk, d], "dtype": "bfloat16", "causal": False,
           "ms": time_ms(lambda: flash_attention_cuda(q, k, v, causal=False), reps=50),
           "plain_ms": time_ms(lambda: ref.mha_reference(q, k, v, causal=False), reps=10),
           "sdpa_ms": time_ms(lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True),
                              reps=50),
           **attention_bound(b, hq, hkv, sq, d, 2, causal=False, sk=sk), "refused": refused}
    del q, k, v
    torch.cuda.empty_cache()
    return row


def run_vlm(args, dev, card, rng):
    """(b): llava-next-mistral-7b at its published width and depth (bf16,
    random weights from a seeded generator on the card): prefill of 2 x
    (576 image + 3,520 text) tokens, the prompt less its last 8 text
    tokens then 8 decode steps against it, and `launch.serve`."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import get_model
    from repro_torch.train.optimizer import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(VLM_ARCH, reduced=args.lm_reduced)
    b = LM_BATCH
    s_text = (LM_SEQ if not args.lm_reduced else 128) - cfg.frontend_tokens
    out = {}
    t0 = time.perf_counter()
    api = get_model(cfg, dev)
    params = api.init(torch.Generator(device=dev).manual_seed(args.seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = _param_count(params)
    batch = {"tokens": _lm_tokens(rng, cfg, b, s_text, dev),
             **_modality(cfg, rng, b, s_text, dev, torch.bfloat16)}
    logits, cache, times, launches, rows, peak = multimodal_prefill(api, params, batch)
    length = cfg.frontend_tokens + s_text
    _check_prefill(cfg, "lm_multimodal (b)", logits, cache, launches, rows,
                   MULTIMODAL_PREFILLS, length)
    out["prefill"] = {"arch": cfg.name, "params": n_params, "param_gb": 2 * n_params / 1e9,
                      "init_s": init_s, "batch": b, "image_tokens": cfg.frontend_tokens,
                      "text_tokens": s_text, "seq": length, "prefill_s": times,
                      "prefill_tok_per_s": b * length / min(times), "peak_mem_gb": peak / 1e9,
                      "attention_launches": launches, "seconds": time.perf_counter() - t0}
    emit({"phase": "lm_multimodal", "part": "b_vlm_prefill", "card": card, **out["prefill"]})
    del cache

    # The prompt less its last VLM_CHECK_TAIL tokens, then decode, against
    # the whole prompt: in bf16 (max |Δ| <= 0.05 max |logit|, and the same
    # top-1 on each row whose float32 top-2 margin exceeds one bf16
    # rounding of max |logit|: under random weights two leading logits
    # can sit closer, ~0.03 at |logit| 4-8, and then bf16 cannot order
    # them, PERF.md §6), in float32 at full depth (same top-1 on every
    # row, allclose 1e-3), and one layer in bf16 against float32.
    t0 = time.perf_counter()
    tail = VLM_CHECK_TAIL
    lp, ld, n = _prefill_tail_vs_decode(api, params, batch, tail)
    check(n == length, f"lm_multimodal (b): the cache holds {n} positions, want {length}")
    bf16 = {"layers": cfg.num_layers, **_agreement(lp, ld)}
    bf16["ok"] = bf16["max_abs_diff"] <= 0.05 * bf16["max_abs_logit"]
    layer = vlm_layer_bf16(cfg, params["blocks"][0], rng, dev, length)
    launches = read_counts()["flash_attention_cuda"]
    reset_counts()
    params = tree_map(lambda t: t.float(), params)   # float32, 28.5 GB: the bf16 copy goes
    gc.collect()
    torch.cuda.empty_cache()
    api32 = get_model(dataclasses.replace(cfg, dtype="float32"), dev)
    lp, ld, _ = _prefill_tail_vs_decode(api32, params, {**batch, "patches": batch[
        "patches"].float()}, tail)
    f32 = {"layers": cfg.num_layers, **_agreement(lp, ld),
           "allclose_1e-3": bool(torch.allclose(lp, ld, atol=1e-3, rtol=1e-3))}
    f32["ok"] = f32["top1_prefill"] == f32["top1_decode"] and f32["allclose_1e-3"]
    bf16["bf16_rounding"] = 2.0 ** (math.floor(math.log2(bf16["max_abs_logit"])) - 7)
    bf16["top1_rows_held"] = [r for r, m in enumerate(f32["top2_margin"])
                              if m > bf16["bf16_rounding"]]
    bf16["ok"] = bf16["ok"] and all(bf16["top1_prefill"][r] == bf16["top1_decode"][r]
                                    for r in bf16["top1_rows_held"])
    launches += read_counts()["flash_attention_cuda"]
    out["decode"] = {"seq": length, "decoded": tail, "bfloat16": bf16, "float32": f32,
                     "layer0_bf16": layer, "seconds": time.perf_counter() - t0}
    emit({"phase": "lm_multimodal", "part": "b_vlm_prefill_vs_decode", **out["decode"]})
    check(bf16["ok"] and f32["ok"] and layer["ok"],
          f"lm_multimodal (b): llava prefill against {tail} decode steps: {out['decode']}")
    del params, api, api32, batch, logits, lp, ld
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    argv = VLM_SERVE_ARGV + (["--reduced"] if args.lm_reduced else []) + [
        "--seed", str(args.seed), "--device", str(dev)]
    with watch_engine() as seen:
        served = serve.main(argv)
    check(served["completed"] == 16 and served["tokens"] == 16 * 32,
          f"lm_multimodal serve: {served}")
    check(served["kv_pages_in_use"] == 0 and served["truncated"] == 0,
          f"lm_multimodal serve: {served}")
    out["serve"] = {"argv": argv, **served, "ticks": seen["ticks"],
                    "ticks_per_s": seen["ticks"] / seen["tick_s"],
                    "seconds": time.perf_counter() - t0}
    emit({"phase": "lm_multimodal", "part": "b_vlm_serve", "card": card, **out["serve"]})
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


def encdec_layers_bf16(cfg, params, rng, dev, s_src, s_tgt):
    """One encoder layer, and one decoder layer with its cross-attention,
    in bf16 on unit-normal input against the same layer in float32
    (relative L2)."""
    import dataclasses
    import torch
    from repro_torch.models import encdec
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    enc, dec = params["enc"][0], params["dec"][0]
    x = torch.as_tensor(rng.standard_normal((2, s_src, cfg.d_model)), dtype=torch.float32,
                        device=dev).to(torch.bfloat16)
    y = torch.as_tensor(rng.standard_normal((2, s_tgt, cfg.d_model)), dtype=torch.float32,
                        device=dev).to(torch.bfloat16)
    out = {}
    for name, fn, p, args in (
            ("encoder", encdec._enc_block, enc, (x,)),
            ("decoder", encdec._dec_block, dec, (y, x))):
        pos = torch.arange(args[0].shape[1], device=dev)
        got = fn(cfg, p, *args, pos).float()
        want = fn(cfg32, {n: w.float() for n, w in p.items()}, *(a.float() for a in args), pos)
        out[name] = _rel_l2(got, want)
    out["ok"] = max(out.values()) <= MULTIMODAL_REL_L2
    return out


def run_audio(args, dev, card, rng):
    """(c): seamless-m4t-large-v2 at its published width and depth (bf16,
    random weights from a seeded generator on the card): prefill of 2 x
    3,072 frames and 2 x 256 text tokens; prefill against 64 sequential
    decode steps on a cache built from `encode` and `_enc_kv`; one
    encoder layer and one decoder layer in bf16 against float32."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import encdec, get_model, registry
    cfg = get_arch(AUDIO_ARCH, reduced=args.lm_reduced)
    b = LM_BATCH
    src = registry.ENCDEC_DECODE_SRC_LEN if not args.lm_reduced else 96
    tgt = AUDIO_TGT if not args.lm_reduced else 32
    s_check = AUDIO_CHECK_SEQ if not args.lm_reduced else 16
    out = {}
    t0 = time.perf_counter()
    api = get_model(cfg, dev)
    params = api.init(torch.Generator(device=dev).manual_seed(args.seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = _param_count(params)
    batch = {"tokens": _lm_tokens(rng, cfg, b, tgt, dev),
             **_modality(cfg, rng, b, src, dev, torch.bfloat16)}
    logits, cache, times, launches, rows, peak = multimodal_prefill(api, params, batch)
    _check_prefill(cfg, "lm_multimodal (c)", logits, cache, launches, rows,
                   MULTIMODAL_PREFILLS, tgt)
    check(tuple(cache["xk"].shape) == (cfg.num_layers, b, cfg.num_kv_heads, src,
                                       encdec._hd(cfg)), "lm_multimodal (c): cross KV shape")
    out["prefill"] = {"arch": cfg.name, "params": n_params, "param_gb": 2 * n_params / 1e9,
                      "init_s": init_s, "batch": b, "src_frames": src, "tgt_tokens": tgt,
                      "prefill_s": times, "prefill_tok_per_s": b * (src + tgt) / min(times),
                      "peak_mem_gb": peak / 1e9, "attention_launches": launches,
                      "seconds": time.perf_counter() - t0}
    emit({"phase": "lm_multimodal", "part": "c_audio_prefill", "card": card, **out["prefill"]})
    del cache, logits

    t0 = time.perf_counter()
    toks = batch["tokens"][:, :s_check]
    lp, _ = api.prefill(params, {"frames": batch["frames"], "tokens": toks})
    enc_out = encdec.encode(cfg, params, batch["frames"])
    dcache = encdec.init_cache(cfg, b, s_check + 4, src, dev)
    for i, p in enumerate(params["dec"]):
        dcache["xk"][i], dcache["xv"][i] = encdec._enc_kv(cfg, p, enc_out)
    for t in range(s_check):
        ld, dcache = api.decode(params, dcache, toks[:, t])
    torch.cuda.synchronize()
    out["decode"] = {"seq": s_check, "src_frames": src,
                     "layers": cfg.num_encoder_layers + cfg.num_layers,
                     **_agreement(lp, ld), "seconds": time.perf_counter() - t0}
    emit({"phase": "lm_multimodal", "part": "c_audio_prefill_vs_decode", "dtype": "bfloat16",
          **out["decode"]})
    del dcache, enc_out, lp, ld

    t0 = time.perf_counter()
    out["layers_bf16"] = {**encdec_layers_bf16(cfg, params, rng, dev, src, tgt),
                          "seconds": time.perf_counter() - t0}
    emit({"phase": "lm_multimodal", "part": "c_audio_layers_bf16", **out["layers_bf16"]})
    launches = read_counts()["flash_attention_cuda"]
    check(out["decode"]["ok"], f"lm_multimodal (c): seamless prefill against {s_check} "
          f"decode steps: {out['decode']}")
    check(out["layers_bf16"]["ok"], f"lm_multimodal (c): a layer in bf16 against float32: "
          f"{out['layers_bf16']}")
    del params, api, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


def _audio_train_batch(args, cfg, dev):
    """`run_audio_train`'s batch (its tokens and frames from one seeded
    generator), the frames' and the tokens' lengths."""
    import torch
    from repro_torch.models import registry
    src = registry.ENCDEC_DECODE_SRC_LEN if not args.lm_reduced else 96
    tgt = AUDIO_TGT if not args.lm_reduced else 32
    rng = np.random.default_rng((args.seed, 11))
    toks = rng.integers(0, cfg.vocab_size, (LM_BATCH, tgt + 1))
    batch = {"tokens": torch.as_tensor(toks[:, :-1], dtype=torch.int32, device=dev),
             "labels": torch.as_tensor(toks[:, 1:], dtype=torch.int32, device=dev),
             **_modality(cfg, rng, LM_BATCH, src, dev, torch.bfloat16)}
    return batch, src, tgt


def run_audio_train(args, dev, card):
    """(e): one seamless-m4t-large-v2 training step at full width and
    depth (bf16, AdamW, remat as configured) on 2 x (3,072 frames + 256
    tokens), so every cross-attention's backward runs at Sq != Sk: the
    batch goes straight to `api.loss` and `make_train_step` (the
    registry's train spec keeps equal lengths).  A finite loss and
    gradient norm, B9's backward launches (one an attention of a step),
    the step's seconds (median of the steps after the first) and peak
    memory."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import get_model
    from repro_torch.train.optimizer import OptimizerConfig, adamw_init
    from repro_torch.train.train_step import make_train_step
    cfg = get_arch(AUDIO_ARCH, reduced=args.lm_reduced)
    t0 = time.perf_counter()
    api = get_model(cfg, dev)
    params = api.init(torch.Generator(device=dev).manual_seed(args.seed))
    opt = adamw_init(params)
    step = make_train_step(api.loss, OptimizerConfig(**AUDIO_TRAIN_OPT))
    batch, src, tgt = _audio_train_batch(args, cfg, dev)
    b = LM_BATCH
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    init_s = time.perf_counter() - t0
    reset_counts()
    params, opt, rows = _train_steps(step, params, opt, [batch] * AUDIO_TRAIN_STEPS)
    launches = read_counts()
    losses, norms, times = ([r[key] for r in rows] for key in ("loss", "grad_norm", "step_s"))
    out = {"arch": cfg.name, "params": _param_count(params), "batch": b, "src_frames": src,
           "tgt_tokens": tgt, "steps": AUDIO_TRAIN_STEPS, "init_s": init_s,
           "step_s": times, "step_median_s": float(np.median(times[1:])), "losses": losses,
           "grad_norms": norms, "launches": launches,
           "bwd_launches_per_step": launches["flash_attention_bwd_cuda"] / AUDIO_TRAIN_STEPS,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    attn = _attention_calls(cfg)
    out["ok"] = (all(np.isfinite(losses)) and all(np.isfinite(norms))
                 and launches["flash_attention_bwd_cuda"] == attn * AUDIO_TRAIN_STEPS)
    del params, opt, batch, api
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_lm_multimodal(args, dev, card):
    """The vlm and audio families, the failover guard around them: (a)
    B9 at seamless's cross shape timed, causal refused and a gradient
    taken there; (b) llava at full size; (c) seamless at full size; (d)
    the reduced llava and seamless card against CPU and through
    `launch.serve` (seamless's gradient also at Sq != Sk); (e) one
    seamless training step at full size at Sq != Sk; (f) no plain
    attention over (b) and (c).  Each model is released before the
    next."""
    import torch
    from repro_torch.launch import serve
    guard = start_failover_guard()
    t_phase = time.perf_counter()
    rng = np.random.default_rng((args.seed, 8))
    parts = {}
    t0 = time.perf_counter()
    parts["a"] = {**time_cross_attention(dev, args.seed), "seconds": time.perf_counter() - t0}
    emit({"phase": "lm_multimodal", "part": "a_cross_attention_times", "card": card,
          **parts["a"]})

    t0 = time.perf_counter()
    with count_plain_attention() as plain:
        vlm_out, vlm_launches = run_vlm(args, dev, card, rng)
        parts["b"] = {**vlm_out, "seconds": time.perf_counter() - t0}
        t0 = time.perf_counter()
        audio_out, audio_launches = run_audio(args, dev, card, rng)
        parts["c"] = {**audio_out, "seconds": time.perf_counter() - t0}
    parts["f"] = {"plain_attention": dict(plain), "seconds": 0.0}
    emit({"phase": "lm_multimodal", "part": "f_plain_attention", **parts["f"]})
    check(not plain, f"lm_multimodal (f): plain attention ran on the main path: {dict(plain)}")

    t0 = time.perf_counter()
    reduced = {}
    for arch in (VLM_ARCH, AUDIO_ARCH):
        argv = REDUCED_MULTIMODAL_SERVE[arch] + ["--seed", str(args.seed), "--device", str(dev)]
        served = serve.main(argv)
        served_ok = (served["completed"] == 16 and served["tokens"] == 16 * 32
                     and served["kv_pages_in_use"] == 0 and served["truncated"] == 0)
        reduced[arch] = {"serving": check_model_serving(dev, args.seed, arch),
                         "gradient": check_model_gradient(dev, args.seed, arch),
                         "serve": {"argv": argv, **served, "ok": served_ok}}
    # the reduced seamless's gradient at Sq != Sk: 64 tokens over 96 frames
    reduced[AUDIO_ARCH]["gradient_sq_ne_sk"] = check_model_gradient(
        dev, args.seed, AUDIO_ARCH, frames=AUDIO_GRAD_FRAMES)
    parts["d"] = {**reduced, "seconds": time.perf_counter() - t0}
    emit({"phase": "lm_multimodal", "part": "d_reduced_card_vs_cpu", **parts["d"]})
    check(all(r["serving"]["ok"] and r["gradient"]["ok"] and r["serve"]["ok"]
              for r in reduced.values()) and reduced[AUDIO_ARCH]["gradient_sq_ne_sk"]["ok"],
          f"lm_multimodal (d): the reduced models on the card: {reduced}")
    t0 = time.perf_counter()
    parts["e"] = {**run_audio_train(args, dev, card), "seconds": time.perf_counter() - t0}
    emit({"phase": "lm_multimodal", "part": "e_audio_train", "card": card, **parts["e"]})
    check(parts["e"]["ok"], f"lm_multimodal (e): seamless training at Sq != Sk: {parts['e']}")
    seconds = time.perf_counter() - t_phase
    emit({"phase": "lm_multimodal", "part": "all", "card": card, "seconds": seconds,
          "parts_s": {n: p["seconds"] for n, p in parts.items()}})
    failover_guard("lm_multimodal", guard)
    gc.collect()
    torch.cuda.empty_cache()
    launches = (vlm_launches + audio_launches
                + sum(r["serving"]["attention_launches"] + r["gradient"]["attention_launches"]
                      for r in reduced.values()))
    return {"launches": launches, "vlm_launches": vlm_launches,
            "audio_launches": audio_launches,
            "bwd_launches": sum(r["gradient"]["attention_bwd_launches"]
                                for r in reduced.values())
            + reduced[AUDIO_ARCH]["gradient_sq_ne_sk"]["attention_bwd_launches"]
            + parts["e"]["launches"]["flash_attention_bwd_cuda"],
            "audio_train_bwd_launches": parts["e"]["launches"]["flash_attention_bwd_cuda"],
            "cross": parts["a"], "parts": parts, "seconds": seconds}


# ---------------------------------------------------------------------------
# distributed: the mesh, the sharding rules, the int8 all-reduce, the dry run
# ---------------------------------------------------------------------------

# the dry run's cells: (arch, shape, --mesh), each `python -m
# repro_torch.launch.dryrun --subprocess` of its own, started at the top of
# `main` and read back in `run_distributed` (host work beside the card's)
DRYRUN_CELLS = (("yi-6b", "train_4k", "single"), ("jamba-1.5-large-398b", "decode_32k", "multi"))
DRYRUN_OUT = ROOT / "build" / "dryrun"
DRYRUN_TIMEOUT_S = 600
ALLREDUCE_STEPS = 3              # error-feedback steps held to the one-rank identities
ALLREDUCE_TIMED = 5              # calls timed (median)
ALLREDUCE_CPU_LEAVES = ("blocks/0/wq", "blocks/1/w_down", "final_norm")
CARD_BYTES = 80e9                # the card's memory


def start_dryruns():
    """One dry-run process a cell of `DRYRUN_CELLS`, started now; each
    writes its JSON under `DRYRUN_OUT` and its output to a log beside
    it.  Every process is stopped at exit if still running."""
    import atexit
    import os
    DRYRUN_OUT.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for arch, shape, mesh in DRYRUN_CELLS:
        log = open(DRYRUN_OUT / f"{arch}__{shape}__{mesh}.log", "w")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--subprocess",
               "--arch", arch, "--shape", shape, "--mesh", mesh, "--out", str(DRYRUN_OUT)]
        procs.append(((arch, shape, mesh), subprocess.Popen(
            cmd, env=env, stdout=log, stderr=subprocess.STDOUT), time.perf_counter(), log))
    atexit.register(lambda: [p.kill() for _, p, _, _ in procs if p.poll() is None])
    return procs


def collect_dryruns(procs):
    """Each cell's JSON once its process has ended: status, the process's
    seconds and the per-device argument bytes against the card's."""
    out = []
    for (arch, shape, mesh), proc, t0, log in procs:
        try:
            rc = proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        log.close()
        mesh_name = "2x16x16" if mesh == "multi" else "16x16"
        path = DRYRUN_OUT / f"{arch}__{shape}__{mesh_name}.json"
        rec = json.loads(path.read_text()) if path.exists() else {"status": "missing"}
        arg = (rec.get("memory") or {}).get("argument_bytes")
        out.append({"cell": f"{arch}__{shape}__{mesh_name}", "rc": rc,
                    "status": rec.get("status"), "error": rec.get("error"),
                    "wall_s": rec.get("wall_s"), "process_s": time.perf_counter() - t0,
                    "argument_gb_per_device": None if arg is None else arg / 1e9,
                    "output_gb_per_device": None if arg is None
                    else rec["memory"]["output_bytes"] / 1e9
                    if rec["memory"]["output_bytes"] is not None else None,
                    "fits_card": arg is not None and arg < CARD_BYTES,
                    "flops_per_device": rec.get("flops_per_device"),
                    "params": rec.get("params")})
    return out


PARTITIONED_STEPS = 3            # (d): steps of the partitioned path (the first warms up)
PARTITIONED_FAMILY_STEPS = 2     # (e)-(i): 2, not 3: the whole run passed 830 s (PERF.md §5)
PARTITIONED_LOSS_RTOL = 2e-3     # (d)-(i): losses against the plain step's, relative
PARTITIONED_MOE_LAYERS = 4       # (e): olmoe's 16 cut as lm_train cuts: 20 B a parameter (1.78B)
PARTITIONED_VLM_LAYERS = 8       # (f): llava's 32, the same cut (1.90B)
# (h): xlstm-1.3b's 48 layers cut to one superblock (7 mLSTM + 1 sLSTM,
# 0.38B) for time, not memory: its scans are launch-bound Python loops,
# so one microbatch of 2 x 512 tokens (two scan chunks)
PARTITIONED_SSM_LAYERS = 8
PARTITIONED_SSM_SEQ = 512
PARTITIONED_HYBRID_SEQ = 512     # (i): the reduced jamba's step, 2 x 512 in 2 microbatches
PARTITIONED_MIXER_TOL = 2e-2     # (i): the Mamba mixer's bf16 outputs and gradients, x max


def _dtensor_state(api, cfg, mesh, dev, seed):
    """``cfg``'s parameters from ``seed`` and their AdamW state on the
    mesh of one, every leaf made a DTensor by `distribute_tensor` with
    its `NamedSharding`'s placements (the package keeps plain tensors on
    a mesh of one, so the part does it itself)."""
    import torch
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed import sharding as sh
    from repro_torch.train import adamw_init
    with sh.use_mesh(mesh):
        params = api.init(torch.Generator(device=dev).manual_seed(seed))
        psh = sh.param_shardings(params, cfg, mesh)
        params = sh.tree_map_with_path(
            lambda path, x, s: distribute_tensor(x, mesh, s.placements()), params, psh)
        state = adamw_init(params, sh.opt_state_shardings(params, cfg, mesh))
    return params, state


def _train_steps(step_fn, params, state, batches, before=None):
    """``step_fn`` over ``batches``: (params, state, [per-step loss,
    grad norm and wall seconds]); ``before(batch)`` runs ahead of each
    step, outside its time."""
    import torch
    rows = []
    for batch in batches:
        if before is not None:
            before(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, metrics = step_fn(params, state, batch)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        rows.append({"loss": loss, "grad_norm": float(metrics["grad_norm"]),
                     "step_s": time.perf_counter() - t0})
    return params, state, rows


def run_plain_steps(dev, cfg, seed, batches, opt, micro):
    """(e), (f): the plain step (plain card tensors, no mesh) of ``cfg``'s
    model from ``seed`` over ``batches``: per-step loss and seconds, the
    warm median, peak memory; the model released after."""
    import torch
    from repro_torch.models import get_model
    from repro_torch.train import OptimizerConfig, adamw_init, make_train_step
    api = get_model(cfg, dev)
    params = api.init(torch.Generator(device=dev).manual_seed(seed))
    state = adamw_init(params)
    torch.cuda.reset_peak_memory_stats()
    params, state, rows = _train_steps(
        make_train_step(api.loss, OptimizerConfig(**opt), microbatches=micro),
        params, state, batches)
    out = {"per_step": rows, "step_s_median": float(np.median([r["step_s"]
                                                               for r in rows[1:] or rows])),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del params, state, api
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _local_calls(cfg):
    """`sharding.on_local_groups` and `on_local_blocks` calls in one
    training forward: the MoE's dispatch and combine a MoE layer (every
    layer of the moe family, the hybrid's ``i % moe_every == 0``), one
    call a mLSTM or sLSTM layer, two a Mamba mixer (its conv, its
    scan)."""
    from repro_torch.models import hybrid
    if cfg.family == "hybrid":
        per = cfg.attn_period
        n = hybrid._n_super(cfg)
        return (2 * n * sum(hybrid._is_moe(cfg, i) for i in range(per)), 2 * n * (per - 1))
    if cfg.family == "moe":
        return 2 * cfg.num_layers, 0
    return 0, cfg.num_layers if cfg.family == "ssm" else 0


def run_partitioned_steps(dev, mesh, cfg, seed, batches, opt, micro, plain):
    """(d)-(i): ``cfg``'s model from ``seed`` as the partitioned train
    step on the mesh of one (`_dtensor_state`), each batch placed by
    `batch_shardings`'s placements, one step a batch through
    `make_train_step` in ``micro`` microbatches.  Each step's B9
    launches (forward and backward) and `sharding.on_local_heads`,
    `on_local_groups` and `on_local_blocks` calls are counted against
    the model's own (`_attention_calls`, `_local_calls`), the losses held
    to ``plain``'s (the plain step on the same model, seed and batches:
    per-step loss and seconds, warm median, peak memory) within
    PARTITIONED_LOSS_RTOL, bit equality reported."""
    import torch
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import get_model
    from repro_torch.train import OptimizerConfig, make_train_step
    api = get_model(cfg, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state = _dtensor_state(api, cfg, mesh, dev, seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = sh.tree_leaves_with_path((params, state))
    dtensors = sum(sh.is_dtensor(x) for _, x in leaves)
    n_params = _param_count(params)

    calls = {"on_local_heads": 0, "on_local_groups": 0, "on_local_blocks": 0}
    real = {name: getattr(sh, name) for name in calls}

    def counted(name):
        def call(*a, **kw):
            calls[name] += 1
            return real[name](*a, **kw)
        return call

    def placed(batch):
        bsh = sh.batch_shardings(batch, mesh)
        return {k: distribute_tensor(v, mesh, bsh[k].placements()) for k, v in batch.items()}

    def zero(_):
        reset_counts()
        for name in calls:
            calls[name] = 0

    step_fn = make_train_step(api.loss, OptimizerConfig(**opt), microbatches=micro)
    rows, counts = [], []
    torch.cuda.reset_peak_memory_stats()
    for name in calls:
        setattr(sh, name, counted(name))
    try:
        with count_plain_attention() as plain_calls, sh.use_mesh(mesh):
            for batch in map(placed, batches):
                params, state, (row,) = _train_steps(step_fn, params, state, [batch], zero)
                rows.append(row)
                counts.append((read_counts(), dict(calls)))
    finally:
        for name, fn in real.items():
            setattr(sh, name, fn)
    peak = torch.cuda.max_memory_allocated()
    remat = 2 if cfg.remat else 1
    per_bwd = _attention_calls(cfg) * micro
    per_fwd = per_bwd * remat
    per_groups, per_blocks = (n * micro * remat for n in _local_calls(cfg))
    steps = []
    for i, (row, (launches, n_calls)) in enumerate(zip(rows, counts)):
        want = plain["per_step"][i]
        steps.append({"step": i, **row, "loss_plain": want["loss"],
                      "loss_rel_err": abs(row["loss"] - want["loss"]) / abs(want["loss"]),
                      "loss_bits_equal": row["loss"] == want["loss"],
                      "step_s_plain": want["step_s"],
                      "attention_launches": launches["flash_attention_cuda"],
                      "attention_bwd_launches": launches["flash_attention_bwd_cuda"],
                      "local_heads_calls": n_calls["on_local_heads"],
                      "local_group_calls": n_calls["on_local_groups"],
                      "local_block_calls": n_calls["on_local_blocks"],
                      "other_launches": sum(v for k, v in launches.items()
                                            if not k.startswith("flash_attention"))})
    warm = steps[1:] or steps
    out = {"arch": cfg.name, "layers": cfg.num_layers, "params": n_params,
           "global_batch": len(next(iter(batches[0].values()))), "microbatches": micro,
           "batch_shapes": {k: list(v.shape) for k, v in batches[0].items()},
           "steps": len(steps), "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
           "leaves": len(leaves), "dtensor_leaves": dtensors, "init_s": init_s,
           "step_s_median": float(np.median([r["step_s"] for r in warm])),
           "step_s_median_plain": plain["step_s_median"],
           "peak_mem_gb": peak / 1e9, "peak_mem_gb_plain": plain["peak_mem_gb"],
           "want_per_step": {"attention": per_fwd, "attention_bwd": per_bwd,
                             "on_local_heads": per_fwd, "on_local_groups": per_groups,
                             "on_local_blocks": per_blocks},
           "plain_or_library_attention_calls": plain_calls, "per_step": steps,
           "launches": {"flash_attention_cuda": sum(r["attention_launches"] for r in steps),
                        "flash_attention_bwd_cuda": sum(r["attention_bwd_launches"]
                                                        for r in steps)}}
    out["step_ratio_to_plain"] = out["step_s_median"] / out["step_s_median_plain"]
    out["ok"] = (dtensors == len(leaves) and not plain_calls
                 and len(steps) == len(plain["per_step"])
                 and all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
                         and r["loss_rel_err"] <= PARTITIONED_LOSS_RTOL
                         and r["attention_launches"] == per_fwd
                         and r["attention_bwd_launches"] == per_bwd
                         and r["local_heads_calls"] == per_fwd
                         and r["local_group_calls"] == per_groups
                         and r["local_block_calls"] == per_blocks
                         and r["other_launches"] == 0 for r in steps))
    del params, state, api
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _pipeline_batches(dev, cfg, seq, steps):
    """``steps`` batches of TRAIN_BATCH x ``seq`` tokens and labels from
    the launcher's synthetic corpus, on the card."""
    import torch
    from repro_torch.data.pipeline import DataPipeline, make_synthetic_corpus
    corpus = make_synthetic_corpus(total_tokens=TRAIN_CORPUS_TOKENS,
                                   vocab_size=cfg.vocab_size, device=dev)
    pipeline = DataPipeline(corpus, global_batch=TRAIN_BATCH, seq_len=seq)
    return [{k: torch.as_tensor(v, device=dev) for k, v in pipeline.batch_at(step).items()}
            for step in range(steps)]


def run_partitioned_step(args, dev, mesh, trained):
    """(d): lm_train (c)'s model (yi-6b at full width cut to TRAIN_LAYERS,
    the same seed) and batches as the partitioned train step on the mesh
    of one (`run_partitioned_steps`), PARTITIONED_STEPS steps of
    TRAIN_BATCH x TRAIN_SEQ in TRAIN_MICRO microbatches, held to (c)'s
    first ones (``trained``: its per-step rows)."""
    import dataclasses
    from repro_torch.configs import get_arch
    full = get_arch(LM_ARCH, reduced=args.lm_reduced)
    cfg = dataclasses.replace(full, num_layers=min(TRAIN_LAYERS, full.num_layers))
    seq = TRAIN_SEQ if not args.lm_reduced else 64
    batches = _pipeline_batches(dev, cfg, seq, PARTITIONED_STEPS)
    plain = {**trained, "per_step": trained["per_step"][:PARTITIONED_STEPS]}
    return {**run_partitioned_steps(dev, mesh, cfg, args.seed, batches, TRAIN_OPT,
                                    TRAIN_MICRO, plain), "seq": seq}


def run_partitioned_family(args, dev, mesh, arch, layers=None, *, micro=TRAIN_MICRO,
                           seq=TRAIN_SEQ, reduced=False, why="AdamW's 20 B a parameter"):
    """(e), (f), (h), (i): ``arch`` at full width cut to ``layers`` (the
    reduced config with ``reduced``), the plain step first
    (`run_plain_steps`), then the partitioned one on the same model, seed
    and batches: PARTITIONED_FAMILY_STEPS steps of TRAIN_BATCH x ``seq``
    tokens (for the vlm family ``seq`` less its image tokens, each batch
    with `_modality`'s patches) in ``micro`` microbatches; ``why`` says
    why the depth is cut."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    full = get_arch(arch, reduced=args.lm_reduced or reduced)
    cfg = dataclasses.replace(full, num_layers=min(layers or full.num_layers,
                                                   full.num_layers))
    seq = (seq if not args.lm_reduced else 64) - (
        cfg.frontend_tokens if cfg.family == "vlm" else 0)
    rng = np.random.default_rng((args.seed, 12))
    batches = [{**b, **_modality(cfg, rng, TRAIN_BATCH, seq, dev, torch.bfloat16)}
               for b in _pipeline_batches(dev, cfg, seq, PARTITIONED_FAMILY_STEPS)]
    t0 = time.perf_counter()
    plain = run_plain_steps(dev, cfg, args.seed, batches, TRAIN_OPT, micro)
    plain_s = time.perf_counter() - t0
    out = run_partitioned_steps(dev, mesh, cfg, args.seed, batches, TRAIN_OPT, micro, plain)
    return {**out, "text_seq": seq, "plain_s": plain_s,
            "cut": f"{cfg.num_layers} of {full.num_layers} layers: {why}"}


def run_partitioned_mamba(args, dev, mesh):
    """(i) 1: jamba's Mamba mixer alone at its published width (bf16,
    LM_BATCH x RECURRENT_SEQ tokens of unit-normal hidden state and a
    unit-normal upstream gradient), forward and backward as the plain
    mixer and as the partitioned one on the mesh of one (every parameter
    and the input a DTensor placed by the rules; `on_local_blocks`
    counted, 2 a forward: the conv and the scan): the output and the
    input's and every parameter's gradients within PARTITIONED_MIXER_TOL
    x max of the plain ones, bit equality reported, and the seconds of a
    forward and backward on each side (the first call compared, then
    timed)."""
    import torch
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import get_arch
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import mamba
    cfg = get_arch(HYBRID_ARCH, reduced=args.lm_reduced)
    s = RECURRENT_SEQ if not args.lm_reduced else 64
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    p = mamba.init_mamba_params(cfg, gen)
    x = torch.randn((LM_BATCH, s, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    dy = torch.randn(x.shape, generator=gen, device=dev).to(torch.bfloat16)
    names = list(p)

    def fwd_bwd(params, xx, gy):
        live = [t.detach().requires_grad_(True) for t in [xx] + [params[n] for n in names]]
        y = mamba.mamba_train(cfg, dict(zip(names, live[1:])), live[0])
        return [y.detach()] + list(torch.autograd.grad(y, live, gy))

    with sh.use_mesh(mesh):
        psh = sh.param_shardings(p, cfg, mesh)
        pd = {n: distribute_tensor(p[n], mesh, psh[n].placements()) for n in names}
        xsh = sh.batch_shardings({"x": x}, mesh)["x"].placements()
        xd, dyd = (distribute_tensor(t, mesh, xsh) for t in (x, dy))
    calls = [0]
    real = sh.on_local_blocks

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    out = {"d_model": cfg.d_model, "d_inner": mamba._d_inner(cfg), "d_state": cfg.mamba_d_state,
           "batch": LM_BATCH, "seq": s, "params": sum(t.numel() for t in p.values())}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    want = fwd_bwd(p, x, dy)
    torch.cuda.synchronize()
    out["plain_first_s"] = time.perf_counter() - t0
    out["plain_s"] = time_ms(lambda: fwd_bwd(p, x, dy), reps=2, warmup=0) / 1e3
    out["plain_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    sh.on_local_blocks = counted
    try:
        with sh.use_mesh(mesh):
            t0 = time.perf_counter()
            got = [t.full_tensor() for t in fwd_bwd(pd, xd, dyd)]
            torch.cuda.synchronize()
            out["partitioned_first_s"] = time.perf_counter() - t0
            out["local_block_calls"] = calls[0]
            out["partitioned_s"] = time_ms(lambda: fwd_bwd(pd, xd, dyd), reps=2,
                                           warmup=0) / 1e3
    finally:
        sh.on_local_blocks = real
    out["partitioned_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["ratio_to_plain"] = out["partitioned_s"] / out["plain_s"]
    rows = {}
    for name, a, b in zip(["output", "x"] + names, got, want):
        err = float((a.float() - b.float()).abs().max())
        rows[name] = {"max_abs_diff": err, "bits_equal": bool(torch.equal(a, b)),
                      "within_tol": bool(torch.isfinite(a).all())
                      and err <= PARTITIONED_MIXER_TOL * float(b.float().abs().max())}
    out["compared"] = rows
    out["all_bits_equal"] = all(r["bits_equal"] for r in rows.values())
    out["ok"] = out["local_block_calls"] == 2 and all(r["within_tol"] for r in rows.values())
    del p, pd, x, xd, dy, dyd, want, got
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_partitioned_hybrid(args, dev, mesh):
    """(i): jamba-1.5-large-398b, whose superblock does not fit a card:
    its Mamba mixer alone at the published width (`run_partitioned_mamba`),
    then the reduced model's whole partitioned step against its plain step
    (`run_partitioned_family`: the Mamba scans, the attention mixer through
    B9 on local heads, the MoE FFN on local groups and the dense FFN
    together), 2 x PARTITIONED_HYBRID_SEQ tokens in TRAIN_MICRO
    microbatches."""
    mixer = run_partitioned_mamba(args, dev, mesh)
    step = run_partitioned_family(args, dev, mesh, HYBRID_ARCH, micro=TRAIN_MICRO,
                                  seq=PARTITIONED_HYBRID_SEQ, reduced=True,
                                  why="the reduced config (a superblock is 88.33 GB)")
    return {"mamba_mixer": mixer, "step": step, "launches": step["launches"],
            "ok": mixer["ok"] and step["ok"]}


def run_partitioned_audio(args, dev, mesh, audio_train):
    """(g): `run_audio_train`'s model (seamless-m4t-large-v2 at full width
    and depth), seed, batch and optimizer as the partitioned step,
    PARTITIONED_FAMILY_STEPS steps, held to that run's first losses
    (``audio_train``); every cross-attention at Sq != Sk on the local
    heads."""
    from repro_torch.configs import get_arch
    cfg = get_arch(AUDIO_ARCH, reduced=args.lm_reduced)
    batch, src, tgt = _audio_train_batch(args, cfg, dev)
    plain = {"per_step": [{"loss": l, "step_s": t} for l, t in zip(
        audio_train["losses"], audio_train["step_s"])][:PARTITIONED_FAMILY_STEPS],
             "step_s_median": audio_train["step_median_s"],
             "peak_mem_gb": audio_train["peak_mem_gb"]}
    out = run_partitioned_steps(dev, mesh, cfg, args.seed, [batch] * PARTITIONED_FAMILY_STEPS,
                                AUDIO_TRAIN_OPT, 1, plain)
    return {**out, "src_frames": src, "tgt_tokens": tgt}


def _bits_equal(a, b) -> bool:
    """Whether two float32 tensors hold the same bits."""
    import torch
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def run_distributed(args, dev, card, dryruns, trained, audio_train):
    """The distributed phase, the failover guard after it: (a)
    `make_host_mesh(1)` on the card (an NCCL world of one) and yi-6b's
    full-width training state cut to TRAIN_LAYERS layers (the cut of
    `lm_train`'s (c)) placed through `param_shardings`,
    `opt_state_shardings` and `device_put`: every leaf stays the same
    plain card tensor; (b) `make_compressed_allreduce` over NCCL on a
    float32 gradient tree of that model with its error state, for
    ALLREDUCE_STEPS steps of error feedback: on one rank the output is
    dequantize(quantize(g + err)) and the residual g + err less it, bit
    for bit, and ALLREDUCE_CPU_LEAVES equal the same call on the CPU;
    then ALLREDUCE_TIMED calls timed beside one pass over g, err, the
    output and the residual at the memory rate; (c) the dry-run cells
    started at the top of `main`, each ``ok`` with its per-device
    argument bytes under the card's; (d) `run_partitioned_step` on the
    mesh against ``trained`` (lm_train (c)'s result); (e) olmoe-1b-7b
    and (f) llava-next-mistral-7b at full width cut in depth
    (`run_partitioned_family`), each against its own plain step; (g)
    seamless-m4t-large-v2 at full size against ``audio_train``
    (lm_multimodal (e)'s result, `run_partitioned_audio`); (h)
    xlstm-1.3b at full width cut to one superblock of
    PARTITIONED_SSM_LAYERS (the scans are launch-bound loops: a cut for
    time), 2 x PARTITIONED_SSM_SEQ tokens in one microbatch, against its
    own plain step (`run_partitioned_family`); (i) jamba-1.5-large-398b:
    its Mamba mixer at the published width, partitioned against plain,
    and the reduced model's whole step against its plain step
    (`run_partitioned_hybrid`); (j) the process group destroyed."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_model
    from repro_torch.train.optimizer import adamw_init
    t_phase = time.perf_counter()
    parts = {}

    t0 = time.perf_counter()
    mesh = make_host_mesh(1, dev)
    full = get_arch(LM_ARCH, reduced=args.lm_reduced)
    cfg = dataclasses.replace(full, num_layers=min(TRAIN_LAYERS, full.num_layers))
    params = get_model(cfg, dev).init(torch.Generator(device=dev).manual_seed(args.seed))
    opt = adamw_init(params)
    with sh.use_mesh(mesh):
        psh = sh.param_shardings(params, cfg, mesh)
        osh = sh.opt_state_shardings(opt, cfg, mesh)
        placed = sh.device_put((params, opt), (psh, osh))
    torch.cuda.synchronize()
    leaves = sh.tree_leaves_with_path((params, opt))
    got = sh.tree_leaves_with_path(placed)
    specs = [s.spec for _, s in sh.tree_leaves_with_path((psh, osh))]
    same = sum(a is b for (_, a), (_, b) in zip(leaves, got))
    plain = sum(type(b) is torch.Tensor and b.device.type == dev.type for _, b in got)
    parts["a"] = {"backend": dist.get_backend(), "world": dist.get_world_size(),
                  "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
                  "layers": cfg.num_layers, "params": _param_count(params),
                  "leaves": len(leaves), "same_tensor": same, "plain_card_tensors": plain,
                  "sharded_specs": sum(any(p is not None for p in s) for s in specs),
                  "seconds": time.perf_counter() - t0}
    parts["a"]["ok"] = same == plain == len(leaves) and parts["a"]["world"] == 1
    emit({"phase": "distributed", "part": "a_mesh_and_placement", **parts["a"]})
    check(parts["a"]["ok"], f"distributed (a): placement on a mesh of one: {parts['a']}")
    shapes = [(path, tuple(x.shape)) for path, x in sh.tree_leaves_with_path(params)]
    del params, opt, placed, leaves, got, psh, osh
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev).manual_seed(args.seed + 7)
    grads = {path: torch.randn(shape, generator=g, device=dev) for path, shape in shapes}
    err = col.init_error_state(grads)
    reduce_fn = col.make_compressed_allreduce(mesh)
    n_floats = sum(math.prod(shape) for _, shape in shapes)
    identities = True
    cpu_equal = {}
    for step in range(ALLREDUCE_STEPS):
        out, new_err = reduce_fn(grads, err)
        for path in grads:
            xf = grads[path] + err[path]
            q, scale = col.quantize_int8(xf)
            identities &= _bits_equal(out[path], col.dequantize_int8(q, scale))
            identities &= _bits_equal(new_err[path], xf - out[path])
            del xf, q, scale
        if step == ALLREDUCE_STEPS - 1:
            for path in ALLREDUCE_CPU_LEAVES:
                o, e = col.compressed_psum_leaf(grads[path].cpu(), err[path].cpu(), ())
                cpu_equal[path] = (_bits_equal(o, out[path].cpu())
                                   and _bits_equal(e, new_err[path].cpu()))
        err = new_err
        del out
    torch.cuda.synchronize()
    ms = [time_ms(lambda: reduce_fn(grads, err), reps=1, warmup=0)
          for _ in range(ALLREDUCE_TIMED)]
    moved = 4 * 4 * n_floats   # g and err read, the output and the residual written
    parts["b"] = {"leaves": len(shapes), "floats": n_floats, "grad_gb": 4 * n_floats / 1e9,
                  "steps": ALLREDUCE_STEPS, "identities_bit_equal": bool(identities),
                  "cpu_leaves_bit_equal": cpu_equal, "ms": ms,
                  "median_ms": float(np.median(ms)), "bytes": moved,
                  "stream_ms": moved / HBM_BYTES_PER_S * 1e3,
                  "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                  "seconds": time.perf_counter() - t0}
    parts["b"]["ok"] = identities and len(cpu_equal) == 3 and all(cpu_equal.values())
    emit({"phase": "distributed", "part": "b_compressed_allreduce", "card": card,
          **parts["b"]})
    check(parts["b"]["ok"], f"distributed (b): the int8 all-reduce on one rank: {parts['b']}")
    del grads, err, new_err
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cells = collect_dryruns(dryruns)
    parts["c"] = {"cells": cells, "wait_s": time.perf_counter() - t0,
                  "seconds": time.perf_counter() - t0}
    emit({"phase": "distributed", "part": "c_dryrun", **parts["c"]})
    check(all(c["status"] == "ok" and c["rc"] == 0 and c["fits_card"] for c in cells),
          f"distributed (c): the dry-run cells: {cells}")

    partitioned = (
        ("d", "d_partitioned_step", lambda: run_partitioned_step(args, dev, mesh, trained)),
        ("e", "e_partitioned_moe", lambda: run_partitioned_family(
            args, dev, mesh, MOE_ARCH, PARTITIONED_MOE_LAYERS)),
        ("f", "f_partitioned_vlm", lambda: run_partitioned_family(
            args, dev, mesh, VLM_ARCH, PARTITIONED_VLM_LAYERS)),
        ("g", "g_partitioned_audio", lambda: run_partitioned_audio(
            args, dev, mesh, audio_train)),
        ("h", "h_partitioned_ssm", lambda: run_partitioned_family(
            args, dev, mesh, SSM_ARCH, PARTITIONED_SSM_LAYERS, micro=1,
            seq=PARTITIONED_SSM_SEQ, why="time: its scans are launch-bound loops")),
        ("i", "i_partitioned_hybrid", lambda: run_partitioned_hybrid(args, dev, mesh)))
    for name, label, run in partitioned:
        t0 = time.perf_counter()
        parts[name] = run()
        parts[name]["seconds"] = time.perf_counter() - t0
        emit({"phase": "distributed", "part": label, "card": card, **parts[name]})
        check(parts[name]["ok"],
              f"distributed ({name}): the partitioned step on the mesh: {parts[name]}")

    dist.destroy_process_group()
    parts["j"] = {"group_destroyed": not dist.is_initialized(), "seconds": 0.0}
    check(parts["j"]["group_destroyed"], "distributed (j): the process group outlived the phase")
    seconds = time.perf_counter() - t_phase
    emit({"phase": "distributed", "part": "all", "card": card, "seconds": seconds,
          "parts_s": {n: p["seconds"] for n, p in parts.items()}})
    launches = {k: sum(parts[n]["launches"][k] for n, _, _ in partitioned)
                for k in ("flash_attention_cuda", "flash_attention_bwd_cuda")}
    return {"parts": parts, "seconds": seconds, "launches": launches}


def reset_counts():
    from repro_torch.kernels import (bloom_probe, flash_attention, hash_probe, rmi_lookup,
                                     rmi_scan)
    for m in (rmi_lookup, rmi_scan, hash_probe, bloom_probe, flash_attention):
        m.reset_launch_counts()


def read_counts():
    from repro_torch.kernels import (bloom_probe, flash_attention, hash_probe, rmi_lookup,
                                     rmi_scan)
    return {**rmi_lookup.LAUNCHES, **rmi_scan.LAUNCHES, **hash_probe.LAUNCHES,
            **bloom_probe.LAUNCHES, **flash_attention.LAUNCHES}


FAILOVER_COUNTERS = ("kernel_failover", "kernel_failover.errors", "kernel_failover.recoveries")


def failover_counters():
    from repro_torch.obs.metrics import default_registry
    reg = default_registry()
    return {k: int(reg.counter(k).value) for k in FAILOVER_COUNTERS}


def start_failover_guard():
    """Forget every sticky reroute before a main path; returns the
    counters to hold the path's own against."""
    from repro_torch.kernels import ops
    ops.reset_failover()
    return failover_counters()


def failover_guard(path, start):
    """After a main path: its `failover_summary()` and the three
    counters.  A kernel that raised even once on the path (an error, a
    disabled pair) fails the run, so no kernel passes behind its twin."""
    from repro_torch.kernels import ops
    now = failover_counters()
    delta = {k: now[k] - start[k] for k in FAILOVER_COUNTERS}
    summary = ops.failover_summary()
    emit({"phase": "failover_guard", "path": path, "summary": summary, "counters": delta})
    check(not any(r["disabled"] for r in summary.values()),
          f"{path}: a kernel pair was rerouted to its plain twin: {summary}")
    check(delta["kernel_failover.errors"] == 0 and delta["kernel_failover"] == 0,
          f"{path}: a kernel raised on the main path: {delta}")
    return {"summary": summary, "counters": delta}


def check_injected_failover(svc, q, launch, tag):
    """Two injected ``kernel.dispatch`` faults on a warm kernel path: the
    attempt and its retry fail, the pair reroutes to its plain twin with
    bit-identical answers and no launch, and the 64th call since the
    failover re-probes the kernel, recovers and launches it again."""
    import torch
    from repro_torch import faults
    from repro_torch.kernels import ops, rmi_lookup

    start = start_failover_guard()
    want_get, want_rank = svc.get(q), svc.lookup_batch(q)
    n0 = rmi_lookup.LAUNCHES[launch]
    with faults.inject(faults.FaultSchedule({"kernel.dispatch": 2})) as sched:
        got_get = svc.get(q)
    check(sched.fired["kernel.dispatch"] == 2, f"{tag}: the faults did not fire")
    summary = ops.failover_summary()
    check([r["disabled"] for r in summary.values()] == [True], f"{tag}: no reroute: {summary}")
    check(all(np.array_equal(a, b) for a, b in zip(got_get, want_get)),
          f"{tag}: rerouted get != the kernel's")
    rerouted = []
    for _ in range(ops.FAILOVER_REPROBE_EVERY):
        rerouted.append(rmi_lookup.LAUNCHES[launch] - n0)
        check(torch.equal(svc.lookup_batch(q), want_rank), f"{tag}: rerouted lookup_batch")
    after = {k: v - start[k] for k, v in failover_counters().items()}
    relaunched = rmi_lookup.LAUNCHES[launch] - n0
    check(after == {"kernel_failover": 1, "kernel_failover.errors": 2,
                    "kernel_failover.recoveries": 1}, f"{tag}: counters {after}")
    check(rerouted == [0] * ops.FAILOVER_REPROBE_EVERY and relaunched == 1,
          f"{tag}: launches while rerouted {rerouted}, after {relaunched}")
    check(not any(r["disabled"] for r in ops.failover_summary().values()),
          f"{tag}: the re-probe did not re-enable the kernel")
    ops.reset_failover()
    check(faults.active() is None, f"{tag}: a fault schedule left in force")
    return {"pair": next(iter(summary)), "counters": after, "queries": int(q.size),
            "launches_while_rerouted": rerouted[-1], "launches_after_reprobe": relaunched}


def run_failover_injected(dev):
    """Phase 2's failover check on n = 50k keys: B1 through the
    `cuda_fused` service, then B4 through the K = 4 `sharded_fused` one."""
    from repro_torch.data import gen_maps
    from repro_torch.index_service import IndexService, ServiceConfig, ShardedIndexService

    t0 = time.perf_counter()
    rng = np.random.default_rng(5)
    base = gen_maps(SMALL_N, seed=5)
    ins = _absent(base, rng.uniform(base[0], base[-1], 2_000))
    dels = rng.choice(base, 1_000, replace=False)
    q = np.concatenate([rng.choice(base, 20_000), ins[:2_000], dels,
                        rng.uniform(base[0] - 1, base[-1] + 1, 2_000)])
    out = {}
    for tag, svc, launch in (
            ("cuda_fused", IndexService(base, ServiceConfig(strategy="cuda_fused"), device=dev),
             "rmi_merged_lookup_cuda"),
            ("sharded_fused", ShardedIndexService(base, ServiceConfig(
                num_shards=4, strategy="sharded_fused"), device=dev),
             "rmi_sharded_merged_lookup_cuda")):
        svc.insert(ins)
        svc.delete(dels)
        out[tag] = check_injected_failover(svc, q, launch, tag)
    out["seconds"] = time.perf_counter() - t0
    return out


FRONTEND_TENANTS = 8
FRONTEND_WRITE_REQUESTS = 20    # per tenant, before the window: reads, ranges, own writes
FRONTEND_READS = 1_000          # per tenant, in the timed read window
FRONTEND_SCAN_ROWS = 10_000
FRONTEND_READ_KINDS = ("get", "contains", "range", "scan")


def _point_keys(rng, raw):
    q = raw[rng.integers(0, raw.size, rng.integers(1, 65))]
    q[::2] += rng.uniform(-1e-7, 1e-7, q[::2].size)  # mostly absent
    return q


def _key_range(rng, raw):
    w = int(rng.integers(1, FRONTEND_SCAN_ROWS + 1))
    i = int(rng.integers(0, raw.size - w))
    return raw[i], raw[i + w]


def _tenant_writes(seed, t, raw, top):
    """Tenant ``t``'s seeded requests before the window: point reads of
    1-64 keys, ranges, and inserts and deletes of keys of its own, each
    followed by a read of them.  Its own keys lie in a band above every
    stored key, so they move no rank, row or membership of the base
    range."""
    rng = np.random.default_rng((seed, t, 0))
    band = top + 10.0 * (t + 1) + 1e-3 * np.arange(FRONTEND_WRITE_REQUESTS * 4)
    used = 0
    reqs = []
    for _ in range(FRONTEND_WRITE_REQUESTS):
        kind = ("get", "contains", "range", "insert", "delete")[rng.integers(0, 5)]
        if kind in ("get", "contains"):
            reqs.append((kind, (_point_keys(rng, raw),)))
        elif kind == "insert":
            keys = band[used: used + 4]
            used += 4
            reqs.append(("insert", (keys, np.arange(4, dtype=np.int64) + t)))
            reqs.append(("get", (keys,)))
        elif kind == "delete" and used:
            keys = band[max(0, used - 6): used]
            reqs.append(("delete", (keys,)))
            reqs.append(("contains", (keys,)))
        elif kind == "range":
            reqs.append(("range", _key_range(rng, raw)))
    return reqs


def _tenant_reads(seed, t, raw):
    """Tenant ``t``'s seeded read window: `FRONTEND_READS` requests, each
    kind of `FRONTEND_READ_KINDS` drawn evenly, over the base range."""
    rng = np.random.default_rng((seed, t, 1))
    reqs = []
    for k in rng.integers(0, len(FRONTEND_READ_KINDS), FRONTEND_READS):
        kind = FRONTEND_READ_KINDS[k]
        reqs.append((kind, (_point_keys(rng, raw),) if kind in ("get", "contains")
                     else _key_range(rng, raw)))
    return reqs


def _run_tenants(fe, scripts):
    """Every tenant's script on its own thread through the started
    ``fe``, each request timed on the client from call to answer.
    Returns (answers per tenant as (kind, args, got, seconds), wall s)."""
    import threading

    answers = [[] for _ in scripts]
    errors = []
    barrier = threading.Barrier(len(scripts))

    def client(t):
        name = f"tenant{t}"
        call = {"get": fe.get, "contains": fe.contains, "insert": fe.insert,
                "delete": fe.delete, "range": fe.range_lookup, "scan": fe.scan}
        try:
            barrier.wait(60)
            for kind, args in scripts[t]:
                t1 = time.perf_counter()
                got = call[kind](name, *args, timeout=120)
                answers[t].append((kind, args, got, time.perf_counter() - t1))
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append((t, repr(e)))
            barrier.abort()

    threads = [threading.Thread(target=client, args=(t,)) for t in range(len(scripts))]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
    wall = time.perf_counter() - t0
    check(not any(th.is_alive() for th in threads), "frontend: a tenant thread hung")
    check(not errors, f"frontend: {errors[:3]}")
    return answers, wall


def run_frontend(svc, rng, dev, card):
    """Eight tenant threads through a started `IndexFrontend` over the
    (compacted) single service, every answer held against NumPy: first
    their own writes with reads of them; then the first scan after those
    writes, whose scan-slab rebuild is timed as the stall it is; then a
    timed window of `FRONTEND_READS` reads a tenant through a fresh
    frontend, its latencies taken over every request of the window; then
    one `pump()` round on this thread with mixed kinds, one dispatch per
    read kind."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve import FrontendConfig, IndexFrontend

    snap = svc._mgr.current()
    raw, n = snap.keys.raw, snap.n
    check(len(svc._active) == 0 and svc.num_delta_levels == 0,
          "frontend: the service must start compacted")
    state = ScanState(snap, np.empty(0), np.empty(0, np.int64), np.empty(0))
    top = float(raw[-1])
    seed = int(rng.integers(1 << 31))
    cfg = FrontendConfig(max_queue=1024, scan_page_size=256)
    checked = dict.fromkeys(("get", "contains", "range", "scan", "insert", "delete"), 0)
    others_max = FRONTEND_WRITE_REQUESTS * 4 * FRONTEND_TENANTS

    def hold(t, own, kind, args, got):
        """One answer against the oracle: base ranks and rows are the
        snapshot's; tenant ``t``'s band holds ``own``."""
        checked[kind] += 1
        if kind == "insert":
            own.update(args[0].tolist())
            check(got == args[0].size, f"frontend/{t}: insert ack {got}")
        elif kind == "delete":
            own.difference_update(args[0].tolist())
            check(got == args[0].size, f"frontend/{t}: delete ack {got}")
        elif kind in ("get", "contains"):
            q = args[0]
            mine = q > top + 5.0   # the bands start at top + 10
            base_live = np.zeros(q.size, bool)
            i = np.clip(np.searchsorted(raw, q), 0, n - 1)
            base_live[~mine] = raw[i[~mine]] == q[~mine]
            live = base_live | np.isin(q, np.fromiter(own, float, len(own)))
            if kind == "contains":
                check(bool(np.array_equal(got, live)), f"frontend/{t}: contains")
                return
            rank, found = got
            check(bool(np.array_equal(found, live)), f"frontend/{t}: get presence")
            check(bool(np.array_equal(rank[~mine], np.searchsorted(raw, q[~mine]))),
                  f"frontend/{t}: get ranks")
            below = np.searchsorted(np.sort(np.fromiter(own, float, len(own))), q[mine])
            r = rank[mine] - n
            check(bool(((r >= below) & (r <= below + others_max)).all()),
                  f"frontend/{t}: own-key ranks")
        elif kind == "range":
            check(got == tuple(int(x) for x in np.searchsorted(raw, args)),
                  f"frontend/{t}: range_lookup")
        else:
            keys, vals, live = (x.cpu().numpy() for x in got)
            lo_n, hi_n = (np.float32(x) for x in snap.keys.normalize(np.array(args)))
            want_k, want_v, _ = state.rows_f32(lo_n, hi_n)
            m = live.ravel()
            check(bool(np.array_equal(keys.ravel()[m], want_k)
                       and np.array_equal(vals.ravel()[m], want_v.astype(np.int32))),
                  f"frontend/{t}: scan rows")

    def summary_of(fe, answers):
        summary = fe.serving_summary()
        check(summary["requests"] == sum(map(len, answers)) and summary["rejected"] == 0
              and summary["shed_writes"] == 0 and summary["deadline_exceeded"] == 0,
              f"frontend: {summary}")
        check(all(r["errors"] == 0 for r in summary["tenants"].values()),
              "frontend: tenant errors")
        return summary

    # 1. each tenant's own writes, read back (no scans: the slab stays)
    fe = IndexFrontend(svc, cfg)
    with fe:
        writes, writes_wall = _run_tenants(
            fe, [_tenant_writes(seed, t, raw, top) for t in range(FRONTEND_TENANTS)])
        owns = [set() for _ in writes]
        for t, rows in enumerate(writes):
            for kind, args, got, _ in rows:
                hold(t, owns[t], kind, args, got)
        writes_summary = summary_of(fe, writes)
        # 2. the stall: the first scan after writes rebuilds the scan slab
        lo, hi = _key_range(rng, raw)
        t0 = time.perf_counter()
        got = fe.scan("stall", lo, hi, timeout=120)
        stall_s = time.perf_counter() - t0
        hold(-1, set(), "scan", (lo, hi), got)

    # 3. the timed read window, through a fresh frontend (its own registries)
    fe = IndexFrontend(svc, cfg)
    with fe:
        reads, wall = _run_tenants(
            fe, [_tenant_reads(seed, t, raw) for t in range(FRONTEND_TENANTS)])
        for t, rows in enumerate(reads):
            for kind, args, got, _ in rows:
                hold(t, owns[t], kind, args, got)
        summary = summary_of(fe, reads)
    rounds = summary["rounds"]
    secs = {k: np.array([s for rows in reads for kind, _, _, s in rows if kind == k])
            for k in FRONTEND_READ_KINDS}
    secs["all"] = np.concatenate([secs[k] for k in FRONTEND_READ_KINDS])
    latency = {k: {"count": int(v.size), "p50_ms": float(np.percentile(v, 50) * 1e3),
                   "p99_ms": float(np.percentile(v, 99) * 1e3),
                   "max_ms": float(v.max() * 1e3), "mean_ms": float(v.mean() * 1e3)}
               for k, v in secs.items()}

    # 4. one round on this thread: one dispatch per read kind
    top_keys = top + 1000.0 + np.arange(3.0)
    reqs = [fe.submit(f"g{c}", "get", raw[rng.integers(0, n, 8)]) for c in range(8)]
    reqs += [fe.submit(f"c{c}", "contains", raw[rng.integers(0, n, 4)]) for c in range(6)]
    reqs += [fe.submit("r", "range", raw[100], raw[5000]),
             fe.submit("s", "scan", raw[200], raw[3000], 256),
             fe.submit("w", "insert", top_keys, np.zeros(3, np.int64))]
    fe.pump()   # warm: the insert moved the delta, so the scan slab rebuilds here
    reqs = [fe.submit(f"g{c}", "get", raw[rng.integers(0, n, 8)]) for c in range(8)]
    reqs += [fe.submit(f"c{c}", "contains", raw[rng.integers(0, n, 4)]) for c in range(6)]
    reqs += [fe.submit("r", "range", raw[100], raw[5000]),
             fe.submit("s", "scan", raw[200], raw[3000], 256)]
    with ops.count_dispatches() as nd:
        check(fe.pump() == len(reqs), "frontend: pump served a partial round")
        dispatches = nd()
    for r in reqs:
        r.wait(10)
    check(dispatches == 4, f"frontend: {len(reqs)} requests of 4 read kinds took "
                           f"{dispatches} dispatches")
    svc.delete(top_keys)
    torch.cuda.synchronize()
    return {"card": card, "tenants": FRONTEND_TENANTS, "checked": checked,
            "writes": {"requests": writes_summary["requests"],
                       "rounds": writes_summary["rounds"], "wall_s": writes_wall},
            "stall_scan_s": stall_s,
            "window": {"requests": summary["requests"], "rounds": rounds, "wall_s": wall,
                       "rounds_per_s": rounds / wall,
                       "requests_per_s": summary["requests"] / wall,
                       "latency_ms": latency,
                       "frontend_read_p99_ms": summary["read_p99_ms"]},
            "pump_round": {"requests": len(reqs), "read_kinds": 4, "dispatches": dispatches}}


# ---------------------------------------------------------------------------
# the paper's other structures (plain torch on the card): the B-Tree over
# the main path's key set, string keys, the learned Bloom filter, LIF, the
# data pipeline's document lookup and `launch.serve --prefix-bloom`
# ---------------------------------------------------------------------------

BTREE_QUERIES = 1 << 20          # stored, and absent, queries per page size
PAPER_WEBDOCS = 100_000          # gen_webdocs strings of the string index
STRING_LEN = 16                  # bytes a string is tokenized to
STRING_HIDDEN = ((), (8,))
STRING_STRATEGIES = ("binary", "biased", "quaternary")
PAPER_URLS = (4_000, 12_000)     # gen_urls keys, non-keys of the learned Bloom
GRU_STEPS = 600
BLOOM_TARGET_FPR = 0.01
BLOOM_MAX_FPR = 0.05             # the reference test's bound on the held-out FPR
LIF_KEYS = 1_000_000             # gen_maps keys LIF synthesizes over
LIF_GRID = {"num_leaves": (10_000, 50_000), "stage0_hidden": ((), (16, 16))}
PIPELINE_TOKENS = (10_000_000, 1_000_000_000)
PIPELINE_OFFSETS = 1 << 20
# tests/test_system.py:66-69, the reference's --prefix-bloom run
PREFIX_BLOOM_ARGV = ["--arch", "yi-6b", "--reduced", "--requests", "3", "--max-new", "4",
                     "--batch-slots", "3", "--max-len", "32", "--prefix-bloom"]


def run_btree(ks, keys_t, index, rng, dev, card):
    """Every `BTREE_PAGE_SIZES` page size over the service's float32 key
    set (``keys_t`` is the snapshot's own device copy), held to
    ``np.searchsorted`` on stored and absent queries, timed with CUDA
    events, its size beside the RMI's."""
    import torch
    from repro_torch.configs.learned_index import BTREE_PAGE_SIZES
    from repro_torch.core.btree import btree_lookup, build_btree

    t0 = time.perf_counter()
    norm = ks.norm
    stored = norm[rng.choice(ks.n, BTREE_QUERIES)]
    absent = ks.normalize(f32_absent_queries(ks, rng, BTREE_QUERIES))
    sets = {name: (torch.as_tensor(q, device=dev), np.searchsorted(norm, q, side="left"))
            for name, q in (("stored", stored), ("absent", absent))}
    rows = []
    for page in BTREE_PAGE_SIZES:
        bt = build_btree(norm, page)
        levels = bt.as_tree(dev)
        row = {"page": page, "depth": bt.depth, "size_bytes": bt.size_bytes}
        for name, (qt, want) in sets.items():
            got = btree_lookup(levels, keys_t, qt, page).cpu().numpy()
            row[f"{name}_mismatches"] = int((got != want).sum())
            check(row[f"{name}_mismatches"] == 0,
                  f"btree page {page}: {name} queries off np.searchsorted")
            row[f"{name}_ms"] = time_ms(lambda: btree_lookup(levels, keys_t, qt, page),
                                        reps=5, warmup=1)
        rows.append(row)
        del levels
    out = {"phase": "paper_structures", "part": "btree", "card": card, "n": int(ks.n),
           "queries": {k: int(v[0].numel()) for k, v in sets.items()},
           "rmi_model_size_bytes": index.model_size_bytes, "rows": rows,
           "seconds": time.perf_counter() - t0}
    emit(out)
    return out


def run_strings(args, dev, card):
    """The §3.5 string index over gen_webdocs at `STRING_LEN` bytes: a
    linear and an (8,) stage-0, every stored string at its position under
    the three strategies."""
    import torch
    from repro_torch.core import (RMIConfig, build_rmi, compile_string_lookup,
                                  make_vector_keyset, tokenize)
    from repro_torch.data import gen_webdocs

    t0 = time.perf_counter()
    vks = make_vector_keyset(tokenize(gen_webdocs(PAPER_WEBDOCS, seed=args.seed), STRING_LEN))
    gen_s = time.perf_counter() - t0
    q = torch.as_tensor(vks.raw, device=dev)
    want = np.arange(vks.n)
    rows = []
    for hidden in STRING_HIDDEN:
        t1 = time.perf_counter()
        idx = build_rmi(vks, RMIConfig(num_leaves=max(64, vks.n // 20), stage0_hidden=hidden,
                                       stage0_train_steps=250, seed=args.seed), device=dev)
        row = {"hidden": list(hidden), "num_leaves": idx.num_leaves,
               "max_window": idx.max_window, "model_size_bytes": idx.model_size_bytes,
               "build_s": time.perf_counter() - t1}
        for strategy in STRING_STRATEGIES:
            lookup = compile_string_lookup(idx, vks, strategy, device=dev)
            bad = int((lookup(q).cpu().numpy() != want).sum())
            check(bad == 0, f"strings {hidden} {strategy}: {bad} stored strings off")
            row[strategy] = {"mismatches": bad, "ms": time_ms(lambda: lookup(q), reps=5)}
        rows.append(row)
    out = {"phase": "paper_structures", "part": "strings", "card": card, "n": vks.n,
           "max_len": STRING_LEN, "gen_s": gen_s, "rows": rows,
           "seconds": time.perf_counter() - t0}
    emit(out)
    return out


def run_learned_bloom(args, dev, card):
    """The §5.1 learned Bloom filter with the paper's GRU (E 32, W 16)
    over gen_urls: no false negative, the held-out FPR within
    `BLOOM_MAX_FPR`, sizes beside a plain Bloom filter at the target
    FPR."""
    from repro_torch.core import GRUSpec, build_bloom, build_learned_bloom
    from repro_torch.core.bloom import string_hash_u64
    from repro_torch.data import gen_urls

    t0 = time.perf_counter()
    keys, nonkeys = gen_urls(*PAPER_URLS, seed=args.seed)
    gen_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    lb = build_learned_bloom(keys, nonkeys, target_fpr=BLOOM_TARGET_FPR, spec=GRUSpec(),
                             train_steps=GRU_STEPS, seed=args.seed, device=dev)
    build_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    fn = int((~lb.contains(keys)).sum())
    contains_s = time.perf_counter() - t1
    check(fn == 0, f"learned bloom: {fn} false negatives")
    check(lb.measured_fpr <= BLOOM_MAX_FPR, f"learned bloom: FPR {lb.measured_fpr}")
    plain = build_bloom(string_hash_u64(keys), fpr=BLOOM_TARGET_FPR)
    out = {"phase": "paper_structures", "part": "learned_bloom", "card": card,
           "keys": len(keys), "nonkeys": len(nonkeys), "steps": GRU_STEPS,
           "target_fpr": BLOOM_TARGET_FPR, "tau": lb.tau, "fnr": lb.fnr,
           "measured_fpr": lb.measured_fpr, "false_negatives": fn,
           "size_bytes": lb.size_bytes, "model_bytes": lb.spec.size_bytes,
           "overflow_bytes": lb.overflow.size_bytes, "plain_bloom_bytes": plain.size_bytes,
           "gen_s": gen_s, "build_s": build_s, "contains_s": contains_s,
           "seconds": time.perf_counter() - t0}
    emit(out)
    return out


def run_lif(args, rng, dev, card):
    """LIF over gen_maps on the four-candidate `LIF_GRID`: every stored
    key at its float32 lower bound through the emitted lookup."""
    import torch
    from repro_torch.core import IndexSpec, make_keyset, synthesize
    from repro_torch.data import gen_maps

    t0 = time.perf_counter()
    ks = make_keyset(gen_maps(LIF_KEYS, seed=args.seed + 11))
    idx, lookup, cands = synthesize(ks, IndexSpec(), LIF_GRID, device=dev)
    synth_s = time.perf_counter() - t0
    q = torch.as_tensor(ks.norm, device=dev)
    bad = int((lookup(q).cpu().numpy() != np.searchsorted(ks.norm, ks.norm)).sum())
    check(bad == 0, f"lif: {bad} stored keys off their lower bound")
    check(len(cands) == 4, f"lif: {len(cands)} candidates")
    out = {"phase": "paper_structures", "part": "lif", "card": card, "n": int(ks.n),
           "candidates": [{"num_leaves": c.config.num_leaves,
                           "hidden": list(c.config.stage0_hidden), "avg_window": c.avg_window,
                           "max_window": c.max_window, "size_bytes": c.size_bytes,
                           "score": c.score} for c in cands],
           "picked": {"num_leaves": idx.num_leaves, "hidden": list(idx.hidden)},
           "mismatches": bad, "lookup_ms": time_ms(lambda: lookup(q), reps=5),
           "synthesize_s": synth_s, "seconds": time.perf_counter() - t0}
    emit(out)
    return out


def run_pipeline(args, rng, dev, card):
    """The data pipeline's document lookup at 10M and 1e9 tokens: every
    seeded offset at the oracle's document (the last start <= it)."""
    from repro_torch.data.pipeline import make_synthetic_corpus

    rows = []
    t0 = time.perf_counter()
    for tokens in PIPELINE_TOKENS:
        t1 = time.perf_counter()
        corpus = make_synthetic_corpus(tokens, seed=args.seed, device=dev)
        build_s = time.perf_counter() - t1
        offsets = rng.integers(0, tokens, PIPELINE_OFFSETS)
        got = corpus.lookup_documents(offsets)
        want = np.searchsorted(corpus.doc_starts, offsets, side="right") - 1
        bad = int((got != want).sum())
        check(bad == 0, f"pipeline {tokens}: {bad} offsets off the oracle's document")
        t1 = time.perf_counter()
        for _ in range(5):
            corpus.lookup_documents(offsets)
        rows.append({"tokens": tokens, "documents": int(corpus.doc_starts.size),
                     "offsets": PIPELINE_OFFSETS, "mismatches": bad, "build_s": build_s,
                     "lookup_documents_ms": (time.perf_counter() - t1) / 5 * 1e3})
    out = {"phase": "paper_structures", "part": "pipeline", "card": card, "rows": rows,
           "seconds": time.perf_counter() - t0}
    emit(out)
    return out


def run_prefix_bloom_serve(card):
    """`launch.serve --prefix-bloom` on the reduced yi-6b, the reference
    test's argv, on the card."""
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    out = serve.main(PREFIX_BLOOM_ARGV)
    check(out["completed"] == 3 and out["tokens"] == 12 and out["kv_pages_in_use"] == 0,
          f"serve --prefix-bloom: {out}")
    row = {"phase": "paper_structures", "part": "serve_prefix_bloom", "card": card,
           "argv": PREFIX_BLOOM_ARGV, **out, "seconds": time.perf_counter() - t0}
    emit(row)
    return row


def run_paper_structures(args, rng, dev, card):
    """Strings, the learned Bloom filter, LIF, the pipeline and the
    prefix-bloom launcher, one `paper_structures` line each (the B-Tree
    line comes from `run_single`)."""
    t0 = time.perf_counter()
    parts = [run_strings(args, dev, card), run_learned_bloom(args, dev, card),
             run_lif(args, rng, dev, card), run_pipeline(args, rng, dev, card),
             run_prefix_bloom_serve(card)]
    return {"seconds": time.perf_counter() - t0, "parts": [p["part"] for p in parts]}


def run_single(args, base, rng, dev, card, record, worst, scan_worst):
    """Phases 3-4 on the single-shard service over ``base``: the main
    path (lookups, scans, compaction), the snapshot-level sharded_fused
    path, and the times.  Returns what the kernels line needs; the
    service and its tensors go when it returns."""
    import torch
    from repro_torch.index_service import IndexService, ServiceConfig
    from repro_torch.index_service.scan import device_scan_slab, scan_page_bound
    from repro_torch.kernels import ops, ref, rmi_lookup
    from repro_torch.kernels.rmi_lookup import rmi_lookup_cuda, rmi_merged_lookup_cuda
    from repro_torch.kernels.rmi_scan import rmi_scan_page_cuda, rmi_scan_range_cuda
    from repro_torch.core.bloom import words_tensor
    from repro_torch.kernels.bloom_probe import bloom_probe_cuda

    # ---- phase 3: the main path at scale ---------------------------------
    t0 = time.perf_counter()
    # a zero payload, so scans carry the staged inserts' values through
    # compaction (gen_maps returns sorted unique keys)
    svc = IndexService(base, ServiceConfig(strategy="cuda_fused", delta_capacity=1 << 20,
                                           bloom_fpr=0.01),
                       vals=np.zeros(base.size, np.int64), device=dev)
    build_svc_s = time.perf_counter() - t0
    snap0 = svc._mgr.current()
    ks0 = snap0.keys
    emit({"phase": "service_build", "n": int(ks0.n),
          "build_s": build_svc_s, "num_leaves": snap0.index.num_leaves,
          "max_window": snap0.index.max_window, "max_dup_run": snap0.max_dup_run,
          "bloom_bits": snap0.bloom.num_bits, "bloom_hashes": snap0.bloom.num_hashes,
          "bloom_mb": snap0.bloom.size_bytes / 1e6})

    # kernels against plain versions on the full service index
    base_norm0 = snap0._device_tree()[1]
    worst = max(worst, compare_kernels(
        f"service{ks0.n}", ks0, snap0.index, rng, BIG_BATCH, dev, record,
        sorted_keys=base_norm0))
    emit({"phase": "kernels_vs_plain", "comparisons": len(record),
          "max_abs_err": worst, "rows": record})

    # -- the main path: each path's counts zeroed just before it, read
    # just after; the dispatch ledger covers the whole run ---------------
    guard0 = start_failover_guard()
    ops.reset_dispatch_stats()
    windows = []
    reset_counts()
    t_main = time.perf_counter()

    # every stored key at its float32 lower bound (start of its run)
    norm = ks0.norm
    idx_all = np.arange(norm.size)
    run_start = np.maximum.accumulate(
        np.where(np.r_[True, norm[1:] != norm[:-1]], idx_all, 0))
    del idx_all
    chunk = 1 << 24
    base_fn = snap0.base_lookup_fn("cuda_fused")
    for s in range(0, ks0.n, chunk):
        got = svc.lookup_batch(ks0.raw[s:s + chunk]).cpu().numpy()
        check(bool((got == run_start[s:s + chunk]).all()),
              f"stored keys [{s}, {s + chunk}) off their float32 lower bound")
    sample = rng.choice(ks0.n, 1 << 22)
    got = base_fn(torch.as_tensor(norm[sample], device=dev)).cpu().numpy()
    check(bool((got == run_start[sample]).all()), "base_lookup_fn off the lower bound")
    del run_start
    emit({"phase": "all_stored_keys", "n": int(ks0.n), "found": True,
          "seconds": time.perf_counter() - t_main})

    # 300k inserts + 300k deletes
    ins = _absent(ks0.raw, rng.uniform(ks0.raw[0], ks0.raw[-1], N_WRITES * 11 // 10))
    ins = rng.choice(ins, N_WRITES, replace=False)
    keep = np.ones(ks0.n, bool)
    keep[rng.choice(ks0.n, N_WRITES, replace=False)] = False
    dels = ks0.raw[~keep]
    ins_vals = 1 + np.arange(ins.size, dtype=np.int64)
    t0 = time.perf_counter()
    check(svc.insert(ins, ins_vals) == ins.size, "insert applied count")
    check(svc.delete(dels) == dels.size, "delete applied count")
    write_s = time.perf_counter() - t0
    oracle = Oracle(ks0.raw, ins, dels)
    checked = check_reads(svc, oracle, rng, "staged", N_GET, N_LOOKUP)
    screen = {"staged": check_screen(svc, oracle, rng, "staged")}
    # keep the staged delta slab for the timing phase
    _, _, active, dk_t, dp_t = svc._capture()
    emit({"phase": "staged_reads", "write_s": write_s, "checked": checked,
          "delta_entries": len(active), "screen": screen["staged"]})
    windows.append(("lookup", read_counts()))

    # the snapshot-level sharded_fused strategy on the staged index
    reset_counts()
    snapshot_sharded = check_snapshot_sharded(snap0, dk_t, dp_t, rng, dev)
    windows.append(("snapshot_sharded", read_counts()))
    emit({"phase": "snapshot_sharded_fused", **snapshot_sharded})

    # scans over the staged state
    reset_counts()
    t0 = time.perf_counter()
    ranges = scan_ranges(ks0.raw, ks0.norm, ins, dels, rng)
    state0 = ScanState(snap0, ins, ins_vals, dels)
    scan_rows0, err0, staged = check_scans(svc, state0, ranges, "staged", dev)
    scan_worst = max(scan_worst, err0)
    windows.append(("scan", read_counts()))
    emit({"phase": "staged_scans", "seconds": time.perf_counter() - t0,
          "cold_scan_batch_s": staged["cold_scan_batch_s"], "ranges": scan_rows0})

    reset_counts()
    t0 = time.perf_counter()
    svc.flush()
    flush_s = time.perf_counter() - t0
    snap1 = svc._mgr.current()
    check(snap1.version == 1 and snap1.n == ks0.n, "one warm compaction")
    oracle1 = Oracle(snap1.keys.raw, np.empty(0), np.empty(0))
    kept, ins_sorted = ks0.raw[keep], np.sort(ins)
    check(bool(np.array_equal(snap1.keys.raw, np.insert(
        kept, np.searchsorted(kept, ins_sorted), ins_sorted))), "compacted key set")
    del kept
    want_vals = np.zeros(snap1.n, np.int64)
    want_vals[np.searchsorted(snap1.keys.raw, ins)] = ins_vals
    check(bool(np.array_equal(snap1.vals, want_vals)), "compacted payload")
    checked1 = check_reads(svc, oracle1, rng, "compacted", N_GET, N_LOOKUP)
    screen["compacted"] = check_screen(svc, oracle1, rng, "compacted")
    log0 = svc.compaction_log[-1]
    windows.append(("lookup", read_counts()))

    # scans over the compacted state
    reset_counts()
    t0 = time.perf_counter()
    state1 = ScanState(snap1, np.empty(0), np.empty(0, np.int64), np.empty(0))
    scan_rows1, err1, compacted = check_scans(svc, state1, ranges, "compacted", dev)
    scan_worst = max(scan_worst, err1)
    windows.append(("scan", read_counts()))
    emit({"phase": "compacted_scans", "seconds": time.perf_counter() - t0,
          "cold_scan_batch_s": compacted["cold_scan_batch_s"], "ranges": scan_rows1})

    # the Bloom kernel on the service's own (compacted) filter, and on an
    # oracle filter of the kernel's own hash family
    reset_counts()
    t0 = time.perf_counter()
    bq, bgot, fold = bloom_on_service_filter(snap1, rng, dev)
    fold["seconds"] = time.perf_counter() - t0
    bloom_oracle_row = bloom_oracle(rng, dev)
    windows.append(("bloom", read_counts()))
    bloom_words = words_tensor(snap1.bloom, dev)
    bkw = dict(num_bits=snap1.bloom.num_bits, k=snap1.bloom.num_hashes)
    bloom_worst = int((bgot != ref.bloom_probe_reference(bq, bloom_words, **bkw)).sum())
    check(bloom_worst == 0, f"bloom kernel != plain on the service filter ({bloom_worst})")
    emit({"phase": "bloom_kernel", "seconds": time.perf_counter() - t0, "filter": {
        "num_bits": bkw["num_bits"], "k": bkw["k"], "mb": snap1.bloom.size_bytes / 1e6,
        "mismatches": bloom_worst, **fold}, "oracle": bloom_oracle_row})
    main_s = time.perf_counter() - t_main
    path_kernels = {"lookup": ("rmi_lookup_cuda", "rmi_merged_lookup_cuda"),
                    "snapshot_sharded": ("rmi_sharded_merged_lookup_cuda",),
                    "scan": ("rmi_scan_range_cuda", "rmi_scan_page_cuda"),
                    "bloom": ("bloom_probe_cuda",)}
    launches = {k: 0 for ks in path_kernels.values() for k in ks}
    for path, counts in windows:
        for k in path_kernels[path]:
            launches[k] += counts[k]
    ledger = ops.dispatch_summary()
    emit({"phase": "compaction", "flush_s": flush_s, "leaves_refit": log0.leaves_refit,
          "max_window": snap1.index.max_window, "checked": checked1,
          "screen": screen["compacted"]})
    emit({"phase": "main_path", "seconds": main_s, "launches": launches,
          "windows": windows, "dispatch_rows": ledger["rows"]})
    for op in ("merged_lookup", "rmi_scan_range", "rmi_scan_page", "bloom_probe"):
        rows = [r for r in ledger["rows"] if r["op"] == op]
        check(bool(rows) and all(r["path"] == "kernel" for r in rows),
              f"{op} rows must all be on path kernel")
    check(all(v > 0 for v in launches.values()), f"a kernel never launched: {launches}")
    failover_guard("single", guard0)

    # ---- phase 4: times on the staged 200M-key index ---------------------
    idx0 = snap0.index
    arrs = snap0._kernel_args()
    kw = dict(hidden=idx0.hidden, n=idx0.n, num_leaves=idx0.num_leaves,
              max_window=idx0.max_window)
    steps = rmi_lookup._search_steps(idx0.max_window)
    d = int(dk_t.shape[0])
    dsteps = rmi_lookup._search_steps(d)
    s0_bytes = int(arrs[0].numel()) * 4
    times = []
    for batch in (65_536, BIG_BATCH):
        q = torch.as_tensor(norm[rng.choice(ks0.n, batch)], device=dev)
        row = {"batch": batch}
        # the snapshot's leaf record, read in place, against the plain twin
        err = lookup_mismatch(rmi_merged_lookup_cuda(q, *arrs, dk_t, dp_t, **kw),
                              ref.rmi_merged_lookup_reference(q, *arrs, dk_t, dp_t, **kw))
        check(err == 0, f"phase 4: merged kernel != plain at {batch}")
        worst = max(worst, err)
        row["merged_ms"] = time_ms(lambda: rmi_merged_lookup_cuda(q, *arrs, dk_t, dp_t, **kw))
        row["merged_plain_ms"] = time_ms(
            lambda: ref.rmi_merged_lookup_reference(q, *arrs, dk_t, dp_t, **kw), reps=5)
        row["base_ms"] = time_ms(lambda: rmi_lookup_cuda(q, *arrs, **kw))
        row["base_plain_ms"] = time_ms(
            lambda: ref.rmi_lookup_reference(q, *arrs, **kw), reps=5)
        row["searchsorted_ms"] = time_ms(lambda: torch.searchsorted(base_norm0, q))
        row["merged_bound_ms"] = bound_bytes(
            batch, steps, dsteps, d, True, s0_bytes) / HBM_BYTES_PER_S * 1e3
        row["base_bound_ms"] = bound_bytes(
            batch, steps, dsteps, d, False, s0_bytes) / HBM_BYTES_PER_S * 1e3
        # end to end: raw float64 keys in, ranks on the card out
        raw_q = snap1.keys.raw[rng.choice(snap1.n, batch)]
        svc.lookup_batch(raw_q)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reps = 10
        for _ in range(reps):
            svc.lookup_batch(raw_q)
        torch.cuda.synchronize()
        row["lookup_batch_qps"] = batch * reps / (time.perf_counter() - t0)
        times.append(row)
    # contains end to end with the screen: half stored keys, half absent
    cq = rng.permutation(np.concatenate([
        snap1.keys.raw[rng.choice(snap1.n, BIG_BATCH // 2)],
        _absent(snap1.keys.raw, rng.uniform(snap1.keys.raw[0], snap1.keys.raw[-1],
                                            BIG_BATCH // 2))]))
    svc.contains(cq)
    t0 = time.perf_counter()
    for _ in range(5):
        svc.contains(cq)
    contains_qps = cq.size * 5 / (time.perf_counter() - t0)
    lat = []
    gq = snap1.keys.raw[rng.choice(snap1.n, 1024)]
    for _ in range(200):
        t0 = time.perf_counter()
        svc.get(gq)
        lat.append(time.perf_counter() - t0)
    emit({"phase": "times", "card": card, "n": int(ks0.n), "steps": steps,
          "dsteps": dsteps, "delta_padded": d, "rows": times,
          "get_1024_p50_ms": float(np.percentile(lat, 50) * 1e3),
          "get_1024_p99_ms": float(np.percentile(lat, 99) * 1e3),
          "contains_screened_qps": contains_qps, "flush_s": flush_s})

    # ---- phase 4: the Bloom kernel on the service's filter ---------------
    bloom_times = []
    raw1 = snap1.keys.raw
    for batch in PROBE_BATCHES:
        stored = raw1[rng.choice(snap1.n, batch // 2)]
        absent = rng.uniform(raw1[0], raw1[-1], batch - stored.size)
        qt = u32_tensor(np.concatenate([stored, absent]).astype(np.float32).view(np.uint32),
                        dev)
        row = {"batch": batch,
               "ms": time_ms(lambda: bloom_probe_cuda(qt, bloom_words, **bkw)),
               "plain_ms": time_ms(lambda: ref.bloom_probe_reference(qt, bloom_words, **bkw),
                                   reps=3, warmup=1),
               "sectors": bloom_sectors(qt, bloom_words, **bkw)}
        row["bound_ms"] = probe_bound_ms(batch, row["sectors"])
        row["max_abs_err"] = int((bloom_probe_cuda(qt, bloom_words, **bkw)
                                  != ref.bloom_probe_reference(qt, bloom_words, **bkw)).sum())
        check(row["max_abs_err"] == 0, f"phase 4: bloom kernel != plain at {batch}")
        bloom_worst = max(bloom_worst, row["max_abs_err"])
        bloom_times.append(row)
    emit({"phase": "bloom_times", "card": card, "rows": bloom_times})

    # ---- phase 4: scans on the staged 200M-key index ---------------------
    t0 = time.perf_counter()
    device_scan_slab(staged["view"], ks0.norm, ks0.normalize)
    pack_slab_s = time.perf_counter() - t0
    ins_t, ivals_t, irank_t, lp_t = staged["slab"]
    base_t = staged["base"]
    plan_t = staged["plan"]
    page = SCAN_PAGE_SIZES[0]
    scan_times = []
    for w in BIG_SCANS:
        lo, hi = ranges[f"r{w}"]
        qn = ks0.normalize(np.array([lo, hi]))
        r0 = int(state0.rank_f32(qn[0]))
        r1 = max(int(state0.rank_f32(qn[1])), r0)
        rows = r1 - r0
        bt = torch.as_tensor(qn, device=dev)
        pages = scan_page_bound([ks0.raw], staged["ins_n"], lo, hi, page)
        kw = dict(page_size=page, max_pages=pages)
        rargs = (bt, *base_t, lp_t, ins_t, ivals_t, irank_t)
        g = -(-rows // page)
        starts = torch.as_tensor((r0 + page * np.arange(g)).astype(np.int32), device=dev)
        end = torch.as_tensor(np.array([r1], np.int32), device=dev)
        pargs = (starts, *base_t, *plan_t, end)
        row = {"rows": rows, "page_size": page, "range_lanes": pages * page,
               "page_lanes": g * page}
        row["range_ms"] = time_ms(lambda: rmi_scan_range_cuda(*rargs, **kw))
        row["range_plain_ms"] = time_ms(
            lambda: ref.rmi_scan_range_reference(*rargs, **kw), reps=3, warmup=1)
        row["page_ms"] = time_ms(lambda: rmi_scan_page_cuda(*pargs, page_size=page),
                                 reps=5, warmup=1)
        row["page_plain_ms"] = time_ms(
            lambda: ref.rmi_scan_page_reference(*pargs, page_size=page), reps=2, warmup=1)
        one = (starts[:1], *pargs[1:])   # a single page (G = 1): the pre-pass and one tile
        row["page_g1_ms"] = time_ms(lambda: rmi_scan_page_cuda(*one, page_size=page))
        row["page_max_abs_err"] = max(
            scan_mismatch(rmi_scan_page_cuda(*a, page_size=page),
                          ref.rmi_scan_page_reference(*a, page_size=page)) for a in (pargs, one))
        check(row["page_max_abs_err"] == 0.0,
              f"phase 4: scan page kernel != plain version at {w} rows")
        slab_bytes = 4 * (ins_t.numel() + ivals_t.numel() + irank_t.numel()) + 8
        plan_bytes = 4 * sum(int(a.numel()) for a in plan_t) + 4 * g + 4
        row["range_bound_ms"] = scan_bound_bytes(
            rows, pages * page, index_bytes=4, delta_bytes=slab_bytes) / HBM_BYTES_PER_S * 1e3
        row["page_bound_ms"] = scan_bound_bytes(
            rows, g * page, index_bytes=0, delta_bytes=plan_bytes) / HBM_BYTES_PER_S * 1e3
        # end to end on the service as it stands (compacted), warm plane
        svc.scan_batch(lo, hi, page)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        reps = 5
        for _ in range(reps):
            out = svc.scan_batch(lo, hi, page)
        torch.cuda.synchronize()
        row["scan_batch_rows_per_s"] = int(out[2].sum()) * reps / (time.perf_counter() - t1)
        scan_times.append(row)
    emit({"phase": "scan_times", "card": card, "n": int(ks0.n), "rows": scan_times,
          "pack_slab_s": pack_slab_s, "staged_inserts": int(staged["ins_n"]),
          "tombstones": int(dels.size)})

    # ---- the multi-tenant frontend over the compacted service -------------
    guard1 = start_failover_guard()
    reset_counts()
    t0 = time.perf_counter()
    front = run_frontend(svc, rng, dev, card)
    counts = read_counts()
    front["launches"] = {k: counts[k] for k in ("rmi_merged_lookup_cuda", "rmi_scan_range_cuda")}
    front["seconds"] = time.perf_counter() - t0
    emit({"phase": "frontend", **front})
    check(all(v > 0 for v in front["launches"].values()),
          f"frontend: a kernel never launched: {front['launches']}")
    failover_guard("frontend", guard1)

    # ---- the B-Tree baseline over the compacted key set --------------------
    btree = run_btree(snap1.keys, snap1._device_tree()[1], snap1.index, rng, dev, card)

    scan_worst = max([scan_worst] + [r["page_max_abs_err"] for r in scan_times])
    return {"times": times, "scan_times": scan_times, "launches": launches,
            "worst": worst, "scan_worst": scan_worst, "n": int(ks0.n),
            "snapshot_sharded": snapshot_sharded, "bloom_times": bloom_times,
            "bloom_worst": bloom_worst, "btree_s": btree["seconds"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=PAPER_N, help="main-path key count")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lm-reduced", action="store_true",
                    help="the reduced models in the LM phases (a rehearsal, not a result)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.core import RMIConfig, build_rmi, make_keyset
    from repro_torch.data import gen_lognormal, gen_maps
    from repro_torch.kernels import flash_attention, hash_probe, rmi_lookup, rmi_scan
    from repro_torch.kernels.rmi_lookup import rmi_lookup_cuda

    dev = torch.device(DEVICE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"{smi} (torch {torch.__version__}, CUDA {torch.version.cuda})"

    # ---- phase 1: card + build (one nvcc per source, all at once) --------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(5) as pool:
        libs = list(pool.map(lambda build: build(),
                             (rmi_lookup.build, rmi_scan.build, hash_probe.build,
                              flash_attention.build, flash_attention.build_backward)))
    build_s = time.perf_counter() - t0
    dryruns = start_dryruns()
    # the scan kernels' tile and shared-memory buffers (dynamic shared
    # memory, which ptxas does not report; the range, page and sharded
    # kernels take the same); the lookups take none
    tiles = {"rmi_scan": {"range_tile": rmi_scan.RANGE_TILE,
                          "range_ins_cap": rmi_scan.RANGE_INS_CAP,
                          "range_prefix_cap": rmi_scan.RANGE_PREFIX_CAP,
                          "range_dynamic_smem_bytes": 4 * (rmi_scan.RANGE_INS_CAP
                                                           + rmi_scan.RANGE_PREFIX_CAP)}}
    for lib in libs:
        log = lib.with_suffix(".log").read_text() if lib.with_suffix(".log").exists() else ""
        emit({"phase": "build", "seconds": build_s, "library": lib.name,
              "ptxas": [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln or "entry function" in ln],
              "tiles": tiles.get(lib.stem.split("-")[0])})
    # B9's bf16 D = 128 instance had 168 registers and no spills before
    # its log-sum-exp output; it must still spill nothing
    attn_ptxas = attention_ptxas()
    emit({"phase": "build", "part": "attention_ptxas", **attn_ptxas})
    fwd128 = attn_ptxas["bf16_d128_forward"] or {}
    check(fwd128.get("spill_stores") == 0 and fwd128.get("spill_loads") == 0,
          f"flash_attention_bf16_kernel<128> spills: {fwd128}")
    # and the bf16 D = 128 backward kernels (dK/dV, dQ) none either
    bwd128 = attn_ptxas["bf16_d128_backward"]
    check(len(bwd128) == 2 and all(r.get("spill_stores") == 0 and r.get("spill_loads") == 0
                                   for r in bwd128.values()),
          f"the bf16 D = 128 backward kernels spill: {bwd128}")

    # ---- phase 2: kernels against plain versions ------------------------
    attn_record = []
    attn_worst = compare_attention_kernel(dev, args.seed, attn_record)
    emit({"phase": "attention_kernel_vs_plain", "max_abs_err": attn_worst,
          "rows": attn_record})
    # a stream of its own: gen_maps(n, seed) draws from default_rng(seed),
    # and "absent" query candidates must not replay its keys
    rng = np.random.default_rng((args.seed, 1))
    record = []
    worst = 0
    small = {
        "maps50k_linear": (gen_maps(SMALL_N, seed=1), ()),
        "maps50k_mlp16x16": (gen_maps(SMALL_N, seed=2), (16, 16)),
        "dup50k_linear": (_dup_heavy(rng, SMALL_N), ()),
        "lognormal50k_linear": (gen_lognormal(SMALL_N, seed=3), ()),
    }
    for label, (raw, hidden) in small.items():
        ks = make_keyset(raw)
        idx = build_rmi(ks, RMIConfig(
            num_leaves=max(16, ks.n // 64), stage0_hidden=hidden,
            stage0_train_steps=300 if hidden else 0), device=dev)
        found = rmi_lookup_cuda(
            torch.as_tensor(ks.norm, device=dev),
            rmi_lookup.stage0_flat(idx.stage0_params, dev),
            *(torch.as_tensor(a, device=dev) for a in
              (idx.leaf_w, idx.leaf_b, idx.err_lo, idx.err_hi, ks.norm)),
            hidden=idx.hidden, n=idx.n, num_leaves=idx.num_leaves,
            max_window=idx.max_window).cpu().numpy()
        check(bool((found == np.searchsorted(ks.norm, ks.norm)).all()),
              f"{label}: stored keys off their lower bound")
        worst = max(worst, compare_kernels(label, ks, idx, rng, BIG_BATCH, dev, record))
    flat_worst, flat_sharded_worst = compare_flat_leaf_kernels(dev, record)
    worst = max(worst, flat_worst)
    scan_record = []
    scan_worst = compare_scan_kernels(rng, dev, scan_record)
    emit({"phase": "scan_kernels_vs_plain", "max_abs_err": scan_worst, "rows": scan_record})
    sharded_record = []
    sharded_lookup_worst = max(compare_sharded_lookup_kernel(rng, dev, sharded_record),
                               flat_sharded_worst)
    sharded_scan_worst = compare_sharded_scan_kernel(rng, dev, sharded_record)
    emit({"phase": "sharded_kernels_vs_plain", "lookup_max_abs_err": sharded_lookup_worst,
          "scan_max_abs_err": sharded_scan_worst, "rows": sharded_record})
    probe_record = []
    hash_worst, bloom_worst = compare_probe_kernels(rng, dev, probe_record)
    emit({"phase": "probe_kernels_vs_plain", "hash_mismatches": hash_worst,
          "bloom_mismatches": bloom_worst, "rows": probe_record})
    emit({"phase": "failover_injected", **run_failover_injected(dev)})

    # ---- the LM substrate (yi-6b), released before the index phases -----
    lm = run_lm(args, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    attn_worst = max(attn_worst, lm["layer0_err"])
    attn_ok = all(r["within_tol"] for r in attn_record) and lm["layer0_ok"]

    # ---- the training path (yi-6b at full width, cut in depth) ----------
    trained = run_lm_train(args, dev, card)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the MoE family (olmoe, moonshot) at full width -------------------
    moe_lm = run_lm_moe(args, dev, card)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the recurrent families (xlstm-1.3b, jamba-1.5-large) -------------
    recurrent = run_lm_recurrent(args, dev, card)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the vlm and audio families (llava, seamless) ---------------------
    multimodal = run_lm_multimodal(args, dev, card)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the mesh, the sharding rules, the int8 all-reduce, the dry run ----
    guard = start_failover_guard()
    distributed = run_distributed(args, dev, card, dryruns, trained["full"],
                                  multimodal["parts"]["e"])
    failover_guard("distributed", guard)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phases 3-4: the single-shard service, then the sharded one ------
    t0 = time.perf_counter()
    base = gen_maps(args.n, seed=args.seed)
    emit({"phase": "keys", "n": int(base.size), "gen_s": time.perf_counter() - t0})
    single = run_single(args, base, rng, dev, card, record, worst, scan_worst)
    # the single-shard service is gone: peak memory stays one service
    gc.collect()
    torch.cuda.empty_cache()
    hashed = run_hash_index(args, base, rng, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    # the K = 4 service runs over every SHARDED_STRIDE-th key (a cut of
    # depth: the whole run must fit its time limit; PERF.md §4)
    sharded = run_sharded(args, base[::SHARDED_STRIDE].copy(), rng, dev, card)
    del base
    gc.collect()
    torch.cuda.empty_cache()
    rebalanced = run_rebalance(args, rng, dev)
    emit({"phase": "rebalance", **rebalanced})
    gc.collect()
    torch.cuda.empty_cache()
    structures = run_paper_structures(args, rng, dev, card)
    emit({"phase": "paper_structures", "part": "all", "card": card,
          "seconds": structures["seconds"] + single["btree_s"], "parts": ["btree"]
          + structures["parts"]})

    times, scan_times, launches = single["times"], single["scan_times"], single["launches"]
    worst, scan_worst = single["worst"], single["scan_worst"]
    big = times[-1]
    sbig = scan_times[-1]
    slook, sscan = sharded["lookup"], sharded["scans"][-1]
    hbig, bbig = hashed["times"][0], single["bloom_times"][0]   # 1<<20 queries
    hash_worst = max(hash_worst, hashed["mismatches"])
    bloom_worst = max(bloom_worst, single["bloom_worst"])
    sharded_scan_worst = max(sharded_scan_worst, sharded["scan_max_abs_err"],
                             rebalanced["scan_max_abs_err"])
    sharded_lookup_worst = max(sharded_lookup_worst, slook["max_abs_err"])
    src = "src/repro_torch/kernels/csrc/rmi_lookup.cu"
    scan_src = "src/repro_torch/kernels/csrc/rmi_scan.cu"
    probe_src = "src/repro_torch/kernels/csrc/probe.cu"
    print(smi, flush=True)
    emit({"kernels": [
        {"name": "rmi_merged_lookup_cuda", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/rmi_lookup.py:827",
         "launches": launches["rmi_merged_lookup_cuda"], "max_abs_err": worst,
         "bit_identical": worst == 0,
         "ms": big["merged_ms"], "plain_ms": big["merged_plain_ms"],
         "bound_ms": big["merged_bound_ms"], "bound_by": "bytes",
         "library_ms": big["searchsorted_ms"]},
        {"name": "rmi_lookup_cuda", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/rmi_lookup.py:778",
         "launches": launches["rmi_lookup_cuda"], "max_abs_err": worst,
         "bit_identical": worst == 0,
         "ms": big["base_ms"], "plain_ms": big["base_plain_ms"],
         "bound_ms": big["base_bound_ms"], "bound_by": "bytes",
         "library_ms": big["searchsorted_ms"]},
        {"name": "rmi_scan_range_cuda", "route": "cuda", "source": scan_src,
         "replaces": "src/repro/kernels/rmi_lookup.py:510",
         "launches": launches["rmi_scan_range_cuda"], "max_abs_err": scan_worst,
         "bit_identical": scan_worst == 0,
         "ms": sbig["range_ms"], "plain_ms": sbig["range_plain_ms"],
         "bound_ms": sbig["range_bound_ms"], "bound_by": "bytes", "library_ms": None},
        {"name": "rmi_scan_page_cuda", "route": "cuda", "source": scan_src,
         "replaces": "src/repro/kernels/rmi_lookup.py:336",
         "launches": launches["rmi_scan_page_cuda"], "max_abs_err": scan_worst,
         "bit_identical": scan_worst == 0,
         "ms": sbig["page_ms"], "plain_ms": sbig["page_plain_ms"],
         "bound_ms": sbig["page_bound_ms"], "bound_by": "bytes", "library_ms": None},
        {"name": "rmi_sharded_merged_lookup_cuda", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/rmi_lookup.py:895",
         "launches": launches["rmi_sharded_merged_lookup_cuda"]
         + sharded["launches"]["rmi_sharded_merged_lookup_cuda"],
         "max_abs_err": sharded_lookup_worst, "bit_identical": sharded_lookup_worst == 0,
         "ms": slook["ms"], "plain_ms": slook["plain_ms"], "bound_ms": slook["bound_ms"],
         "bound_by": "bytes", "library_ms": slook["searchsorted_ms"]},
        {"name": "rmi_sharded_scan_page_cuda", "route": "cuda", "source": scan_src,
         "replaces": "src/repro/kernels/rmi_lookup.py:605",
         "launches": sharded["launches"]["rmi_sharded_scan_page_cuda"],
         "max_abs_err": sharded_scan_worst, "bit_identical": sharded_scan_worst == 0,
         "ms": sscan["ms"], "plain_ms": sscan["plain_ms"], "bound_ms": sscan["bound_ms"],
         "bound_by": "bytes", "library_ms": None},
        {"name": "hash_probe_cuda", "route": "cuda", "source": probe_src,
         "replaces": "src/repro/kernels/hash_probe.py:51", "launches": hashed["launches"],
         "max_abs_err": hash_worst, "bit_identical": hash_worst == 0,
         "ms": hbig["ms"], "plain_ms": hbig["plain_ms"], "bound_ms": hbig["bound_ms"],
         "separate_arrays_bound_ms": hbig["separate_arrays_bound_ms"],
         "bound_by": "bytes", "library_ms": None},
        {"name": "bloom_probe_cuda", "route": "cuda", "source": probe_src,
         "replaces": "src/repro/kernels/bloom_probe.py:45",
         "launches": launches["bloom_probe_cuda"],
         "max_abs_err": bloom_worst, "bit_identical": bloom_worst == 0,
         "ms": bbig["ms"], "plain_ms": bbig["plain_ms"], "bound_ms": bbig["bound_ms"],
         "bound_by": "bytes", "library_ms": None},
        {"name": "flash_attention_cuda", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:83",
         "launches": lm["launches"] + trained["full"]["launches"]["flash_attention_cuda"]
         + moe_lm["launches"] + recurrent["launches"] + multimodal["launches"]
         + distributed["launches"]["flash_attention_cuda"],
         "prefill_launches": lm["launches"],
         "moe_prefill_launches": moe_lm["launches"],
         "hybrid_launches": recurrent["launches"],
         "multimodal_launches": multimodal["launches"],
         "train_launches": trained["full"]["launches"]["flash_attention_cuda"],
         "partitioned_train_launches": distributed["launches"]["flash_attention_cuda"],
         "max_abs_err": attn_worst, "within_tol": attn_ok,
         "ms": lm["timing"]["ms"], "plain_ms": lm["timing"]["plain_ms"],
         "bound_ms": lm["timing"]["bound_ms"], "bound_by": lm["timing"]["bound_by"],
         "library_ms": lm["timing"]["sdpa_ms"],
         "train_shape_ms": trained["timing"]["forward_lse_ms"],
         "cross_shape": multimodal["cross"]["shape"], "cross_ms": multimodal["cross"]["ms"],
         "cross_plain_ms": multimodal["cross"]["plain_ms"],
         "cross_bound_ms": multimodal["cross"]["bound_ms"],
         "cross_bound_by": multimodal["cross"]["bound_by"],
         "cross_library_ms": multimodal["cross"]["sdpa_ms"]},
        {"name": "flash_attention_bwd_cuda", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
         "replaces": "the gradient of src/repro/models/attention.py:33, taken at "
                     "src/repro/train/train_step.py:34",
         "launches": trained["full"]["launches"]["flash_attention_bwd_cuda"]
         + recurrent["hybrid"]["bwd_launches"] + multimodal["bwd_launches"]
         + distributed["launches"]["flash_attention_bwd_cuda"],
         "partitioned_train_launches": distributed["launches"]["flash_attention_bwd_cuda"],
         "hybrid_train_launches": recurrent["hybrid"]["bwd_launches"],
         "multimodal_train_launches": multimodal["bwd_launches"],
         "max_abs_err": trained["max_abs_err"], "worst_err_over_tol": trained["worst"],
         "within_tol": trained["record_ok"],
         "ms": trained["timing"]["ms"], "plain_ms": trained["timing"]["plain_ms"],
         "bound_ms": trained["timing"]["bound_ms"], "bound_by": trained["timing"]["bound_by"],
         "library_ms": trained["timing"]["library_ms"],
         "library_backend": trained["timing"]["library_backend"],
         "cross_shape": trained["timing"]["cross"]["shape"],
         "cross_ms": trained["timing"]["cross"]["ms"],
         "cross_plain_ms": trained["timing"]["cross"]["plain_ms"],
         "cross_bound_ms": trained["timing"]["cross"]["bound_ms"],
         "cross_bound_by": trained["timing"]["cross"]["bound_by"],
         "cross_library_ms": trained["timing"]["cross"]["library_ms"],
         "audio_train_launches": multimodal["audio_train_bwd_launches"],
         "ptxas": attn_ptxas["backward"]},
    ], "batch": big["batch"], "scan_rows": sbig["rows"], "n": single["n"], "shards": slook["S"],
        "sharded_scan_rows": sscan["rows"], "attention_shape": lm["timing"]["shape"],
        "attention_bwd_shape": trained["timing"]["shape"],
        "distributed_s": distributed["seconds"],
        "card": smi,
        "total_s": time.perf_counter() - T_START})
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
