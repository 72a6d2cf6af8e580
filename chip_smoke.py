#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # the paper's Maps scale: 200M keys
    python3 chip_smoke.py --n 2000000   # a quick rehearsal of every phase

Phases, each printing JSON lines; any mismatch raises and the exit code
is non-zero:

  1. card    — the card's name and power limit (nvidia-smi), the kernel
               build and its compiler resource report;
  2. kernels — each CUDA kernel against its plain PyTorch version on the
               card, bit for bit, at n = 50k (linear and (16,16) MLP
               stage-0, and a duplicate-heavy key set) and on the full
               service index: stored, absent, leaf-boundary,
               duplicate-run and out-of-range queries, batches of 1, 777
               and 1<<20, an empty delta and one of 1<<20 entries;
  3. main path — `IndexService(strategy="cuda_fused")` over
               gen_maps(n): every stored key at its float32 lower bound,
               then 300k inserts + 300k deletes checked through get /
               lookup_batch / range_lookup / contains against NumPy
               oracles, a warm compaction (flush) and the same checks
               again; the launch counts and the dispatch ledger of that
               run;
  4. times   — kernel, plain version and torch.searchsorted (the
               paper's binary-search yardstick, timed only) with CUDA
               events, the bound from bytes over 3.35 TB/s, and
               lookup_batch queries/s end to end.

The last line is ``{"ok": true, "device": {...}}``.  Without a card the
script exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM published memory rate
PAPER_N = 200_000_000          # paper §3.6 Maps: 200M longitudes
SMALL_N = 50_000
BIG_BATCH = 1 << 20            # largest batch held against the plain version
BIG_DELTA = 1 << 20            # staged entries of the large delta
N_WRITES = 300_000             # inserts, and deletes, on the main path
N_GET = 1_000_000
N_LOOKUP = 4_000_000


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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


def check_reads(svc, oracle, rng, tag, n_get, n_batch):
    """get / lookup_batch / range_lookup / contains against the oracle."""
    snap = svc._mgr.current()
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
    qb = rng.choice(base, n_batch)
    got = svc.lookup_batch(qb).cpu().numpy()
    want = oracle.rank_f32(snap.keys.norm, snap.keys.normalize, snap.keys.normalize(qb))
    check(bool((got == want).all()), f"{tag}: lookup_batch f32 merged ranks")
    return {"get": n_get, "contains": n_get, "range_lookup": 100, "lookup_batch": n_batch}


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=PAPER_N, help="main-path key count")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.core import RMIConfig, build_rmi, make_keyset
    from repro_torch.data import gen_lognormal, gen_maps
    from repro_torch.index_service import IndexService, ServiceConfig
    from repro_torch.index_service.delta import combine_for_device
    from repro_torch.kernels import ops, ref, rmi_lookup
    from repro_torch.kernels.rmi_lookup import (
        LAUNCHES, reset_launch_counts, rmi_lookup_cuda, rmi_merged_lookup_cuda)

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"{smi} (torch {torch.__version__}, CUDA {torch.version.cuda})"

    # ---- phase 1: card + build ------------------------------------------
    t0 = time.perf_counter()
    lib = rmi_lookup.build()
    build_s = time.perf_counter() - t0
    log = lib.with_suffix(".log").read_text() if lib.with_suffix(".log").exists() else ""
    emit({"phase": "build", "seconds": build_s, "library": lib.name,
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]})

    # ---- phase 2: kernels against plain versions at n = 50k -----------
    rng = np.random.default_rng(args.seed)
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

    # ---- phase 3: the main path at scale ---------------------------------
    t0 = time.perf_counter()
    base = gen_maps(args.n, seed=args.seed)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    svc = IndexService(base, ServiceConfig(strategy="cuda_fused",
                                           delta_capacity=1 << 20), device=dev)
    build_svc_s = time.perf_counter() - t0
    snap0 = svc._mgr.current()
    ks0 = snap0.keys
    emit({"phase": "service_build", "n": int(ks0.n), "gen_s": gen_s,
          "build_s": build_svc_s, "num_leaves": snap0.index.num_leaves,
          "max_window": snap0.index.max_window, "max_dup_run": snap0.max_dup_run})

    # kernels against plain versions on the full service index
    base_norm0 = snap0._device_tree()[1]
    worst = max(worst, compare_kernels(
        f"service{ks0.n}", ks0, snap0.index, rng, BIG_BATCH, dev, record,
        sorted_keys=base_norm0))
    emit({"phase": "kernels_vs_plain", "comparisons": len(record),
          "max_abs_err": worst, "rows": record})

    # -- the main path: counts zeroed just before, read just after --------
    ops.reset_dispatch_stats()
    reset_launch_counts()
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
    t0 = time.perf_counter()
    check(svc.insert(ins) == ins.size, "insert applied count")
    check(svc.delete(dels) == dels.size, "delete applied count")
    write_s = time.perf_counter() - t0
    oracle = Oracle(ks0.raw, ins, dels)
    checked = check_reads(svc, oracle, rng, "staged", N_GET, N_LOOKUP)
    # keep the staged delta slab for the timing phase
    _, _, active, dk_t, dp_t = svc._capture()
    emit({"phase": "staged_reads", "write_s": write_s, "checked": checked,
          "delta_entries": len(active)})

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
    checked1 = check_reads(svc, oracle1, rng, "compacted", N_GET, N_LOOKUP)
    log0 = svc.compaction_log[-1]
    main_s = time.perf_counter() - t_main
    launches = dict(LAUNCHES)
    ledger = ops.dispatch_summary()
    emit({"phase": "compaction", "flush_s": flush_s, "leaves_refit": log0.leaves_refit,
          "max_window": snap1.index.max_window, "checked": checked1})
    emit({"phase": "main_path", "seconds": main_s, "launches": launches,
          "dispatch_rows": ledger["rows"]})
    merged_rows = [r for r in ledger["rows"] if r["op"] == "merged_lookup"]
    check(bool(merged_rows) and all(r["path"] == "kernel" for r in merged_rows),
          "merged_lookup rows must all be on path kernel")
    check(all(v > 0 for v in launches.values()), f"a kernel never launched: {launches}")

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
          "flush_s": flush_s})

    big = times[-1]
    src = "src/repro_torch/kernels/csrc/rmi_lookup.cu"
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
    ], "batch": big["batch"], "n": int(ks0.n), "card": smi,
        "total_s": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
