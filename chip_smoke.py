#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # the paper's Maps scale: 200M keys
    python3 chip_smoke.py --n 2000000   # a quick rehearsal of every phase

Phases, each printing JSON lines; any mismatch raises and the exit code
is non-zero:

  1. card    — the card's name and power limit (nvidia-smi), the two
               kernel libraries built in parallel and their compiler
               resource reports;
  2. kernels — each CUDA kernel against its plain PyTorch version on the
               card, bit for bit: the lookups at n = 50k (linear and
               (16,16) MLP stage-0, and a duplicate-heavy key set) and on
               the full service index (stored, absent, leaf-boundary,
               duplicate-run and out-of-range queries, batches of 1, 777
               and 1<<20, an empty delta and one of 1<<20 entries); the
               scans at n = 50k (float32 ties between staged inserts and
               base keys, NaN / inverted / out-of-span bounds, negative
               and wrapping page starts, unpadded power-of-two deltas);
  3. main path — `IndexService(strategy="cuda_fused")` over
               gen_maps(n) with a zero payload: every stored key at its
               float32 lower bound, then 300k inserts (values 1..300k) +
               300k deletes checked through get / lookup_batch /
               range_lookup / contains against NumPy oracles, ~30 range
               scans through scan_batch / scan_page_fn / scan, a warm
               compaction (flush) and the same checks again.  Each path
               (lookups, scans) runs with the launch counts zeroed just
               before and read just after; the dispatch ledger of the
               whole run;
  4. times   — kernel, plain version and torch.searchsorted (the
               paper's binary-search yardstick, timed only) with CUDA
               events, the bound from bytes over 3.35 TB/s, lookup_batch
               queries/s end to end; both scan kernels and their plain
               versions at 1<<20 and 1<<22 rows, scan_batch rows/s and
               the host build of the scan slab (`scan.pack_slab`).

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
N_GET = 1_000_000
N_LOOKUP = 4_000_000
SCAN_PAGE_SIZES = (256, 160, 1)
SCAN_WIDTHS = (1, 2, 3, 10, 100, 1_000, 4_097, 10_000, 65_536, 100_000)
BIG_SCANS = (1 << 20, 1 << 22)  # rows of the two timed ranges
HOST_SCAN_ROWS = 100_000        # host `scan` checked on ranges up to this wide
DEVICE = "cuda"


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
    delta and unpadded power-of-two delta arrays; NaN, inverted,
    infinite and out-of-span bounds; page starts that are negative,
    past the end or wrap int32.  Returns the max |kernel - plain|."""
    import torch
    from repro_torch.core import make_keyset
    from repro_torch.data import gen_maps
    from repro_torch.index_service.scan import device_scan_plan, device_scan_slab
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmi_scan import rmi_scan_page_cuda, rmi_scan_range_cuda

    t = lambda a: torch.as_tensor(np.asarray(a), device=device)  # noqa: E731
    worst = 0.0
    for label, raw in (("maps50k", gen_maps(SMALL_N, seed=4)),
                       ("dup50k", np.unique(_dup_heavy(rng, SMALL_N)))):
        ks = make_keyset(raw)
        bvals = rng.integers(-(1 << 40), 1 << 40, ks.n)
        fresh = _absent(raw, rng.uniform(raw[0], raw[-1], 3000))
        # raw keys a hair above stored ones: distinct, same float32 key
        ties = _absent(raw, raw[rng.choice(ks.n, 500)] * (1 + 1e-13) + 1e-9)
        deltas = {
            "staged": (np.unique(np.concatenate([fresh[:1500], ties])),
                       np.sort(rng.choice(raw, 2000, replace=False))),
            "tombstones": (np.empty(0), np.sort(rng.choice(raw, 4096, replace=False))),
            "empty": (np.empty(0), np.empty(0)),
            "pow2": (np.sort(fresh[:1024]), np.sort(rng.choice(raw, 1024, replace=False))),
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
                      [ks.normalize(ties[:1])[0], ks.normalize(ties[-1:])[0]]]
            starts = np.array([-7, 0, 1, live // 2, live - 3, live, live + 99,
                               2**31 - 9], np.int32)
            for page_size in SCAN_PAGE_SIZES:
                pages = min(-(-live // page_size) + 2, 4096)
                for b in bounds:
                    bt = t(np.asarray(b, np.float32))
                    kw = dict(page_size=page_size, max_pages=pages)
                    got = rmi_scan_range_cuda(bt, base, bv, *slab, **kw)
                    want = ref.rmi_scan_range_reference(bt, base, bv, *slab, **kw)
                    err = scan_mismatch(got, want)
                    worst = max(worst, err)
                    check(err == 0, f"scan_range kernel != plain: {label}/{dname}/{b}/{page_size}")
                run = np.concatenate([starts, (page_size * np.arange(pages)).astype(np.int32)])
                endt = t(np.array([live], np.int32))
                got = rmi_scan_page_cuda(t(run), base, bv, *plan, endt, page_size=page_size)
                want = ref.rmi_scan_page_reference(t(run), base, bv, *plan, endt,
                                                   page_size=page_size)
                err = scan_mismatch(got, want)
                worst = max(worst, err)
                check(err == 0, f"scan_page kernel != plain: {label}/{dname}/{page_size}")
                empty = rmi_scan_page_cuda(t(np.empty(0, np.int32)), base, bv, *plan, endt,
                                           page_size=page_size)
                check(all(tuple(e.shape) == (0, page_size) for e in empty), "G = 0 pages")
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
    from repro_torch.index_service.scan import device_scan_slab, scan_page_bound
    from repro_torch.kernels import ops, ref, rmi_lookup, rmi_scan
    from repro_torch.kernels.rmi_lookup import rmi_lookup_cuda, rmi_merged_lookup_cuda
    from repro_torch.kernels.rmi_scan import rmi_scan_page_cuda, rmi_scan_range_cuda

    def reset_counts():
        rmi_lookup.reset_launch_counts()
        rmi_scan.reset_launch_counts()

    def read_counts():
        return {**rmi_lookup.LAUNCHES, **rmi_scan.LAUNCHES}

    t_start = time.perf_counter()
    dev = torch.device(DEVICE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"{smi} (torch {torch.__version__}, CUDA {torch.version.cuda})"

    # ---- phase 1: card + build (one nvcc per source, all at once) --------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        libs = list(pool.map(lambda m: m.build(), (rmi_lookup, rmi_scan)))
    build_s = time.perf_counter() - t0
    for lib in libs:
        log = lib.with_suffix(".log").read_text() if lib.with_suffix(".log").exists() else ""
        emit({"phase": "build", "seconds": build_s, "library": lib.name,
              "ptxas": [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]})

    # ---- phase 2: kernels against plain versions at n = 50k -----------
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
    scan_record = []
    scan_worst = compare_scan_kernels(rng, dev, scan_record)
    emit({"phase": "scan_kernels_vs_plain", "max_abs_err": scan_worst, "rows": scan_record})

    # ---- phase 3: the main path at scale ---------------------------------
    t0 = time.perf_counter()
    base = gen_maps(args.n, seed=args.seed)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    # a zero payload, so scans carry the staged inserts' values through
    # compaction (gen_maps returns sorted unique keys)
    svc = IndexService(base, ServiceConfig(strategy="cuda_fused", delta_capacity=1 << 20),
                       vals=np.zeros(base.size, np.int64), device=dev)
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

    # -- the main path: each path's counts zeroed just before it, read
    # just after; the dispatch ledger covers the whole run ---------------
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
    # keep the staged delta slab for the timing phase
    _, _, active, dk_t, dp_t = svc._capture()
    emit({"phase": "staged_reads", "write_s": write_s, "checked": checked,
          "delta_entries": len(active)})
    windows.append(("lookup", read_counts()))

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
    main_s = time.perf_counter() - t_main
    path_kernels = {"lookup": ("rmi_lookup_cuda", "rmi_merged_lookup_cuda"),
                    "scan": ("rmi_scan_range_cuda", "rmi_scan_page_cuda")}
    launches = {k: 0 for ks in path_kernels.values() for k in ks}
    for path, counts in windows:
        for k in path_kernels[path]:
            launches[k] += counts[k]
    ledger = ops.dispatch_summary()
    emit({"phase": "compaction", "flush_s": flush_s, "leaves_refit": log0.leaves_refit,
          "max_window": snap1.index.max_window, "checked": checked1})
    emit({"phase": "main_path", "seconds": main_s, "launches": launches,
          "windows": windows, "dispatch_rows": ledger["rows"]})
    for op in ("merged_lookup", "rmi_scan_range", "rmi_scan_page"):
        rows = [r for r in ledger["rows"] if r["op"] == op]
        check(bool(rows) and all(r["path"] == "kernel" for r in rows),
              f"{op} rows must all be on path kernel")
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

    big = times[-1]
    sbig = scan_times[-1]
    src = "src/repro_torch/kernels/csrc/rmi_lookup.cu"
    scan_src = "src/repro_torch/kernels/csrc/rmi_scan.cu"
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
    ], "batch": big["batch"], "scan_rows": sbig["rows"], "n": int(ks0.n), "card": smi,
        "total_s": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
