#!/usr/bin/env python3
"""The page and sharded scan kernels (B6, B5) of this tree against the
per-lane kernels of an earlier tree, in turns, in one process on one card.

    python3 scan_pair.py --parent DIR            # the Maps scale: 200M keys
    python3 scan_pair.py --parent DIR --n 2000000

DIR holds an earlier checkout (``git archive 4dc89c6`` unpacked) whose
``src/repro_torch/kernels/csrc/rmi_scan.cu`` has that commit's launch
signatures: one thread a lane, ``rmi_scan_page_launch`` with the nested
searches' trip counts and ``rmi_sharded_scan_launch`` with the per-lane
chain's (`PARENT_ARGTYPES`).  Both sources are built with this tree's
nvcc flags.

Inputs, made from ``--seed``: the Maps cell's staged state (gen_maps(n),
300k staged inserts and 300k tombstones, a zero payload, as
`chip_smoke.py`'s main path), and the cut K = 4 cell: every 8th of those
keys in four equal shards with 300k inserts and 300k deletes routed to
them (a quarter of the keys each at a small ``--n``).  B6 runs pages of
256 rows over 1<<20 and 1<<22 ranks and a single page (G = 1); B5 the
K = 4 ranges of about 1<<20 and 1<<22 rows.  Every
output is held against the plain twin bit for bit; times are CUDA events
over 20 launches, kernels in turns (parent, change, change, parent).
Prints JSON lines; the last is ``{"ok": true, ...}``.  Without a card it
exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import chip_smoke as cs

PAGE = 256
WIDTHS = (1 << 20, 1 << 22)
SHARDS = 4
_P, _I = ctypes.c_void_p, ctypes.c_int
PARENT_ARGTYPES = {
    # starts, page_size, base, bvals, n, ins, ivals, ni, del_pos, nd,
    # end_rank, lanes, steps, isteps, dsteps, out keys, vals, live, stream
    "rmi_scan_page_launch": [_P, _I, _P, _P, _I, _P, _P, _I, _P, _I, _P, _I, _I, _I, _I,
                             _P, _P, _P, _P],
    # base, bvals, live_prefix, S, n, ins, ivals, ins_rank, ni, ls0,
    # own_lo, own_hi, lanes, psteps, msteps, out keys, vals, live, stream
    "rmi_sharded_scan_launch": [_P, _P, _P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I,
                                _P, _P, _P, _P],
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def load_parent(source: pathlib.Path, declare=PARENT_ARGTYPES):
    """``source`` built with this tree's flags, its launchers declared
    by ``declare`` (name: argtypes)."""
    from repro_torch.kernels import nvcc
    lib = ctypes.CDLL(str(nvcc.build(source)))
    for name, argtypes in declare.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = _I
    return lib


def parent_page(lib, starts, base, bvals, ins, ivals, del_pos, end_rank, *, page_size):
    """The earlier tree's page kernel: one thread a lane."""
    import torch
    from repro_torch.kernels import nvcc, ref, rmi_scan
    n, ni, nd, g = base.shape[0], ins.shape[0], del_pos.shape[0], starts.shape[0]
    out = rmi_scan._outputs(g, page_size, dev=starts.device)
    err = lib.rmi_scan_page_launch(
        starts.data_ptr(), page_size, base.data_ptr(), bvals.data_ptr(), n, ins.data_ptr(),
        ivals.data_ptr(), ni, del_pos.data_ptr(), nd, end_rank.data_ptr(), g * page_size,
        *ref.trip_counts(n, ni, nd), *(o.data_ptr() for o in out),
        torch.cuda.current_stream(starts.device).cuda_stream)
    nvcc.raise_on_error(err, "parent rmi_scan_page")
    return out


def parent_sharded(lib, base, bvals, lp, ins, ivals, ins_rank, ls0, own_lo, own_hi, *,
                   page_size, max_pages):
    """The earlier tree's sharded kernel: one thread a (shard, lane)."""
    import torch
    from repro_torch.kernels import nvcc, ref, rmi_scan
    (S, n), ni = base.shape, ins.shape[1]
    out = rmi_scan._outputs(S, max_pages, page_size, dev=base.device)
    err = lib.rmi_sharded_scan_launch(
        base.data_ptr(), bvals.data_ptr(), lp.data_ptr(), S, n, ins.data_ptr(),
        ivals.data_ptr(), ins_rank.data_ptr(), ni, ls0.data_ptr(), own_lo.data_ptr(),
        own_hi.data_ptr(), max_pages * page_size, *ref.trip_counts(n + 1, ni),
        *(o.data_ptr() for o in out), torch.cuda.current_stream(base.device).cuda_stream)
    nvcc.raise_on_error(err, "parent rmi_sharded_scan")
    return out


def in_turns(parent, change, plain, mismatch=cs.scan_mismatch):
    """Both kernels bit for bit against the plain twin (``mismatch`` 0),
    then timed parent, change, change, parent."""
    want = plain()
    errs = [mismatch(f(), want) for f in (parent, change)]
    cs.check(errs == [0, 0], f"kernel != plain twin: parent, change = {errs}")
    ms = [cs.time_ms(f) for f in (parent, change, change, parent)]
    return {"parent_ms": [ms[0], ms[3]], "change_ms": [ms[1], ms[2]],
            "ratio": (ms[1] + ms[2]) / (ms[0] + ms[3])}


def run_page(lib, raw, rng, dev):
    import torch
    from repro_torch.core import make_keyset
    from repro_torch.index_service.scan import device_scan_plan
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmi_scan import rmi_scan_page_cuda
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)  # noqa: E731
    ks = make_keyset(raw)
    ins, ivals, dels = cs.write_set(ks.raw, rng, min(cs.N_WRITES, ks.n // 4))
    view = cs._pin_arrays(ks.raw, np.zeros(ks.n, np.int64), ins, ivals, dels)
    plan = [t(a) for a in device_scan_plan(view, ks.normalize)]
    base, bv = t(ks.norm), t(np.zeros(ks.n, np.int32))
    live = view.live_count
    rows = []
    for w in WIDTHS:
        r0 = live // 3
        starts = t((r0 + PAGE * np.arange(-(-w // PAGE))).astype(np.int32))
        end = t(np.array([r0 + w], np.int32))
        for pages in (starts, starts[:1]):
            args = (pages, base, bv, *plan, end)
            row = {"kernel": "rmi_scan_page_cuda", "n": int(ks.n), "staged_inserts": int(ins.size),
                   "tombstones": int(dels.size), "rows": w, "pages": int(pages.shape[0]),
                   "page_size": PAGE}
            row.update(in_turns(lambda: parent_page(lib, *args, page_size=PAGE),
                                lambda: rmi_scan_page_cuda(*args, page_size=PAGE),
                                lambda: ref.rmi_scan_page_reference(*args, page_size=PAGE)))
            emit(row)
            rows.append(row)
    return rows


def run_sharded(lib, raw, rng, dev):
    import torch
    from repro_torch.index_service.scan import scan_page_bound, stack_scan_slabs
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.rmi_scan import rmi_sharded_scan_page_cuda
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)  # noqa: E731
    sub = raw[::cs.SHARDED_STRIDE]
    ins, ivals, dels = cs.write_set(sub, rng, min(cs.N_WRITES, sub.size // 4))
    cuts = np.linspace(0, sub.size, SHARDS + 1).astype(np.int64)
    views = []
    for s in range(SHARDS):
        part = sub[cuts[s]:cuts[s + 1]]
        top = sub[cuts[s + 1]] if s + 1 < SHARDS else np.inf
        mine = (ins >= (part[0] if s else -np.inf)) & (ins < top)
        views.append(cs._pin_arrays(part, np.zeros(part.size, np.int64), ins[mine],
                                    ivals[mine], dels[(dels >= part[0]) & (dels < top)]))
    p = stack_scan_slabs(views)
    slabs = [t(p[k]) for k in ("base", "bvals", "live_prefix", "ins", "ivals", "ins_rank")]
    rows = []
    for w in WIDTHS:
        lo, hi = sub[sub.size // 3], sub[min(sub.size // 3 + w, sub.size - 1)]
        owners = ops.sharded_scan_owners(t(p["normalize"](np.array([lo, hi]))), slabs[0],
                                         slabs[2], slabs[3])
        kw = dict(page_size=PAGE, max_pages=scan_page_bound(p["raws"], p["ins_total"], lo, hi,
                                                            PAGE))
        args = (*slabs, *owners)
        row = {"kernel": "rmi_sharded_scan_page_cuda", "n": int(sub.size), "shards": SHARDS,
               "rows": int(owners[2][-1] - owners[1][0]), "lanes": SHARDS * kw["max_pages"] * PAGE,
               "page_size": PAGE}
        row.update(in_turns(lambda: parent_sharded(lib, *args, **kw),
                            lambda: rmi_sharded_scan_page_cuda(*args, **kw),
                            lambda: ref.rmi_sharded_scan_page_reference(*args, **kw)))
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
        print("scan_pair: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.data import gen_maps
    from repro_torch.kernels import rmi_scan

    parent_src = args.parent / "src/repro_torch/kernels/csrc/rmi_scan.cu"
    if not parent_src.is_file():
        print(f"scan_pair: no {parent_src}", file=sys.stderr)
        return 2
    dev = torch.device(cs.DEVICE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    with ThreadPoolExecutor(2) as pool:
        built = pool.submit(rmi_scan.build)
        lib = pool.submit(load_parent, parent_src).result()
        log = built.result().with_suffix(".log")
    emit({"phase": "build", "ptxas": [ln.strip() for ln in log.read_text().splitlines()
                                      if "registers" in ln or "spill" in ln
                                      or "entry function" in ln] if log.exists() else []})
    rng = np.random.default_rng((args.seed, 2))
    raw = gen_maps(args.n, seed=args.seed)
    page_rows = run_page(lib, raw, rng, dev)
    torch.cuda.empty_cache()
    sharded_rows = run_sharded(lib, raw, rng, dev)
    print(smi, flush=True)
    emit({"ok": True, "card": smi, "torch": torch.__version__,
          "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()},
          "rows": page_rows + sharded_rows})
    return 0


if __name__ == "__main__":
    sys.exit(main())
