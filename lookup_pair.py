#!/usr/bin/env python3
"""The sharded merged lookup (B4) and the §4 hash probe (B7) of this tree
against an earlier tree's kernels, in turns, in one process on one card.

    python3 lookup_pair.py --parent DIR            # the Maps scale: 200M keys
    python3 lookup_pair.py --parent DIR --n 2000000

DIR holds an earlier checkout (``git archive 12efced`` unpacked) whose
``src/repro_torch/kernels/csrc/{rmi_lookup,probe}.cu`` have that commit's
launch signatures: one thread a (shard, query) reading four separate
leaf arrays, and a hash probe reading separate key and link arrays
(`PARENT_ARGTYPES`).  Every source is built with this tree's nvcc
flags.

Inputs, made from ``--seed``: the cut K = 4 cell of `chip_smoke.py`
(`ShardedIndexService(num_shards=4, strategy="sharded_fused")` over every
8th key of gen_maps(n) with `chip_smoke.write_set`'s inserts and
deletes, its staged plan, 1<<20 stored, absent and edge queries), the
same with eight shards, and the §4 map over all n keys with S = n slots,
probed by 1<<20 and 1<<24 stored keys.  Every output is held against the
plain twin bit for bit; times are CUDA events over 20 launches, the
kernels in turns (parent, change, change, parent).  The ptxas report of
this tree's kernels is printed first.  Prints JSON lines; the last is
``{"ok": true, ...}``.  Without a card it exits non-zero before printing
any result.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys

import numpy as np

import chip_smoke as cs
from scan_pair import emit, in_turns, load_parent

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
PARENT_ARGTYPES = {
    "rmi_lookup.cu": {
        # q, S, B, s0, nl, h1, h2, leaf_w, leaf_b, err_lo, err_hi, keys,
        # dkeys, dprefix, D, shard_n, shard_m, shard_ratio, steps, dsteps,
        # strides, out_base, out_contrib, stream
        "rmi_sharded_lookup_launch": [_P, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                                      _I, _P, _P, _P, _I, _I, _P, _P, _P, _P]},
    "probe.cu": {
        # q, B, s0, leaf_w, leaf_b, M, f32(M/n), f32(n-1), slot_key,
        # slot_next, S, f32(S/n), ovf_key, ovf_next, O, trips, out, stream
        "hash_probe_launch": [_P, _I, _P, _P, _P, _I, _F, _F, _P, _P, _I, _F, _P, _P, _I,
                              _I, _P, _P]},
}
BATCH = 1 << 20
HASH_BATCHES = (1 << 20, 1 << 24)


def parent_sharded(lib, q, s0, leaf_w, leaf_b, err_lo, err_hi, keys, dkeys, dprefix,
                   shard_n, shard_m, shard_ratio, *, hidden, max_window):
    """The earlier tree's sharded lookup: one thread a (shard, query),
    four separate (S, M) leaf arrays with contiguous rows."""
    import torch
    from repro_torch.kernels import nvcc, rmi_lookup
    S, B = q.shape
    leaves = (leaf_w, leaf_b, err_lo, err_hi)
    strides = [t.stride(0) for t in (q, s0, *leaves, keys, dkeys, dprefix)]
    buf = (ctypes.c_longlong * 9)(*strides)
    base = torch.empty((S, B), dtype=torch.int32, device=q.device)
    contrib = torch.empty_like(base)
    d = dkeys.shape[1]
    err = lib.rmi_sharded_lookup_launch(
        q.data_ptr(), S, B, s0.data_ptr(), len(hidden) + 1,
        hidden[0] if hidden else 0, hidden[1] if len(hidden) > 1 else 0,
        *(a.data_ptr() for a in leaves), keys.data_ptr(), dkeys.data_ptr(),
        dprefix.data_ptr(), d, shard_n.data_ptr(), shard_m.data_ptr(), shard_ratio.data_ptr(),
        rmi_lookup._search_steps(max_window), rmi_lookup._search_steps(d),
        ctypes.addressof(buf), base.data_ptr(), contrib.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    nvcc.raise_on_error(err, "parent rmi_sharded_lookup")
    return base, contrib


def parent_hash(lib, q, s0, leaf_w, leaf_b, slot_key, slot_next, ovf_key, ovf_next, *,
                n, num_leaves, num_slots, trips):
    """The earlier tree's hash probe: separate key and link arrays."""
    import torch
    from repro_torch.kernels import nvcc
    out = torch.empty(q.shape, dtype=torch.bool, device=q.device)
    err = lib.hash_probe_launch(
        q.data_ptr(), q.shape[0], s0.data_ptr(), leaf_w.data_ptr(), leaf_b.data_ptr(),
        num_leaves, float(np.float32(num_leaves / n)), float(np.float32(n - 1)),
        slot_key.data_ptr(), slot_next.data_ptr(), num_slots,
        float(np.float32(num_slots / n)), ovf_key.data_ptr(), ovf_next.data_ptr(),
        ovf_key.shape[0], trips, out.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream)
    nvcc.raise_on_error(err, "parent hash_probe")
    return out


def run_sharded(lib, raw, rng, dev, shards):
    import torch
    from repro_torch.index_service import ServiceConfig, ShardedIndexService
    from repro_torch.kernels import ref
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
    separate = (*args[:2], *(a.contiguous() for a in args[2:6]), *args[6:])
    row = {"kernel": "rmi_sharded_merged_lookup_cuda", "n": int(base.size), "shards": shards,
           "batch": BATCH, "max_window": int(plan.max_window),
           "delta_padded": int(plan.dkeys.shape[1])}
    row.update(in_turns(lambda: parent_sharded(lib, *separate, **kw),
                        lambda: rmi_sharded_merged_lookup_cuda(*args, **kw),
                        lambda: ref.rmi_sharded_merged_lookup_reference(*args, **kw),
                        cs.lookup_mismatch))
    emit(row)
    return row


def run_hash(lib, raw, rng, dev):
    import torch
    from repro_torch.core import build_model_hashmap
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.hash_probe import hash_probe_cuda
    hm, idx, ks = build_model_hashmap(raw, raw.size, device=dev)
    tabs = ops.hash_probe_tensors(hm, idx, ks, dev)
    separate = tuple(t.contiguous() for t in tabs)
    kw = cs.hash_kwargs(hm, idx)
    rows = []
    for batch in HASH_BATCHES:
        q = torch.as_tensor(ks.norm[rng.choice(ks.n, batch)], device=dev)
        row = {"kernel": "hash_probe_cuda", "n": int(ks.n), "batch": batch,
               "max_chain": int(hm.max_chain)}
        row.update(in_turns(lambda: parent_hash(lib, q, *separate, **kw),
                            lambda: hash_probe_cuda(q, *tabs, **kw),
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
    from repro_torch.data import gen_maps
    from repro_torch.kernels import hash_probe, rmi_lookup

    csrc = args.parent / "src/repro_torch/kernels/csrc"
    if not all((csrc / src).is_file() for src in PARENT_ARGTYPES):
        print(f"lookup_pair: no parent sources under {csrc}", file=sys.stderr)
        return 2
    dev = torch.device(cs.DEVICE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    parent_lookup, parent_probe = (load_parent(csrc / src, declare)
                                   for src, declare in PARENT_ARGTYPES.items())
    rmi_lookup.build()
    hash_probe.build()
    emit({"phase": "build", "ptxas": {
        **cs.ptxas_resources(rmi_lookup, ("rmi_sharded_lookup_kernel",)),
        **cs.ptxas_resources(hash_probe, ("hash_probe_kernel",))}})
    rng = np.random.default_rng((args.seed, 3))
    raw = gen_maps(args.n, seed=args.seed)
    rows = [run_sharded(parent_lookup, raw, rng, dev, k) for k in (4, 8)]
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
