#!/usr/bin/env python3
"""The flash-attention kernels (B9 and its backward) of this tree against
an earlier tree's, in turns, in one process on one card.

    python3 attention_pair.py --parent DIR

DIR holds an earlier checkout (``git archive <commit>`` unpacked).  Each
tree's kernels are called through that tree's own wrapper: DIR's
``src/repro_torch/kernels/flash_attention.py`` is loaded as a module of
its own with its sources pointed at DIR's ``flash_attention.cu`` and
``flash_attention_bwd.cu``, so the script follows any launch signature
whose Python wrappers (`flash_attention_cuda`, `flash_attention_bwd_cuda`)
take the same arguments.  Each tree builds with its own flags, and
ptxas's registers and spills are printed for each instance.

Inputs, made from ``--seed``: bf16 causal attention at yi-6b's heads
(32 query heads, 4 KV heads of 128) and S = 4,096.  The forward, at the
prefill batch (B = 2) and the training microbatch (B = 1): both kernels'
outputs held bit for bit against each other (neither call stores the
log-sum-exp).  The backward, at the training microbatch: both
gradients from the same output, log-sum-exp and output gradient, held
to each other at `chip_smoke.py`'s bf16 tolerance (max |Δ| <= 2e-2 x
max |parent|, relative L2 <= 1e-2), not bit for bit (the designs sum in
other orders).  With ``--bwd-bits`` (a parent of the same backward
design) the backward must instead give the parent's bits there and at
`BWD_BITS_SHAPES` (square shapes in both dtypes, causal and full, ragged
lengths, every head dim), and its time must stay within `RATIO_BAND`
of the parent's.  Times are CUDA events, kernels in turns (parent,
change, change, parent, parent, change; both trees the same
repetitions); the change's backward is also split by launch (its four
kernels' mean device time under `torch.profiler`).

The control of `chip_smoke.py`'s relative L2 bound on the bf16 gradient
(`ATTN_BWD_SPLIT_REL_L2`): this tree's backward built as well with
``-DATTN_BWD_SINGLE_BF16`` (P and dS fed to dV, dK and dQ as one bf16
value, the lo products left out), both builds held against the plain
twin at S = 77, 1,000 and the training shape; the row gives each
gradient's relative L2 error beside the bound.  Prints JSON lines; the
last is ``{"ok": true, ...}``.  Without a card it exits non-zero before
printing any result.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import math
import pathlib
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import chip_smoke as cs

SHAPES = ((2, 32, 4, 4096, 128), (1, 32, 4, 4096, 128))   # (B, Hq, Hkv, S, D)
BWD_SHAPE = cs.TRAIN_ATTN_SHAPE
TURNS = ("parent", "change", "change", "parent", "parent", "change")
# (B, Hq, Hkv, S, D, causal) of the control, the last the training shape
CONTROL_SHAPES = ((1, 4, 2, 77, 64, False), (1, 8, 2, 1000, 128, True), (*BWD_SHAPE, True))
# (B, Hq, Hkv, S, D) of the square backward held bit for bit with --bwd-bits
BWD_BITS_SHAPES = ((1, 4, 2, 77, 32), (2, 8, 2, 130, 64), (1, 8, 1, 64, 128),
                   (1, 16, 4, 1000, 128), (2, 16, 16, 3072, 64))
RATIO_BAND = (0.97, 1.03)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _in_turns(parent, change, reps):
    times = {"parent": [], "change": []}
    for who in TURNS:
        times[who].append(cs.time_ms(parent if who == "parent" else change,
                                     reps=reps, warmup=3))
    return times


def _control(dev, g, control_lib):
    """Each gradient's relative L2 error against the plain twin, of this
    tree's bf16 backward and of its single-bf16 build, at
    `CONTROL_SHAPES`."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import nvcc, ref
    rows = []
    for b, hq, hkv, s, d, causal in CONTROL_SHAPES:
        q, k, v = (torch.randn((b, h, s, d), generator=g, device=dev).to(torch.bfloat16)
                   for h in (hq, hkv, hkv))
        with torch.no_grad():
            out, lse = fa.flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
        d_out = torch.randn(out.shape, generator=g, device=dev).to(torch.bfloat16)
        split = fa.flash_attention_bwd_cuda(q, k, v, out, lse, d_out, causal=causal)
        single = [torch.empty_like(t) for t in (q, k, v)]
        scratch = torch.empty(fa._bwd_scratch_floats(q.dtype, b, hq, s, s, d),
                              dtype=torch.float32, device=dev)
        err = control_lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), d_out.data_ptr(),
            lse.data_ptr(), scratch.data_ptr(), *(t.data_ptr() for t in single),
            b, hq, hkv, s, s, d, 1, 1.0 / math.sqrt(d), int(causal),
            torch.cuda.current_stream(dev).cuda_stream)
        nvcc.raise_on_error(err, "single-bf16 flash_attention_bwd")
        want = ref.mha_backward_reference(q, k, v, out, lse, d_out, causal=causal)
        torch.cuda.synchronize()

        def rel_l2(got):
            return {tag: float((x.float() - w.float()).norm() / w.float().norm())
                    for tag, x, w in zip(("dq", "dk", "dv"), got, want)}

        row = {"shape": [b, hq, hkv, s, d], "causal": causal,
               "limit": cs.ATTN_BWD_SPLIT_REL_L2, "split_rel_l2": rel_l2(split),
               "single_rel_l2": rel_l2(single)}
        row["split_within"] = max(row["split_rel_l2"].values()) <= row["limit"]
        row["single_over"] = min(row["single_rel_l2"].values()) > row["limit"]
        cs.check(row["split_within"], f"bf16 backward over its relative L2 bound: {row}")
        rows.append(row)
        del q, k, v, out, lse, d_out, split, single, scratch, want
    return rows


def _bwd_bits(dev, g, parent_fa, fa):
    """Whether the change's backward gives the parent's bits at each of
    `BWD_BITS_SHAPES`, in both dtypes, causal and full."""
    import torch
    rows = []
    for b, hq, hkv, s, d in BWD_BITS_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                q, k, v = (torch.randn((b, h, s, d), generator=g, device=dev).to(dt)
                           for h in (hq, hkv, hkv))
                with torch.no_grad():
                    out, lse = fa.flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
                d_out = torch.randn(out.shape, generator=g, device=dev).to(dt)
                want = parent_fa.flash_attention_bwd_cuda(q, k, v, out, lse, d_out,
                                                          causal=causal)
                got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, d_out, causal=causal)
                equal = all(torch.equal(x, w) for x, w in zip(got, want))
                row = {"shape": [b, hq, hkv, s, d], "dtype": str(dt).split(".")[1],
                       "causal": causal, "bits_equal": equal}
                cs.check(equal, f"backward parent and change differ in bits: {row}")
                rows.append(row)
    return rows


def _by_launch(fn, reps):
    """Mean device ms a call of each kernel ``fn`` launches, from
    `torch.profiler`'s CUDA activity over ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            m = re.search(r"attention_\w+(?:<\d+>)?", e.key)
            out[m.group(0) if m else e.key[:60]] = e.device_time_total / 1e3 / reps
    return out


def _parent_wrapper(root):
    """DIR's `kernels/flash_attention.py` as a module of its own, its
    sources pointed at DIR's; None (with the reason on stderr) if DIR
    lacks one of them."""
    kernels = root / "src/repro_torch/kernels"
    files = (kernels / "flash_attention.py", kernels / "csrc/flash_attention.cu",
             kernels / "csrc/flash_attention_bwd.cu")
    for path in files:
        if not path.is_file():
            print(f"attention_pair: no {path}", file=sys.stderr)
            return None
    spec = importlib.util.spec_from_file_location("parent_flash_attention", files[0])
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.SOURCE, module.BWD_SOURCE = files[1], files[2]
    return module


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, required=True,
                    help="root of the earlier checkout")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bwd-bits", action="store_true",
                    help="the parent has this backward design: hold its bits and time")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("attention_pair: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import nvcc, ref

    parent_fa = _parent_wrapper(args.parent)
    if parent_fa is None:
        return 2
    dev = torch.device(cs.DEVICE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    control_flags = (*fa.FLAGS, "-DATTN_BWD_SINGLE_BF16")
    builds = {"parent": (parent_fa.SOURCE, parent_fa.FLAGS),
              "change": (fa.SOURCE, fa.FLAGS),
              "parent_bwd": (parent_fa.BWD_SOURCE, parent_fa.FLAGS),
              "change_bwd": (fa.BWD_SOURCE, fa.FLAGS),
              "control_bwd": (fa.BWD_SOURCE, control_flags)}
    with ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda job: nvcc.build(*job), builds.values()))
    control_lib = ctypes.CDLL(str(nvcc.library_path(fa.BWD_SOURCE, control_flags)))
    fa.declare_backward(control_lib)
    for name, (src, flags) in builds.items():
        if name != "control_bwd":
            log = nvcc.library_path(src, flags).with_suffix(".log")
            emit({"phase": "build", "tree": name, "ptxas": cs.ptxas_entries(log)})

    g = torch.Generator(device=dev).manual_seed(args.seed)
    rows = []
    for b, hq, hkv, s, d in SHAPES:
        q, k, v = (torch.randn((b, h, s, d), generator=g, device=dev).to(torch.bfloat16)
                   for h in (hq, hkv, hkv))

        def parent():
            return parent_fa.flash_attention_cuda(q, k, v, causal=True)

        def change():
            return fa.flash_attention_cuda(q, k, v, causal=True)

        bits_equal = bool(torch.equal(parent(), change()))
        cs.check(bits_equal, f"parent and change differ at {b, hq, hkv, s, d}")
        times = _in_turns(parent, change, 50)
        row = {"kernel": "flash_attention_cuda", "shape": [b, hq, hkv, s, d],
               "dtype": "bfloat16", "causal": True, "bits_equal": bits_equal,
               "parent_ms": times["parent"], "change_ms": times["change"],
               "ratio": sum(times["change"]) / sum(times["parent"])}
        emit(row)
        rows.append(row)

    b, hq, hkv, s, d = BWD_SHAPE
    q, k, v = (torch.randn((b, h, s, d), generator=g, device=dev).to(torch.bfloat16)
               for h in (hq, hkv, hkv))
    with torch.no_grad():
        out, lse = fa.flash_attention_cuda(q, k, v, causal=True, return_lse=True)
    d_out = torch.randn(out.shape, generator=g, device=dev).to(torch.bfloat16)

    def parent_bwd():
        return parent_fa.flash_attention_bwd_cuda(q, k, v, out, lse, d_out, causal=True)

    def change_bwd():
        return fa.flash_attention_bwd_cuda(q, k, v, out, lse, d_out, causal=True)

    grads, got = parent_bwd(), change_bwd()
    torch.cuda.synchronize()
    tol, rel_tol = cs.ATTN_BWD_TOL["bfloat16"], cs.ATTN_BWD_REL_L2
    held = {"bits_equal": all(torch.equal(x, w) for x, w in zip(got, grads))}
    for tag, x, w in zip(("dq", "dk", "dv"), got, grads):
        x, w = x.float(), w.float()
        held[tag] = {"max_abs_err": float((x - w).abs().max()),
                     "max_abs_parent": float(w.abs().max()),
                     "rel_l2": float((x - w).norm() / w.norm())}
        cs.check(held[tag]["max_abs_err"] <= tol * held[tag]["max_abs_parent"]
                 and held[tag]["rel_l2"] <= rel_tol,
                 f"backward parent and change differ in {tag}: {held[tag]}")
    times = _in_turns(parent_bwd, change_bwd, 20)
    ratio = sum(times["change"]) / sum(times["parent"])
    row = {"kernel": "flash_attention_bwd_cuda", "shape": [b, hq, hkv, s, d],
           "dtype": "bfloat16", "causal": True, "vs_parent": held,
           "parent_ms": times["parent"], "change_ms": times["change"], "ratio": ratio,
           "change_launch_ms": _by_launch(change_bwd, reps=5)}
    if args.bwd_bits:
        cs.check(held["bits_equal"], "backward parent and change differ in bits")
        cs.check(RATIO_BAND[0] <= ratio <= RATIO_BAND[1],
                 f"backward time ratio {ratio} outside {RATIO_BAND}")
        row["bits_shapes"] = _bwd_bits(dev, g, parent_fa, fa)
    emit(row)
    rows.append(row)
    del q, k, v, out, lse, d_out, grads, got
    control = _control(dev, g, control_lib)
    emit({"kernel": "flash_attention_bwd_cuda", "control": control})
    print(smi, flush=True)
    emit({"ok": True, "card": smi, "torch": torch.__version__,
          "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()},
          "rows": rows, "control": control})
    return 0


if __name__ == "__main__":
    sys.exit(main())
