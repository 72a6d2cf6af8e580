#!/usr/bin/env python3
"""The flash-attention forward kernel (B9) of this tree against an
earlier tree's, in turns, in one process on one card.

    python3 attention_pair.py --parent DIR

DIR holds an earlier checkout (``git archive 7ac87eb`` unpacked) whose
``src/repro_torch/kernels/csrc/flash_attention.cu`` has that commit's
launch signature, without the log-sum-exp pointer (`PARENT_ARGTYPES`).
Both sources are built with this tree's attention flags, and ptxas's
registers and spills are printed for each instance.

Inputs, made from ``--seed``: bf16 causal attention at yi-6b's heads
(32 query heads, 4 KV heads of 128) and S = 4,096, at the prefill batch
(B = 2) and the training microbatch (B = 1).  Both kernels' outputs are
held bit for bit against each other (the inference call passes no
log-sum-exp pointer); times are CUDA events over 50 launches, kernels in
turns (parent, change, change, parent, parent, change).  Prints JSON
lines; the last is ``{"ok": true, ...}``.  Without a card it exits
non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import pathlib
import subprocess
import sys

import chip_smoke as cs

SHAPES = ((2, 32, 4, 4096, 128), (1, 32, 4, 4096, 128))   # (B, Hq, Hkv, S, D)
_P, _I = ctypes.c_void_p, ctypes.c_int
# q, k, v, out, B, Hq, Hkv, S, D, dtype, scale, causal, stream
PARENT_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, required=True,
                    help="root of the earlier checkout")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("attention_pair: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import nvcc

    parent_src = args.parent / "src/repro_torch/kernels/csrc/flash_attention.cu"
    if not parent_src.is_file():
        print(f"attention_pair: no {parent_src}", file=sys.stderr)
        return 2
    dev = torch.device(cs.DEVICE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    lib = ctypes.CDLL(str(nvcc.build(parent_src, fa.FLAGS)))
    lib.flash_attention_launch.argtypes = PARENT_ARGTYPES
    lib.flash_attention_launch.restype = _I
    fa.build()
    for name, src in (("parent", parent_src), ("change", fa.SOURCE)):
        log = nvcc.library_path(src, fa.FLAGS).with_suffix(".log")
        emit({"phase": "build", "tree": name, "ptxas": cs.ptxas_entries(log)})

    g = torch.Generator(device=dev).manual_seed(args.seed)
    rows = []
    for b, hq, hkv, s, d in SHAPES:
        q, k, v = (torch.randn((b, h, s, d), generator=g, device=dev).to(torch.bfloat16)
                   for h in (hq, hkv, hkv))
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def parent():
            err = lib.flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv, s, d,
                1, 1.0 / math.sqrt(d), 1, stream)
            nvcc.raise_on_error(err, "parent flash_attention")

        def change():
            return fa.flash_attention_cuda(q, k, v, causal=True)

        parent()
        cs.check(torch.equal(out, change()), f"parent and change differ at {b, hq, hkv, s, d}")
        times = {"parent": [], "change": []}
        for who in ("parent", "change", "change", "parent", "parent", "change"):
            times[who].append(cs.time_ms(parent if who == "parent" else change,
                                         reps=50, warmup=5))
        row = {"kernel": "flash_attention_cuda", "shape": [b, hq, hkv, s, d],
               "dtype": "bfloat16", "causal": True, "parent_ms": times["parent"],
               "change_ms": times["change"],
               "ratio": sum(times["change"]) / sum(times["parent"])}
        emit(row)
        rows.append(row)
    print(smi, flush=True)
    emit({"ok": True, "card": smi, "torch": torch.__version__,
          "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()},
          "rows": rows})
    return 0


if __name__ == "__main__":
    sys.exit(main())
