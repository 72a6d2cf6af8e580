#!/usr/bin/env python3
"""The host Bloom build (`core/bloom.build_bloom`) of this tree against an
earlier tree's, in turns, in one process on the card's host.

    python3 bloom_pair.py --parent DIR [--n 200000000] [--fpr 0.01]

DIR holds an earlier checkout (``git archive 84b729e`` unpacked), whose
``src/repro_torch/core/bloom.py`` sets the bits with `np.bitwise_or.at`.
The keys are the main path's: ``gen_maps(n, seed)`` made unique, as the
single-shard service of `chip_smoke.py` builds its screen over them
(`build_snapshot` -> ``build_bloom(keys.raw, fpr=0.01)``, at the build
and again at every flush).  Builds in turns (parent, change, change,
parent), wall-clock seconds each; the words of every build must be equal.
Prints JSON lines, the card's ``nvidia-smi`` line and the host's core
count beside the times; the last line is ``{"ok": true, ...}``.  The
times are the card's host's, so without a card it exits non-zero before
making any key.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

TURNS = ("parent", "change", "change", "parent")


def _module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod           # its dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, required=True)
    ap.add_argument("--n", type=int, default=200_000_000)
    ap.add_argument("--fpr", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("bloom_pair: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.core import bloom
    from repro_torch.data import gen_maps
    parent = _module(args.parent / "src/repro_torch/core/bloom.py", "parent_bloom")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    t0 = time.perf_counter()
    keys = np.unique(gen_maps(args.n, seed=args.seed))
    print(json.dumps({"keys": int(keys.size), "gen_s": time.perf_counter() - t0,
                      "card": smi, "host_cpus": os.cpu_count()}), flush=True)
    words, times = None, {"parent": [], "change": []}
    for who in TURNS:
        build = (parent if who == "parent" else bloom).build_bloom
        t0 = time.perf_counter()
        bf = build(keys, fpr=args.fpr)
        seconds = time.perf_counter() - t0
        times[who].append(seconds)
        same = words is None or np.array_equal(bf.words, words)
        words = bf.words if words is None else words
        print(json.dumps({"turn": who, "seconds": seconds, "num_bits": bf.num_bits,
                          "num_hashes": bf.num_hashes, "words_equal": same}), flush=True)
        if not same:
            print(f"bloom_pair: the {who} build's words differ", file=sys.stderr)
            return 1
        del bf
    print(smi, flush=True)
    print(json.dumps({"ok": True, "keys": int(keys.size), "fpr": args.fpr, "card": smi,
                      "host_cpus": os.cpu_count(), "parent_s": times["parent"],
                      "change_s": times["change"],
                      "speedup": sum(times["parent"]) / sum(times["change"])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
