"""Serving entry point: batched decode through `ServeEngine` on one card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
        --requests 16 --max-new 32 --batch-slots 8 --max-len 512

The reference's flags and JSON line (`repro/launch/serve.py`), plus
``--device`` (default ``cuda``; ``cpu`` runs the plain path on the host)
and ``--seed`` (parameters from a seeded `torch.Generator` on the
device, prompts from `np.random.default_rng(seed)`, the
``--prefix-bloom`` classifier's weights and batches from ``seed``), and
a ``truncated`` count in the output.  ``--prefix-bloom`` builds the
reference's learned prefix filter (512 ``prefix-%04d`` keys, 2,048
``other-%05d`` non-keys, a W = 8, E = 8 GRU over 16 bytes, 150 steps)
on ``--device`` and hands it to the engine's prefix screen.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.learned_bloom import GRUSpec, build_learned_bloom
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--prefix-bloom", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch, reduced=args.reduced)
    api = get_model(cfg, dev)
    params = api.init(torch.Generator(device=dev).manual_seed(args.seed))

    bloom = None
    if args.prefix_bloom:
        keys = [f"prefix-{i:04d}" for i in range(512)]
        negs = [f"other-{i:05d}" for i in range(2048)]
        bloom = build_learned_bloom(
            keys, negs, target_fpr=0.01,
            spec=GRUSpec(width=8, embed=8, max_len=16), train_steps=150,
            seed=args.seed, device=dev,
        )

    engine = ServeEngine(
        api, params, batch_slots=args.batch_slots, max_len=args.max_len,
        prefix_bloom=bloom,
    )
    rng = np.random.default_rng(args.seed)
    reqs = [
        Request(
            uid=i,
            prompt=[int(t) for t in rng.integers(0, cfg.vocab_size, rng.integers(4, 12))],
            max_new_tokens=args.max_new,
        )
        for i in range(args.requests)
    ]
    t0 = time.time()
    done = engine.run(reqs)
    dt = time.time() - t0
    toks = sum(len(r.generated) for r in done)
    out = {
        "completed": len(done),
        "tokens": toks,
        "tok_per_s": round(toks / dt, 1),
        "kv_pages_in_use": engine.kv.num_allocated,
        "prefix_cache_hits": engine.prefix_cache_hits,
        "truncated": sum(r.truncated for r in done),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
