"""Training entry point: data pipeline -> sharded train loop ->
checkpoints.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch yi-9b --reduced --steps 200 --global-batch 8 --seq 128

The reference's flags and returned dict (`repro/launch/train.py`), plus
``--device`` (default ``cuda``; ``cpu`` runs the plain path on the
host).  Fault tolerance in the loop, as in the reference: resume from
the newest intact checkpoint on start, atomic periodic checkpoints, a
straggler policy watching step times, and a data order that derives
any step's batch from the step number alone.  Parameters come from
``torch.Generator(device).manual_seed(0)`` (the reference's
``PRNGKey(0)``; the numbers differ) and are placed on
``make_host_mesh(--model-axis)`` through `param_shardings` and
`device_put`, as the reference places them; a restart restores into the
same shardings.  The mesh's rule is the reference's: its size must
divide by ``--model-axis`` (on one card ``--model-axis 2`` fails that
assertion before anything launches).

On a mesh of more than one rank (a process group started by the caller,
one process a rank) the dense family (yi-6b, yi-9b, mistral-nemo-12b,
mistral-large-123b), the moe family (olmoe-1b-7b, moonshot-v1-16b-a3b,
the experts parallel over ``model``), the ssm family (xlstm-1.3b) and
the hybrid family (jamba-1.5-large-398b; the recurrent scans on each
rank's local blocks) train partitioned as the reference's jitted step
does over its mesh: the parameters are DTensors placed by
`param_shardings`, the optimizer state by `opt_state_shardings`
(ZeRO-1), each batch by `batch_shardings` (every rank builds the global
batch and keeps its rows), and the step is the same function under
DTensor dispatch.
Checkpoints are written by rank 0 and restored into the same placements
on every rank.  The vlm and audio families' steps partition too
(`make_train_step` on their batches), but this entry point, like the
reference's, feeds tokens and labels only, which their losses refuse
on any mesh.  A mesh of one keeps plain tensors and the one-card path.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataPipeline, make_synthetic_corpus
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import (
    CheckpointManager,
    StragglerPolicy,
    config_fingerprint,
    restore_checkpoint,
)
from repro_torch.distributed.sharding import (
    device_put,
    opt_state_shardings,
    param_shardings,
    place_batch,
    use_mesh,
)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import get_model
from repro_torch.train.optimizer import OptimizerConfig, adamw_init
from repro_torch.train.train_step import make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    own_group = not dist.is_initialized()
    try:
        return _train(args, dev)
    finally:
        if own_group and dist.is_initialized():
            dist.destroy_process_group()


def _train(args, dev) -> dict:
    """`main` on ``dev`` under the process group `make_host_mesh` finds or
    starts (`main` destroys one it started)."""
    cfg = get_arch(args.arch, reduced=args.reduced)
    api = get_model(cfg, dev)
    mesh = make_host_mesh(args.model_axis, dev)
    opt_cfg = OptimizerConfig(lr=args.lr, warmup_steps=args.warmup, total_steps=args.steps)

    corpus = make_synthetic_corpus(total_tokens=2_000_000, vocab_size=cfg.vocab_size,
                                   device=dev)
    pipeline = DataPipeline(corpus, global_batch=args.global_batch, seq_len=args.seq)

    with use_mesh(mesh):
        params = api.init(torch.Generator(device=dev).manual_seed(0))
        psh = param_shardings(params, cfg, mesh)
        params = device_put(params, psh)
        opt_state = adamw_init(params, opt_state_shardings(params, cfg, mesh))
        step_fn = make_train_step(api.loss, opt_cfg, microbatches=args.microbatches)

        start_step = 0
        ckpt = None
        if args.checkpoint_dir:
            ckpt = CheckpointManager(args.checkpoint_dir, every=args.checkpoint_every)
            try:
                (params, opt_state), start_step = restore_checkpoint(
                    args.checkpoint_dir, (params, opt_state),
                    shardings=(psh, opt_state_shardings(opt_state, cfg, mesh)))
                print(f"[train] resumed from step {start_step}")
            except FileNotFoundError:
                pass

        straggler = StragglerPolicy()
        history = []
        t_tokens = args.global_batch * args.seq
        for step in range(start_step, args.steps):
            batch = place_batch(pipeline.batch_at(step), mesh)
            t0 = time.time()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            if straggler.observe(dt):
                print(f"[train] straggler event at step {step}: {dt:.2f}s")
            if step % args.log_every == 0 or step == args.steps - 1:
                print(
                    f"[train] step {step:5d} loss={loss:7.4f} "
                    f"lr={float(metrics['lr']):.2e} "
                    f"gnorm={float(metrics['grad_norm']):.2f} "
                    f"{t_tokens / dt:,.0f} tok/s"
                )
            history.append(loss)
            if ckpt and ckpt.should_save(step):
                ckpt.save(step, (params, opt_state),
                          meta={"config": config_fingerprint(cfg)})
        if ckpt:
            ckpt.save(args.steps, (params, opt_state))
    return {
        "first_loss": history[0] if history else None,
        "last_loss": history[-1] if history else None,
        "straggler_events": straggler.events,
    }


if __name__ == "__main__":
    out = main()
    print(json.dumps(out))
