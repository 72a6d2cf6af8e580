"""Multi-pod dry run: build every (arch x shape x mesh) cell on
placeholder ranks and record what it would hold and compute (the
reference's `repro/launch/dryrun.py`).

The reference forces 512 host devices through ``XLA_FLAGS`` in its
first lines.  The port's placeholder ranks are PyTorch's fake process
group (backend ``"fake"``, world 256 or 512) under `FakeTensorMode`:
`run_cell` starts that group in this process and destroys it before it
returns, so it is set up only where the dry run runs (``python -m
repro_torch.launch.dryrun``), never at import and never in a caller
that runs the module as a subprocess.

For each cell this builds the step's inputs as fake tensors (the
parameters from ``api.init``, the AdamW state or the cache, the batch),
places them with the production shardings as fake DTensors, and
records, one JSON a cell in ``--out``:

  * ``status`` — ``ok``, ``skipped`` (with `shape_supported`'s reason)
    or ``failed`` (with the error);
  * ``params`` — `count_params`;
  * ``memory.argument_bytes`` — per device, from the placed inputs'
    local shapes (a number leaf, the cache's ``len``, as the reference's
    int32 scalar); ``memory.output_bytes`` — per device: the state the
    step returns in the shardings the cell names (train: parameters and
    AdamW state; decode: the cache) plus every other output (logits,
    metrics, prefill's cache) whole, from one step run on the global
    fake tensors;
  * ``flops`` — `torch.utils.flop_counter.FlopCounterMode` over that one
    step (matrix products only), with ``flops_per_device`` its share.  A
    train step is counted with its microbatches as one (the whole global
    batch through one loss and one gradient): every product's rows scale
    with the batch, so the count is the same, from an eighth of the
    Python operations.
    The ssm and hybrid families step through time in Python loops, so
    their train and prefill cells record ``flops: null`` with the reason
    and skip the step (their decode step is one token and runs).

The reference's ``temp_bytes``, ``code_bytes``, ``cost_analysis()`` and
``hlo_analysis`` come from XLA's compiler and partitioner, which the
port has no twin of (ROADMAP queue C): eager PyTorch runs no partitioned
program here, and the FLOP count is of the global step.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Any, Dict

import torch

from repro_torch.configs import ARCHS, SHAPES, get_arch, shape_supported
from repro_torch.distributed.sharding import (
    batch_shardings,
    cache_shardings,
    device_put,
    opt_state_shardings,
    param_shardings,
    set_dp_over_model,
    tree_leaves_with_path,
)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import get_model
from repro_torch.train.optimizer import OptimizerConfig, adamw_init
from repro_torch.train.train_step import make_train_step

_LOOP_FAMILIES = ("ssm", "hybrid")  # Python loops over time in train and prefill


def count_params(abstract_params, cfg) -> Dict[str, float]:
    total = 0
    expert = 0
    for keys, leaf in tree_leaves_with_path(abstract_params):
        n = int(torch.Size(leaf.shape).numel())
        total += n
        if "we_gate" in keys or "we_up" in keys or "we_down" in keys:
            expert += n
    active = total
    if cfg.num_experts:
        frac = cfg.experts_per_token / cfg.num_experts
        active = total - expert * (1.0 - frac)
    return {"n_params": float(total), "n_active": float(active)}


def _fake_world(size: int) -> None:
    """A fake process group of ``size`` ranks in this process (rank 0)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def _leaf_bytes(leaf, sharding=None) -> int:
    if not isinstance(leaf, torch.Tensor):
        return 4  # a number leaf: the reference's int32 scalar
    shape = leaf.shape if sharding is None else sharding.local_shape(leaf.shape)
    return int(torch.Size(shape).numel()) * leaf.element_size()


def _bytes(tree, shardings=None) -> int:
    """Per-device bytes of ``tree`` in ``shardings`` (None: whole)."""
    leaves = tree_leaves_with_path(tree)
    if shardings is None:
        return sum(_leaf_bytes(x) for _, x in leaves)
    return sum(_leaf_bytes(x, s) for (_, x), (_, s)
               in zip(leaves, tree_leaves_with_path(shardings)))


def _out_bytes(out, out_shardings) -> int:
    """The step's outputs: each in its sharding, or whole where the cell
    names none (the reference's ``out_shardings``)."""
    return sum(_bytes(o, s) for o, s in zip(out, out_shardings))


def build_cell(arch: str, shape_name: str, multi_pod: bool,
               microbatches: int = 8, dp_over_model: bool | None = None):
    """The cell's step (and the step its FLOPs are counted through), its
    global fake inputs with their shardings and its outputs' (None:
    unnamed), the inputs placed as fake DTensors, and the
    `FakeTensorMode` they live in; needs the fake group of the mesh's
    size."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = get_arch(arch)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    set_dp_over_model(cfg.dp_over_model if dp_over_model is None else dp_over_model)
    mode = FakeTensorMode(allow_non_fake_inputs=True)  # the mesh holds real rank tensors
    with mode:
        return (cfg, mesh, mode) + _fake_inputs(cfg, SHAPES[shape_name], mesh, microbatches)


def _fake_inputs(cfg, shape, mesh, microbatches):
    api = get_model(cfg, "cpu")

    params = api.init(torch.Generator().manual_seed(0))
    psh = param_shardings(params, cfg, mesh)
    batch = {k: torch.empty(s, dtype=dt) for k, (s, dt) in api.batch_spec(shape).items()}

    if shape.kind == "train":
        opt = adamw_init(params)
        accum = os.environ.get("LIX_ACCUM_DTYPE", "float32")
        accum_dtype = torch.bfloat16 if accum == "bfloat16" else torch.float32
        step = make_train_step(api.loss, OptimizerConfig(), microbatches=microbatches,
                               accum_dtype=accum_dtype)
        count_step = make_train_step(api.loss, OptimizerConfig(), accum_dtype=accum_dtype)
        args = (params, opt, batch)
        shardings = (psh, opt_state_shardings(opt, cfg, mesh), batch_shardings(batch, mesh))
        out_shardings = (psh, shardings[1], None)
    elif shape.kind == "prefill":
        step = count_step = api.prefill
        args = (params, batch)
        shardings = (psh, batch_shardings(batch, mesh))
        out_shardings = (None, None)
    else:  # decode
        cache = api.init_cache(shape.global_batch, shape.seq_len)
        csh = cache_shardings(cache, cfg, mesh, batch_size=shape.global_batch)
        tok = batch["token"]
        step = count_step = api.decode
        args = (params, cache, tok)
        shardings = (psh, csh, batch_shardings({"token": tok}, mesh)["token"])
        out_shardings = (None, csh)
    placed = device_put(args, shardings, src_data_rank=None)
    return step, count_step, args, shardings, out_shardings, placed


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str) -> Dict:
    mesh_name = "2x16x16" if multi_pod else "16x16"
    cell_id = f"{arch}__{shape_name}__{mesh_name}"
    path = os.path.join(out_dir, cell_id + ".json")
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    ok, reason = shape_supported(cfg, shape)
    devices = 512 if multi_pod else 256
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "kind": shape.kind, "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "num_devices": devices,
    }
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = reason
        _write(path, rec)
        print(f"[dryrun] {cell_id}: SKIPPED ({reason})")
        return rec

    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    t0 = time.time()
    try:
        _fake_world(devices)
        cfg, mesh, mode, step, count_step, args, shardings, out_shardings, placed = build_cell(
            arch, shape_name, multi_pod)
        with mode:
            rec["build_s"] = round(time.time() - t0, 1)
            memory = {"argument_bytes": _bytes(args, shardings)}
            if cfg.family in _LOOP_FAMILIES and shape.kind != "decode":
                flops, out_bytes = None, None
                rec["flops_reason"] = (f"the {cfg.family} family steps through time in "
                                       "Python loops: not counted under fake tensors")
            else:
                with FlopCounterMode(display=False) as counter:
                    out = count_step(*args)
                flops = int(counter.get_total_flops())
                out_bytes = _out_bytes(out, out_shardings)
            memory["output_bytes"] = out_bytes
        rec.update(
            status="ok",
            wall_s=round(time.time() - t0, 1),
            memory=memory,
            flops=flops,
            flops_per_device=None if flops is None else flops / devices,
            params=count_params(args[0], cfg),
        )
        print(
            f"[dryrun] {cell_id}: OK {rec['wall_s']}s "
            f"args={memory['argument_bytes'] / 2**30:.2f}GiB/dev "
            f"flops/dev={rec['flops_per_device']}"
        )
    except Exception as e:  # record the failure, keep sweeping
        rec["status"] = "failed"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[dryrun] {cell_id}: FAILED {rec['error'][:200]}")
    finally:
        set_dp_over_model(False)
        if dist.is_initialized():
            dist.destroy_process_group()
    _write(path, rec)
    return rec


def _write(path: str, rec: Dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", choices=["all", *SHAPES])
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--subprocess", action="store_true",
                    help="run each cell in a fresh subprocess")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    cells = [(a, s, m) for a in archs for s in shapes for m in meshes]
    multi = len(cells) > 1
    for a, s, m in cells:
        mesh_name = "2x16x16" if m else "16x16"
        path = os.path.join(args.out, f"{a}__{s}__{mesh_name}.json")
        if args.skip_existing and os.path.exists(path):
            with open(path) as f:
                if json.load(f).get("status") in ("ok", "skipped"):
                    print(f"[dryrun] {a}__{s}__{mesh_name}: cached")
                    continue
        if args.subprocess and multi:
            cmd = [
                sys.executable, "-m", "repro_torch.launch.dryrun",
                "--arch", a, "--shape", s,
                "--mesh", "multi" if m else "single", "--out", args.out,
            ]
            subprocess.run(cmd, check=False)
        else:
            run_cell(a, s, m, args.out)


if __name__ == "__main__":
    main()
