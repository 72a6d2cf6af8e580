"""Fault tolerance: atomic checkpoints + restart + straggler policy.

Checkpoint layout (one directory per step), the reference package's:

    <root>/step_00001230.tmp/     — written first
        manifest.json             — leaf paths, shapes, dtypes, step,
                                    meta, per-file SHA-256
        arr_00000.npy ...         — one file per leaf (host copies)
    <root>/step_00001230/         — atomic rename when complete
    <root>/LATEST                 — step number, written last

Crash at any point leaves either a complete checkpoint or an ignorable
*.tmp.  A tree is a nested dict, list or tuple of tensors (a
``state_dict`` is one); its leaves are flattened in the order and under
the path strings that ``jax.tree_util.tree_flatten_with_path`` gives
(dict keys sorted, list indices as digits), and bf16 leaves are stored
as their uint16 bit pattern with the logical dtype ``"bfloat16"``, so
either package reads the other's steps.  Leaves are full host arrays:
a restart places them on whatever device it names, or on whatever mesh
(`restore_checkpoint(..., shardings=)`); a tree of DTensors is gathered
and written by rank 0 alone (`save_checkpoint`).

Straggler mitigation (`StragglerPolicy`): per-step wall-clock deadline
tracking with an EWMA baseline; a step exceeding k× the EWMA raises a
straggler event — the launcher's response is checkpoint-restart minus
the slow host (the node-failure path doubles as the straggler path).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import faults
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


class CheckpointCorrupt(RuntimeError):
    """A checkpoint step failed integrity verification (checksum
    mismatch, missing/truncated file, unreadable manifest)."""


# ---- trees ---------------------------------------------------------------

def _flatten(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """[(path, leaf)] in JAX's pytree order: dict keys sorted, list and
    tuple entries by index; everything else is a leaf (None is an empty
    node, as in JAX)."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _flatten(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in _flatten(v, prefix + (str(i),))]
    if tree is None:
        return []
    return [("/".join(prefix), tree)]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(like, dict):
        return type(like)((k, _unflatten(like[k], leaves)) for k in sorted(like))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    if like is None:
        return None
    return next(leaves)


def _host_array(leaf) -> Tuple[np.ndarray, str]:
    """(array to store, logical dtype name) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            # numpy has no bfloat16: store the bit pattern
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def _leaf_tensor(a: np.ndarray, logical_dtype: str) -> torch.Tensor:
    if logical_dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def config_fingerprint(cfg) -> str:
    try:
        blob = json.dumps(dataclasses.asdict(cfg), sort_keys=True, default=str)
    except TypeError:
        blob = repr(cfg)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


# ---- checkpoint integrity ------------------------------------------------

def _sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def _step_dirs(root: str) -> List[int]:
    """Published (non-tmp, non-quarantined) step numbers, ascending."""
    try:
        names = os.listdir(root)
    except FileNotFoundError:
        return []
    return sorted(
        int(d[5:]) for d in names
        if d.startswith("step_") and d[5:].isdigit()
    )


def verify_step(d: str) -> Dict:
    """Verify one published step dir against its manifest checksums and
    return the manifest.  Raises `CheckpointCorrupt` on an unreadable
    manifest, a missing file, or a SHA-256 mismatch.  Pre-checksum
    checkpoints (no ``files``/``sha256`` entries) only get existence
    checks — restore still catches their read errors and falls back."""
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorrupt(f"{d}: unreadable manifest: {e}") from e
    files: Dict[str, str] = dict(manifest.get("files") or {})
    for entry in manifest.get("leaves", ()):
        if entry.get("file"):
            files.setdefault(entry["file"], entry.get("sha256", ""))
    for rel in sorted(files):
        p = os.path.join(d, rel)
        if not os.path.isfile(p):
            raise CheckpointCorrupt(f"{d}: missing {rel}")
        want = files[rel]
        if want and _sha256_file(p) != want:
            raise CheckpointCorrupt(f"{d}: checksum mismatch on {rel}")
    return manifest


def quarantine_step(d: str, reason: str = "") -> str:
    """Move a corrupt step dir aside (``<dir>.quarantine``) so no later
    restore retries it; the rename is atomic, counted, and traced.  The
    age-gated sweep in `_gc` collects quarantines like abandoned tmps."""
    q = d + ".quarantine"
    if os.path.exists(q):
        shutil.rmtree(q, ignore_errors=True)
    os.replace(d, q)
    obs_metrics.default_registry().counter("ckpt.quarantined").add(1)
    obs_trace.instant(
        "ckpt.quarantine", cat="fault", dir=os.path.basename(d),
        reason=reason,
    )
    return q


def _tear(d: str) -> None:
    """Simulate a torn write / bit rot: truncate the first data file of
    a published step to half its size.  Only reachable through the
    ``ckpt.write.torn`` fault point."""
    for base, _dirs, names in sorted(os.walk(d)):
        for n in sorted(names):
            if n == "manifest.json":
                continue
            p = os.path.join(base, n)
            with open(p, "r+b") as f:
                f.truncate(max(1, os.path.getsize(p) // 2))
            return


def _publish(root: str, tmp: str, final: str, step: int, keep_last: int) -> None:
    """The end of every save: the crash point, the atomic rename, the
    torn-write point, LATEST last, then GC."""
    faults.maybe("ckpt.write.crash")  # dies pre-publish: only .tmp left
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    if faults.should("ckpt.write.torn"):
        _tear(final)  # published, then silently corrupted on disk
    # LATEST last: readers never see a partial checkpoint
    with open(os.path.join(root, "LATEST.tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(root, "LATEST.tmp"), os.path.join(root, "LATEST"))
    _gc(root, keep_last)


def _fresh_tmp(root: str, step: int) -> Tuple[str, str]:
    os.makedirs(root, exist_ok=True)
    name = f"step_{step:010d}"
    tmp = os.path.join(root, name + ".tmp")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    return tmp, os.path.join(root, name)


def save_checkpoint(
    root: str, step: int, tree: Any, *, meta: Optional[Dict] = None,
    keep_last: int = 3,
) -> str:
    """Write ``tree`` as step ``step`` under ``root``; returns the step's
    directory.  A tree of DTensors (the partitioned train step) is saved
    by every rank together: each leaf gathered whole (`full_tensor`, a
    collective), rank 0 alone writing and publishing one file set, the
    other ranks waiting at a barrier until it is done or has failed, so
    LATEST only ever names a step rank 0 published whole."""
    leaves = _flatten(tree)
    on_mesh = any(is_dtensor(leaf) for _, leaf in leaves)
    writer = not on_mesh or dist.get_rank() == 0
    final = os.path.join(root, f"step_{step:010d}")
    try:
        if writer:
            tmp, final = _fresh_tmp(root, step)
        manifest = {
            "step": step,
            "meta": meta or {},
            "leaves": [],
            "written_at": time.time(),
        }
        for i, (p, leaf) in enumerate(leaves):
            if is_dtensor(leaf):
                leaf = leaf.full_tensor()
            if not writer:
                continue
            arr, logical_dtype = _host_array(leaf)
            fn = f"arr_{i:05d}.npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["leaves"].append(
                {"path": p, "file": fn, "shape": list(arr.shape),
                 "dtype": logical_dtype, "sha256": _sha256_file(
                     os.path.join(tmp, fn))}
            )
        if writer:
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            _publish(root, tmp, final, step, keep_last)
    finally:
        if on_mesh:
            dist.barrier()
    return final


_TMP_TTL_S = 15 * 60.0  # a healthy writer publishes well within this


def _gc(root: str, keep_last: int, tmp_ttl_s: float = _TMP_TTL_S) -> None:
    for step in _step_dirs(root)[:-keep_last]:
        shutil.rmtree(
            os.path.join(root, f"step_{step:010d}"), ignore_errors=True
        )
    # age-gated tmp sweep: another writer's IN-PROGRESS step also looks
    # like `step_*.tmp` (replicated savers share the root), so only tmp
    # dirs old enough to be certainly-abandoned crashes are collected.
    # Quarantined (corrupt) steps are swept on the same clock: long
    # enough to debug, not forever.
    now = time.time()
    for d in os.listdir(root):
        if not (d.endswith(".tmp") or d.endswith(".quarantine")):
            continue
        p = os.path.join(root, d)
        try:
            age = now - os.path.getmtime(p)
        except OSError:
            continue  # racing writer published or cleaned it already
        if age >= tmp_ttl_s:
            shutil.rmtree(p, ignore_errors=True)


def latest_step(root: str) -> Optional[int]:
    p = os.path.join(root, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        step = int(f.read().strip())
    if os.path.isdir(os.path.join(root, f"step_{step:010d}")):
        return step
    # LATEST points at a GC'd/incomplete/quarantined dir: fall back to
    # the newest published step
    steps = _step_dirs(root)
    if not steps:
        return None
    # heal the pointer atomically so every later reader takes the fast
    # path instead of re-walking the directory; best-effort (a reader
    # may lack write permission on the checkpoint root)
    try:
        heal = os.path.join(root, "LATEST.tmp")
        with open(heal, "w") as f:
            f.write(str(steps[-1]))
        os.replace(heal, p)
    except OSError:
        pass
    return steps[-1]


def newest_intact_step(
    root: str, *, step: Optional[int] = None
) -> Tuple[int, Dict]:
    """(step, verified manifest) — of the requested step, or of the
    newest published step that passes `verify_step`.  Every corrupt dir
    hit on the way down is quarantined (so it is tried exactly once,
    ever) and counted as a restore fallback.  An explicitly requested
    corrupt step raises `CheckpointCorrupt`; running out of steps
    raises `FileNotFoundError` (the callers' "fresh init" signal)."""
    if step is not None:
        d = os.path.join(root, f"step_{step:010d}")
        if not os.path.isdir(d):
            raise FileNotFoundError(
                f"no checkpoint step {step} under {root}"
            )
        try:
            return step, verify_step(d)
        except CheckpointCorrupt as e:
            quarantine_step(d, str(e))
            raise
    steps = _step_dirs(root)
    if not steps:
        raise FileNotFoundError(f"no checkpoint under {root}")
    reg = obs_metrics.default_registry()
    for s in reversed(steps):
        d = os.path.join(root, f"step_{s:010d}")
        try:
            manifest = verify_step(d)
        except CheckpointCorrupt as e:
            quarantine_step(d, str(e))
            reg.counter("ckpt.restore_fallbacks").add(1)
            continue
        return s, manifest
    raise FileNotFoundError(f"no intact checkpoint under {root}")


def restore_checkpoint(
    root: str, like: Any, *, step: Optional[int] = None, shardings: Any = None,
    device=None,
) -> Tuple[Any, int]:
    """Restore into the structure of ``like``: each leaf a tensor of
    ``like``'s leaf dtype.  With ``shardings`` (a tree of
    `distributed.sharding.NamedSharding`) the leaves are placed on the
    *current* mesh through `distributed.sharding.device_put` (the
    elastic-restart path: the checkpoint has no mesh baked in); without,
    on ``device`` (None = "cuda").  Steps are checksum-verified before
    use; a torn or corrupt step is quarantined and restore falls back to
    the newest intact one."""
    dev = None if shardings is not None else resolve_device(device)
    explicit = step is not None
    while True:
        step, manifest = newest_intact_step(root, step=step)
        d = os.path.join(root, f"step_{step:010d}")
        try:
            arrs = [_leaf_tensor(np.load(os.path.join(d, e["file"])), e["dtype"])
                    for e in manifest["leaves"]]
        except (OSError, ValueError) as e:
            # pre-checksum step with an unreadable leaf: same treatment
            quarantine_step(d, f"unreadable leaf: {e}")
            if explicit:
                raise CheckpointCorrupt(f"{d}: unreadable leaf: {e}") from e
            step = None
            continue
        break
    flat_like = [leaf for _, leaf in _flatten(like)]
    if len(arrs) != len(flat_like):
        raise ValueError(
            f"checkpoint has {len(arrs)} leaves, expected {len(flat_like)}")
    out = [a.to(device=dev, dtype=torch.as_tensor(l).dtype)
           for a, l in zip(arrs, flat_like)]
    if shardings is not None:
        from repro_torch.distributed.sharding import device_put
        return device_put(_unflatten(like, iter(out)), shardings), step
    return _unflatten(like, iter(out)), step


@dataclasses.dataclass
class StragglerPolicy:
    """EWMA step-time tracker; flags steps slower than factor×baseline.

    Warm-up is median-seeded: the first ``min_samples`` observations are
    collected raw and the baseline is their median, so a straggler that
    happens to land during warm-up (compilation, cold caches make that
    the COMMON case) cannot inflate the EWMA and mask every later slow
    step behind a bloated factor×baseline threshold."""

    factor: float = 3.0
    alpha: float = 0.1
    min_samples: int = 5
    _ewma: float = 0.0
    _n: int = 0
    events: int = 0
    _warm: List[float] = dataclasses.field(default_factory=list)

    def observe(self, step_time: float) -> bool:
        self._n += 1
        if self._n <= self.min_samples:
            self._warm.append(step_time)
            self._ewma = float(np.median(self._warm))
            return False
        slow = step_time > self.factor * self._ewma
        if slow:
            self.events += 1
        else:
            self._ewma = (1 - self.alpha) * self._ewma + self.alpha * step_time
        return slow


class IndexCheckpointer:
    """Crash-safe checkpoints of a `ShardedIndexService` (the always-on
    writability restart path), in the reference package's layout.

    Each step directory is self-contained and covers the FULL service
    state mid-churn, without flushing or compacting anything:

        <root>/step_NNNNNNNNNN/
            manifest.json        — shard count, per-shard snapshot
                                   version + WAL sizes, per-file SHA-256
            router.npz           — LearnedRouter (boundaries + model)
            shard-XX/
                snapshot-vvvvvv.npz  — the shard's current snapshot in
                                       the VersionManager wire format
                delta.npz            — the shard's delta WAL slice: the
                                       level stack (frozen + active)
                                       collapsed by `collapse_levels`

    Publication is the tree checkpoint's protocol (tmp dir -> files ->
    os.replace -> LATEST last -> age-gated GC), so a kill at ANY point
    leaves either a complete checkpoint or an ignorable tmp.  Restore
    rebuilds each shard through `VersionManager.load_latest` on its
    `shard-XX/` dir — the snapshot file carries the fitted model, so
    nothing is refit — then re-stages the WAL slice as the shard's
    active delta, so the restored service answers bit-exactly like the
    killed one."""

    def __init__(self, root: str, *, every: int = 1, keep_last: int = 3):
        self.root = root
        self.every = every
        self.keep_last = keep_last

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.every == 0

    def save(self, step: int, svc) -> str:
        from repro_torch.index_service.delta import collapse_levels
        from repro_torch.index_service.sharded import _ROUTER_FILE, _SHARD_DIR

        tmp, final = _fresh_tmp(self.root, step)
        manifest: Dict[str, Any] = {
            "step": step,
            "written_at": time.time(),
            "num_shards": svc.num_shards,
            "shards": [],
        }
        for s, shard in enumerate(svc.shards):
            # one consistent capture per shard: the snapshot and the
            # collapsed delta slice come from the SAME (snap, frozen,
            # active) triple, so the checkpoint is a point-in-time view
            # even while writers keep staging
            snap, frozen, active = shard._state()
            sub = os.path.join(tmp, _SHARD_DIR.format(s))
            snap_path = snap.save(sub)
            ins, vals, dels = collapse_levels(snap.keys.raw, frozen, active)
            wal = {"ins": ins, "dels": dels}
            if vals is not None:
                wal["vals"] = vals
            with open(os.path.join(sub, "delta.npz"), "wb") as f:
                np.savez(f, **wal)
            manifest["shards"].append({
                "dir": _SHARD_DIR.format(s),
                "snapshot": os.path.basename(snap_path),
                "snapshot_version": int(snap.version),
                "wal_inserts": int(ins.size),
                "wal_deletes": int(dels.size),
            })
        svc.router.save(os.path.join(tmp, _ROUTER_FILE))
        # per-file SHA-256 over everything but the manifest itself, so
        # restore can prove a step intact before trusting any of it
        files: Dict[str, str] = {}
        for base, _dirs, names in os.walk(tmp):
            for n in names:
                p = os.path.join(base, n)
                files[os.path.relpath(p, tmp)] = _sha256_file(p)
        manifest["files"] = files
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        _publish(self.root, tmp, final, step, self.keep_last)
        return final

    def restore(self, config=None, *, device=None):
        """(service, step) from the newest INTACT checkpoint, its shards
        on ``device`` (None = "cuda"): each candidate step is
        checksum-verified first, corrupt steps are quarantined and
        skipped (newest -> oldest), and only a root with no intact step
        left raises FileNotFoundError."""
        from repro_torch.index_service.delta import DeltaBuffer
        from repro_torch.index_service.router import LearnedRouter
        from repro_torch.index_service.service import IndexService, ServiceConfig
        from repro_torch.index_service.sharded import (
            _ROUTER_FILE,
            _SHARD_DIR,
            ShardedIndexService,
        )
        from repro_torch.index_service.snapshot import VersionManager

        step, manifest = newest_intact_step(self.root)
        d = os.path.join(self.root, f"step_{step:010d}")
        router = LearnedRouter.load(os.path.join(d, _ROUTER_FILE))
        config = dataclasses.replace(
            config or ServiceConfig(), num_shards=router.num_shards,
            snapshot_dir=None,
        )
        svc = ShardedIndexService(
            np.empty(0), config, device=device, _router=router, _shards=[]
        )
        shards = []
        for entry in manifest["shards"]:
            sub = os.path.join(d, entry["dir"])
            mgr = VersionManager.load_latest(
                sub, keep=config.keep_snapshots, device=svc.device)
            # the checkpoint dir is immutable history: detach it so a
            # later compaction's save/GC cycle can never mutate it
            mgr.directory = None
            cfg = dataclasses.replace(config, num_shards=1, snapshot_dir=None)
            shard = IndexService(np.empty(0), cfg, _manager=mgr)
            with np.load(os.path.join(sub, "delta.npz")) as z:
                ins, dels = z["ins"], z["dels"]
                vals = z["vals"] if "vals" in z.files else np.zeros(
                    ins.shape, np.int64
                )
            if ins.size or dels.size:
                shard._active = DeltaBuffer.from_arrays(
                    ins, vals, dels, capacity=cfg.delta_capacity
                )
                shard._plane.drop()
            shards.append(shard)
        svc._shards = shards
        return svc, step


class CheckpointManager:
    """save-every-k + keep-last-k + resume, with failure injection hooks
    used by the fault-tolerance tests."""

    def __init__(self, root: str, *, every: int = 100, keep_last: int = 3):
        self.root = root
        self.every = every
        self.keep_last = keep_last

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.every == 0

    def save(self, step: int, tree: Any, meta: Optional[Dict] = None) -> str:
        return save_checkpoint(
            self.root, step, tree, meta=meta, keep_last=self.keep_last
        )

    def restore_or_init(self, like: Any, init_fn, *, device=None):
        # CheckpointCorrupt can only escape restore_checkpoint for an
        # EXPLICIT step request; the default newest-intact walk folds
        # corruption into fallback and only raises FileNotFoundError
        # once every step has been quarantined — either way, init fresh
        try:
            return restore_checkpoint(self.root, like, device=device)
        except (FileNotFoundError, CheckpointCorrupt):
            return init_fn(), 0
