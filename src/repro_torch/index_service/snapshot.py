"""Versioned immutable index snapshots + double-buffered atomic swap.

A snapshot is the unit of consistency for the writable index service:
one (RMI, sorted base keys, max_window) triple plus the optional value
payload, all built together and never mutated afterwards.  Batched
readers grab ``VersionManager.current()`` once per batch; because a
swap only replaces the *reference* and the previous snapshot is
retained as the second buffer, an in-flight batch keeps consistent
arrays even if a compaction publishes mid-batch.  Each snapshot keeps
its device tensors (keys, leaf arrays, stage-0 buffer) on its own
``device``, uploaded once at first use.

Snapshots serialize to a single ``.npz`` per version
(``snapshot-000042.npz``), byte-compatible with the reference package:
a file written by either package loads in the other.

Exactness note: device lookups run in the float32 normalized frame,
where distinct raw keys may collide.  ``refine_base_rank`` converts the
float32 lower bound into the exact raw-key lower bound with at most
``max_dup_run`` vectorized advance steps plus an exact ``searchsorted``
fallback for keys absent from the base.
"""

from __future__ import annotations

import dataclasses
import os
import re
import threading
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import search as search_lib
from repro_torch.core.keys import KeySet, make_keyset
from repro_torch.core.rmi import RMIConfig, RMIndex, build_rmi, refit_rmi, rmi_lookup
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernels_ops
from repro_torch.kernels import ref as kernels_ref
from repro_torch.kernels.rmi_lookup import rmi_lookup_cuda, rmi_merged_lookup_cuda

# strategies whose closures enter through a CUDA kernel (on the card;
# on the CPU the same wrappers run their plain versions)
KERNEL_STRATEGIES: Tuple[str, ...] = ("cuda", "cuda_fused")

_SNAP_RE = re.compile(r"snapshot-(\d+)\.npz$")

# The lookup strategy registry: every name a snapshot (and through it
# IndexService) accepts for base and merged lookups.
#
#   binary / biased / quaternary — §3.4 search variants over the base in
#       plain torch ops, plus the delta lower bound and prefix gather.
#   cuda        — base search via the CUDA RMI kernel; the delta search
#       stays plain torch ops.
#   cuda_fused  — ONE kernel launch runs stage-0 MLP -> leaf position ->
#       first probe -> bounded base search -> delta lower bound ->
#       prefix gather.
#   torch_fused — the plain PyTorch version of cuda_fused: same
#       arithmetic, same results, no kernel.
MERGED_STRATEGIES: Tuple[str, ...] = (
    "binary", "biased", "quaternary", "cuda", "cuda_fused", "torch_fused",
)

# each port strategy's twin in the reference registry
REFERENCE_STRATEGY: Dict[str, str] = {
    "binary": "binary", "biased": "biased", "quaternary": "quaternary",
    "cuda": "pallas", "cuda_fused": "pallas_fused", "torch_fused": "xla_fused",
}


def validate_strategy(strategy: str) -> str:
    """Fail-fast membership check shared by every strategy consumer."""
    if strategy not in MERGED_STRATEGIES:
        raise ValueError(
            f"unknown lookup strategy {strategy!r}; "
            f"expected one of {MERGED_STRATEGIES}"
        )
    return strategy


def _max_dup_run(norm: np.ndarray) -> int:
    """Longest run of equal float32 normalized keys (>= 1)."""
    if norm.size < 2:
        return 1
    boundaries = np.nonzero(np.diff(norm) > 0)[0]
    edges = np.concatenate([[-1], boundaries, [norm.size - 1]])
    return int(np.max(np.diff(edges)))



@dataclasses.dataclass
class IndexSnapshot:
    """Immutable by convention: nothing mutates a published snapshot;
    compaction builds a successor and swaps the reference."""

    version: int
    keys: KeySet
    index: RMIndex
    vals: Optional[np.ndarray] = None       # payload aligned with keys.raw
    bloom: None = None                      # the Bloom screen is not ported yet
    max_dup_run: int = 1
    device: Optional[torch.device] = None   # None = "cuda"

    def __post_init__(self):
        if self.bloom is not None:
            raise NotImplementedError("Bloom screens are not ported yet")
        self.device = resolve_device(self.device)
        self._compiled: Dict[str, Callable] = {}

    @property
    def n(self) -> int:
        return self.keys.n

    # ---- device path -----------------------------------------------------
    def _device_tree(self) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """(RMI tensors, normalized base keys) on this snapshot's device,
        uploaded once per snapshot and shared by every closure."""
        cached = self._compiled.get("devtree")
        if cached is None:
            cached = self._compiled["devtree"] = (
                self.index.as_tree(self.device),
                torch.as_tensor(self.keys.norm, device=self.device),
            )
        return cached

    def _device_base(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(normalized float32 keys, int32 payload) on this snapshot's
        device for the scan closures.  The keys are `_device_tree`'s
        tensor, not a second upload; the payload is clipped to int32 and
        uploaded once (zeros on the device when the snapshot has
        none)."""
        cached = self._compiled.get("devbase")
        if cached is None:
            base_norm = self._device_tree()[1]
            if self.vals is not None:
                bvals = torch.as_tensor(np.clip(
                    self.vals, np.iinfo(np.int32).min, np.iinfo(np.int32).max
                ).astype(np.int32), device=self.device)
            else:
                bvals = torch.zeros(self.n, dtype=torch.int32, device=self.device)
            cached = self._compiled["devbase"] = (base_norm, bvals)
        return cached

    def _kernel_args(self):
        tree, base_norm = self._device_tree()
        return (tree["s0"], tree["leaf_w"], tree["leaf_b"], tree["err_lo"],
                tree["err_hi"], base_norm)

    def merged_lookup_fn(self, strategy: str = "binary") -> Callable:
        """fn (q_norm, delta_keys, delta_prefix) -> (base_lb, rank).

        One RMI bounded search over the base plus one fixed-trip
        branchless lower bound over the fused delta array and a single
        prefix gather — one CUDA launch under `cuda_fused`, kernel plus
        torch ops under `cuda`, torch ops otherwise; see
        MERGED_STRATEGIES.  Each call is one dispatch.
        """
        validate_strategy(strategy)
        fn = self._compiled.get(strategy)
        if fn is None:
            idx = self.index
            kw = dict(hidden=idx.hidden, n=idx.n, num_leaves=idx.num_leaves,
                      max_window=idx.max_window)
            if strategy in ("cuda_fused", "torch_fused"):
                impl = (rmi_merged_lookup_cuda if strategy == "cuda_fused"
                        else kernels_ref.rmi_merged_lookup_reference)
                args = self._kernel_args()

                def merged(q, dkeys, dprefix):
                    return impl(q, *args, dkeys, dprefix, **kw)
            else:
                if strategy == "cuda":
                    args = self._kernel_args()

                    def base(q):
                        return rmi_lookup_cuda(q, *args, **kw)
                else:
                    tree, base_norm = self._device_tree()

                    def base(q):
                        return rmi_lookup(tree, base_norm, q, strategy=strategy, **kw)

                def merged(q, dkeys, dprefix):
                    b = base(q)
                    lb = search_lib.lower_bound_full(dkeys, q)
                    return b, b + dprefix[torch.clamp(lb, max=dkeys.shape[0])]

            kernel = strategy in KERNEL_STRATEGIES
            snap_n = self.n

            def fn(q, dkeys, dprefix, _inner=merged):
                # ONE device-program entry per call: count it and
                # attribute wall time to (merged_lookup, strategy)
                with kernels_ops.dispatch_span(
                    "merged_lookup", kernel=kernel and q.device.type == "cuda",
                    strategy=strategy,
                    sig=(tuple(q.shape), tuple(dkeys.shape), snap_n, strategy),
                ):
                    return _inner(q, dkeys, dprefix)

            self._compiled[strategy] = fn
        return fn

    def scan_page_fn(
        self, strategy: str = "binary", page_size: int = 256
    ) -> Callable:
        """fn (starts, ins_keys, ins_vals, del_pos, end_rank) ->
        (keys (G, page_size) f32, vals i32, live_mask bool) — one page
        of merged rows per start rank, gathered straight out of
        base+delta merge order without materializing the merge.

        The kernel strategies (``cuda``/``cuda_fused``) run
        `rmi_scan_page_cuda`; every other strategy runs its plain twin
        (`ref.rmi_scan_page_reference`).  Delta inputs come from
        `scan.device_scan_plan`.  Same float32/int32 exactness caveat as
        ``lookup_batch`` — the host `IndexService.scan` path is the
        exact float64 surface."""
        validate_strategy(strategy)
        use_kernel = strategy in KERNEL_STRATEGIES
        key = f"scan:{'kernel' if use_kernel else 'plain'}:{page_size}"
        fn = self._compiled.get(key)
        if fn is None:
            base_norm, bvals = self._device_base()

            def fn(starts, ins_keys, ins_vals, del_pos, end_rank):
                return kernels_ops.rmi_scan_page_op(
                    starts, base_norm, bvals, ins_keys, ins_vals,
                    del_pos, end_rank,
                    page_size=page_size, use_kernel=use_kernel,
                    strategy=strategy,
                )

            self._compiled[key] = fn
        return fn

    def scan_range_fn(
        self, strategy: str = "binary", page_size: int = 256,
        max_pages: int = 1,
    ) -> Callable:
        """fn (bounds, ins_keys, ins_vals, ins_rank, live_prefix)
        -> (keys (max_pages, page_size) f32, vals i32, live_mask bool)
        — the FUSED scan read path: the merged ranks of ``bounds =
        [lo, hi)``, every page start, and every row gather happen in
        one dispatch (`kernels.ops.rmi_scan_range_op`: one launch of
        `rmi_scan_range_cuda` under the kernel strategies, its plain
        twin otherwise).  Nothing ranks on the host; ``max_pages`` is
        only the output-shape bound (pages past the range come back
        masked).  Delta inputs come from `scan.device_scan_slab`,
        cached by the service per (snapshot, delta version)."""
        validate_strategy(strategy)
        use_kernel = strategy in KERNEL_STRATEGIES
        key = f"scanr:{'kernel' if use_kernel else 'plain'}:{page_size}:{max_pages}"
        fn = self._compiled.get(key)
        if fn is None:
            base_norm, bvals = self._device_base()

            def fn(bounds, ins_keys, ins_vals, ins_rank, live_prefix):
                return kernels_ops.rmi_scan_range_op(
                    bounds, base_norm, bvals, live_prefix, ins_keys,
                    ins_vals, ins_rank,
                    page_size=page_size, max_pages=max_pages,
                    use_kernel=use_kernel, strategy=strategy,
                )

            self._compiled[key] = fn
        return fn

    def base_lookup_fn(self, strategy: str = "binary") -> Callable:
        """fn (q_norm) -> base lower bound, for callers that resolve the
        delta on the host.  Both kernel strategies lower to the base RMI
        kernel here (no delta to fuse); `torch_fused` to the identical
        `binary` search."""
        validate_strategy(strategy)
        # cuda/cuda_fused and binary/torch_fused are pairwise the same
        # base computation: share one closure
        alias = {"cuda_fused": "cuda", "torch_fused": "binary"}
        tag = alias.get(strategy, strategy)
        key = f"base:{tag}"
        fn = self._compiled.get(key)
        if fn is None:
            idx = self.index
            kw = dict(hidden=idx.hidden, n=idx.n, num_leaves=idx.num_leaves,
                      max_window=idx.max_window)
            if tag == "cuda":
                args = self._kernel_args()

                def base(q):
                    return rmi_lookup_cuda(q, *args, **kw)
            else:
                tree, base_norm = self._device_tree()

                def base(q):
                    return rmi_lookup(tree, base_norm, q, strategy=tag, **kw)

            kernel = tag in KERNEL_STRATEGIES
            snap_n = self.n

            def fn(q, _inner=base):
                with kernels_ops.dispatch_span(
                    "base_lookup", kernel=kernel and q.device.type == "cuda",
                    strategy=tag, sig=(tuple(q.shape), snap_n, tag),
                ):
                    return _inner(q)

            self._compiled[key] = fn
        return fn

    # ---- exact host refinement ------------------------------------------
    def refine_base_rank(
        self, qraw: np.ndarray, b: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(exact lower bound in base raw keys, present-in-base mask)."""
        raw = self.keys.raw
        n = raw.size
        q = np.asarray(qraw, np.float64)
        i = np.clip(np.asarray(b, np.int64), 0, n)
        # float32 lower bound trails the raw one by at most max_dup_run
        for _ in range(self.max_dup_run):
            c = np.minimum(i, n - 1)
            step = (raw[c] < q) & (i < n)
            if not step.any():
                break
            i = i + step
        in_base = (i < n) & (raw[np.minimum(i, n - 1)] == q)
        miss = ~in_base
        if miss.any():  # absent keys have no window guarantee: exact fallback
            i[miss] = np.searchsorted(raw, q[miss], side="left")
        return i, in_base

    # ---- persistence -----------------------------------------------------
    def save(self, directory: str) -> str:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"snapshot-{self.version:06d}.npz")
        idx = self.index
        cfg = idx.config
        payload = {
            "version": np.int64(self.version),
            "raw": self.keys.raw,
            "key_lo": np.float64(self.keys.lo),
            "key_hi": np.float64(self.keys.hi),
            "max_dup_run": np.int64(self.max_dup_run),
            "leaf_w": idx.leaf_w, "leaf_b": idx.leaf_b,
            "err_lo": idx.err_lo, "err_hi": idx.err_hi, "sigma": idx.sigma,
            "is_btree": idx.is_btree, "seg_lo": idx.seg_lo, "seg_hi": idx.seg_hi,
            "max_window": np.int64(idx.max_window),
            "cfg_num_leaves": np.int64(cfg.num_leaves),
            "cfg_hidden": np.asarray(cfg.stage0_hidden, np.int64),
            "cfg_steps": np.int64(cfg.stage0_train_steps),
            "cfg_sample": np.int64(cfg.stage0_sample or -1),
            "cfg_lr": np.float64(cfg.stage0_lr),
            "cfg_hybrid": np.float64(
                np.nan if cfg.hybrid_threshold is None else cfg.hybrid_threshold
            ),
            "cfg_seed": np.int64(cfg.seed),
        }
        for k, v in idx.stage0_params.items():
            payload[f"s0_{k}"] = v
        if self.vals is not None:
            payload["vals"] = self.vals
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **payload)
        os.replace(tmp, path)  # crash-safe publish
        return path

    @staticmethod
    def load(path: str, device=None) -> "IndexSnapshot":
        with np.load(path) as z:
            if "bloom_words" in z.files:
                raise NotImplementedError(
                    f"{path} carries a Bloom screen; Bloom screens are not "
                    "ported yet"
                )
            raw = z["raw"]
            lo, hi = float(z["key_lo"]), float(z["key_hi"])
            # build-time normalization (make_keyset / build_snapshot)
            # rejects a degenerate frame outright, so hi > lo for every
            # snapshot we wrote ourselves — but a hand-rolled or
            # corrupted file must not NaN-poison the whole key set
            span = hi - lo
            if span > 0:
                norm = ((raw - lo) / span).astype(np.float32)
            else:
                norm = np.zeros(raw.shape, np.float32)
            keys = KeySet(raw=raw, norm=norm, lo=lo, hi=hi)
            hybrid = float(z["cfg_hybrid"])
            cfg = RMIConfig(
                num_leaves=int(z["cfg_num_leaves"]),
                stage0_hidden=tuple(int(h) for h in z["cfg_hidden"]),
                stage0_train_steps=int(z["cfg_steps"]),
                stage0_sample=(None if int(z["cfg_sample"]) < 0
                               else int(z["cfg_sample"])),
                stage0_lr=float(z["cfg_lr"]),
                hybrid_threshold=None if np.isnan(hybrid) else int(hybrid),
                seed=int(z["cfg_seed"]),
            )
            s0 = {
                k[3:]: z[k] for k in z.files if k.startswith("s0_")
            }
            index = RMIndex(
                config=cfg, n=keys.n, num_leaves=cfg.num_leaves, in_dim=1,
                stage0_params=s0,
                leaf_w=z["leaf_w"], leaf_b=z["leaf_b"],
                err_lo=z["err_lo"], err_hi=z["err_hi"], sigma=z["sigma"],
                is_btree=z["is_btree"], seg_lo=z["seg_lo"], seg_hi=z["seg_hi"],
                max_window=int(z["max_window"]),
            )
            vals = z["vals"] if "vals" in z.files else None
            return IndexSnapshot(
                version=int(z["version"]), keys=keys, index=index,
                vals=vals, max_dup_run=int(z["max_dup_run"]), device=device,
            )


def build_snapshot(
    raw_keys: np.ndarray,
    *,
    vals: Optional[np.ndarray] = None,
    config: Optional[RMIConfig] = None,
    version: int = 0,
    bloom_fpr: Optional[float] = None,
    warm_from: Optional[IndexSnapshot] = None,
    device=None,
    verbose: bool = False,
) -> Tuple[IndexSnapshot, int]:
    """Build a snapshot over sorted unique raw keys (vals aligned).

    With ``warm_from``, the RMI is rebuilt via `refit_rmi` (stage-0
    reused, only changed leaves refit); falls back to a cold `build_rmi`
    when the warm path is incompatible or the resulting search window
    degrades past 4x the old one.  Returns (snapshot, leaves_refit);
    leaves_refit is -1 for a cold build.  ``bloom_fpr`` must be None:
    the Bloom screen is not ported yet.
    """
    if bloom_fpr is not None:
        raise NotImplementedError("Bloom screens are not ported yet")
    dev = resolve_device(device)
    raw_keys = np.asarray(raw_keys, np.float64)
    if vals is None:
        keys = make_keyset(raw_keys)
    else:
        if raw_keys.size < 2 or raw_keys[0] == raw_keys[-1]:
            raise ValueError("need >= 2 distinct keys")
        lo, hi = float(raw_keys[0]), float(raw_keys[-1])
        norm = ((raw_keys - lo) / (hi - lo)).astype(np.float32)
        keys = KeySet(raw=raw_keys, norm=norm, lo=lo, hi=hi)
    cfg = config or (warm_from.index.config if warm_from else RMIConfig())

    index = None
    refit = -1
    if warm_from is not None:
        try:
            index, refit = refit_rmi(
                warm_from.index, warm_from.keys, keys, config=cfg,
                device=dev, verbose=verbose,
            )
            if index.max_window > max(4 * warm_from.index.max_window, 64):
                index, refit = None, -1  # fit degraded too far: go cold
        except ValueError:
            index = None
    if index is None:
        index = build_rmi(keys, cfg, device=dev, verbose=verbose)

    snap = IndexSnapshot(
        version=version, keys=keys, index=index, vals=vals,
        max_dup_run=_max_dup_run(keys.norm), device=dev,
    )
    return snap, refit


class VersionManager:
    """Double-buffered atomic snapshot swap + on-disk version history.

    ``current()`` is a single reference read; publishing retains the
    predecessor (the second buffer) so device arrays backing in-flight
    batches stay alive until the *next* swap.
    """

    def __init__(self, snapshot: IndexSnapshot,
                 directory: Optional[str] = None, keep: int = 2):
        self._lock = threading.Lock()
        self._cur = snapshot
        self._prev: Optional[IndexSnapshot] = None
        self.directory = directory
        self.keep = keep

    @property
    def version(self) -> int:
        return self._cur.version

    def current(self) -> IndexSnapshot:
        return self._cur  # atomic reference read

    def previous(self) -> Optional[IndexSnapshot]:
        return self._prev

    def swap(self, new: IndexSnapshot) -> None:
        with self._lock:
            if new.version <= self._cur.version:
                raise ValueError(
                    f"version must advance: {new.version} <= {self._cur.version}"
                )
            self._prev, self._cur = self._cur, new
        if self.directory is not None:
            self.save_current()

    # ---- persistence -----------------------------------------------------
    def save_current(self) -> str:
        assert self.directory is not None, "VersionManager has no directory"
        path = self._cur.save(self.directory)
        self._gc()
        return path

    def _gc(self) -> None:
        snaps = sorted(
            (f for f in os.listdir(self.directory) if _SNAP_RE.search(f)),
            key=lambda f: int(_SNAP_RE.search(f).group(1)),
        )
        for f in snaps[: -self.keep]:
            os.remove(os.path.join(self.directory, f))

    @staticmethod
    def load_latest(directory: str, keep: int = 2, device=None) -> "VersionManager":
        snaps = sorted(
            (f for f in os.listdir(directory) if _SNAP_RE.search(f)),
            key=lambda f: int(_SNAP_RE.search(f).group(1)),
        )
        if not snaps:
            raise FileNotFoundError(f"no snapshots under {directory}")
        snap = IndexSnapshot.load(os.path.join(directory, snaps[-1]), device=device)
        return VersionManager(snap, directory=directory, keep=keep)
