"""Public wrappers around the port's kernels, with dispatch accounting.

Each op launches the CUDA kernel for tensors on the card and runs the
plain PyTorch version for tensors on the CPU; callers never touch the
launch directly.  There is no failover: a kernel that fails to build or
launch raises.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.rmi_lookup import (
    rmi_lookup_cuda,
    rmi_merged_lookup_cuda,
    stage0_flat,
)
from repro_torch.kernels.rmi_scan import rmi_scan_page_cuda, rmi_scan_range_cuda
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

# ---------------------------------------------------------------------------
# dispatch accounting & cost attribution
# ---------------------------------------------------------------------------
# Every public op below is one host->device program entry: one kernel
# launch on the card, or one plain PyTorch evaluation.  Recording at the
# op boundary gives the dispatch-discipline tests an observable (a read
# path that regresses into per-shard or per-page dispatch loops shows up
# as >1 per logical call) and the cost model its raw material: per-op
# wall time tagged kernel-vs-plain and strategy, plus first-seen shape
# signatures (the reference counts them as jit retraces; here they mark
# the first call at a new shape).
#
# Counters are per-thread (`count_dispatches()` reads only the calling
# thread's count, so the background compaction thread can never pollute
# a test's window) with a thread-tagged global ledger alongside.

DISPATCH_COUNT = 0  # process-wide total

class _DispatchTls(threading.local):
    def __init__(self):
        self.count = 0


_TLS = _DispatchTls()
_DISPATCH_LOCK = threading.Lock()
_THREAD_COUNTS = {}      # thread name -> dispatches recorded on it
_ATTRIBUTION = {}        # (op, path, strategy) -> [count, wall_s, retraces]
_SEEN_SIGNATURES = set()  # (op, signature) — never cleared (see above)


@functools.lru_cache(maxsize=None)
def _op_metrics(op: str, path: str):
    reg = obs_metrics.default_registry()
    return (
        reg.counter(f"dispatch.{op}.{path}.count"),
        reg.histogram(f"dispatch.{op}.wall_s"),
        reg.counter(f"dispatch.{op}.retraces"),
    )


def _record_dispatch(op, path, strategy, seconds, sig) -> None:
    global DISPATCH_COUNT
    _TLS.count += 1
    retrace = False
    key = (op, path, strategy or "")
    with _DISPATCH_LOCK:
        DISPATCH_COUNT += 1
        name = threading.current_thread().name
        _THREAD_COUNTS[name] = _THREAD_COUNTS.get(name, 0) + 1
        if sig is not None:
            sk = (op, sig)
            if sk not in _SEEN_SIGNATURES:
                _SEEN_SIGNATURES.add(sk)
                retrace = True
        row = _ATTRIBUTION.get(key)
        if row is None:
            row = _ATTRIBUTION[key] = [0, 0.0, 0]
        row[0] += 1
        row[1] += seconds
        row[2] += retrace
    counter, hist, retraces = _op_metrics(op, path)
    counter.add(1)
    hist.observe(seconds)
    if retrace:
        retraces.add(1)


@contextlib.contextmanager
def dispatch_span(op: str, *, kernel: bool, strategy=None, sig=()):
    """Wrap ONE device-program entry: counts it (per-thread + global),
    attributes its wall time to (op, kernel|plain, strategy), flags
    first-seen signatures, and emits a trace span."""
    path = "kernel" if kernel else "plain"
    t0 = time.perf_counter()
    with obs_trace.span(f"dispatch.{op}", cat="dispatch", path=path,
                        strategy=strategy or ""):
        try:
            yield
        finally:
            _record_dispatch(op, path, strategy,
                             time.perf_counter() - t0, sig)

@contextlib.contextmanager
def count_dispatches():
    """Context manager yielding a zero-arg callable that reports how
    many device-op entries ran since the context opened — on THIS
    thread only, so concurrent background compaction can't pollute the
    window.  (Back-compat shim over the per-thread counters.)"""
    start = _TLS.count
    yield lambda: _TLS.count - start


def thread_dispatch_counts() -> dict:
    """{thread name: dispatches recorded on it} since the last reset."""
    with _DISPATCH_LOCK:
        return dict(_THREAD_COUNTS)


def dispatch_summary() -> dict:
    """Cost-attribution snapshot: total, per-thread counts, and one row
    per (op, path, strategy) with count / wall seconds / retraces."""
    with _DISPATCH_LOCK:
        total = DISPATCH_COUNT
        by_thread = dict(_THREAD_COUNTS)
        rows = [
            {"op": op, "path": path, "strategy": strategy,
             "count": c, "wall_s": s, "retraces": r}
            for (op, path, strategy), (c, s, r) in sorted(
                _ATTRIBUTION.items())
        ]
    return {"total": total, "by_thread": by_thread, "rows": rows}


def reset_dispatch_stats() -> None:
    """Zero the global ledger (per-thread deltas via `count_dispatches`
    are unaffected; the retrace seen-set survives by design)."""
    global DISPATCH_COUNT
    with _DISPATCH_LOCK:
        DISPATCH_COUNT = 0
        _THREAD_COUNTS.clear()
        _ATTRIBUTION.clear()


def _shape(x):
    return tuple(getattr(x, "shape", ()) or ())


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _index_tensors(index, sorted_keys_norm, device):
    return (
        stage0_flat(index.stage0_params, device),
        *(torch.as_tensor(a, device=device) for a in
          (index.leaf_w, index.leaf_b, index.err_lo, index.err_hi)),
        torch.as_tensor(sorted_keys_norm, device=device),
    )


def rmi_lookup_op(index, sorted_keys_norm, q_norm: torch.Tensor):
    """Batched RMI base lookup through `rmi_lookup_cuda` (the kernel on
    the card, its plain version on the CPU).  `index` is an RMIndex."""
    with dispatch_span(
        "rmi_lookup", kernel=_on_card(q_norm), strategy="cuda",
        sig=(_shape(q_norm), index.n, index.num_leaves),
    ):
        return rmi_lookup_cuda(
            q_norm, *_index_tensors(index, sorted_keys_norm, q_norm.device),
            hidden=index.hidden, n=index.n, num_leaves=index.num_leaves,
            max_window=index.max_window,
        )


def rmi_merged_lookup_op(index, sorted_keys_norm, q_norm: torch.Tensor,
                         delta_keys, delta_prefix, *, use_kernel=True,
                         strategy=None):
    """Fused base+delta merged lookup -> (base_lb, merged_rank).

    One dispatch covering the RMI bounded search over the base *and*
    the delta prefix search (`strategy="cuda_fused"`); with
    ``use_kernel=False`` the plain PyTorch version runs instead
    (`strategy="torch_fused"`) — same arithmetic, same results."""
    dev = q_norm.device
    args = (q_norm, *_index_tensors(index, sorted_keys_norm, dev),
            torch.as_tensor(delta_keys, device=dev),
            torch.as_tensor(delta_prefix, device=dev))
    kw = dict(hidden=index.hidden, n=index.n, num_leaves=index.num_leaves,
              max_window=index.max_window)
    sig = (_shape(q_norm), _shape(delta_keys), index.n)
    if not use_kernel:
        with dispatch_span("rmi_merged_lookup", kernel=False,
                           strategy=strategy or "torch_fused", sig=sig):
            return ref.rmi_merged_lookup_reference(*args, **kw)
    with dispatch_span("rmi_merged_lookup", kernel=_on_card(q_norm),
                       strategy=strategy or "cuda_fused", sig=sig):
        return rmi_merged_lookup_cuda(*args, **kw)


def rmi_scan_page_op(
    starts, base_keys, base_vals, ins_keys, ins_vals, del_pos, end_rank,
    *, page_size=256, use_kernel=True, strategy=None,
):
    """Rank-addressed merged scan gather -> (keys, vals, live_mask).

    Page g holds the merged rows at ranks ``starts[g] + [0, page_size)``
    of (base minus dead positions) ∪ (effective staged inserts) —
    tombstones elided, insert values woven in — without materializing
    the merge: `rmi_scan_page_cuda` on the card, its plain version on
    the CPU or with ``use_kernel=False``.  Keys are in the snapshot's
    normalized float32 frame and values int32; ``live_mask`` is True
    for ranks in [0, end_rank).  ``base_keys``/``base_vals`` are tensors;
    the other inputs may be arrays and move to their device."""
    dev = base_keys.device
    args = (
        torch.as_tensor(starts, dtype=torch.int32, device=dev),
        base_keys, base_vals,
        torch.as_tensor(ins_keys, dtype=torch.float32, device=dev),
        torch.as_tensor(ins_vals, dtype=torch.int32, device=dev),
        torch.as_tensor(del_pos, dtype=torch.int32, device=dev),
        torch.as_tensor(end_rank, dtype=torch.int32, device=dev).reshape(1),
    )
    sig = (_shape(args[0]), _shape(base_keys), _shape(args[3]), page_size)
    impl = rmi_scan_page_cuda if use_kernel else ref.rmi_scan_page_reference
    with dispatch_span("rmi_scan_page", kernel=use_kernel and _on_card(base_keys),
                       strategy=strategy, sig=sig + (use_kernel,)):
        keys, vals, live = impl(*args, page_size=page_size)
        return keys, vals, live.bool()


def rmi_scan_range_op(
    bounds, base_keys, base_vals, live_prefix, ins_keys, ins_vals,
    ins_rank, *, page_size=256, max_pages=1, use_kernel=True, strategy=None,
):
    """Fused endpoint ranking + paged merged-scan gather: ONE dispatch
    computes the merged ranks of ``bounds = [lo, hi)`` and every page of
    rows in between -> (keys, vals, live_mask), each (max_pages,
    page_size).  Ranks, page starts and rows all resolve on the device
    through the prefix-sum page index (``live_prefix``, ``ins_rank``,
    from `index_service.scan.device_scan_slab`); ``max_pages`` is a
    conservative shape bound and pages past the range come back
    masked.  `rmi_scan_range_cuda` on the card, its plain version on the
    CPU or with ``use_kernel=False``."""
    dev = base_keys.device
    args = (torch.as_tensor(bounds, dtype=torch.float32, device=dev),
            base_keys, base_vals, live_prefix, ins_keys, ins_vals, ins_rank)
    sig = (_shape(base_keys), _shape(ins_keys), page_size, max_pages)
    impl = rmi_scan_range_cuda if use_kernel else ref.rmi_scan_range_reference
    with dispatch_span("rmi_scan_range", kernel=use_kernel and _on_card(base_keys),
                       strategy=strategy, sig=sig + (use_kernel,)):
        keys, vals, live = impl(*args, page_size=page_size, max_pages=max_pages)
        return keys, vals, live.bool()
