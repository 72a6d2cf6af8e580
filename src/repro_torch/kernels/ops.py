"""Public wrappers around the port's kernels, with dispatch accounting.

Each op launches the CUDA kernel for tensors on the card and runs the
plain PyTorch version for tensors on the CPU; callers never touch the
launch directly.  The lookup and scan ops (B1, B3-B6) run their kernel
under the reference's retry-once, sticky failover onto the plain twin
(`run_with_failover`).  On a card tensor only an injected fault
reroutes: a kernel library that fails to build or load, and any real
launch error, raises from the op.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time

import numpy as np
import torch

from repro_torch import faults
from repro_torch.core.bloom import words_tensor
from repro_torch.core.models import pack_stage0
from repro_torch.core.rmi import LEAF_FIELDS
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding
from repro_torch.kernels import ref, rmi_lookup, rmi_scan
from repro_torch.kernels.bloom_probe import as_u32_bits, bloom_probe_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.hash_probe import hash_probe_cuda
from repro_torch.kernels.rmi_lookup import (
    rmi_lookup_cuda,
    rmi_merged_lookup_cuda,
    rmi_sharded_merged_lookup_cuda,
    stage0_flat,
)
from repro_torch.kernels.rmi_scan import (
    rmi_scan_page_cuda,
    rmi_scan_range_cuda,
    rmi_sharded_scan_page_cuda,
)
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


# ---------------------------------------------------------------------------
# kernel -> plain twin failover
# ---------------------------------------------------------------------------
# Every lookup and scan op below has a bit-identical plain twin one
# branch away; a kernel that RAISES at launch (a CUDA runtime fault, an
# injected ``kernel.dispatch`` fault) must not take the read path down
# with it.  Policy, per (op, strategy), as in the reference:
#
#   * a healthy kernel that raises is retried ONCE (transient faults
#     heal invisibly), and a second failure stickily reroutes the pair
#     to the twin — counted as ``kernel_failover``;
#   * while rerouted, every `FAILOVER_REPROBE_EVERY`-th call re-probes
#     the kernel with a single attempt; success re-enables it
#     (``kernel_failover.recoveries``), failure stays on the twin.
#
# Every error is counted (``kernel_failover.errors``) and traced, so a
# reroute is never quiet.  On a card tensor only an injected fault
# (`faults.InjectedFault`) reroutes: a library that does not build or
# load raises before the policy runs, and a real launch error or a
# refused input raises from the op.  On CPU tensors every exception
# reroutes, as in the reference.
#
# The healthy fast path costs one dict read and one attribute check.

FAILOVER_REPROBE_EVERY = 64


class _Failover:
    """Sticky health record for one (op, strategy) kernel pair."""

    __slots__ = ("lock", "disabled", "since")

    def __init__(self):
        self.lock = threading.Lock()
        self.disabled = False   # reroute every call to the twin
        self.since = 0          # twin calls since disablement


_FAILOVER: dict = {}            # (op, strategy) -> _Failover
_FAILOVER_LOCK = threading.Lock()


def _failover_state(op: str, strategy) -> _Failover:
    key = (op, strategy or "")
    st = _FAILOVER.get(key)     # lock-free fast path (GIL-atomic read)
    if st is None:
        with _FAILOVER_LOCK:
            st = _FAILOVER.setdefault(key, _Failover())
    return st


def failover_summary() -> dict:
    """{"op:strategy": {"disabled": bool, "fallback_calls": int}} for
    every kernel pair that has been exercised."""
    with _FAILOVER_LOCK:
        items = list(_FAILOVER.items())
    return {
        f"{op}:{strategy}": {
            "disabled": st.disabled, "fallback_calls": st.since,
        }
        for (op, strategy), st in items
    }


def reset_failover() -> None:
    """Forget all sticky reroutes (tests / bench isolation)."""
    with _FAILOVER_LOCK:
        _FAILOVER.clear()


def run_with_failover(op: str, strategy, kernel_fn, fallback_fn, t=None, module=None):
    """Run ``kernel_fn`` under the retry-once + sticky-failover policy,
    rerouting to ``fallback_fn`` (bit-identical results) on failure.
    Both callables own their dispatch_span, so attribution stays honest
    about which program actually ran.  Twin errors propagate: with the
    kernel already out of the picture there is nothing left to fail
    over to.

    ``t`` is the tensor the kernel runs on.  When it lies on the card,
    ``module``'s kernel library is built and loaded first, so a build
    or load error raises here, and only `faults.InjectedFault` is
    caught: any other error of the kernel propagates."""
    on_card = t is not None and _on_card(t)
    if on_card and module is not None:
        module.load()
    rerouted = faults.InjectedFault if on_card else Exception
    st = _failover_state(op, strategy)
    probe = False
    if st.disabled:
        with st.lock:
            if st.disabled:
                st.since += 1
                if st.since % FAILOVER_REPROBE_EVERY:
                    return fallback_fn()
                probe = True
    reg = obs_metrics.default_registry()
    for _attempt in range(1 if probe else 2):
        try:
            faults.maybe("kernel.dispatch")
            out = kernel_fn()
        except rerouted as e:
            reg.counter("kernel_failover.errors").add(1)
            obs_trace.instant(
                "kernel.error", cat="fault", op=op,
                strategy=strategy or "", error=type(e).__name__,
            )
            continue
        if st.disabled:
            with st.lock:
                st.disabled = False
                st.since = 0
            reg.counter("kernel_failover.recoveries").add(1)
            obs_trace.instant("kernel.recovered", cat="fault", op=op,
                              strategy=strategy or "")
        return out
    if not st.disabled:
        with st.lock:
            st.disabled = True
            st.since = 0
        reg.counter("kernel_failover").add(1)
        obs_trace.instant("kernel.failover", cat="fault", op=op,
                          strategy=strategy or "")
    return fallback_fn()


def _kernel_or_twin(op: str, strategy, run, use_kernel: bool, module,
                    t: torch.Tensor):
    """``run(kernel: bool)`` as one dispatch: the plain twin when
    ``use_kernel`` is off, else the kernel under the failover policy
    with the twin behind it."""
    if not use_kernel:
        return run(False)
    return run_with_failover(op, strategy, lambda: run(True), lambda: run(False),
                             t, module)


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
    (`strategy="torch_fused"`) — same arithmetic, same results.  A
    kernel that raises rides the retry-once + sticky-failover policy
    onto that twin (`run_with_failover`)."""
    dev = q_norm.device
    args = (q_norm, *_index_tensors(index, sorted_keys_norm, dev),
            torch.as_tensor(delta_keys, device=dev),
            torch.as_tensor(delta_prefix, device=dev))
    kw = dict(hidden=index.hidden, n=index.n, num_leaves=index.num_leaves,
              max_window=index.max_window)
    sig = (_shape(q_norm), _shape(delta_keys), index.n)

    def run(kernel):
        with dispatch_span(
            "rmi_merged_lookup", kernel=kernel and _on_card(q_norm),
            strategy=(strategy or "cuda_fused") if kernel
            else "torch_fused" if use_kernel else (strategy or "torch_fused"),
            sig=sig + (kernel,),
        ):
            if kernel:
                return rmi_merged_lookup_cuda(*args, **kw)
            return ref.rmi_merged_lookup_reference(*args, **kw)

    return _kernel_or_twin("rmi_merged_lookup", strategy or "cuda_fused", run, use_kernel,
                           rmi_lookup, q_norm)


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

    def run(kernel):
        impl = rmi_scan_page_cuda if kernel else ref.rmi_scan_page_reference
        with dispatch_span("rmi_scan_page", kernel=kernel and _on_card(base_keys),
                           strategy=strategy, sig=sig + (kernel,)):
            keys, vals, live = impl(*args, page_size=page_size)
            return keys, vals, live.bool()

    return _kernel_or_twin("rmi_scan_page", strategy, run, use_kernel, rmi_scan, base_keys)


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

    def run(kernel):
        impl = rmi_scan_range_cuda if kernel else ref.rmi_scan_range_reference
        with dispatch_span("rmi_scan_range", kernel=kernel and _on_card(base_keys),
                           strategy=strategy, sig=sig + (kernel,)):
            keys, vals, live = impl(*args, page_size=page_size, max_pages=max_pages)
            return keys, vals, live.bool()

    return _kernel_or_twin("rmi_scan_range", strategy, run, use_kernel, rmi_scan, base_keys)


# ---------------------------------------------------------------------------
# sharded lookups and scans: stacked (S, ...) shard arrays
# ---------------------------------------------------------------------------

def _pad_m(a, m_pad: int) -> np.ndarray:
    a = np.asarray(a, np.float32)
    return np.pad(a, (0, m_pad - a.size))


def pad_shard_row(index, keys_norm, n_pad: int, m_pad: int) -> dict:
    """One shard's row of the stacked lookup layout, padded to an
    explicit ``(n_pad, m_pad)`` bucket — the incremental counterpart of
    `stack_shard_arrays`: the sharded service re-packs only the rows
    whose snapshot changed and keeps the rest byte-stable.  Leaf arrays
    pad with zeros, keys with +inf, the stage-0 parameters are one flat
    buffer (`pack_stage0`), and ``ratio`` is ``np.float32(m / n)`` from
    the host."""
    k = np.asarray(keys_norm, np.float32)
    keys = np.full(n_pad, np.inf, np.float32)
    keys[: k.size] = k
    return {
        "stage0": pack_stage0(index.stage0_params),
        "leaf_w": _pad_m(index.leaf_w, m_pad), "leaf_b": _pad_m(index.leaf_b, m_pad),
        "err_lo": _pad_m(index.err_lo, m_pad), "err_hi": _pad_m(index.err_hi, m_pad),
        "keys": keys,
        "n": np.int32(index.n), "m": np.int32(index.num_leaves),
        "ratio": np.float32(index.num_leaves / index.n),
        "max_window": index.max_window,
        "hidden": tuple(index.config.stage0_hidden),
    }


def stack_rows(rows, device) -> dict:
    """Stack `pad_shard_row` rows into the (S, ...) tensors
    `sharded_routed_lookup` takes, on ``device`` (fresh copies:
    nothing aliases the rows), plus the shared ``hidden`` and the
    maximum ``max_window``.  The four leaf tensors are the column views
    of one (S, M, 4) float32 record (w, b, err_lo, err_hi), which the
    sharded lookup kernel reads with one 16-byte load a leaf."""
    hiddens = {r["hidden"] for r in rows}
    if len(hiddens) != 1:
        raise ValueError("shards disagree on stage-0 architecture")

    def up(key, dtype=None):
        return torch.from_numpy(np.stack(
            [np.asarray(r[key], dtype) for r in rows])).to(device)

    out = {k: up(k) for k in ("stage0", "keys")}
    record = torch.from_numpy(np.stack(
        [np.stack([r[f] for f in LEAF_FIELDS], axis=1) for r in rows])).to(device)
    out.update(zip(LEAF_FIELDS, record.unbind(2)))
    out["shard_n"] = up("n", np.int32)
    out["shard_m"] = up("m", np.int32)
    out["shard_ratio"] = up("ratio", np.float32)
    out["hidden"] = hiddens.pop()
    out["max_window"] = max(int(r["max_window"]) for r in rows)
    return out


def stack_shard_arrays(indexes, key_arrays, device) -> dict:
    """Pad and stack per-shard (RMIndex, sorted f32 keys) pairs into the
    (S, ...) layout `sharded_routed_lookup` consumes: leaf arrays
    zero-padded to the widest shard, keys +inf-padded to the longest
    (never read: the kernel clips by each shard's true n), stage-0
    buffers one row per shard, true sizes and host-computed
    ``f32(m / n)`` as (S,) arrays.  Returns tensors on ``device`` plus
    the shared ``hidden`` and the maximum ``max_window``."""
    n_max = max(np.asarray(k).size for k in key_arrays)
    m_max = max(ix.num_leaves for ix in indexes)
    return stack_rows([pad_shard_row(ix, k, n_max, m_max)
                       for ix, k in zip(indexes, key_arrays)], device)


def sharded_reassemble(local_base, delta_contrib, shard_of, base_offsets,
                       merged_offsets):
    """Global rank reassembly: pick each query's routed shard row and
    add the prefix-sum offsets.

    ``base_offsets[j]`` is the number of base keys in shards < j and
    ``merged_offsets[j]`` the number of LIVE keys (base + delta net) in
    shards < j, so

        base(q)   = base_offsets[route(q)]   + local_base
        merged(q) = merged_offsets[route(q)] + local_base + delta_contrib

    (at the snapshot level, where the delta is global, callers pass
    ``merged_offsets=base_offsets``).  int32 throughout, as in the
    reference."""
    j = shard_of.long()
    lb = local_base.gather(0, j[None, :])[0]
    ct = delta_contrib.gather(0, j[None, :])[0]
    return base_offsets[j] + lb, merged_offsets[j] + lb + ct


def sharded_routed_lookup(
    q_stacked, shard_of, stage0, leaf_w, leaf_b, err_lo, err_hi,
    sorted_keys, delta_keys, delta_prefix, shard_n, shard_m, shard_ratio,
    base_off, merged_off, *, hidden=(), max_window, use_kernel=True,
):
    """Sharded merged lookup + routed reassembly, with no dispatch span
    of its own: `rmi_sharded_merged_lookup_cuda` (its plain twin on the
    CPU or with ``use_kernel=False``) over the stacked (S, ...) shard
    tensors, then `sharded_reassemble`.  Returns global ``(base_rank,
    merged_rank)``, int32 (B,)."""
    impl = (rmi_sharded_merged_lookup_cuda if use_kernel
            else ref.rmi_sharded_merged_lookup_reference)
    lb, ct = impl(q_stacked, stage0, leaf_w, leaf_b, err_lo, err_hi, sorted_keys,
                  delta_keys, delta_prefix, shard_n, shard_m, shard_ratio,
                  hidden=tuple(hidden), max_window=max_window)
    return sharded_reassemble(lb, ct, shard_of, base_off, merged_off)


def rmi_sharded_routed_lookup_op(
    q_stacked, shard_of, *plan, hidden=(), max_window, use_kernel=True,
    strategy=None,
):
    """`sharded_routed_lookup` in ONE dispatch (``plan`` is its stacked
    shard tensors, delta and offsets, in its order).  The kernel path
    rides the retry-once + sticky-failover policy onto the plain twin."""
    sorted_keys, delta_keys = plan[5], plan[6]
    sig = (_shape(q_stacked), _shape(sorted_keys), _shape(delta_keys))

    def run(kernel):
        with dispatch_span("rmi_sharded_routed_lookup",
                           kernel=kernel and _on_card(q_stacked),
                           strategy=strategy or "sharded_fused", sig=sig + (kernel,)):
            return sharded_routed_lookup(q_stacked, shard_of, *plan, hidden=hidden,
                                         max_window=max_window, use_kernel=kernel)

    return _kernel_or_twin("rmi_sharded_routed_lookup", strategy or "sharded_fused", run,
                           use_kernel, rmi_lookup, q_stacked)


def sharded_scan_owners(bounds, base_keys, live_prefix, ins_keys):
    """The sharded scan's rank pre-pass, in plain torch (the reference
    runs it in XLA outside its kernel): each shard's merged ranks of
    ``bounds = [lo, hi)`` through its prefix-sum page index, and the
    prefix sums of the per-shard spans.  Returns ``(ls0, own_lo,
    own_hi)``, int32 (S,): shard s owns stream slots [own_lo, own_hi)
    starting at its local rank ls0."""
    dev = base_keys.device
    b = torch.as_tensor(bounds, dtype=torch.float32, device=dev)
    S = base_keys.shape[0]
    steps, isteps = ref.trip_counts(base_keys.shape[1], ins_keys.shape[1])
    qb = b[None, :].expand(S, 2)
    bl = ref.rows_lower_bound(base_keys, qb, base_keys.shape[1], steps)
    lr = (live_prefix.gather(1, bl.long())
          + ref.rows_lower_bound(ins_keys, qb, ins_keys.shape[1], isteps))
    ls0 = lr[:, 0].contiguous()
    span = torch.maximum(lr[:, 1], ls0) - ls0   # inverted ranges clamp empty
    pre = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                     torch.cumsum(span, 0, dtype=torch.int32)])
    return ls0, pre[:-1].contiguous(), pre[1:].contiguous()


def rmi_sharded_scan_page_op(
    bounds, base_keys, base_vals, live_prefix, ins_keys, ins_vals,
    ins_rank, *, page_size=256, max_pages=1, use_kernel=True, strategy=None,
):
    """Sharded fused scan in ONE dispatch: rank ``bounds = [lo, hi)`` on
    every shard (plain torch: all keys of lower shards sort below both
    bounds, so the per-shard spans concatenate into the global stream and
    their prefix sums are the ownership offsets), gather each shard's
    owned rows (`rmi_sharded_scan_page_cuda`, or its plain twin on the
    CPU or with ``use_kernel=False``), and reduce the owner-masked
    (S, G, P) matrices into the global (G, P) page stream.  All slabs
    share one normalized frame (`index_service.scan.pack_scan_slab`);
    rows come back in it.  Returns ``(keys f32, vals i32, live_mask
    bool)``, pages past the range fully masked."""
    sig = (_shape(base_keys), _shape(ins_keys), page_size, max_pages)

    def run(kernel):
        impl = rmi_sharded_scan_page_cuda if kernel else ref.rmi_sharded_scan_page_reference
        with dispatch_span("rmi_sharded_scan_page",
                           kernel=kernel and _on_card(base_keys),
                           strategy=strategy, sig=sig + (kernel,)):
            owners = sharded_scan_owners(bounds, base_keys, live_prefix, ins_keys)
            keys, vals, live = impl(
                base_keys, base_vals, live_prefix, ins_keys, ins_vals, ins_rank,
                *owners, page_size=page_size, max_pages=max_pages)
            # exactly one shard owns each stream slot
            return (keys.amin(0), vals.sum(0, dtype=torch.int32),
                    live.amax(0).bool())

    return _kernel_or_twin("rmi_sharded_scan_page", strategy, run, use_kernel, rmi_scan, base_keys)


# ---------------------------------------------------------------------------
# §4 / §5 point probes
# ---------------------------------------------------------------------------

def bloom_probe_op(bf, queries_u32, *, device=None) -> torch.Tensor:
    """Batched Bloom probe through `bloom_probe_cuda` (the kernel on the
    card, its plain version on the CPU) -> (B,) bool.  `bf` is a
    core.BloomFilter; ``queries_u32`` pre-folded uint32 keys: a tensor
    (int32 bit patterns or uint32; its device decides) or an array
    (moved to ``device``).  The words are uploaded on every call, as
    the reference's op does; hold them with `core.compile_bloom_probe`
    for repeated probes."""
    q = queries_u32
    if not isinstance(q, torch.Tensor):
        q = torch.as_tensor(np.ascontiguousarray(q, np.uint32), device=resolve_device(device))
    q = as_u32_bits(q)
    words = words_tensor(bf, q.device)
    with dispatch_span("bloom_probe", kernel=_on_card(q), strategy="cuda",
                       sig=(_shape(q), bf.num_bits, bf.num_hashes)):
        return bloom_probe_cuda(q, words, num_bits=bf.num_bits, k=bf.num_hashes)


def hash_probe_tensors(hm, index, keys, device) -> tuple:
    """The probe's tables on ``device``: the linear stage-0, the leaf
    parameters, and the slot and overflow keys normalized into the key
    set's float32 frame (NaN stays NaN) with int32 links.  Each pair the
    kernel reads together is one 8-byte record, packed on ``device``
    after the upload (one `torch.stack` each): ``leaf_w`` and ``leaf_b``
    are the columns of an (M, 2) float32 record, and each key and link
    the columns of an (N, 2) int32 record (key bits, next), the key
    column viewed as float32."""
    dev = torch.device(device)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731

    def pairs(key, nxt):
        rec = torch.stack([t(keys.normalize(key)).view(torch.int32),
                           t(nxt.astype(np.int32))], dim=1)
        return rec.view(torch.float32)[:, 0], rec[:, 1]

    leaves = torch.stack([t(index.leaf_w), t(index.leaf_b)], dim=1)
    return (t(pack_stage0(index.stage0_params)), leaves[:, 0], leaves[:, 1],
            *pairs(hm.slot_key, hm.slot_next), *pairs(hm.ovf_key, hm.ovf_next))


def hash_probe_op(hm, index, keys, q_raw, *, device=None) -> torch.Tensor:
    """Batched hash-model probe through `hash_probe_cuda` -> (B,) bool.
    `hm` is a HashMap, `index` its linear-stage RMI, `keys` the KeySet
    whose frame normalizes the raw float64 queries ``q_raw`` (on the
    host, as the reference does).  The tables go to ``device`` (None =
    "cuda") on every call."""
    dev = resolve_device(device)
    q = torch.as_tensor(keys.normalize(q_raw), device=dev)
    with dispatch_span("hash_probe", kernel=_on_card(q), strategy="cuda",
                       sig=(_shape(q), hm.num_slots, index.n)):
        return hash_probe_cuda(
            q, *hash_probe_tensors(hm, index, keys, dev), n=index.n,
            num_leaves=index.num_leaves, num_slots=hm.num_slots,
            trips=max(0, hm.max_chain - 1))


# ---------------------------------------------------------------------------
# LM substrate: attention
# ---------------------------------------------------------------------------

def attention_op(q, k, v, *, causal=True, use_kernel=True) -> torch.Tensor:
    """(B, Hq, Sq, D) GQA attention over (B, Hkv, Sk, D) keys and values
    through `flash_attention_cuda`: the kernel for tensors on the card
    (it masks ragged tiles itself, so every length goes to it; causal
    needs Sq == Sk), the plain `ref.mha_reference` on the CPU.  Under
    grad mode with an input that requires grad the call goes through the
    autograd Function (`flash_attention.FlashAttention`): the forward
    and backward kernels on the card (Sq == Sk only: ROADMAP queue C
    13), their plain versions on the CPU.
    ``use_kernel=False`` runs `ref.mha_reference` on any device, through
    torch autograd.  DTensors q, k and v (the partitioned train step)
    go through `distributed.sharding.on_local_heads`: each rank's local
    batch rows and heads through this op, the output a DTensor placed
    as q."""
    if sharding.is_dtensor(q):
        return sharding.on_local_heads(
            functools.partial(attention_op, causal=causal, use_kernel=use_kernel), q, k, v)
    kernel = use_kernel and _on_card(q)
    with dispatch_span("attention", kernel=kernel, strategy="cuda",
                       sig=(_shape(q), _shape(k), str(q.dtype), causal)):
        if not use_kernel:
            return ref.mha_reference(q, k, v, causal=causal)
        return flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                    causal=causal)
