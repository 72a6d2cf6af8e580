"""Batched serving engine: continuous batching over the decode step.

A deliberately compact engine that exercises the learned-index
integrations end to end:

  * slot assignment for incoming requests (fixed decode batch; free
    slots recycled as requests finish) — continuous batching;
  * paged KV allocation with the RMI page table (serve/kvcache.py):
    admission reserves pages for the prompt only, and `tick()` GROWS
    the allocation page by page as generation crosses page boundaries,
    so the page table always accounts for every written token;
  * admission control instead of raw ``MemoryError``: an admit that
    cannot get pages (or a slot) returns False — backpressure the
    caller's queue absorbs — and a mid-generation page shortage stalls
    just that request until a neighbour frees pages (with a last-resort
    truncation of the most-complete stalled request when *nothing* can
    make progress, so the engine always converges);
  * a learned Bloom filter screening the prefix cache: "have we served
    this prompt prefix before?" is an existence query in front of cold
    storage, the paper's §5 use case verbatim.  Served prefixes are
    ADDED to the filter on completion, so the screen actually learns
    (a fresh engine starts answering hits on its second pass).

The model decode function is any registry ModelAPI.decode; requests
step in lockstep (one decode_step per engine tick for the whole batch).

The port of the reference's `repro/serve/engine.py`, tick for tick: the
engine calls ``api.decode`` directly (PyTorch runs eagerly; the decode
step updates the cache in place), takes the argmax on the model's
device and copies the next tokens to the host once per tick.  The
allocator and the tokens live on ``api.device``.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import MetricsRegistry, default_registry
from repro_torch.serve.kvcache import PagedKVAllocator


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int
    generated: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    done: bool = False
    # generation cut short by KV exhaustion (all active requests
    # stalled): the engine finished this request early to free pages
    truncated: bool = False
    # prompt tokens not yet fed to the lockstep decode (set on admission)
    _pending: List[int] = dataclasses.field(default_factory=list)
    _prefix_key: Optional[str] = None
    _kv_stalled: bool = False


def prefix_key(prompt: List[int]) -> str:
    """The prefix-cache key: a digest of the first 16 prompt tokens."""
    return hashlib.sha1(bytes(str(prompt[:16]), "utf8")).hexdigest()[:16]


class ServeEngine:
    # Concurrency contract: instances cross threads (built by the caller,
    # driven by one dispatcher), but every mutating method — admit, tick,
    # retire — runs on that single dispatcher thread; there is no
    # internal lock by design.
    # lixlint: thread-shared
    # lixlint: unsynchronized(single-dispatcher-thread ownership; see contract above)
    def __init__(
        self,
        api,
        params,
        *,
        batch_slots: int = 8,
        max_len: int = 256,
        page_size: int = 16,
        kv_pages: Optional[int] = None,
        prefix_bloom=None,
        metrics: Optional[MetricsRegistry] = None,
    ):
        self.api = api
        self.params = params
        self.batch_slots = batch_slots
        self.max_len = max_len
        self.device = api.device
        self.cache = api.init_cache(batch_slots, max_len)
        # kv_pages < the full batch_slots*max_len provision makes page
        # exhaustion reachable: admission defers and growth stalls
        self.kv = PagedKVAllocator(
            num_pages=(batch_slots * (max_len // page_size)
                       if kv_pages is None else kv_pages),
            page_size=page_size,
            device=self.device,
        )
        self.prefix_bloom = prefix_bloom
        self._free_slots = list(range(batch_slots))
        self._active: Dict[int, Request] = {}
        self._tokens = np.zeros((batch_slots,), np.int32)
        self._decode = api.decode
        self.prefix_cache_hits = 0
        self.metrics = metrics if metrics is not None else default_registry()
        self._admit_ctr = self.metrics.counter("engine.admitted")
        self._defer_ctr = self.metrics.counter("engine.deferred")
        self._prefix_hit_ctr = self.metrics.counter("engine.prefix_cache_hits")
        self._kv_grow_ctr = self.metrics.counter("engine.kv_grow_pages")
        self._kv_stall_ctr = self.metrics.counter("engine.kv_stalls")
        self._truncate_ctr = self.metrics.counter("engine.truncations")
        self._tick_hist = self.metrics.histogram("op.tick.latency_s")

    # ---- admission -------------------------------------------------------
    def admit(self, req: Request) -> bool:
        """Take a slot + prompt pages for ``req``; False = deferred
        (no slot, or no pages — backpressure, never ``MemoryError``)."""
        if not self._free_slots:
            return False
        key = prefix_key(req.prompt)
        if self.prefix_bloom is not None:
            if bool(self.prefix_bloom.contains([key])[0]):
                self.prefix_cache_hits += 1
                self._prefix_hit_ctr.add(1)
        slot = self._free_slots.pop()
        try:
            # pages for the PROMPT only; decode grows the allocation as
            # generated tokens cross page boundaries (see _tick_inner)
            self.kv.alloc(req.uid, max(1, len(req.prompt)))
        except MemoryError:
            # out of KV pages: hand the slot back and defer the request
            # — the old path leaked the slot and crashed run()
            self._free_slots.append(slot)
            self._defer_ctr.add(1)
            return False
        self._admit_ctr.add(1)
        req.slot = slot
        req._prefix_key = key
        self._active[req.uid] = req
        # feed the prompt sequentially (a production engine prefills;
        # lockstep decode keeps this engine minimal)
        self._tokens[req.slot] = req.prompt[0] if req.prompt else 0
        req._pending = list(req.prompt[1:])
        return True

    # ---- one lockstep decode tick -----------------------------------------
    def tick(self) -> List[Request]:
        if not self._active:
            return []
        with obs_trace.span(
            "engine.tick", cat="serve", active=len(self._active)
        ), self._tick_hist.time():
            return self._tick_inner()

    def _finish(self, req: Request, finished: List[Request]) -> None:
        req.done = True
        finished.append(req)
        self._free_slots.append(req.slot)
        self.kv.free(req.uid)
        del self._active[req.uid]
        if (self.prefix_bloom is not None and req._prefix_key is not None
                and hasattr(self.prefix_bloom, "add")):
            # the screen learns: the NEXT request with this prefix is a
            # prefix-cache hit instead of a guaranteed miss
            self.prefix_bloom.add([req._prefix_key])

    def _grow_kv(self, req: Request, tokens_needed: int) -> bool:
        """Ensure the request's pages cover ``tokens_needed`` tokens;
        False = out of pages (the request stalls this tick)."""
        if tokens_needed <= self.kv.request_capacity(req.uid):
            return True
        try:
            self.kv.alloc(req.uid, 1)  # exactly one more page
        except MemoryError:
            if not req._kv_stalled:
                req._kv_stalled = True
                self._kv_stall_ctr.add(1)
            return False
        self._kv_grow_ctr.add(1)
        req._kv_stalled = False
        return True

    def _tick_inner(self) -> List[Request]:
        logits, self.cache = self._decode(
            self.params, self.cache,
            torch.as_tensor(self._tokens, device=self.device),
        )
        nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        finished: List[Request] = []
        progressed = False
        stalled: List[Request] = []
        for req in list(self._active.values()):
            if req._pending:  # still consuming the prompt
                self._tokens[req.slot] = req._pending.pop(0)
                progressed = True
                continue
            # grow the allocation BEFORE committing the next generated
            # token: every written token is page-table-accounted (the
            # old engine wrote up to max_new_tokens past the prompt's
            # pages and the RMI table under-counted)
            if not self._grow_kv(req, len(req.prompt) + len(req.generated) + 1):
                stalled.append(req)
                continue
            tok = int(nxt[req.slot])
            req.generated.append(tok)
            self._tokens[req.slot] = tok
            progressed = True
            if len(req.generated) >= req.max_new_tokens:
                self._finish(req, finished)
        if stalled and not progressed and not finished:
            # every active request is KV-stalled and nothing freed a
            # page this tick: without intervention no page will EVER
            # free.  Truncate the most-complete stalled request — its
            # pages unblock the rest and the engine converges.
            victim = max(stalled, key=lambda r: len(r.generated))
            victim.truncated = True
            self._truncate_ctr.add(1)
            self._finish(victim, finished)
        return finished

    def run(self, requests: List[Request], max_ticks: int = 10_000) -> List[Request]:
        queue = list(requests)
        done: List[Request] = []
        ticks = 0
        while (queue or self._active) and ticks < max_ticks:
            while queue and self.admit(queue[0]):
                queue.pop(0)
            done.extend(self.tick())
            ticks += 1
        return done
