"""Serving: the paged KV allocator with its learned page table and the
continuous-batching engine (the reference's `repro.serve`, less the
index frontend, which waits for ROADMAP queue A)."""

from repro_torch.serve.kvcache import PagedKVAllocator
from repro_torch.serve.engine import Request, ServeEngine, prefix_key

__all__ = ["PagedKVAllocator", "Request", "ServeEngine", "prefix_key"]
