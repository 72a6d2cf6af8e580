"""Serving: the paged KV allocator with its learned page table, the
continuous-batching engine, and the multi-tenant index frontend (the
reference's `repro.serve`)."""

from repro_torch.serve.kvcache import PagedKVAllocator
from repro_torch.serve.engine import Request, ServeEngine, prefix_key
from repro_torch.serve.frontend import (
    DEGRADED_WRITES,
    HEALTH_STATES,
    HEALTHY,
    STALE_READS,
    UNAVAILABLE,
    Backpressure,
    DeadlineExceeded,
    FrontendConfig,
    IndexFrontend,
    WriteShed,
    retry_with_backoff,
)

__all__ = [
    "PagedKVAllocator",
    "Request", "ServeEngine", "prefix_key",
    "Backpressure", "DeadlineExceeded", "FrontendConfig", "IndexFrontend",
    "WriteShed", "retry_with_backoff",
    "HEALTH_STATES", "HEALTHY", "DEGRADED_WRITES", "STALE_READS",
    "UNAVAILABLE",
]
