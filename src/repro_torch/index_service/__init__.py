"""Writable learned indexes: delta buffers, warm re-train, versioned
snapshot swap (the paper's §3.3 inserts/updates challenge), in torch.

Public API:
  Write path:    DeltaBuffer (staging), Compactor / CompactionStats
  Consistency:   IndexSnapshot, VersionManager, build_snapshot
  Front end:     IndexService, ServiceConfig — batched mixed
                 get/range/insert/delete/contains ops
  Scans:         ScanPage / PinnedView / scan_pages / repack_pages —
                 paged (keys, vals, live_mask) streams in base+delta
                 merge order over a view pinned at iterator creation
"""

from repro_torch.index_service.compact import (
    CompactionStall,
    CompactionStats,
    Compactor,
    merge_delta,
)
from repro_torch.index_service.delta import (
    DeltaBuffer,
    collapse_levels,
    combine_for_device,
    count_less,
    live_mask,
    member,
)
from repro_torch.index_service.plane import (
    DevicePlane,
    scan_plane_key,
    scan_plane_key_eq,
)
from repro_torch.index_service.scan import (
    PinnedView,
    ScanPage,
    pin_view,
    repack_pages,
    scan_pages,
)
from repro_torch.index_service.service import IndexService, ServiceConfig
from repro_torch.index_service.snapshot import (
    MERGED_STRATEGIES,
    REFERENCE_STRATEGY,
    IndexSnapshot,
    VersionManager,
    build_snapshot,
)

__all__ = [
    "CompactionStall", "CompactionStats", "Compactor", "merge_delta",
    "DeltaBuffer", "collapse_levels", "combine_for_device", "count_less",
    "live_mask", "member",
    "IndexService", "ServiceConfig",
    "DevicePlane", "scan_plane_key", "scan_plane_key_eq",
    "PinnedView", "ScanPage", "pin_view", "repack_pages", "scan_pages",
    "IndexSnapshot", "MERGED_STRATEGIES", "REFERENCE_STRATEGY",
    "VersionManager", "build_snapshot",
]
