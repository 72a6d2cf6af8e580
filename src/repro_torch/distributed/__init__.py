"""The port's distributed layer (the reference's `repro.distributed`):
the sharding rules (exported here, as the reference exports them), the
int8 compressed all-reduce (`distributed.collectives`), and fault
tolerance: crash-safe tree and index checkpoints, restart, and the
straggler policy."""

from repro_torch.distributed.fault_tolerance import (
    CheckpointCorrupt,
    CheckpointManager,
    IndexCheckpointer,
    StragglerPolicy,
    config_fingerprint,
    latest_step,
    newest_intact_step,
    quarantine_step,
    restore_checkpoint,
    save_checkpoint,
    verify_step,
)
from repro_torch.distributed.sharding import (
    batch_shardings,
    cache_shardings,
    opt_state_shardings,
    param_shardings,
)

__all__ = [
    "CheckpointCorrupt", "CheckpointManager", "IndexCheckpointer",
    "StragglerPolicy", "batch_shardings", "cache_shardings", "config_fingerprint",
    "latest_step", "newest_intact_step", "opt_state_shardings", "param_shardings",
    "quarantine_step", "restore_checkpoint", "save_checkpoint", "verify_step",
]
