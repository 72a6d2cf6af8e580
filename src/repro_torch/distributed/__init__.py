"""Fault tolerance for the port: crash-safe tree and index checkpoints,
restart, and the straggler policy (the reference's
`repro.distributed.fault_tolerance`).  The reference package's
`distributed/__init__` exports its sharding rules; the port has no
sharding module yet (ROADMAP queue A), so this one exports the
fault-tolerance names only."""

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

__all__ = [
    "CheckpointCorrupt", "CheckpointManager", "IndexCheckpointer",
    "StragglerPolicy", "config_fingerprint", "latest_step",
    "newest_intact_step", "quarantine_step", "restore_checkpoint",
    "save_checkpoint", "verify_step",
]
