"""Atomic sharded checkpoints + PBS-reconciled manifest sync."""
from .manager import (  # noqa: F401
    BLOCK_BYTES,
    Manifest,
    SyncReport,
    latest_step,
    load_manifest,
    reconcile_manifests,
    restore_checkpoint,
    save_checkpoint,
    signature,
    sync_checkpoint,
)
