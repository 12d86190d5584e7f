"""Deterministic data pipeline + PBS-reconciled consumption ledger."""
from .pipeline import (  # noqa: F401
    DataConfig,
    Ledger,
    global_batch,
    host_shard,
    sample_tokens,
    step_sample_ids,
)
