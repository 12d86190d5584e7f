"""Tree-partitioned cold-start front end over PBS (DESIGN.md §15).

``partition_pair`` walks a binary range tree over the 32-bit key space
with batched per-range ToW digests (one ``tree_digest`` kernel sweep per
level), prunes converged ranges, and hands each divergent range with a
small residual d̂ to PBS as an ordinary known-d session;
``tree_reconcile`` is the one-call in-process form.  The wire flow — a
cold-start peer exchanging ``MSG_TREE`` digest/verdict frames with a pair
endpoint or the hub before PBS admission — is the reference's
``repro.net`` and is not ported yet.
"""
from .partition import (
    SPAN,
    TreeConfig,
    TreeLeaf,
    TreeResult,
    TreeStats,
    leaf_slices,
    level_digests,
    level_digests_ref,
    level_verdicts,
    partition_pair,
    range_bounds,
    split_ranges,
    tree_reconcile,
    tree_seeds,
)

__all__ = [
    "SPAN",
    "TreeConfig",
    "TreeLeaf",
    "TreeResult",
    "TreeStats",
    "leaf_slices",
    "level_digests",
    "level_digests_ref",
    "level_verdicts",
    "partition_pair",
    "range_bounds",
    "split_ranges",
    "tree_reconcile",
    "tree_seeds",
]
