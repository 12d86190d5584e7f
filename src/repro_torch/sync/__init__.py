"""Continuous epoch reconciliation for divergent replicas (DESIGN.md §11),
carried over from the reference package's ``sync`` facade.

``repro_torch.sync`` is the facade over the continuous-sync machinery that lives
with each layer it extends: sets mutate between **epochs** and only deltas
move — in H2D traffic (the device-resident CSR stores are patched in
place through tombstone-reclaiming swap-remove + append lanes instead of
rebuilt) and on the wire (the ``MSG_EPOCH`` envelope carries the epoch id
plus the d̂ re-estimation handshake through the phase-0 codecs).

The pieces, in dependency order:

* ``SessionBatch(mutable=True)`` + ``apply_mutations`` / ``advance_session``
  / ``apply_churn`` (``repro_torch.recon.session``) — delta-mutable cohort
  stores with per-row capacity lanes and compaction on overflow;
* ``ReconcileServer(continuous=True).advance_epoch`` (``repro_torch.recon``) —
  the in-process epoch loop, re-estimating d through the batched ToW
  kernel path and folding learned diffs for replica convergence;
* ``encode_epoch`` / ``decode_epoch`` (``repro_torch.wire``) — the epoch
  envelope, mirroring ``MSG_MUX``'s ledger rules (inner bits per Formula
  (1), envelope bytes as transport overhead);
* ``AliceEndpoint`` / ``BobEndpoint`` / ``HubEndpoint`` with
  ``continuous=True`` plus the ``run_pair_epoch`` / ``run_hub_epoch``
  drivers (``repro_torch.net``) — epochs over real transports, reusing live
  sessions and channels with no re-admission;
* ``submit_tree`` on the endpoints + ``tree_reconcile`` (``repro_torch.tree``,
  DESIGN.md §15) — the cold-start ramp: a brand-new or long-offline
  replica's first epoch has no sane d̂, so it routes through the tree
  front end (range digests, recurse into divergence, leaf ranges as
  known-d sessions) and from the next ``advance_epoch`` on rejoins the
  ordinary delta path above.

Locked down by tests/test_torch_sync.py (delta path ≡ from-scratch
rebuild, byte for byte, and multi-epoch hub runs under churn against the
``core.pbs.reconcile`` oracle and the reference package's hub).
"""
from ..net import (
    AliceEndpoint,
    BobEndpoint,
    ChaosTransport,
    FaultPlan,
    HubEndpoint,
    run_hub_epoch,
    run_pair_epoch,
)
from ..recon.server import ReconcileServer
from ..tree import TreeConfig, TreeResult, partition_pair, tree_reconcile
from ..recon.session import (
    SessionBatch,
    StoreCapacityError,
    advance_session,
    apply_churn,
)
from ..wire import decode_epoch, encode_epoch, epoch_overhead_bytes

__all__ = [
    "AliceEndpoint",
    "BobEndpoint",
    "ChaosTransport",
    "FaultPlan",
    "HubEndpoint",
    "ReconcileServer",
    "SessionBatch",
    "StoreCapacityError",
    "TreeConfig",
    "TreeResult",
    "advance_session",
    "apply_churn",
    "decode_epoch",
    "encode_epoch",
    "epoch_overhead_bytes",
    "partition_pair",
    "run_hub_epoch",
    "run_pair_epoch",
    "tree_reconcile",
]
