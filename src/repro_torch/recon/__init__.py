"""Batched multi-session set reconciliation on the accelerator path.

The single-session protocol in ``repro_torch.core.pbs`` is the numpy oracle; this
package turns it into a traffic-serving system (DESIGN.md §5): a
``SessionBatch`` planner uploads each cohort's element store to the device
once and emits only small gather/overlay arrays per round, a fused
``execute_round`` rebuilds unit rows on device and runs both sides'
bin/sketch/decode in one call, and ``ReconcileServer`` enqueues all
cohorts before the first readback while keeping per-session byte ledgers identical to
``core.pbs.reconcile``.

``ReconcileServer(continuous=True)`` extends the same machinery to
continuous epoch reconciliation (DESIGN.md §11): ``advance_epoch`` folds
learned diffs and local churn into delta-mutable stores patched in place,
so a long-lived session pays O(churn) H2D per epoch instead of a rebuild.
"""
from .engine import (
    encode_side,
    encode_side_ext,
    execute_round,
    execute_round_ext,
)
from .server import ReconcileServer, phase0_numerators, reconcile_batch
from .session import (
    CohortRoundPlan,
    CohortStore,
    ReconSession,
    SessionBatch,
    SideStore,
    StoreCapacityError,
    advance_session,
    apply_churn,
    cohort_store_from_numpy,
    degrade_exhausted,
    escalate_session,
)

__all__ = [
    "CohortRoundPlan",
    "CohortStore",
    "ReconSession",
    "ReconcileServer",
    "SessionBatch",
    "SideStore",
    "StoreCapacityError",
    "advance_session",
    "apply_churn",
    "cohort_store_from_numpy",
    "degrade_exhausted",
    "escalate_session",
    "encode_side",
    "encode_side_ext",
    "execute_round",
    "execute_round_ext",
    "phase0_numerators",
    "reconcile_batch",
]
