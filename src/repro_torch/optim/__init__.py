"""AdamW (+ the ZeRO-1 plan) and LR schedules, and error-feedback top-k
gradient compression, on one card."""
from .adamw import (  # noqa: F401
    LeafPlan,
    OptConfig,
    apply_updates,
    build_plan,
    init_opt_state,
    lr_schedule,
    opt_state_from_numpy,
    opt_state_spec,
    sync_gradient,
)
