"""AdamW (its per-leaf gradient sync and ZeRO-1 across ranks) and LR
schedules, and error-feedback top-k gradient compression."""
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
