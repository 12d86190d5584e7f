"""Training layer: the step factory (``make_train_step``) and state init,
and the mesh helpers the serving engine shares."""
from .step import (  # noqa: F401
    TrainBundle,
    batch_axes,
    batch_pspec_tree,
    batch_shapes,
    init_train_state,
    make_train_step,
    mesh_ctx,
    mesh_sizes,
)
