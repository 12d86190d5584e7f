"""Training layer: the step factory (``make_train_step``) and state init,
one process a rank, the mesh helpers the serving engine shares, and the
state's one-rank layout (``layout``)."""
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
