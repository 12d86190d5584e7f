"""Training layer: the mesh helpers the serving engine shares (the training
step itself is slice 2 of ROADMAP Queue A item 15)."""
from .step import batch_axes, mesh_ctx, mesh_sizes  # noqa: F401
