"""Mesh helpers of the training step, which ``serve.engine`` shares.

The training step itself (``make_train_step``, the loss, the optimizer
state) is slice 2 of ROADMAP Queue A item 15.
"""
from __future__ import annotations

import numpy as np

from repro_torch.models.layers import MeshCtx


def mesh_ctx(mesh) -> MeshCtx:
    names = mesh.axis_names
    return MeshCtx(
        model_size=mesh.shape["model"],
        data_axes=tuple(a for a in names if a != "model"),
        data_size=mesh.shape.get("data", 1),
    )


def mesh_sizes(mesh) -> dict:
    return {a: mesh.shape[a] for a in mesh.axis_names}


def batch_axes(mesh, batch: int):
    """Mesh axes to shard the batch dim over ('pod'+'data' when divisible)."""
    dp = tuple(a for a in mesh.axis_names if a != "model")
    world = int(np.prod([mesh.shape[a] for a in dp]))
    if batch % world == 0:
        return dp
    if "data" in dp and batch % mesh.shape["data"] == 0:
        return ("data",)
    return None  # replicate
