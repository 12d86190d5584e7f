"""Mesh records for the port.

The reference builds ``jax.sharding.Mesh`` objects over (pod, data, model)
axes.  The port runs on one card so far: ``make_local_mesh`` returns a
record with the reference mesh's ``axis_names`` and ``shape`` and the
``torch.device`` everything of the model lives on.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels.platform import resolve_device


@dataclass(frozen=True)
class LocalMesh:
    axis_names: tuple
    shape: dict            # axis name -> size
    device: torch.device


def make_local_mesh(data: int = 1, model: int = 1, device=None) -> LocalMesh:
    """A (data, model) mesh of one device.  ``device=None`` means the CUDA
    card and raises without one; ``device="cpu"`` runs the plain PyTorch
    path (the tests)."""
    if data * model != 1:
        raise NotImplementedError(
            f"a ({data}, {model}) mesh: the port runs on one card until the multi-card "
            "slice of ROADMAP Queue A item 15")
    return LocalMesh(("data", "model"), {"data": data, "model": model},
                     resolve_device(device))


def make_production_mesh(*, multi_pod: bool = False):
    raise NotImplementedError(
        "production meshes span many cards: a later slice of ROADMAP Queue A item 15")
