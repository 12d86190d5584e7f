"""Mesh records for the port, and the collectives over them.

The reference builds ``jax.sharding.Mesh`` objects over (pod, data, model)
axes and runs its step under ``shard_map``.  The port runs one process a
rank: ``make_local_mesh(data, model)`` returns this rank's record of a
(data, model) mesh over an initialised ``torch.distributed`` process group
of ``data · model`` ranks (``repro_torch.launch.ranks.run_ranks`` starts
them).  Rank ``r`` sits at ``(r // model, r % model)``: the order of
``jax.make_mesh((data, model), ...)`` over the first ``data · model``
devices, so the shards a rank holds are the reference's.  A mesh of one
rank needs no process group.

The record carries one process group an axis — ``"model"``: the ranks that
share this rank's data coordinate; ``"data"``: those that share its model
coordinate — and the collectives over any set of its axes
(``all_gather``, ``reduce_scatter``, ``all_reduce``, ``all_to_all``):
tiled along a dimension, as ``jax.lax.all_gather(..., tiled=True)``,
``psum_scatter(..., tiled=True)`` and ``all_to_all(..., tiled=True)``;
axes of size 1 are left out, and a collective over none is the identity.
Over several axes the ranks are ordered as the reference orders them,
``d · M + m``: the world group's own order.

The gloo backend takes every one of these collectives on CUDA tensors
(the card's torch 2.11, ``tools/multirank_probe.py``; gloo copies through
host memory itself), so ranks that share a card run them as they are.
``ledger`` counts each collective's calls, bytes in and host wall seconds;
``dispatch`` counts the MoE dispatches over the mesh (``models.ffn``): calls,
routed (token, slot) pairs and pairs dropped at capacity.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels.platform import resolve_device

AXES = ("data", "model")


@dataclass(frozen=True)
class LocalMesh:
    axis_names: tuple
    shape: dict            # axis name -> size
    device: torch.device
    rank: int = 0
    coords: tuple = (0, 0)                 # (data, model) of this rank
    groups: dict = field(default_factory=dict, repr=False, compare=False)
    backend: str | None = None             # None: one rank, no process group
    ledger: dict = field(default_factory=dict, repr=False, compare=False)
    dispatch: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def world(self) -> int:
        return int(np.prod([self.shape[a] for a in self.axis_names]))

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        return self.coords[self.axis_names.index(axis)]

    def _axes(self, axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in axes and self.shape[a] > 1)

    def size(self, axes) -> int:
        return int(np.prod([self.shape[a] for a in self._axes(axes)]))

    def group(self, axes):
        """The process group over ``axes`` (those of size above 1), or None
        where there are none."""
        live = self._axes(axes)
        if not live:
            return None
        return self.groups[live[0] if len(live) == 1 else "world"]

    def _run(self, name: str, fn, x: torch.Tensor, out_shape) -> torch.Tensor:
        """``fn(out, x)`` into a new ``out`` of ``out_shape``, ledgered."""
        t0 = time.perf_counter()
        out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
        fn(out, x)
        led = self.ledger.setdefault(name, {"calls": 0, "bytes": 0, "seconds": 0.0})
        led["calls"] += 1
        led["bytes"] += x.numel() * x.element_size()
        led["seconds"] += time.perf_counter() - t0
        return out

    def all_gather(self, x: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
        """Concatenate every rank's ``x`` along ``dim``, in rank order over
        ``axes`` (``jax.lax.all_gather(x, axes, axis=dim, tiled=True)``)."""
        g, n = self.group(axes), self.size(axes)
        if g is None:
            return x
        xt = x.movedim(dim, 0).contiguous()
        out = self._run("all_gather", lambda o, i: _all_gather(o, i, g), xt,
                        (n * xt.shape[0],) + tuple(xt.shape[1:]))
        return out.movedim(0, dim)

    def reduce_scatter(self, x: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
        """Sum ``x`` over ``axes`` and keep this rank's ``1/n`` block along
        ``dim`` (``jax.lax.psum_scatter(..., scatter_dimension=dim,
        tiled=True)``)."""
        g, n = self.group(axes), self.size(axes)
        if g is None:
            return x
        xt = x.movedim(dim, 0).contiguous()
        if xt.shape[0] % n:
            raise ValueError(f"reduce_scatter of {xt.shape[0]} rows over {n} ranks")
        out = self._run("reduce_scatter", lambda o, i: _reduce_scatter(o, i, g), xt,
                        (xt.shape[0] // n,) + tuple(xt.shape[1:]))
        return out.movedim(0, dim)

    def all_reduce(self, x: torch.Tensor, axes, op: str = "sum") -> torch.Tensor:
        """``x`` summed (or maxed, ``op="max"``) over ``axes``, a new tensor."""
        g = self.group(axes)
        if g is None:
            return x
        red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX

        def run(o, i):
            o.copy_(i)
            dist.all_reduce(o, op=red, group=g)

        return self._run("all_reduce", run, x.contiguous(), tuple(x.shape))

    def all_to_all(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Block ``j`` of ``x``'s dimension 0 goes to the ``j``-th rank over
        ``axes`` and this rank's block of every rank comes back in rank
        order (``jax.lax.all_to_all(x, axes, 0, 0, tiled=True)``).  Raises
        ``ValueError`` where the ranks do not divide dimension 0."""
        g, n = self.group(axes), self.size(axes)
        if g is None:
            return x
        if x.shape[0] % n:
            raise ValueError(f"all_to_all of {x.shape[0]} rows over {n} ranks")
        return self._run("all_to_all", lambda o, i: dist.all_to_all_single(o, i, group=g),
                         x.contiguous(), tuple(x.shape))


def _all_gather(out, inp, group) -> None:
    # torch >= 2.12 renames all_gather_into_tensor (it warns); the card's
    # torch 2.11 has the old name only
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, inp, group=group)


def _reduce_scatter(out, inp, group) -> None:
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    fn(out, inp, group=group)


def make_local_mesh(data: int = 1, model: int = 1, device=None) -> LocalMesh:
    """This rank's (data, model) mesh.  ``device=None`` means the CUDA card
    (this rank's, ``cuda:(rank % device_count)``) and raises without one;
    ``device="cpu"`` runs the plain PyTorch path (the tests).

    A mesh of ``data · model > 1`` ranks needs an initialised process group
    of exactly that many ranks, and raises without one.  Every rank must
    call this in the same order (it creates the axis groups)."""
    if data < 1 or model < 1:
        raise ValueError(f"a ({data}, {model}) mesh")
    names = AXES
    shape = {"data": data, "model": model}
    if data * model == 1:
        return LocalMesh(names, shape, resolve_device(device))
    if not dist.is_initialized() or dist.get_world_size() != data * model:
        have = dist.get_world_size() if dist.is_initialized() else "no"
        raise RuntimeError(
            f"a ({data}, {model}) mesh needs a process group of {data * model} ranks, "
            f"found {have} (start the ranks with repro_torch.launch.ranks.run_ranks)")
    rank = dist.get_rank()
    coords = (rank // model, rank % model)
    if device is None:
        device = torch.device("cuda", rank % max(1, torch.cuda.device_count()))
    dev = resolve_device(device)
    backend = dist.get_backend()
    # new_group is collective: every rank creates every group, in one order
    by_data = [dist.new_group([d * model + m for m in range(model)]) for d in range(data)]
    by_model = [dist.new_group([d * model + m for d in range(data)]) for m in range(model)]
    groups = {"model": by_data[coords[0]], "data": by_model[coords[1]],
              "world": dist.group.WORLD}
    return LocalMesh(names, shape, dev, rank=rank, coords=coords, groups=groups,
                     backend=backend)


def make_production_mesh(*, multi_pod: bool = False):
    raise NotImplementedError(
        "production meshes span many cards and a 'pod' axis: ROADMAP Queue A item 15 "
        "sub-item 6d (the dry run's multi-pod meshes)")
