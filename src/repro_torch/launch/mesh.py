"""Mesh records for the port, and the collectives over them.

The reference builds ``jax.sharding.Mesh`` objects over (pod, data, model)
axes and runs its step under ``shard_map``.  The port runs one process a
rank: ``make_local_mesh(data, model)`` returns this rank's record of a
(data, model) mesh over an initialised ``torch.distributed`` process group
of ``data · model`` ranks (``repro_torch.launch.ranks.run_ranks`` starts
them).  Coordinates are row-major over the axes — rank ``r`` of (data,
model) sits at ``(r // model, r % model)`` — the order of
``jax.make_mesh`` over the first devices, so the shards a rank holds are
the reference's.  A mesh of one rank needs no process group.

Meta meshes count without ranks: ``make_local_mesh(data, model,
device="meta", rank=r)`` is rank ``r``'s record of a (data, model) mesh
with no process group, and ``make_production_mesh(multi_pod=...)`` the
reference's production meshes, (data 16, model 16) or (pod 2, data 16,
model 16), whose 'pod' axis carries data parallelism only.  A 'pod' axis
exists on meta meshes only.  On a meta mesh a collective allocates its
result on ``meta`` and ledgers the call; a tensor on any other device
raises (no fallback).  The dry run (``launch.dryrun``) counts a cell on
rank 0 of such a mesh.

The record carries one process group an axis — ``"model"``: the ranks that
share this rank's data coordinate; ``"data"``: those that share its model
coordinate — and the collectives over any set of its axes
(``all_gather``, ``reduce_scatter``, ``all_reduce``, ``all_to_all``):
tiled along a dimension, as ``jax.lax.all_gather(..., tiled=True)``,
``psum_scatter(..., tiled=True)`` and ``all_to_all(..., tiled=True)``;
axes of size 1 are left out, and a collective over none is the identity.
Over several axes the ranks are ordered as the reference orders them,
row-major over the axes (``d · M + m``: the world group's own order).

The gloo backend takes every one of these collectives on CUDA tensors
(the card's torch 2.11, ``tools/multirank_probe.py``; gloo copies through
host memory itself), so ranks that share a card run them as they are.

``ledger`` counts, per collective, its calls, bytes in (``bytes``), bytes
of its results (``out_bytes``), host wall seconds, and the ring bytes a
participating rank moves (``ring_bytes``, ``roofline.hlo``'s formulas in
the reference: with S the result's bytes and N the group's ranks, an
all-reduce 2·S·(N−1)/N, an all-gather S·(N−1)/N, a reduce-scatter
S·(N−1), an all-to-all S·(N−1)/N), split by the link the group spans
(``ring_bytes_nvlink`` where every rank of the group lies in one node of
``NODE_CARDS`` cards, node = flat rank // 8, else ``ring_bytes_nic``).
``dispatch`` counts the MoE dispatches over the mesh (``models.ffn``):
calls, routed (token, slot) pairs and pairs dropped at capacity.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels.platform import resolve_device

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")      # the multi-pod production mesh's
NODE_CARDS = 8                           # cards a node, joined all to all by NVLink


def ring_bytes(op: str, result_bytes: int, n: int) -> float:
    """Bytes one participating rank moves for ``op`` over a ring of ``n``
    ranks with a result of ``result_bytes`` (``roofline.hlo._coll_bytes``
    in the reference)."""
    if n <= 1:
        return 0.0
    if op == "all_reduce":
        return 2.0 * result_bytes * (n - 1) / n
    if op == "reduce_scatter":
        return float(result_bytes) * (n - 1)
    if op in ("all_gather", "all_to_all"):
        return result_bytes * (n - 1) / n
    raise ValueError(f"no ring rule for {op!r}")


@dataclass(frozen=True)
class LocalMesh:
    axis_names: tuple
    shape: dict            # axis name -> size
    device: torch.device
    rank: int = 0
    coords: tuple = (0, 0)                 # this rank's coordinate on each axis
    groups: dict = field(default_factory=dict, repr=False, compare=False)
    backend: str | None = None             # None: no process group (one rank, or meta)
    ledger: dict = field(default_factory=dict, repr=False, compare=False)
    dispatch: dict = field(default_factory=dict, repr=False, compare=False)
    _links: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def world(self) -> int:
        return int(np.prod([self.shape[a] for a in self.axis_names]))

    @property
    def is_meta(self) -> bool:
        return self.device.type == "meta"

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        return self.coords[self.axis_names.index(axis)]

    def _axes(self, axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in axes and self.shape[a] > 1)

    def size(self, axes) -> int:
        return int(np.prod([self.shape[a] for a in self._axes(axes)]))

    def group_ranks(self, axes) -> list:
        """The flat ranks of this rank's group over ``axes``, in the group's
        order (row-major over the axes)."""
        live = self._axes(axes)
        idx = [range(self.shape[a]) if a in live else (c,)
               for a, c in zip(self.axis_names, self.coords)]
        sizes = [self.shape[a] for a in self.axis_names]
        return [int(np.ravel_multi_index(i, sizes)) for i in itertools.product(*idx)]

    def link(self, axes) -> str:
        """``"nvlink"`` where every rank of this rank's group over ``axes``
        lies in one node of ``NODE_CARDS`` cards, else ``"nic"``."""
        live = self._axes(axes)
        if live not in self._links:
            nodes = {r // NODE_CARDS for r in self.group_ranks(live)}
            self._links[live] = "nvlink" if len(nodes) == 1 else "nic"
        return self._links[live]

    def group(self, axes):
        """The process group over ``axes`` (those of size above 1), or None
        where there are none."""
        live = self._axes(axes)
        if not live:
            return None
        if self.is_meta:
            raise ValueError("a meta mesh has no process groups")
        return self.groups[live[0] if len(live) == 1 else "world"]

    def _run(self, name: str, fn, x: torch.Tensor, out_shape, axes) -> torch.Tensor:
        """``fn(out, x)`` into a new ``out`` of ``out_shape``, ledgered; on a
        meta mesh ``out`` is only allocated."""
        t0 = time.perf_counter()
        if self.is_meta and x.device.type != "meta":
            raise ValueError(f"a {name} on a meta mesh takes meta tensors, got one on "
                             f"{x.device}")
        out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
        if not self.is_meta:
            fn(out, x)
        out_bytes = out.numel() * out.element_size()
        ring = ring_bytes(name, out_bytes, self.size(axes))
        led = self.ledger.setdefault(name, {"calls": 0, "bytes": 0, "out_bytes": 0,
                                            "ring_bytes": 0.0, "ring_bytes_nvlink": 0.0,
                                            "ring_bytes_nic": 0.0, "seconds": 0.0})
        led["calls"] += 1
        led["bytes"] += x.numel() * x.element_size()
        led["out_bytes"] += out_bytes
        led["ring_bytes"] += ring
        led["ring_bytes_" + self.link(axes)] += ring
        led["seconds"] += time.perf_counter() - t0
        return out

    def all_gather(self, x: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
        """Concatenate every rank's ``x`` along ``dim``, in rank order over
        ``axes`` (``jax.lax.all_gather(x, axes, axis=dim, tiled=True)``)."""
        n = self.size(axes)
        if n == 1:
            return x
        xt = x.movedim(dim, 0).contiguous()
        out = self._run("all_gather", lambda o, i: _all_gather(o, i, self.group(axes)), xt,
                        (n * xt.shape[0],) + tuple(xt.shape[1:]), axes)
        return out.movedim(0, dim)

    def reduce_scatter(self, x: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
        """Sum ``x`` over ``axes`` and keep this rank's ``1/n`` block along
        ``dim`` (``jax.lax.psum_scatter(..., scatter_dimension=dim,
        tiled=True)``)."""
        n = self.size(axes)
        if n == 1:
            return x
        xt = x.movedim(dim, 0).contiguous()
        if xt.shape[0] % n:
            raise ValueError(f"reduce_scatter of {xt.shape[0]} rows over {n} ranks")
        out = self._run("reduce_scatter",
                        lambda o, i: _reduce_scatter(o, i, self.group(axes)), xt,
                        (xt.shape[0] // n,) + tuple(xt.shape[1:]), axes)
        return out.movedim(0, dim)

    def all_reduce(self, x: torch.Tensor, axes, op: str = "sum") -> torch.Tensor:
        """``x`` summed (or maxed, ``op="max"``) over ``axes``, a new tensor."""
        if self.size(axes) == 1:
            return x
        red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX

        def run(o, i):
            o.copy_(i)
            dist.all_reduce(o, op=red, group=self.group(axes))

        return self._run("all_reduce", run, x.contiguous(), tuple(x.shape), axes)

    def all_to_all(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Block ``j`` of ``x``'s dimension 0 goes to the ``j``-th rank over
        ``axes`` and this rank's block of every rank comes back in rank
        order (``jax.lax.all_to_all(x, axes, 0, 0, tiled=True)``).  Raises
        ``ValueError`` where the ranks do not divide dimension 0."""
        n = self.size(axes)
        if n == 1:
            return x
        if x.shape[0] % n:
            raise ValueError(f"all_to_all of {x.shape[0]} rows over {n} ranks")
        return self._run("all_to_all",
                         lambda o, i: dist.all_to_all_single(o, i, group=self.group(axes)),
                         x.contiguous(), tuple(x.shape), axes)


def _all_gather(out, inp, group) -> None:
    # torch >= 2.12 renames all_gather_into_tensor (it warns); the card's
    # torch 2.11 has the old name only
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, inp, group=group)


def _reduce_scatter(out, inp, group) -> None:
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    fn(out, inp, group=group)


def meta_mesh(shape: dict, rank: int = 0) -> LocalMesh:
    """Rank ``rank``'s record of a mesh of ``shape`` (axis -> size, in
    order) on the ``meta`` device: no process group; its collectives
    allocate their results and ledger the calls."""
    names = tuple(shape)
    if names not in (AXES, POD_AXES) or any(n < 1 for n in shape.values()):
        raise ValueError(f"a meta mesh over {shape}: axes {AXES} or {POD_AXES}")
    world = int(np.prod(list(shape.values())))
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} of a mesh of {world} ranks")
    coords = tuple(int(c) for c in np.unravel_index(rank, tuple(shape.values())))
    return LocalMesh(names, dict(shape), torch.device("meta"), rank=rank, coords=coords)


def make_local_mesh(data: int = 1, model: int = 1, device=None, rank: int = 0) -> LocalMesh:
    """This rank's (data, model) mesh.  ``device=None`` means the CUDA card
    (this rank's, ``cuda:(rank % device_count)``) and raises without one;
    ``device="cpu"`` runs the plain PyTorch path (the tests);
    ``device="meta"`` is rank ``rank``'s record of the mesh with no process
    group (``meta_mesh``), for counting.

    Otherwise a mesh of ``data · model > 1`` ranks needs an initialised
    process group of exactly that many ranks, and raises without one, and
    ``rank`` must be 0 (the process group says which rank this is).  Every
    rank must call this in the same order (it creates the axis groups)."""
    if data < 1 or model < 1:
        raise ValueError(f"a ({data}, {model}) mesh")
    names = AXES
    shape = {"data": data, "model": model}
    if device is not None and torch.device(device).type == "meta":
        return meta_mesh(shape, rank)
    if rank:
        raise ValueError(f"rank {rank} names a meta mesh's rank; a mesh of ranks takes "
                         "its rank from the process group")
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


def make_production_mesh(*, multi_pod: bool = False, rank: int = 0) -> LocalMesh:
    """Rank ``rank``'s meta record of the reference's production mesh
    (``repro.launch.mesh.make_production_mesh``): (data 16, model 16) =
    256 ranks, or with ``multi_pod`` (pod 2, data 16, model 16) = 512."""
    shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
             else {"data": 16, "model": 16})
    return meta_mesh(shape, rank)
