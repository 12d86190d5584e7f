"""Parameter-spec system: one source of truth for shapes and init.

A model is described as a nested dict of `P` leaves.  From that single tree
we derive (a) materialized parameters drawn from a seed, (b) stand-ins on
the ``meta`` device (nothing allocated), and (c) parameters carried over
from the JAX package, key for key (`params_from_numpy`).

The logical sharding axes of each leaf ('model', 'data', None, or a tuple
of axes sharding one dimension, major first) are the reference's.  A
rank holds the slices its mesh coordinates pick (``dim_blocks``,
``shard_params``), as ``shard_map`` hands them to the reference's body;
``gather_params`` puts every rank's slices back together.  Both work on
any tree of `P` leaves: the parameters, and the optimizer state's tree
(``optim.opt_state_spec``, whose flat leaves are sharded over their
holders and, under ZeRO-1, over 'data').
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.kernels.platform import resolve_device


@dataclass(frozen=True)
class P:
    """A parameter leaf: shape + logical sharding + init law.

    `logical` (optional): the unpadded shape — init draws random values at
    this shape and zero-pads to `shape`, so the same seed yields the same
    model whatever the head padding."""

    shape: tuple
    axes: tuple            # logical axis per dim: 'model' | None
    init: str = "normal"   # normal | zeros | ones | scaled
    scale: float | None = None
    dtype: Any = torch.bfloat16
    logical: tuple | None = None


def tree_map_p(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map_p(fn, v) for k, v in tree.items()}
    assert isinstance(tree, P), type(tree)
    return fn(tree)


def tree_map(fn, tree):
    """Apply ``fn`` to every non-dict leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def abstract_params(tree):
    """Tensors on the ``meta`` device: shapes and dtypes, no memory."""
    return tree_map_p(lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"), tree)


# a normal leaf of more elements than this is drawn in slices of at most
# SLICE_ELEMS float32 values, each scaled in place and cast into the leaf:
# drawn whole, deepseek-v2's stacked expert leaf (7.55e9 elements at 6 MoE
# layers) would need two float32 copies, 60 GB
SLICE_ABOVE = 1 << 30
SLICE_ELEMS = 1 << 28


def init_params(tree, generator: torch.Generator, device=None):
    """Materialize parameters on ``device`` (``None``: the CUDA card, and
    raises without one; ``"cpu"`` when asked), drawn from ``generator``,
    which must live on that device.

    Each normal leaf is drawn in float32 at its `logical` shape, scaled by
    `scale` or 1/sqrt(fan_in), cast to its dtype and zero-padded to `shape`
    (the law of the reference's ``init_params``; the random stream is
    torch's, not JAX's).  A leaf above ``SLICE_ABOVE`` elements is drawn
    slice by slice in the same law."""
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"a generator on {generator.device} cannot draw parameters on "
                         f"{device}: pass torch.Generator(device={str(device)!r})")

    def build(p: P):
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=p.dtype, device=device)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=p.dtype, device=device)
        draw = p.logical or p.shape
        fan_in = draw[-2] if len(draw) >= 2 else draw[-1]
        scale = p.scale if p.scale is not None else 1.0 / np.sqrt(max(1, fan_in))
        if np.prod(draw) > SLICE_ABOVE:
            x = torch.empty(draw, dtype=p.dtype, device=device)
            flat = x.view(-1)
            for lo in range(0, flat.numel(), SLICE_ELEMS):
                part = torch.randn(min(SLICE_ELEMS, flat.numel() - lo), generator=generator,
                                   dtype=torch.float32, device=device)
                flat[lo:lo + part.numel()] = part.mul_(scale)
        else:
            x = torch.randn(draw, generator=generator, dtype=torch.float32, device=device)
            x = (x * scale).to(p.dtype)
        if p.logical is not None and p.logical != p.shape:
            pad = []
            for a, b in reversed(list(zip(p.shape, p.logical))):
                pad += [0, a - b]
            x = torch.nn.functional.pad(x, pad)
        return x

    return tree_map_p(build, tree)


def _leaf_from_numpy(arr, device: torch.device, dtype) -> torch.Tensor:
    arr = np.array(arr, order="C")          # a private, writable copy
    if arr.dtype.name == "bfloat16":        # ml_dtypes.bfloat16: no torch twin in numpy
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree_of_arrays, device, dtype=None):
    """The reference's parameters (nested dicts of numpy or JAX arrays) as
    the port's, key for key, on ``device`` — cast to ``dtype`` if given,
    else in each leaf's own dtype (bfloat16 leaves stay bfloat16)."""
    device = torch.device(device)
    return tree_map(lambda a: _leaf_from_numpy(a, device, dtype), tree_of_arrays)


def _dim_axes(ax) -> tuple:
    return () if ax is None else (ax if isinstance(ax, tuple) else (ax,))


def dim_blocks(shape, axes, sizes: dict, at: dict) -> tuple:
    """The slices of an array of ``shape`` held at mesh coordinates ``at``
    (axis -> index) of a mesh of ``sizes``: dimension ``i`` split over
    ``axes[i]`` — an axis, a tuple of axes (major first, as a
    ``PartitionSpec`` entry) or None.  Raises ``ValueError`` where a
    dimension does not split evenly."""
    out = []
    for dim, ax in zip(shape, axes):
        idx, n = 0, 1
        for a in _dim_axes(ax):
            idx, n = idx * sizes[a] + at.get(a, 0), n * sizes[a]
        if dim % n:
            raise ValueError(f"dimension {dim} of {tuple(shape)} does not split over {ax} ({n})")
        out.append(slice(idx * (dim // n), (idx + 1) * (dim // n)))
    return tuple(out)


def shard_params(tree_of_arrays, spec, mesh, dtype=None):
    """This rank's slices of global arrays (numpy, JAX or CPU tensors,
    shaped as ``spec``'s leaves) on ``mesh.device``, each in its own dtype
    or cast to ``dtype``."""
    at = dict(zip(mesh.axis_names, mesh.coords))

    def leaf(a, p: P):
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"array of shape {tuple(a.shape)} for a leaf of {p.shape}")
        part = a[dim_blocks(p.shape, p.axes, mesh.shape, at)]
        if isinstance(part, torch.Tensor):
            return part.to(device=mesh.device, dtype=dtype or part.dtype).contiguous()
        return _leaf_from_numpy(part, mesh.device, dtype)

    return _zip_spec(leaf, tree_of_arrays, spec)


def abstract_shards(tree, mesh):
    """This rank's shards of ``tree``'s leaves as tensors on the ``meta``
    device: the shapes ``shard_params`` would give, nothing allocated."""
    at = dict(zip(mesh.axis_names, mesh.coords))

    def leaf(p: P):
        blocks = dim_blocks(p.shape, p.axes, mesh.shape, at)
        return torch.empty(tuple(b.stop - b.start for b in blocks), dtype=p.dtype,
                           device="meta")

    return tree_map_p(leaf, tree)


def _zip_spec(fn, tree, spec):
    if isinstance(spec, dict):
        if not isinstance(tree, dict) or set(tree) != set(spec):
            raise ValueError(f"tree keys {sorted(tree) if isinstance(tree, dict) else tree!r} "
                             f"against spec keys {sorted(spec)}")
        return {k: _zip_spec(fn, tree[k], spec[k]) for k in spec}
    return fn(tree, spec)


def gather_params(tree, spec, mesh, *, everywhere: bool = False, axes=None):
    """Every rank's local leaves of ``spec`` put back into global tensors
    (on the CPU; on each rank's device with ``everywhere``): returned on
    rank 0, ``None`` on the others — on every rank with ``everywhere``.
    ``axes`` (default: all of the mesh's) are the axes gathered over; a
    leaf must be replicated over the others (``ValueError`` otherwise).
    Collective: every rank of the mesh calls it."""
    axes = mesh.axis_names if axes is None else tuple(axes)
    live = [a for a in mesh.axis_names if a in axes and mesh.shape[a] > 1]
    keep = everywhere or mesh.rank == 0
    members = []                                # each group member's coordinates
    for j in range(int(np.prod([mesh.shape[a] for a in live]))):
        at = dict(zip(mesh.axis_names, mesh.coords))
        at.update(zip(live, (int(c) for c in np.unravel_index(j, [mesh.shape[a]
                                                                  for a in live]))))
        members.append(at)

    def leaf(x, p: P):
        left = {a for ax in p.axes for a in _dim_axes(ax)} - set(live)
        if any(mesh.shape[a] > 1 for a in left):
            raise ValueError(f"a leaf sharded over {sorted(left)} gathered over {live}")
        if not live:
            return x.detach().clone() if everywhere else x.detach().cpu().clone()
        parts = mesh.all_gather(x.detach().contiguous().reshape(1, -1), live, 0)
        if not keep:
            return None
        if not everywhere:
            parts = parts.cpu()
        out = torch.empty(p.shape, dtype=x.dtype, device=parts.device)
        for part, at in zip(parts, members):
            out[dim_blocks(p.shape, p.axes, mesh.shape, at)] = part.reshape(x.shape)
        return out

    out = _zip_spec(leaf, tree, spec)
    return out if keep else None


def stack_layers(tree, n_layers: int):
    """Add a leading layer axis to every leaf (never sharded)."""
    return tree_map_p(
        lambda p: P(
            (n_layers,) + p.shape, (None,) + p.axes, p.init, p.scale, p.dtype,
            logical=((n_layers,) + p.logical) if p.logical is not None else None,
        ),
        tree,
    )


def count_params(tree) -> int:
    total = 0

    def add(p):
        nonlocal total
        total += int(np.prod(p.shape))
        return p

    tree_map_p(add, tree)
    return total
