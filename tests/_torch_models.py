"""Shared helpers of the model scaffold's differential tests
(``test_torch_models.py``, ``test_torch_serve.py``,
``test_torch_recurrent.py``, ``test_torch_moe.py``,
``test_torch_frontends.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import PartitionSpec as JP

from repro.models.spec import tree_map_p
from repro_torch.models.spec import params_from_numpy


def draw_tree(spec, rng):
    """float32 numpy parameters for every leaf of a reference spec: norms
    near 1, biases small but non-zero, weights at their init scale."""
    def draw(p):
        if p.init == "ones":
            return (1 + 0.1 * rng.standard_normal(p.shape)).astype(np.float32)
        if p.init == "zeros":
            return (0.1 * rng.standard_normal(p.shape)).astype(np.float32)
        fan = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        scale = p.scale if p.scale is not None else 1 / np.sqrt(fan)
        return (scale * rng.standard_normal(p.shape)).astype(np.float32)

    return tree_map_p(draw, spec)


def on_mesh(jmesh, fn, *args):
    """Run ``fn(*args)`` jitted inside a 1x1 shard_map (every arg
    replicated); ``jmesh`` is (mesh, ctx)."""
    mesh, _ = jmesh
    body = jax.shard_map(fn, mesh=mesh, in_specs=tuple(JP() for _ in args),
                         out_specs=JP(), check_vma=False)
    return jax.jit(body)(*args)


def t(a, dtype=None):
    """numpy -> torch on the CPU (bfloat16 via its bit pattern)."""
    return params_from_numpy({"x": a}, "cpu", dtype)["x"]


def j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32), dtype)


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def leaves(tree, path=()):
    """(path, leaf) of every non-dict leaf of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, path + (k,))
        else:
            yield path + (k,), v
