"""Shared helper of ``test_torch_models.py`` and ``test_torch_serve.py``."""
import numpy as np

from repro.models.spec import tree_map_p


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
