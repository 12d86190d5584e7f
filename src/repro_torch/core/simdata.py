"""Synthetic set pairs for experiments, built the way the paper builds them
(§8 Experiment Setup): A drawn uniformly without replacement from a 32-bit
universe (0 excluded), B = A minus d random elements, so |A △ B| = d and
B ⊂ A — the same best-case-for-Graphene setup the paper uses.
"""
from __future__ import annotations

import numpy as np

from .sets import unique_keys


def random_set(size: int, rng: np.random.Generator) -> np.ndarray:
    """`size` distinct uniform uint32 keys, 0 excluded."""
    out = np.zeros(0, dtype=np.uint32)
    while len(out) < size:
        need = int((size - len(out)) * 1.1) + 16
        cand = rng.integers(1, 1 << 32, size=need, dtype=np.uint64).astype(np.uint32)
        out = unique_keys(np.concatenate([out, cand]))
    rng.shuffle(out)
    return out[:size]


def make_pair(size_a: int, d: int, rng: np.random.Generator):
    """(A, B) with |A| = size_a, B ⊂ A, |A △ B| = d."""
    a = random_set(size_a, rng)
    b = rng.permutation(a)[: size_a - d]
    return a, b


def make_pair_two_sided(size_a: int, d_a_only: int, d_b_only: int, rng: np.random.Generator):
    """General case: both A\\B and B\\A non-empty."""
    base = random_set(size_a + d_b_only, rng)
    a = base[: size_a]
    b = np.concatenate([a[: size_a - d_a_only], base[size_a :]])
    rng.shuffle(b)
    return a, b
