"""Hash families for PBS.

The paper uses xxHash; on TPU we use the murmur3/splitmix finalizer family
(multiply-xorshift), which vectorizes to pure 32-bit VPU ops (DESIGN.md §3).
Every protocol round r and purpose (grouping / binning / checksum / ToW) draws
an independent function via distinct derived seeds.
"""
from __future__ import annotations

import numpy as np

_GOLDEN = np.uint32(0x9E3779B9)
_C1 = np.uint32(0x85EBCA6B)
_C2 = np.uint32(0xC2B2AE35)

# Mersenne prime for the 4-wise independent polynomial hash (ToW).
MERSENNE_P = (1 << 31) - 1


def mix32(x: np.ndarray, seed: int) -> np.ndarray:
    """murmur3 fmix32 with additive seeding; vectorized uint32 -> uint32."""
    x = np.asarray(x, dtype=np.uint32).copy()
    x += np.uint32((int(seed) * 0x9E3779B9) & 0xFFFFFFFF)
    x ^= x >> np.uint32(16)
    x *= _C1
    x ^= x >> np.uint32(13)
    x *= _C2
    x ^= x >> np.uint32(16)
    return x


def derive_seed(master: int, *streams: int) -> int:
    """Derive an independent child seed from (master, stream ids)."""
    s = np.uint32(master)
    for st in streams:
        s = mix32(np.uint32(st), int(s))
    return int(s)


def mix32_seeded(x: np.ndarray, seeds: np.ndarray) -> np.ndarray:
    """``mix32`` with a *per-element* seed array (same wrap-around uint32
    arithmetic, so element i equals ``mix32(x[i], int(seeds[i]))`` exactly).

    This is what lets the batched planner (DESIGN.md §12) evaluate S
    sessions' independently-seeded hash functions in one numpy pass instead
    of S scalar calls."""
    x = np.asarray(x, dtype=np.uint32) + np.asarray(seeds, dtype=np.uint32) * _GOLDEN
    x ^= x >> np.uint32(16)
    x *= _C1
    x ^= x >> np.uint32(13)
    x *= _C2
    x ^= x >> np.uint32(16)
    return x


def derive_seed_seeded(masters: np.ndarray, *stream_cols: np.ndarray) -> np.ndarray:
    """Vectorized ``derive_seed``: chain ``mix32_seeded`` over per-element
    stream columns.  ``derive_seed_seeded(m, s1, s2)[i] ==
    derive_seed(int(m[i]), int(s1[i]), int(s2[i]))`` by construction."""
    s = np.asarray(masters, dtype=np.uint32)
    for col in stream_cols:
        s = mix32_seeded(np.asarray(col, dtype=np.uint32), s)
    return s


def hash_to_range_seeded(
    x: np.ndarray, sizes: np.ndarray, seeds: np.ndarray
) -> np.ndarray:
    """Vectorized ``hash_to_range`` with per-element range sizes and seeds:
    the multiply-shift reduction ``(mix32(x, seed) * size) >> 32`` element
    by element — exact match of the scalar form for every element."""
    h = mix32_seeded(x, seeds)
    return (
        (h.astype(np.uint64) * np.asarray(sizes, dtype=np.uint64)) >> np.uint64(32)
    ).astype(np.int64)


def hash_to_range(x: np.ndarray, size: int, seed: int) -> np.ndarray:
    """Uniform hash of uint32 keys into [0, size) (size need not be a power of 2)."""
    h = mix32(x, seed)
    # multiply-shift style range reduction: (h * size) >> 32, bias-free enough
    # for our sizes and avoids the slight mod bias.
    return ((h.astype(np.uint64) * np.uint64(size)) >> np.uint64(32)).astype(np.int64)


def hash_to_pm1(x: np.ndarray, seed: int) -> np.ndarray:
    """2-universal ±1 hash (not used by ToW — see poly4_pm1)."""
    return 1 - 2 * (mix32(x, seed) & np.uint32(1)).astype(np.int64)


def poly4_coeffs(seed: int) -> np.ndarray:
    """Four coefficients in [1, p) for the 4-wise independent polynomial hash."""
    c = mix32(np.arange(4, dtype=np.uint32), seed).astype(np.uint64) % np.uint64(MERSENNE_P)
    return np.maximum(c, np.uint64(1))


def poly4_pm1(x: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    """4-wise independent hash U -> {+1, -1} via degree-3 polynomial mod p.

    All arithmetic stays in uint64: operands are < 2^31 so products fit.
    """
    x = np.asarray(x, dtype=np.uint64) % np.uint64(MERSENNE_P)
    acc = np.zeros_like(x)
    for c in coeffs:  # Horner
        acc = (acc * x + np.uint64(c)) % np.uint64(MERSENNE_P)
    return 1 - 2 * (acc & np.uint64(1)).astype(np.int64)
