"""Pure-numpy oracles for every kernel (the exact-equality ground truth)."""
from __future__ import annotations

import numpy as np


def gf2_matmul_ref(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Exact GF(2) product via int64 matmul then mod 2."""
    return (np.asarray(a, dtype=np.int64) @ np.asarray(b, dtype=np.int64)) % 2


def mix32_ref(x: np.ndarray, seed: int) -> np.ndarray:
    x = np.asarray(x, dtype=np.uint32).copy()
    x += np.uint32((int(seed) * 0x9E3779B9) & 0xFFFFFFFF)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2AE35)
    x ^= x >> np.uint32(16)
    return x


def bin_parity_xorsum_ref(elems: np.ndarray, n_bins: int, seed: int):
    """Sequential-scatter oracle for the bin_xorsum kernel (same mod-n hash)."""
    e = np.asarray(elems, dtype=np.uint32)
    bins = (mix32_ref(e, seed) % np.uint32(n_bins)).astype(np.int64)
    counts = np.zeros(n_bins, dtype=np.int64)
    np.add.at(counts, bins, 1)
    xors = np.zeros(n_bins, dtype=np.uint32)
    np.bitwise_xor.at(xors, bins, e)
    parity = (counts & 1).astype(np.int32)
    xor_bits = ((xors[:, None] >> np.arange(32, dtype=np.uint32)) & 1).astype(np.int32)
    return parity, xor_bits, xors


def bin_parity_xorsum_units_ref(elems, valid, seeds, n_bins: int):
    """Sequential-scatter oracle for the batched units kernel.

    Bins with the protocol's multiply-shift hash ``(mix32(e) * n) >> 32``
    (``core.hashing.hash_to_range``), evaluated in uint64 as ground truth for
    the kernel's 16-bit-split formulation.
    """
    e = np.asarray(elems, dtype=np.uint32)
    v = np.asarray(valid) != 0
    U, _ = e.shape
    parity = np.zeros((U, n_bins), dtype=np.int32)
    xors = np.zeros((U, n_bins), dtype=np.uint32)
    for u in range(U):
        vals = e[u][v[u]]
        h = mix32_ref(vals, int(seeds[u]))
        bins = ((h.astype(np.uint64) * np.uint64(n_bins)) >> np.uint64(32)).astype(np.int64)
        counts = np.zeros(n_bins, dtype=np.int64)
        np.add.at(counts, bins, 1)
        np.bitwise_xor.at(xors[u], bins, vals)
        parity[u] = (counts & 1).astype(np.int32)
    return parity, xors


def tow_sketch_ref(elems: np.ndarray, seeds: np.ndarray) -> np.ndarray:
    """Oracle for the ToW kernel's two-round mix family."""
    e = np.asarray(elems, dtype=np.uint32)
    h1 = mix32_ref(e, 0x5EED)[:, None]
    h = mix32_ref(h1 ^ np.asarray(seeds, dtype=np.uint32)[None, :], 0x7077)
    signs = 1 - 2 * (h & np.uint32(1)).astype(np.int64)
    return signs.sum(axis=0).astype(np.int32)
