"""BCH syndrome sketches (the "parity bitmap sketch" codec).

Exactly the minisketch/PinSketch coding the paper adopts (§2.5, App. I):
the sketch of an n-bit parity bitmap is its **t odd syndromes**
``S_1, S_3, ..., S_{2t-1}`` over GF(2^m), n = 2^m − 1 — t·m bits total.
Because syndromes are GF(2)-linear in the bitmap, Bob decodes by XORing
Alice's sketch with his own and locating the ≤ t set bits of the *difference*
bitmap via Berlekamp–Massey + Chien search.

``decode`` is the numpy reference; ``kernels/`` provides the MXU formulation
(syndromes & Chien as dense GF(2) matmuls) validated against this oracle.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from .gf2m import GF2m, get_field


@dataclass(frozen=True)
class BCHCode:
    n: int  # bitmap length, 2^m - 1
    t: int  # error-correction capacity

    @property
    def m(self) -> int:
        return (self.n + 1).bit_length() - 1

    @property
    def field(self) -> GF2m:
        return get_field(self.m)

    @property
    def sketch_bits(self) -> int:
        return self.t * self.m


@functools.lru_cache(maxsize=None)
def bch_code(n: int, t: int) -> BCHCode:
    """Memoized ``BCHCode`` lookup for the hot per-round paths.

    ``BCHCode`` itself is a cheap frozen dataclass, but routing every cohort
    encode/decode through one cached instance per (n, t) also keeps the
    field singleton (``get_field``) and its memoized syndrome/Chien matrices
    warm, so round planning never re-derives GF tables.
    """
    return BCHCode(n, t)


def sketch_from_positions(code: BCHCode, positions: np.ndarray) -> np.ndarray:
    """Odd syndromes S_{2j+1} = XOR_i alpha^(pos_i * (2j+1)), j = 0..t-1.

    ``positions`` are the indices of set bits in the parity bitmap — i.e. the
    bins with odd cardinality.  Empty -> all-zero sketch.
    """
    gf = code.field
    syn = np.zeros(code.t, dtype=np.int64)
    if len(positions):
        pos = np.asarray(positions, dtype=np.int64)[:, None]
        j = np.arange(code.t, dtype=np.int64)[None, :]
        vals = gf.pow_alpha(pos * (2 * j + 1))  # (npos, t)
        syn = np.bitwise_xor.reduce(vals, axis=0)
    return syn


def sketch_xor(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Sketches are linear: sketch(A) ^ sketch(B) == sketch(A xor B)."""
    return np.bitwise_xor(a, b)


def sketch_increment(code: BCHCode, positions: np.ndarray, t0: int) -> np.ndarray:
    """The incremental odd syndromes S_{2*t0+1} .. S_{2t-1} of a bitmap.

    Prefix compatibility (the rateless invariant, DESIGN.md §16): for any
    t0 < t over the same field,

        concat(sketch at t0, sketch_increment(t0)) == sketch at t

    because syndrome j never depends on the sketch capacity it ships in.
    ``MSG_PARITY`` frames carry exactly these columns.
    """
    gf = code.field
    if not 0 <= t0 <= code.t:
        raise ValueError(f"increment base t0={t0} out of range for t={code.t}")
    syn = np.zeros(code.t - t0, dtype=np.int64)
    if len(positions):
        pos = np.asarray(positions, dtype=np.int64)[:, None]
        j = np.arange(t0, code.t, dtype=np.int64)[None, :]
        vals = gf.pow_alpha(pos * (2 * j + 1))
        syn = np.bitwise_xor.reduce(vals, axis=0)
    return syn


def decode_extended(n: int, prefix: np.ndarray, increment: np.ndarray):
    """Decode a difference bitmap from a cached sketch prefix plus the
    incremental syndromes a ``MSG_PARITY`` extension delivered.

    Concatenation *is* the fresh (n, t') sketch — no re-derivation, no
    re-sent bits — so this is byte-identical to ``decode_sketch`` over a
    sketch encoded at t' from scratch (property-tested in
    tests/test_rateless.py).  Returns (ok, positions).
    """
    prefix = np.asarray(prefix, dtype=np.int64)
    increment = np.asarray(increment, dtype=np.int64)
    t2 = len(prefix) + len(increment)
    return decode_sketch(bch_code(n, t2), np.concatenate([prefix, increment]))


def _expand_syndromes(code: BCHCode, odd_syn: np.ndarray) -> np.ndarray:
    """Full S_1..S_2t from odd syndromes via S_{2k} = S_k^2 (char-2 Frobenius)."""
    gf = code.field
    full = np.zeros(2 * code.t + 1, dtype=np.int64)  # full[j] = S_j, index 0 unused
    full[1::2] = odd_syn
    for k in range(1, code.t + 1):
        full[2 * k] = int(gf.mul(full[k], full[k]))
    return full[1:]


def berlekamp_massey(code: BCHCode, syndromes: np.ndarray) -> np.ndarray:
    """Error-locator polynomial Lambda(x) from S_1..S_2t.

    Same O(t^2) class as the Levinson solver the paper uses; chosen for its
    fixed 2t-iteration structure (vmap/fori-friendly on TPU — DESIGN.md §3).
    Returns coefficients [Lambda_0=1, Lambda_1, ..., Lambda_L].
    """
    gf = code.field
    S = np.asarray(syndromes, dtype=np.int64)
    C = np.zeros(2 * code.t + 1, dtype=np.int64)
    B = np.zeros(2 * code.t + 1, dtype=np.int64)
    C[0] = B[0] = 1
    L, mshift, b = 0, 1, 1
    for i in range(2 * code.t):
        # discrepancy d = S_i + sum_{j=1..L} C_j * S_{i-j}
        d = int(S[i])
        for j in range(1, L + 1):
            d ^= int(gf.mul(C[j], S[i - j]))
        if d == 0:
            mshift += 1
        elif 2 * L <= i:
            T = C.copy()
            coef = int(gf.div(d, b))
            mult = gf.mul(coef, B)
            C[mshift:] = C[mshift:] ^ mult[: len(C) - mshift]
            L = i + 1 - L
            B = T
            b = d
            mshift = 1
        else:
            coef = int(gf.div(d, b))
            mult = gf.mul(coef, B)
            C[mshift:] = C[mshift:] ^ mult[: len(C) - mshift]
            mshift += 1
    return C[: L + 1], L


def chien_search(code: BCHCode, locator: np.ndarray) -> np.ndarray:
    """All i in [0, n) with Lambda(alpha^{-i}) == 0 — the error bit positions."""
    gf = code.field
    i = np.arange(code.n, dtype=np.int64)
    xs = gf.pow_alpha((-i) % code.n)
    vals = gf.poly_eval([int(c) for c in locator], xs)
    return np.nonzero(vals == 0)[0]


def batched_decode(code: BCHCode, sketches: np.ndarray):
    """Decode U difference sketches simultaneously (vectorized across units).

    This is the TPU-shaped formulation (DESIGN.md §3): Berlekamp–Massey has a
    fixed 2t-iteration structure, so all group pairs advance in lockstep with
    masked state updates — the numpy mirror of the vmap'd JAX/Pallas path.

    Returns (ok: (U,) bool, positions: list of U int arrays).
    """
    gf = code.field
    t = code.t
    sk = np.asarray(sketches, dtype=np.int64)
    U = sk.shape[0]
    if U == 0:
        return np.zeros(0, dtype=bool), []

    # Expand odd syndromes to S_1..S_2t via Frobenius squaring.
    S = np.zeros((U, 2 * t), dtype=np.int64)
    S[:, 0::2] = sk
    for k in range(1, t + 1):
        S[:, 2 * k - 1] = gf.mul(S[:, k - 1], S[:, k - 1])

    # ---- batched Berlekamp–Massey --------------------------------------
    width = 2 * t + 1
    C = np.zeros((U, width), dtype=np.int64)
    B = np.zeros((U, width), dtype=np.int64)
    C[:, 0] = B[:, 0] = 1
    L = np.zeros(U, dtype=np.int64)
    b = np.ones(U, dtype=np.int64)
    mshift = np.ones(U, dtype=np.int64)
    cols = np.arange(width)

    for i in range(2 * t):
        # discrepancy d_u = S[u,i] ^ XOR_j C[u,j] * S[u,i-j], j = 1..L_u
        d = S[:, i].copy()
        for j in range(1, i + 1):
            term = gf.mul(C[:, j], S[:, i - j])
            d ^= np.where(L >= j, term, 0)
        nz = d != 0
        grow = nz & (2 * L <= i)
        stay = nz & ~grow

        coef = np.where(nz, gf.mul(d, gf.inv(np.where(b == 0, 1, b))), 0)
        idx = cols[None, :] - mshift[:, None]
        Bsh = np.where(idx >= 0, np.take_along_axis(B, np.clip(idx, 0, width - 1), 1), 0)
        Cnew = C ^ gf.mul(coef[:, None], Bsh)

        B = np.where(grow[:, None], C, B)
        C = np.where(nz[:, None], Cnew, C)
        bnew = np.where(grow, d, b)
        L = np.where(grow, i + 1 - L, L)
        mshift = np.where(grow, 1, np.where(stay, mshift + 1, mshift + 1))
        b = bnew

    # ---- batched Chien search -------------------------------------------
    # vals[u, i] = Lambda_u(alpha^{-i}); roots mark error positions.
    ii = np.arange(code.n, dtype=np.int64)
    ok = np.ones(U, dtype=bool)
    positions: list[np.ndarray] = [None] * U  # type: ignore[list-item]
    zero_sketch = ~sk.any(axis=1)
    # evaluate in chunks to bound memory: (U, chunk, t+1)
    root_count = np.zeros(U, dtype=np.int64)
    roots_buf: list[list[np.ndarray]] = [[] for _ in range(U)]
    chunk = max(1, int(4e6 // max(1, U)))
    Lam = C[:, : t + 1]
    for s0 in range(0, code.n, chunk):
        xs = gf.pow_alpha((-ii[s0 : s0 + chunk]) % code.n)  # (c,)
        acc = np.zeros((U, len(xs)), dtype=np.int64)
        for k in range(t, -1, -1):
            acc = gf.mul(acc, xs[None, :]) ^ Lam[:, k : k + 1]
        zu, zi = np.nonzero(acc == 0)
        root_count += np.bincount(zu, minlength=U)
        for u, i0 in zip(zu, zi + s0):
            roots_buf[u].append(i0)

    for u in range(U):
        pos = np.array(sorted(roots_buf[u]), dtype=np.int64)
        if zero_sketch[u]:
            ok[u] = True
            positions[u] = np.zeros(0, dtype=np.int64)
            continue
        if L[u] == 0 or L[u] > t or len(pos) != L[u]:
            ok[u] = False
            positions[u] = np.zeros(0, dtype=np.int64)
            continue
        if np.any(sketch_from_positions(code, pos) != sk[u]):
            ok[u] = False
            positions[u] = np.zeros(0, dtype=np.int64)
            continue
        positions[u] = pos
    return ok, positions


def decode_sketch(code: BCHCode, diff_sketch: np.ndarray):
    """Locate the set bits of the difference bitmap from its odd syndromes.

    Returns (ok, positions).  ok=False signals a BCH decoding failure — more
    than t bits actually differ (PBS handles this with the 3-way group split,
    paper §3.2).  Failure detection: locator degree != number of roots found,
    or inconsistent syndromes.
    """
    odd = np.asarray(diff_sketch, dtype=np.int64)
    if not odd.any():
        return True, np.zeros(0, dtype=np.int64)
    full = _expand_syndromes(code, odd)
    locator, L = berlekamp_massey(code, full)
    if L == 0 or L > code.t:
        return False, np.zeros(0, dtype=np.int64)
    positions = chien_search(code, locator)
    if len(positions) != L:
        return False, np.zeros(0, dtype=np.int64)
    # Consistency: recomputing the sketch from the found positions must match.
    if np.any(sketch_from_positions(code, positions) != odd):
        return False, np.zeros(0, dtype=np.int64)
    return True, positions
