"""GF(2^m) arithmetic for BCH sketches.

Two representations are used throughout:

* **integer form** — a field element is an int in ``[0, 2^m)`` whose bits are the
  polynomial coefficients.  Fast scalar/numpy ops via log/antilog tables
  (only for small m ≤ 14, the PBS regime where n = 2^m − 1 ≤ 16383).
* **bit-vector form** — an element is a length-m 0/1 vector.  Multiplication by a
  *constant* c is then a binary m×m matrix ``mult_matrix(c)`` over GF(2), which is
  what lets syndrome computation / Chien search become dense MXU matmuls
  (see kernels/gf2_matmul.py and DESIGN.md §3).

For the PinSketch baseline we also need GF(2^32), which is too large for tables;
``clmul_reduce`` implements vectorized carry-less multiplication + reduction.
"""
from __future__ import annotations

import functools

import numpy as np

# Primitive polynomials (including the x^m term), indexed by m.
PRIMITIVE_POLY = {
    3: 0b1011,
    4: 0b10011,
    5: 0b100101,
    6: 0b1000011,
    7: 0b10001001,
    8: 0b100011101,
    9: 0b1000010001,
    10: 0b10000001001,
    11: 0b100000000101,
    12: 0b1000001010011,
    13: 0b10000000011011,
    14: 0b100010001000011,
    # x^32 + x^22 + x^2 + x + 1 — maximal-length LFSR taps, primitive.
    32: (1 << 32) | (1 << 22) | (1 << 2) | (1 << 1) | 1,
}


class GF2m:
    """Log/antilog-table field GF(2^m) for m ≤ 14."""

    def __init__(self, m: int):
        if m not in PRIMITIVE_POLY or m > 14:
            raise ValueError(f"unsupported field GF(2^{m})")
        self.m = m
        self.n = (1 << m) - 1  # multiplicative group order == BCH length
        self.poly = PRIMITIVE_POLY[m]
        # exp table of length 2n so that exp[(a+b)] needs no mod.
        exp = np.zeros(2 * self.n, dtype=np.int64)
        log = np.zeros(self.n + 1, dtype=np.int64)
        x = 1
        for i in range(self.n):
            exp[i] = x
            log[x] = i
            x <<= 1
            if x & (1 << m):
                x ^= self.poly
        if x != 1:  # primitive polynomial sanity: alpha^n == 1
            raise AssertionError("polynomial is not primitive")
        exp[self.n:] = exp[: self.n]
        log[0] = -1  # log of 0 is undefined; sentinel
        self.exp = exp
        self.log = log

    # ---- scalar/numpy ops (arrays of integer-form elements) ------------
    def mul(self, a, b):
        a = np.asarray(a, dtype=np.int64)
        b = np.asarray(b, dtype=np.int64)
        out = self.exp[(self.log[a] + self.log[b]) % self.n]
        return np.where((a == 0) | (b == 0), 0, out)

    def inv(self, a):
        a = np.asarray(a, dtype=np.int64)
        if np.any(a == 0):
            raise ZeroDivisionError("inverse of 0 in GF(2^m)")
        return self.exp[(self.n - self.log[a]) % self.n]

    def div(self, a, b):
        return self.mul(a, self.inv(b))

    def pow_alpha(self, e):
        """alpha**e for integer exponents (vectorized)."""
        e = np.asarray(e, dtype=np.int64) % self.n
        return self.exp[e]

    def square(self, a):
        return self.mul(a, a)

    def poly_eval(self, coeffs, xs):
        """Evaluate sum_k coeffs[k] * xs**k (coeffs[0] is the constant term)."""
        xs = np.asarray(xs, dtype=np.int64)
        acc = np.zeros_like(xs)
        for c in reversed(coeffs):
            acc = self.mul(acc, xs) ^ int(c)
        return acc

    # ---- bit-vector form helpers (for the GF(2)-matmul kernel path) ----
    def to_bits(self, a) -> np.ndarray:
        """Integer form -> (..., m) 0/1 int32 bit vectors (LSB first)."""
        a = np.asarray(a, dtype=np.int64)
        shifts = np.arange(self.m, dtype=np.int64)
        return ((a[..., None] >> shifts) & 1).astype(np.int32)

    def from_bits(self, bits: np.ndarray) -> np.ndarray:
        bits = np.asarray(bits, dtype=np.int64)
        shifts = np.arange(self.m, dtype=np.int64)
        return (bits << shifts).sum(axis=-1)

    def mult_matrix(self, c: int) -> np.ndarray:
        """m x m binary matrix M with bits(c*x) = bits(x) @ M (mod 2)."""
        rows = [self.to_bits(self.mul(1 << k, c)) for k in range(self.m)]
        return np.stack(rows, axis=0).astype(np.int32)

    @functools.lru_cache(maxsize=None)
    def syndrome_matrix(self, t: int) -> np.ndarray:
        """(n, t*m) binary matrix P mapping a parity bitmap to its t odd syndromes.

        P[i, j*m:(j+1)*m] = bits(alpha^(i*(2j+1))).  A bitmap's sketch is
        (bitmap @ P) mod 2 — one dense GF(2) matmul (MXU-friendly).
        Memoized per (field, t): fields are singletons via ``get_field``, so
        repeated cohort encodes reuse one table instead of re-deriving it.
        """
        i = np.arange(self.n, dtype=np.int64)[:, None]
        j = np.arange(t, dtype=np.int64)[None, :]
        powers = self.pow_alpha(i * (2 * j + 1))  # (n, t) integer elements
        return self.to_bits(powers).reshape(self.n, t * self.m)

    @functools.lru_cache(maxsize=None)
    def syndrome_matrix_range(self, t0: int, t1: int) -> np.ndarray:
        """(n, (t1-t0)*m) column slice of ``syndrome_matrix``: syndromes
        S_{2*t0+1} .. S_{2*t1-1} only.

        Because ``syndrome_matrix(t)[:, j*m:(j+1)*m]`` depends only on j —
        never on t — the (n, t) sketch is a strict prefix of the (n, t')
        sketch for any t' > t, and
        ``hstack(syndrome_matrix(t0), syndrome_matrix_range(t0, t1)) ==
        syndrome_matrix(t1)`` exactly.  This is what lets the rateless
        recovery path (DESIGN.md §16) ship only the *incremental* syndromes
        on BCH overload and decode at t1 against the cached prefix.
        """
        if not 0 <= t0 <= t1:
            raise ValueError(f"bad syndrome range [{t0}, {t1})")
        i = np.arange(self.n, dtype=np.int64)[:, None]
        j = np.arange(t0, t1, dtype=np.int64)[None, :]
        powers = self.pow_alpha(i * (2 * j + 1))
        return self.to_bits(powers).reshape(self.n, (t1 - t0) * self.m)

    @functools.lru_cache(maxsize=None)
    def chien_matrix(self, t: int) -> np.ndarray:
        """((t+1)*m, n*m) binary matrix C for whole-field polynomial evaluation.

        With L = concat(bits(Lambda_0..Lambda_t)) (length (t+1)m),
        (L @ C) mod 2 reshaped to (n, m) gives bits(Lambda(alpha^{-i})) for
        all i — the decode convention, so all-zero rows are error positions.
        """
        out = np.zeros(((t + 1) * self.m, self.n * self.m), dtype=np.int32)
        i = np.arange(self.n, dtype=np.int64)
        for k in range(t + 1):
            consts = self.pow_alpha(-i * k)  # alpha^(-i*k) for all i
            for b in range(self.m):
                basis = 1 << b  # bits(Lambda_k)[b] contributes basis * const
                prod = self.mul(basis, consts)  # (n,)
                out[k * self.m + b] = self.to_bits(prod).reshape(-1)
        return out


@functools.lru_cache(maxsize=None)
def get_field(m: int) -> GF2m:
    return GF2m(m)


# --------------------------------------------------------------------------
# GF(2^32) via carry-less multiplication (vectorized numpy, no tables).
# --------------------------------------------------------------------------
_POLY32_LOW = np.uint64(PRIMITIVE_POLY[32] & 0xFFFFFFFF)  # reduction taps below x^32


def clmul32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Carry-less 32x32 -> 64 bit multiply, vectorized (uint64 arrays)."""
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    acc = np.zeros(np.broadcast(a, b).shape, dtype=np.uint64)
    ones = np.uint64(0xFFFFFFFFFFFFFFFF)
    for k in range(32):
        mask = ((b >> np.uint64(k)) & np.uint64(1)) * ones  # all-ones where bit set
        acc ^= (a << np.uint64(k)) & mask
    return acc


def gf32_reduce(x: np.ndarray) -> np.ndarray:
    """Reduce a 64-bit carry-less product modulo the GF(2^32) primitive poly.

    The x^22 tap means each fold can reintroduce high bits; four passes are
    enough to clear them (54 -> 44 -> 34 -> 24 bit bound).
    """
    x = np.asarray(x, dtype=np.uint64)
    for _ in range(4):
        hi = x >> np.uint64(32)
        x = (x & np.uint64(0xFFFFFFFF)) ^ clmul32(hi, _POLY32_LOW)
    return x


def gf32_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return gf32_reduce(clmul32(a, b))


def gf32_pow(a: np.ndarray, e: int) -> np.ndarray:
    """a**e in GF(2^32) by square-and-multiply (vectorized over a)."""
    a = np.asarray(a, dtype=np.uint64)
    result = np.ones_like(a)
    base = a
    while e:
        if e & 1:
            result = gf32_mul(result, base)
        base = gf32_mul(base, base)
        e >>= 1
    return result


def gf32_inv(a: np.ndarray) -> np.ndarray:
    # a^(2^32 - 2) == a^-1 for a != 0.
    return gf32_pow(a, (1 << 32) - 2)
