"""Baselines the paper evaluates against (§7/§8): PinSketch, Difference
Digest (IBF), Graphene (BF + IBF), and PinSketch/WP (PinSketch + PBS's
hash-partitioning trick).

Scope notes (documented deviations — see EXPERIMENTS.md §Paper-validation):

* PinSketch root-finding: minisketch factors the locator polynomial with
  Berlekamp trace; we locate roots by evaluating the locator on Alice's
  candidate elements, which is exact in the paper's own experimental setup
  (B ⊂ A so A △ B ⊆ A) and has the same O(d²)-dominated decode scaling.
* Graphene: Protocol I (the B ⊂ A best case the paper grants it), with the
  BF/IBF split optimized numerically and the IBF-only fallback.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .gf2m import _POLY32_LOW, gf32_mul
from .hashing import derive_seed, hash_to_range, mix32
from .tow import ELL_DEFAULT

_POLY32_INT = (1 << 32) | int(_POLY32_LOW)

# ---------------------------------------------------------------------------
# PinSketch over GF(2^32)
# ---------------------------------------------------------------------------


def pinsketch_encode(elems: np.ndarray, t: int) -> np.ndarray:
    """Odd power-sum syndromes S_j = sum_{x in S} x^j, j = 1, 3, .., 2t-1."""
    x = np.asarray(elems, dtype=np.uint64)
    out = np.zeros(t, dtype=np.uint64)
    if len(x) == 0:
        return out
    cur = x.copy()          # x^1
    sq = gf32_mul(x, x)     # x^2
    for j in range(t):
        out[j] = np.bitwise_xor.reduce(cur)
        if j + 1 < t:
            cur = gf32_mul(cur, sq)  # x^(2j+1) -> x^(2j+3)
    return out


def _gf32_mul_scalar(a: int, b: int) -> int:
    """Scalar GF(2^32) multiply on Python ints (~100x the numpy bit-loop)."""
    r = 0
    a, b = int(a), int(b)
    while b:
        lsb = b & -b
        r ^= a << (lsb.bit_length() - 1)
        b ^= lsb
    for i in range(r.bit_length() - 1, 31, -1):  # reduce mod primitive poly
        if (r >> i) & 1:
            r ^= _POLY32_INT << (i - 32)
    return r


def _gf32_inv_scalar(a: int) -> int:
    """Inverse via extended Euclid over GF(2)[x] (O(32) int steps)."""
    if a == 0:
        raise ZeroDivisionError("gf32 inverse of 0")
    r0, r1 = _POLY32_INT, int(a)
    s0, s1 = 0, 1
    while r1 != 1:
        shift = r0.bit_length() - r1.bit_length()
        if shift < 0:
            r0, r1, s0, s1 = r1, r0, s1, s0
            continue
        r0 ^= r1 << shift
        s0 ^= s1 << shift
        if r0.bit_length() < r1.bit_length():
            r0, r1, s0, s1 = r1, r0, s1, s0
    for i in range(s1.bit_length() - 1, 31, -1):
        if (s1 >> i) & 1:
            s1 ^= _POLY32_INT << (i - 32)
    return s1


def pinsketch_decode(
    sketch_diff: np.ndarray, candidates: np.ndarray, t: int
) -> tuple[bool, np.ndarray]:
    """Locate the difference set from XORed sketches.

    O(t^2) Berlekamp–Massey over GF(2^32) followed by locator evaluation on
    the candidate elements (exact under the paper's B ⊂ A setup).
    """
    odd = np.asarray(sketch_diff, dtype=np.uint64)
    if not odd.any():
        return True, np.zeros(0, dtype=np.uint64)
    # Expand syndromes: S_{2k} = S_k^2.
    S = np.zeros(2 * t, dtype=np.uint64)
    S[0::2] = odd
    for k in range(1, t + 1):
        S[2 * k - 1] = gf32_mul(S[k - 1], S[k - 1])

    width = 2 * t + 1
    C = np.zeros(width, dtype=np.uint64)
    B = np.zeros(width, dtype=np.uint64)
    C[0] = B[0] = 1
    L, mshift, b = 0, 1, 1
    for i in range(2 * t):
        d = int(S[i])
        if L > 0:
            d ^= int(np.bitwise_xor.reduce(gf32_mul(C[1 : L + 1], S[i - L : i][::-1])))
        if d == 0:
            mshift += 1
        elif 2 * L <= i:
            T = C.copy()
            coef = _gf32_mul_scalar(d, _gf32_inv_scalar(b))
            C[mshift:] ^= gf32_mul(np.uint64(coef), B[: width - mshift])
            L, B, b, mshift = i + 1 - L, T, d, 1
        else:
            coef = _gf32_mul_scalar(d, _gf32_inv_scalar(b))
            C[mshift:] ^= gf32_mul(np.uint64(coef), B[: width - mshift])
            mshift += 1
    if L == 0 or L > t:
        return False, np.zeros(0, dtype=np.uint64)
    # Evaluate locator at x^{-1} for each candidate x: roots of
    # Lambda(z) are inverses of the difference elements.  Equivalently
    # evaluate sum_k Lambda_k x^{L-k} == 0 (multiply through by x^L).
    xs = np.asarray(candidates, dtype=np.uint64)
    acc = np.zeros_like(xs)
    for k in range(0, L + 1):
        acc = gf32_mul(acc, xs) ^ C[k]
    found = xs[acc == 0]
    found = np.unique(found)
    if len(found) != L:
        return False, np.zeros(0, dtype=np.uint64)
    return True, found


@dataclass
class BaselineResult:
    diff: set
    success: bool
    bytes_sent: int
    rounds: int = 1


def pinsketch_reconcile(a: np.ndarray, b: np.ndarray, t: int) -> BaselineResult:
    """One-shot PinSketch: Bob sends his t-syndrome sketch (t * 32 bits)."""
    sk_a = pinsketch_encode(a, t)
    sk_b = pinsketch_encode(b, t)
    ok, found = pinsketch_decode(sk_a ^ sk_b, a, t)
    bytes_sent = (t * 32 + 7) // 8
    return BaselineResult(
        diff=set(int(x) for x in found), success=ok, bytes_sent=bytes_sent
    )


def pinsketch_wp_reconcile(
    a: np.ndarray, b: np.ndarray, d_plan: int, t: int, delta: float = 5.0, seed: int = 0,
    max_rounds: int = 3,
) -> BaselineResult:
    """PinSketch/WP (§8.3): hash-partition into g groups, PinSketch each pair.

    Uses the same delta and t as PBS; per-group sketch costs t * 32 bits
    (no parity bitmap, so positions cost log|U| not log n — the 3-4x safety
    margin penalty the paper highlights).  Groups whose decode fails retry
    with a fresh hash next round (checksum-gated like PBS).
    """
    g = max(1, round(d_plan / delta))
    total_bits = 0
    diff: set[int] = set()
    a_work = np.asarray(a, dtype=np.uint32)
    b_arr = np.asarray(b, dtype=np.uint32)
    pending = list(range(g))
    rounds = 0
    for rnd in range(1, max_rounds + 1):
        if not pending:
            break
        rounds = rnd
        seed_g = derive_seed(seed, 0x9A, rnd)
        ga = hash_to_range(a_work, g, seed_g)
        gb = hash_to_range(b_arr, g, seed_g)
        nxt = []
        for gi in pending:
            mem_a = a_work[ga == gi]
            mem_b = b_arr[gb == gi]
            sk = pinsketch_encode(mem_a, t) ^ pinsketch_encode(mem_b, t)
            total_bits += t * 32 + 32  # sketch + checksum
            ok, found = pinsketch_decode(sk, mem_a, t)
            if not ok:
                nxt.append(gi)
                continue
            diff.update(int(x) for x in found)
        # every group re-hashes next round; simple and conservative
        pending = nxt
    td = set(int(x) for x in a_work) ^ set(int(x) for x in b_arr)
    return BaselineResult(
        diff=diff, success=diff == td, bytes_sent=(total_bits + 7) // 8, rounds=rounds
    )


# ---------------------------------------------------------------------------
# Invertible Bloom Filter + Difference Digest
# ---------------------------------------------------------------------------


class IBF:
    """idSum/hashSum/count cells with k-hash insertion and peeling."""

    def __init__(self, cells: int, k: int, seed: int):
        self.cells = cells
        self.k = k
        self.seed = seed
        self.id_sum = np.zeros(cells, dtype=np.uint32)
        self.hash_sum = np.zeros(cells, dtype=np.uint32)
        self.count = np.zeros(cells, dtype=np.int64)

    def _cells_of(self, x: np.ndarray) -> np.ndarray:
        # k distinct hash functions -> (len(x), k) cell indices
        return np.stack(
            [hash_to_range(x, self.cells, derive_seed(self.seed, 0x1BF, j)) for j in range(self.k)],
            axis=1,
        )

    def insert_all(self, xs: np.ndarray, sign: int = 1):
        xs = np.asarray(xs, dtype=np.uint32)
        if len(xs) == 0:
            return
        idx = self._cells_of(xs)  # (N, k)
        hv = mix32(xs, derive_seed(self.seed, 0xC4EC))
        for j in range(self.k):
            np.bitwise_xor.at(self.id_sum, idx[:, j], xs)
            np.bitwise_xor.at(self.hash_sum, idx[:, j], hv)
            np.add.at(self.count, idx[:, j], sign)

    def subtract(self, other: "IBF") -> "IBF":
        out = IBF(self.cells, self.k, self.seed)
        out.id_sum = self.id_sum ^ other.id_sum
        out.hash_sum = self.hash_sum ^ other.hash_sum
        out.count = self.count - other.count
        return out

    def peel(self) -> tuple[bool, set]:
        """Recover the encoded difference by iterative peeling."""
        recovered: set[int] = set()
        check_seed = derive_seed(self.seed, 0xC4EC)
        for _ in range(self.cells * 4):
            pure = np.nonzero(
                (np.abs(self.count) == 1)
                & (self.hash_sum == mix32(self.id_sum, check_seed))
                & (self.id_sum != 0)
            )[0]
            if len(pure) == 0:
                break
            ci = int(pure[0])
            x = np.uint32(self.id_sum[ci])
            sgn = int(self.count[ci])
            xa = np.array([x], dtype=np.uint32)
            idx = self._cells_of(xa)[0]
            hv = mix32(xa, check_seed)[0]
            for j in range(self.k):
                self.id_sum[idx[j]] ^= x
                self.hash_sum[idx[j]] ^= hv
                self.count[idx[j]] -= sgn
            recovered.add(int(x))
        ok = not self.count.any() and not self.id_sum.any()
        return ok, recovered

    @property
    def bytes(self) -> int:
        # 3 words of log|U| = 32 bits per cell (paper's 6d log|U| accounting).
        return self.cells * 12


def ddigest_reconcile(
    a: np.ndarray, b: np.ndarray, d_plan: int, seed: int = 0
) -> BaselineResult:
    """Difference Digest: IBF with 2*d_hat cells (k = 3 if d_hat > 200 else 4)."""
    cells = max(8, 2 * d_plan)
    k = 3 if d_plan > 200 else 4
    ibf_a = IBF(cells, k, seed)
    ibf_a.insert_all(a)
    ibf_b = IBF(cells, k, seed)
    ibf_b.insert_all(b)
    ok, rec = ibf_a.subtract(ibf_b).peel()
    td = set(int(x) for x in np.asarray(a).ravel()) ^ set(int(x) for x in np.asarray(b).ravel())
    return BaselineResult(diff=rec, success=ok and rec == td, bytes_sent=ibf_b.bytes)


# ---------------------------------------------------------------------------
# Graphene (Protocol I, B ⊂ A)
# ---------------------------------------------------------------------------


class BloomFilter:
    def __init__(self, nbits: int, k: int, seed: int):
        self.nbits = max(8, nbits)
        self.k = max(1, k)
        self.seed = seed
        self.bits = np.zeros(self.nbits, dtype=bool)

    def add_all(self, xs: np.ndarray):
        xs = np.asarray(xs, dtype=np.uint32)
        for j in range(self.k):
            self.bits[hash_to_range(xs, self.nbits, derive_seed(self.seed, 0xBF, j))] = True

    def query_all(self, xs: np.ndarray) -> np.ndarray:
        xs = np.asarray(xs, dtype=np.uint32)
        hit = np.ones(len(xs), dtype=bool)
        for j in range(self.k):
            hit &= self.bits[hash_to_range(xs, self.nbits, derive_seed(self.seed, 0xBF, j))]
        return hit

    @property
    def bytes(self) -> int:
        return (self.nbits + 7) // 8


def graphene_plan(size_b: int, size_a: int, d_plan: int):
    """Optimize (BF fpr, IBF cells) for protocol I; IBF-only fallback.

    total(fpr) = 1.44 log2(1/fpr) |B| bits + 12 bytes * cells, with
    cells = tau * (fpr * (|A| - |B| candidates...) + slack).  Numeric sweep.
    """
    best = None
    a_minus_b = max(size_a - (size_a - d_plan), d_plan)  # |A\B| approx d
    for log2_inv in range(1, 21):
        fpr = 2.0 ** (-log2_inv)
        bf_bits = 1.44 * log2_inv * (size_a - d_plan)  # BF sized on |B|
        exp_missing = fpr * a_minus_b
        cells = int(np.ceil(1.5 * exp_missing + 12))
        total = bf_bits / 8 + cells * 12
        if best is None or total < best[0]:
            best = (total, fpr, cells, False)
    # IBF-only fallback (degenerate Graphene)
    cells_only = int(np.ceil(1.5 * d_plan + 12))
    if cells_only * 12 < best[0]:
        best = (cells_only * 12, 1.0, cells_only, True)
    return best  # (bytes, fpr, cells, ibf_only)


def graphene_reconcile(
    a: np.ndarray, b: np.ndarray, d_plan: int, seed: int = 0
) -> BaselineResult:
    """Graphene protocol I: Bob sends BF(B) + IBF(B); Alice learns A \\ B."""
    a = np.asarray(a, dtype=np.uint32)
    b = np.asarray(b, dtype=np.uint32)
    total, fpr, cells, ibf_only = graphene_plan(len(b), len(a), d_plan)
    bytes_sent = 0
    if ibf_only:
        candidates = a
    else:
        k = max(1, int(round(np.log2(1.0 / fpr))))
        bf = BloomFilter(int(np.ceil(1.44 * np.log2(1.0 / fpr) * len(b))), k, seed)
        bf.add_all(b)
        bytes_sent += bf.bytes
        hit = bf.query_all(a)
        candidates = a[hit]  # contains all of B plus fp survivors of A\B
        # definite misses are immediately known to be in A\B
    ibf_b = IBF(cells, 4 if d_plan <= 200 else 3, derive_seed(seed, 0x6F))
    ibf_b.insert_all(b)
    bytes_sent += ibf_b.bytes
    ibf_cand = IBF(cells, 4 if d_plan <= 200 else 3, derive_seed(seed, 0x6F))
    ibf_cand.insert_all(candidates)
    ok, rec = ibf_cand.subtract(ibf_b).peel()
    diff = set(int(x) for x in a[~bf.query_all(a)]) if not ibf_only else set()
    diff |= rec
    td = set(int(x) for x in a) ^ set(int(x) for x in b)
    return BaselineResult(diff=diff, success=ok and diff == td, bytes_sent=bytes_sent)
