"""Tug-of-War set-difference cardinality estimator (paper §6, App. A).

d_hat = sum_i (Y_i(A) - Y_i(B))^2 / ell with ell independent ±1 hashes;
unbiased with Var = (2d^2 - 2d)/ell.  PBS then plans for d' = GAMMA * d_hat
so that Pr[d <= d'] >= 99% (paper: GAMMA = 1.38, ell = 128).

The ±1 family is the two-round murmur-finalizer mix the ToW Pallas kernel
uses (``kernels/tow_sketch.py``, mirror in ``kernels/ref.tow_sketch_ref``):
``sign_i(s) = 1 - 2 * (mix32(mix32(s, 0x5EED) ^ seed_i, 0x7077) & 1)``.
Host and device therefore produce bit-identical sketch vectors, which is
what lets ``repro_torch.recon`` route batched phase-0 estimation through the
kernel while staying byte-identical to this numpy oracle, and lets a
``repro_torch.net`` endpoint verify a sketch it received over the wire.  The
variance contract is validated empirically for this family in
tests/test_kernels.py and tests/test_tow_markov.py.

Byte accounting mirrors the wire codec exactly: ``sketch_bytes`` /
``dhat_bytes`` are the *framed* lengths of the ``repro_torch.wire`` phase-0
messages (varint header + bit-packed payload), asserted equal to
``len(encode_*(...))`` in tests/test_wire.py.
"""
from __future__ import annotations

import numpy as np

from .hashing import derive_seed, mix32

ELL_DEFAULT = 128
GAMMA = 1.38

# Fraction of |A| + |B| beyond which a planned d̂ leaves the PBS operating
# regime: at d approaching the total element count, partition-and-recover
# stops paying (bytes/diff crosses the ship-the-keys baseline) while a
# ±3σ estimator error is large in absolute terms, so an underestimate
# burns the whole round budget before degradation catches it.  The tree
# front end (repro_torch.tree) is the intended route for such pairs.
ESTIMATE_LIMIT_FRAC = 0.5


class EstimateOutOfRange(RuntimeError):
    """Planned d̂ exceeds the PBS operating regime for the pair's size.

    Raised on the *estimator* path only (``d_known`` submissions never
    raise — an operator pinning d explicitly has opted out).  Carries the
    numbers so callers can reroute the pair through the tree front end;
    ``classify_error`` maps it to ``error_kind="estimate"``.
    """

    def __init__(self, d_plan: int, total: int, limit_frac: float, sid=None):
        self.d_plan = int(d_plan)
        self.total = int(total)
        self.limit_frac = float(limit_frac)
        self.sid = sid
        at = f" (sid {sid})" if sid is not None else ""
        super().__init__(
            f"planned d̂ {self.d_plan} exceeds {limit_frac:g} of the pair's "
            f"{self.total} elements{at}: outside the PBS estimator regime — "
            f"route this pair through the tree front end (repro_torch.tree)"
        )


def check_estimate(
    d_plan: int,
    total_elems: int,
    limit_frac: float | None = ESTIMATE_LIMIT_FRAC,
    sid=None,
) -> None:
    """Raise ``EstimateOutOfRange`` when a planned d̂ is out of regime;
    ``limit_frac=None`` disables the guard (the legacy burn-the-budget
    behavior)."""
    if limit_frac is not None and d_plan > limit_frac * total_elems:
        raise EstimateOutOfRange(d_plan, total_elems, limit_frac, sid=sid)


def tow_seeds(seed: int, ell: int = ELL_DEFAULT) -> np.ndarray:
    """The per-sketch seed vector (stream 0xE57) — shared host/kernel."""
    return np.array(
        [derive_seed(seed, 0xE57, i) for i in range(ell)], dtype=np.uint32
    )


def tow_sketches(elems: np.ndarray, seed: int, ell: int = ELL_DEFAULT) -> np.ndarray:
    """ell ToW sketches of a set: Y_i = sum_{s in S} f_i(s), f_i: U -> {±1}.

    Vectorized numpy mirror of ``kernels.tow_sketch`` — same hash family,
    same seed derivation, bit-identical output.
    """
    elems = np.asarray(elems, dtype=np.uint32)
    seeds = tow_seeds(seed, ell)
    if len(elems) == 0:
        return np.zeros(ell, dtype=np.int64)
    h1 = mix32(elems, 0x5EED)[:, None]                  # (E, 1)
    h = mix32(h1 ^ seeds[None, :], 0x7077)              # (E, ell)
    signs = 1 - 2 * (h & np.uint32(1)).astype(np.int64)
    return signs.sum(axis=0)


def estimate_numerator(sk_a: np.ndarray, sk_b: np.ndarray) -> int:
    """Integer numerator sum_i (Y_i(A) - Y_i(B))^2 — exact, and what the
    d_hat reply frame carries on the wire (d_hat = numerator / ell)."""
    diff = np.asarray(sk_a, dtype=np.int64) - np.asarray(sk_b, dtype=np.int64)
    return int(np.sum(diff * diff))


def estimate_d(sk_a: np.ndarray, sk_b: np.ndarray) -> float:
    """Unbiased estimate of |A △ B| from the two sketch vectors."""
    return estimate_numerator(sk_a, sk_b) / len(np.asarray(sk_a).ravel())


def planned_d(d_hat: float, gamma: float = GAMMA) -> int:
    return max(1, int(np.ceil(gamma * d_hat)))


# ---------------------------------------------------------------------------
# Wire-frame sizes (numpy-pure mirror of repro_torch.wire; asserted in test_wire)
# ---------------------------------------------------------------------------


def _uvarint_len(v: int) -> int:
    n = 1
    v >>= 7
    while v:
        n += 1
        v >>= 7
    return n


def _framed_len(payload_len: int) -> int:
    # envelope: uvarint(1 + payload) + msg-type byte + payload
    return _uvarint_len(1 + payload_len) + 1 + payload_len


def sketch_value_bits(set_size: int) -> int:
    """Bits per sketch value: each Y_i is an int in [-|S|, |S|] (§6.1)."""
    return int(2 * set_size).bit_length()


def sketch_bytes(set_size: int, ell: int = ELL_DEFAULT) -> int:
    """Framed length of the A->B ToW sketch message (MSG_TOW_SKETCH)."""
    payload = (
        _uvarint_len(set_size)
        + _uvarint_len(ell)
        + (ell * sketch_value_bits(set_size) + 7) // 8
    )
    return _framed_len(payload)


def dhat_bytes(numerator: int) -> int:
    """Framed length of the B->A d_hat reply message (MSG_DHAT)."""
    return _framed_len(_uvarint_len(int(numerator)))
