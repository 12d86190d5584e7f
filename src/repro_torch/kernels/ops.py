"""Wrappers tying the kernels to PBS protocol semantics.

* ``encode_group``       — parity bitmap + bin XOR folds + BCH sketch for one
                           set: ``bin_parity_xorsum`` + ``sketch_groups``.
* ``encode_groups``      — batched encode over U packed units with ragged
                           element counts (padded rows + valid masks) and
                           per-unit bin seeds: ``bin_parity_xorsum_units`` +
                           ``sketch_groups``.  The multi-session engine's
                           fused executor (DESIGN.md §5) composes the same
                           two pieces over both sides at once.
* ``sketch_groups`` / ``sketch_groups_range`` — BCH sketches (or the
                           rateless increment, DESIGN.md §16) of G parity
                           bitmaps (packed words or 0/1 rows) as one packed
                           GF(2) matmul.
* ``bch_decode_batched`` — lock-step batched Berlekamp–Massey + Chien search
                           over all group pairs at once (fixed 2t trips, no
                           data-dependent control; DESIGN.md §3).  Plain
                           tensor ops on the tensors' device.
* ``tow_estimate``       — ToW sketches via the tow_sketch kernel.
* ``chien_eval_matmul``  — whole-field locator evaluation as one GF(2)
                           matmul against the Chien matrix.

Constant tables (syndrome matrices, GF log/exp tables) are built on the
host once per code and cached on the device per ``(code, device)``; the
GF(2) matrices are cached packed per column (``kernels.gf2_matmul``'s
layout), packed with numpy at first use, so no call re-packs them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.bch import BCHCode, bch_code
from .bin_xorsum import bin_parity_xorsum, bin_parity_xorsum_units
from .gf2_matmul import gf2_matmul_packed, pack_bits, pack_bits_np, packed_words
from .platform import note_variant
from .tow_sketch import tow_sketch

_TABLES: dict = {}


def _cached(key, device, build) -> torch.Tensor:
    """Device-resident constant, built on the host on first use."""
    k = (key, str(device))
    t = _TABLES.get(k)
    if t is None:
        t = _TABLES[k] = torch.from_numpy(np.ascontiguousarray(build())).to(device)
    return t


def _cached_packed(key, device, build) -> torch.Tensor:
    """A constant (K, N) GF(2) matrix, packed per column on the host at first
    use and cached on the device as ``(N, ceil(K/32))`` int32 words."""
    return _cached(("packed",) + key, device, lambda: pack_bits_np(np.asarray(build()).T))


def _packed_rows(bitmaps: torch.Tensor, k: int) -> torch.Tensor:
    """Rows of ``k`` GF(2) entries in the packed layout: ``(G, ceil(k/32))``
    words pass through, ``(G, k)`` 0/1 rows are packed first."""
    if bitmaps.shape[-1] == k:
        return pack_bits(bitmaps.to(torch.int32).contiguous())
    if bitmaps.shape[-1] == packed_words(k):
        return bitmaps
    raise ValueError(f"rows of width {bitmaps.shape[-1]} hold neither {k} bits "
                     f"nor {packed_words(k)} words")


def _xor_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """XOR fold along ``dim`` (log-depth halving; torch has no xor reduce)."""
    x = x.movedim(dim, -1)
    while x.shape[-1] > 1:
        k = x.shape[-1]
        h = k // 2
        lo = x[..., :h] ^ x[..., h : 2 * h]
        x = torch.cat([lo, x[..., 2 * h :]], dim=-1) if k % 2 else lo
    if x.shape[-1] == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    return x[..., 0]


def pack_bits_to_field(bits: torch.Tensor, m: int) -> torch.Tensor:
    """(..., t*m) 0/1 -> (..., t) int32 field elements (LSB-first)."""
    t = bits.shape[-1] // m
    b = bits.reshape(bits.shape[:-1] + (t, m)).to(torch.int32)
    shifts = torch.arange(m, dtype=torch.int32, device=bits.device)
    return torch.sum(b << shifts, dim=-1, dtype=torch.int32)


def sketch_groups(bitmaps: torch.Tensor, code: BCHCode) -> torch.Tensor:
    """BCH sketches for G parity bitmaps at once: one GF(2) matmul.

    ``bitmaps``: (G, ceil(n/32)) packed parity words (the engine's, straight
    from ``bin_parity_xorsum_units_packed``) or (G, n) 0/1 int32 rows, which
    are packed first.  Returns (G, t) int32 field elements."""
    P = _cached_packed(
        ("syndrome", code.n, 0, code.t), bitmaps.device,
        lambda: code.field.syndrome_matrix(code.t),
    )
    bits = gf2_matmul_packed(_packed_rows(bitmaps, code.n), P, code.n)
    return pack_bits_to_field(bits, code.m)


def sketch_groups_range(bitmaps: torch.Tensor, code: BCHCode, t0: int) -> torch.Tensor:
    """Incremental BCH syndromes S_{2*t0+1}..S_{2t-1} for G parity bitmaps
    (packed words or 0/1 rows, as ``sketch_groups`` takes them).

    The same one-matmul formulation as ``sketch_groups`` against the
    ``[t0*m, t*m)`` column slice of the syndrome matrix — the prefix
    property (``core.gf2m.syndrome_matrix_range``) guarantees
    ``concat(sketch at t0, this) == sketch at t`` bit for bit, which is
    what rateless recovery ships (DESIGN.md §16).
    """
    P = _cached_packed(
        ("syndrome", code.n, t0, code.t), bitmaps.device,
        lambda: code.field.syndrome_matrix_range(t0, code.t),
    )
    bits = gf2_matmul_packed(_packed_rows(bitmaps, code.n), P, code.n)
    return pack_bits_to_field(bits, code.m)


def encode_group(elems: torch.Tensor, code: BCHCode, seed: int):
    """Full PBS encode of one group: (parity bitmap (n,) int32, bin XOR sums
    (n,) int32 bit patterns, sketch (t,) int32)."""
    parity, xors = bin_parity_xorsum(elems, n_bins=code.n, seed=seed)
    return parity, xors, sketch_groups(parity[None, :], code)[0]


def encode_groups(
    elems: torch.Tensor, valid: torch.Tensor, seeds: torch.Tensor, code: BCHCode
):
    """Batched PBS encode of U packed units with ragged element counts.

    ``elems``/``valid``: (U, E) padded rows (false ``valid`` marks padding);
    ``seeds``: (U,) per-unit bin seeds.  One bin_xorsum launch bins every
    unit's elements with the protocol's multiply-shift hash, then one GF(2)
    matmul sketches all parity bitmaps (DESIGN.md §5).

    Returns (parity (U, n) int32, xors (U, n) int32 bit patterns,
    sketches (U, t) int32).
    """
    parity, xors = bin_parity_xorsum_units(elems, valid, seeds, n_bins=code.n)
    return parity, xors, sketch_groups(parity, code)


def tow_estimate(elems_a: torch.Tensor, elems_b: torch.Tensor, seeds: torch.Tensor):
    ya = tow_sketch(elems_a, seeds, ell=seeds.shape[0])
    yb = tow_sketch(elems_b, seeds, ell=seeds.shape[0])
    diff = (ya - yb).to(torch.float32)
    return torch.mean(diff * diff)


# ---------------------------------------------------------------------------
# Batched BCH decode in plain tensor ops
# ---------------------------------------------------------------------------


def bch_decode_batched(sketches: torch.Tensor, *, n: int, t: int):
    """Decode U difference sketches -> (ok (U,) bool, positions (U, t) int32,
    count (U,) int32).

    positions rows are padded with -1 beyond ``count``.  ok=False marks BCH
    overload (paper §3.2 -> 3-way split).  GF ops run on log/exp tables;
    BM is a fixed 2t-trip loop of masked updates (no data-dependent
    control), so all U rows advance in lock step.
    """
    U = sketches.shape[0]
    note_variant("bch_decode_batched", (n, t, U))
    dev = sketches.device
    gf = bch_code(n, t).field
    exp_t = _cached(("exp", n), dev, lambda: gf.exp.astype(np.int64))       # (2n,)
    log_t = _cached(
        ("log", n), dev, lambda: np.where(gf.log < 0, 0, gf.log).astype(np.int64)
    )

    def gmul(a, b):
        prod = exp_t[torch.remainder(log_t[a] + log_t[b], n)]
        return torch.where((a == 0) | (b == 0), 0, prod)

    def ginv(a):
        return exp_t[torch.remainder(n - log_t[a], n)]

    sk = sketches.to(torch.int64)

    # S_1..S_2t with S_2k = S_k^2
    S = torch.zeros((U, 2 * t), dtype=torch.int64, device=dev)
    S[:, 0::2] = sk
    for k in range(1, t + 1):
        S[:, 2 * k - 1] = gmul(S[:, k - 1], S[:, k - 1])

    W = 2 * t + 1
    cols = torch.arange(W, device=dev)
    j = torch.arange(1, W, device=dev)
    C = torch.zeros((U, W), dtype=torch.int64, device=dev)
    C[:, 0] = 1
    B = C.clone()
    L = torch.zeros(U, dtype=torch.int64, device=dev)
    b = torch.ones(U, dtype=torch.int64, device=dev)
    mshift = torch.ones(U, dtype=torch.int64, device=dev)
    for i in range(2 * t):
        s_idx = torch.clamp(i - j, 0, 2 * t - 1)
        gath = S[:, s_idx]                                   # (U, W-1)
        mask = (j[None, :] <= i) & (j[None, :] <= L[:, None])
        d = S[:, i] ^ _xor_reduce(torch.where(mask, gmul(C[:, 1:], gath), 0), 1)

        nz = d != 0
        grow = nz & (2 * L <= i)
        coef = torch.where(nz, gmul(d, ginv(torch.where(b == 0, 1, b))), 0)
        idx = cols[None, :] - mshift[:, None]
        Bsh = torch.where(
            idx >= 0, torch.gather(B, 1, torch.clamp(idx, 0, W - 1)), 0
        )
        Cnew = C ^ gmul(coef[:, None].expand_as(Bsh), Bsh)

        B = torch.where(grow[:, None], C, B)
        C = torch.where(nz[:, None], Cnew, C)
        b = torch.where(grow, d, b)
        L_next = torch.where(grow, i + 1 - L, L)
        mshift = torch.where(grow, 1, mshift + 1)
        L = L_next

    # Chien search: evaluate Lambda at alpha^{-i} for all i (Horner, t+1 steps)
    ii = torch.arange(n, device=dev)
    xs = exp_t[torch.remainder(-ii, n)]                      # (n,)
    acc = torch.zeros((U, n), dtype=torch.int64, device=dev)
    for k in range(t, -1, -1):
        acc = gmul(acc, xs[None, :].expand(U, n)) ^ C[:, k : k + 1]
    is_root = acc == 0                                       # (U, n)
    count = is_root.sum(dim=1)

    # gather root positions (sort on the sentinel key n+1), padded with -1
    key = torch.where(is_root, ii[None, :], n + 1)
    pos = torch.sort(key, dim=1).values[:, :t]
    pos = torch.where(torch.arange(t, device=dev)[None, :] < count[:, None], pos, -1)

    # verify: recompute odd syndromes from found roots
    jj = torch.arange(t, device=dev)
    powers = torch.remainder(
        torch.clamp(pos, min=0)[:, :, None] * (2 * jj + 1)[None, None, :], n
    )
    vals = torch.where((pos >= 0)[:, :, None], exp_t[powers], 0)  # (U, t, t)
    recomputed = _xor_reduce(vals, 1)                             # (U, t)

    zero_sk = ~torch.any(sk != 0, dim=1)
    ok = (
        (L > 0) & (L <= t) & (count == L) & torch.all(recomputed == sk, dim=1)
    ) | zero_sk
    # failed or empty rows expose no positions (matches core.bch semantics)
    expose = ok & ~zero_sk
    count = torch.where(expose, count, 0)
    pos = torch.where(expose[:, None], pos, -1)
    return ok, pos.to(torch.int32), count.to(torch.int32)


def chien_eval_matmul(locator_bits: torch.Tensor, code: BCHCode) -> torch.Tensor:
    """Whole-field locator evaluation as one GF(2) matmul.

    locator_bits: (U, (t+1)*m) 0/1 -> eval bits (U, n, m) int32; rows of
    zeros are roots.
    """
    k = locator_bits.shape[1]
    C = _cached_packed(
        ("chien", code.n, code.t), locator_bits.device,
        lambda: code.field.chien_matrix(code.t),
    )
    ev = gf2_matmul_packed(_packed_rows(locator_bits, k), C, k)
    return ev.reshape(ev.shape[0], code.n, code.m)
