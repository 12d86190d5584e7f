"""The fused round executor: one cohort's round as one device call sequence.

Per call (DESIGN.md §5 round dataflow), for all U packed units at once:

1. **on-device row build** — gather each unit's element row from the
   cohort's resident store (uploaded once per run), derive the valid mask
   from the store counts, apply Alice's diff overlay (drop removed = A ∩ D̂
   by value match, append added = D̂ \\ A columns), and mask both sides by
   the unit's 3-way-split filter chain with the same multiply-shift hash
   the protocol uses on the host;
2. **fused two-side encode** — Alice's and Bob's built rows stack into ONE
   ``bin_parity_xorsum_units_packed`` launch and ONE GF(2) sketch matmul
   (half the kernel launches of encoding each side separately), the parity
   bitmaps passed between the two bit-packed, 32 bins to a word; the
   per-unit wrap-around checksums are folded into the same pass;
3. the sketch XOR feeds ``bch_decode_batched`` — the lock-step fixed-trip
   Berlekamp–Massey + Chien search (DESIGN.md §3) — locating each unit's
   differing bins (``ok`` False = BCH overload → the host re-queues the
   unit's 3-way split).

Everything runs eagerly on the device of the store tensors, enqueued on the
current stream without synchronising; the caller reads results back when it
needs them.  Shape polymorphism is confined to (U, Wa, Wb, R, X, F), all
bucketed to powers of two by the planner; every entry point ledgers its
(static args, shapes) key with ``note_variant`` so a serving loop can assert
that a warm run meets no new variant.

Keys, seeds, XOR folds and checksums are int32 bit patterns of the
protocol's uint32 values (see ``kernels.bin_xorsum``).

``encode_side`` is the single-side half of the same pass — one endpoint's
row build + bin/sketch/checksum without the other side or the decode.
"""
from __future__ import annotations

import torch

from ..core.bch import bch_code
from ..kernels.bin_xorsum import (
    as_u32,
    bin_parity_xorsum_units_packed,
    mix32,
    mulshift_bins,
    to_i32,
)
from ..kernels.ops import bch_decode_batched, sketch_groups, sketch_groups_range
from ..kernels.platform import note_variant
from ..obs.trace import NULL_TRACER

# Opt-in profiler hook (DESIGN.md §14): install a Tracer built with
# torch_profiler=True and every executor dispatch window is annotated inside
# a ``torch.profiler.profile`` capture.  The default NULL_TRACER hands back a
# shared no-op context, so the un-opted path costs one with-statement.
_DISPATCH_TRACER = NULL_TRACER


def set_dispatch_tracer(tracer) -> None:
    """Install (or, with None, remove) the tracer whose ``annotate`` wraps
    every ``execute_round``/``encode_side`` dispatch."""
    global _DISPATCH_TRACER
    _DISPATCH_TRACER = tracer if tracer is not None else NULL_TRACER


def _note(name: str, static: tuple, *tensors) -> None:
    """Ledger this dispatch's variant key (DESIGN.md §12): the static
    arguments plus every tensor argument's shape."""
    note_variant(name, static + tuple(tuple(t.shape) for t in tensors))


def _wrap_csum(elems: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-unit checksum c(S) = sum mod 2^32.  The int64 sum of at most 2^20
    values below 2^32 cannot overflow, so masking it is exact."""
    vals = torch.where(valid, as_u32(elems), 0)
    return to_i32(torch.sum(vals, dim=1))


def _build_rows(flat, start, cnt, row_map, width: int):
    """Gather padded unit element rows + validity from the CSR store.

    ``width`` is the planner's per-round gather width (pow2-bucketed max row
    count among the gathered units); reads past a row's count are clamped to
    index 0 and masked invalid.
    """
    rows = row_map.to(torch.int64)
    starts = start[rows].to(torch.int64)[:, None]           # (U, 1)
    counts = cnt[rows][:, None]
    offs = torch.arange(width, dtype=torch.int32, device=flat.device)[None, :]
    valid = offs < counts
    idx = torch.where(valid, starts + offs, 0)
    return flat[idx], valid                                  # (U, W) int32, bool


def _apply_filters(elems, valid, fseeds, fbins, fcnt):
    """Mask elements by the unit's 3-way-split filter chain (paper §3.2).

    F (the chain depth) is a small static dim; inactive levels (fcnt <= k)
    pass everything through.
    """
    for k in range(fseeds.shape[1]):
        on = (fcnt > k)[:, None]
        bins3 = mulshift_bins(mix32(elems, fseeds[:, k][:, None]), 3)
        valid = valid & (~on | (bins3 == fbins[:, k][:, None]))
    return valid


def _build_side(
    flat, start, cnt, row_map, width, removed, removed_cnt, added, added_cnt,
    unit_valid, fseeds, fbins, fcnt,
):
    """One side's full on-device unit-row build: CSR gather, diff overlay
    (drop ``removed`` by value match, append ``added`` columns — both may be
    zero-width, in which case the overlay ops vanish), split-filter chain,
    and the padding-unit mask.  Shared by the fused two-side executor and
    the single-side executor."""
    e, v = _build_rows(flat, start, cnt, row_map, width)
    # the removed width R is a small static bucket: match column by column
    # instead of materialising the (U, W, R) comparison cube
    for r in range(removed.shape[1]):
        hit = (e == removed[:, r : r + 1]) & (removed_cnt > r)[:, None]
        v = v & ~hit
    if added.shape[1]:
        x = torch.arange(added.shape[1], device=e.device)[None, :]
        e = torch.cat([e, added], dim=1)
        v = torch.cat([v, x < added_cnt[:, None]], dim=1)
    v = _apply_filters(e, v, fseeds, fbins, fcnt)
    return e, v & (unit_valid != 0)[:, None]


def _pad_width(elems, valid, width):
    pad = width - elems.shape[1]
    if pad == 0:
        return elems, valid
    return (
        torch.nn.functional.pad(elems, (0, pad)),
        torch.nn.functional.pad(valid, (0, pad)),
    )


def _build_both(
    flat_a, start_a, cnt_a, flat_b, start_b, cnt_b, row_map, unit_valid, seeds,
    removed, removed_cnt, added, added_cnt, fseeds, fbins, fcnt,
    width_a, width_b,
):
    """Alice's rows (store + diff overlay) and Bob's (store only), padded to
    one width and stacked for the fused two-side encode."""
    u = row_map.shape[0]
    empty_overlay = torch.zeros((u, 0), dtype=torch.int32, device=flat_a.device)
    zero_cnt = torch.zeros(u, dtype=torch.int32, device=flat_a.device)
    ea, va = _build_side(
        flat_a, start_a, cnt_a, row_map, width_a,
        removed, removed_cnt, added, added_cnt, unit_valid, fseeds, fbins, fcnt,
    )
    eb, vb = _build_side(
        flat_b, start_b, cnt_b, row_map, width_b,
        empty_overlay, zero_cnt, empty_overlay, zero_cnt,
        unit_valid, fseeds, fbins, fcnt,
    )
    width = max(ea.shape[1], eb.shape[1])
    ea, va = _pad_width(ea, va, width)
    eb, vb = _pad_width(eb, vb, width)
    elems2 = torch.cat([ea, eb], dim=0)                      # (2U, W)
    valid2 = torch.cat([va, vb], dim=0)
    seeds2 = torch.cat([seeds, seeds], dim=0)
    return elems2, valid2, seeds2


def execute_round(
    flat_a: torch.Tensor,
    start_a: torch.Tensor,
    cnt_a: torch.Tensor,
    flat_b: torch.Tensor,
    start_b: torch.Tensor,
    cnt_b: torch.Tensor,
    row_map: torch.Tensor,
    unit_valid: torch.Tensor,
    seeds: torch.Tensor,
    removed: torch.Tensor,
    removed_cnt: torch.Tensor,
    added: torch.Tensor,
    added_cnt: torch.Tensor,
    fseeds: torch.Tensor,
    fbins: torch.Tensor,
    fcnt: torch.Tensor,
    *,
    n: int,
    t: int,
    width_a: int,
    width_b: int,
):
    """Run one PBS round for U packed units of one (n, t) cohort.

    Returns (xors_a, xors_b (U, n) int32 bit patterns, ok (U,) bool,
    positions (U, t) padded with -1, counts (U,), csum_a, csum_b (U,) int32
    bit patterns, sk_diff (U, t)).
    """
    with _DISPATCH_TRACER.annotate("repro.execute_round"):
        _note("execute_round", (n, t, width_a, width_b),
              flat_a, start_a, flat_b, start_b, row_map, removed, added, fseeds)
        code = bch_code(n, t)
        elems2, valid2, seeds2 = _build_both(
            flat_a, start_a, cnt_a, flat_b, start_b, cnt_b, row_map, unit_valid,
            seeds, removed, removed_cnt, added, added_cnt, fseeds, fbins, fcnt,
            width_a, width_b,
        )
        # --- fused two-side encode: one bin launch, one sketch matmul ----
        parity2, xors2 = bin_parity_xorsum_units_packed(elems2, valid2, seeds2, n_bins=n)
        sk2 = sketch_groups(parity2, code)
        csum2 = _wrap_csum(elems2, valid2)

        u = row_map.shape[0]
        sk_diff = sk2[:u] ^ sk2[u:]
        ok, pos, cnt = bch_decode_batched(sk_diff, n=n, t=t)
        # sk_diff rides back with the outcomes: it is the cached syndrome
        # *prefix* the rateless recovery path (DESIGN.md §16) concatenates
        # with incremental parity when a unit overloads — nothing re-encodes.
        return xors2[:u], xors2[u:], ok, pos, cnt, csum2[:u], csum2[u:], sk_diff


def encode_side(
    flat: torch.Tensor,
    start: torch.Tensor,
    cnt: torch.Tensor,
    row_map: torch.Tensor,
    unit_valid: torch.Tensor,
    seeds: torch.Tensor,
    removed: torch.Tensor,
    removed_cnt: torch.Tensor,
    added: torch.Tensor,
    added_cnt: torch.Tensor,
    fseeds: torch.Tensor,
    fbins: torch.Tensor,
    fcnt: torch.Tensor,
    *,
    n: int,
    t: int,
    width: int,
):
    """Encode ONE side's U packed units: the single-endpoint half of the round.

    Same on-device row build + bin/sketch/checksum pass as the fused
    executor, but for a single endpoint's resident store (Bob passes
    zero-width overlays).  Returns (sketches (U, t), xors (U, n) int32 bit
    patterns, csum (U,) int32 bit patterns).
    """
    with _DISPATCH_TRACER.annotate("repro.encode_side"):
        _note("encode_side", (n, t, width),
              flat, start, row_map, removed, added, fseeds)
        code = bch_code(n, t)
        e, v = _build_side(
            flat, start, cnt, row_map, width,
            removed, removed_cnt, added, added_cnt, unit_valid, fseeds, fbins, fcnt,
        )
        parity, xors = bin_parity_xorsum_units_packed(e, v, seeds, n_bins=n)
        return sketch_groups(parity, code), xors, _wrap_csum(e, v)


def execute_round_ext(
    flat_a: torch.Tensor,
    start_a: torch.Tensor,
    cnt_a: torch.Tensor,
    flat_b: torch.Tensor,
    start_b: torch.Tensor,
    cnt_b: torch.Tensor,
    row_map: torch.Tensor,
    unit_valid: torch.Tensor,
    seeds: torch.Tensor,
    removed: torch.Tensor,
    removed_cnt: torch.Tensor,
    added: torch.Tensor,
    added_cnt: torch.Tensor,
    fseeds: torch.Tensor,
    fbins: torch.Tensor,
    fcnt: torch.Tensor,
    *,
    n: int,
    t0: int,
    t1: int,
    width_a: int,
    width_b: int,
):
    """One rateless extension step for U packed units of one (n, t) cohort
    (DESIGN.md §16): rebuild both sides' rows for the SAME round (identical
    bin seeds → identical parity bitmaps) and emit only the XOR of the
    *incremental* syndromes S_{2*t0+1}..S_{2*t1-1} — a (U, t1-t0) array the
    host concatenates onto the cached round-diff prefix and decodes at t1.
    """
    with _DISPATCH_TRACER.annotate("repro.execute_round_ext"):
        _note("execute_round_ext", (n, t0, t1, width_a, width_b),
              flat_a, start_a, flat_b, start_b, row_map, removed, added, fseeds)
        code = bch_code(n, t1)
        elems2, valid2, seeds2 = _build_both(
            flat_a, start_a, cnt_a, flat_b, start_b, cnt_b, row_map, unit_valid,
            seeds, removed, removed_cnt, added, added_cnt, fseeds, fbins, fcnt,
            width_a, width_b,
        )
        parity2, _ = bin_parity_xorsum_units_packed(elems2, valid2, seeds2, n_bins=n)
        inc2 = sketch_groups_range(parity2, code, t0)
        u = row_map.shape[0]
        return inc2[:u] ^ inc2[u:]


def encode_side_ext(
    flat: torch.Tensor,
    start: torch.Tensor,
    cnt: torch.Tensor,
    row_map: torch.Tensor,
    unit_valid: torch.Tensor,
    seeds: torch.Tensor,
    removed: torch.Tensor,
    removed_cnt: torch.Tensor,
    added: torch.Tensor,
    added_cnt: torch.Tensor,
    fseeds: torch.Tensor,
    fbins: torch.Tensor,
    fcnt: torch.Tensor,
    *,
    n: int,
    t0: int,
    t1: int,
    width: int,
):
    """ONE side's incremental syndromes for the current round: the
    ``encode_side`` variant behind rateless parity (DESIGN.md §16).  Same
    on-device row build and bin pass over the same round seeds, but the
    sketch matmul covers only syndrome columns [t0, t1).  Returns
    (U, t1-t0) field elements.
    """
    with _DISPATCH_TRACER.annotate("repro.encode_side_ext"):
        _note("encode_side_ext", (n, t0, t1, width),
              flat, start, row_map, removed, added, fseeds)
        code = bch_code(n, t1)
        e, v = _build_side(
            flat, start, cnt, row_map, width,
            removed, removed_cnt, added, added_cnt, unit_valid, fseeds, fbins, fcnt,
        )
        parity, _ = bin_parity_xorsum_units_packed(e, v, seeds, n_bins=n)
        return sketch_groups_range(parity, code, t0)
