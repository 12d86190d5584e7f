"""Batched per-range ToW digests for the tree front end (DESIGN.md §15).

One launch digests a whole tree-level frontier: the caller packs each
range's keys into one row of a padded ``(R, E)`` matrix with a 0/1 valid
mask, and the kernel emits the ``(R, ell)`` sketch matrix.  Same hash family
as phase 0 (``mix32(mix32(e, 0x5EED) ^ seed, 0x7077)``), so a single-row
frontier reproduces ``tow_sketch`` exactly; the host oracle is
``tree.partition.level_digests_ref``.

On CUDA tensors the hand-written kernel ``csrc/tow_sketch.cu`` runs (rows on
the grid's first axis, so a level of 2^17 rows launches; all-padding tiles
skipped); on CPU tensors ``tree_digest_plain`` runs.  A CUDA tensor launches
the kernel or raises.  Launches are ledgered as ``tree_digest``, apart from
phase 0's ``tow_sketch``.
"""
from __future__ import annotations

import torch

from .platform import count_launch, note_variant
from .tow_sketch import launch_rows
# tree_digest shares tow_sketch's kernel, and so its plain version:
# (R, E) rows and mask -> (R, ell), the same returns
from .tow_sketch import sketch_rows_plain as tree_digest_plain

__all__ = ["tree_digest", "tree_digest_plain"]


def tree_digest(
    elems: torch.Tensor,
    valid: torch.Tensor,
    seeds: torch.Tensor,
    *,
    ell: int = 32,
    tile: int = 512,
) -> torch.Tensor:
    """Per-range ToW sketches: ``(R, E)`` padded rows -> ``(R, ell)`` int32.

    ``elems``: int32 bit patterns of the uint32 keys; ``valid``: bool (or
    any integer 0/1 mask) — a fully masked row comes back all zero;
    ``seeds``: ``(ell,)`` int32 bit patterns.  The reference pads the row
    length up to a multiple of ``tile``; masked padding adds nothing, so the
    kernel takes the rows as they are, and both ledgers key the call by the
    reference's padded shape ``(R, Ep, ell)`` (callers pad to
    ``pow2_bucket`` shapes, where ``Ep == E``).
    """
    if seeds.shape[0] != ell:
        raise ValueError(f"{seeds.shape[0]} seeds for ell={ell}")
    R, E = elems.shape
    if valid.shape != (R, E):
        raise ValueError(f"valid {tuple(valid.shape)} != elems {(R, E)}")
    Ep = max(tile, ((E + tile - 1) // tile) * tile)
    note_variant("tree_digest", (R, Ep, ell))
    if elems.device.type != "cuda":
        return tree_digest_plain(elems, valid, seeds)
    out = launch_rows(elems, seeds, valid)
    count_launch("tree_digest", (R, Ep, ell))
    return out
