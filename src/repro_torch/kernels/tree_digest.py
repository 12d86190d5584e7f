"""Batched per-range ToW digests for the tree front end (DESIGN.md §15).

One launch digests a whole tree-level frontier.  Same hash family as phase
0 (``mix32(mix32(e, 0x5EED) ^ seed, 0x7077)``), so a single-row frontier
reproduces ``tow_sketch`` exactly; the host oracle is
``tree.partition.level_digests_ref``.  Two entries, both ledgered as
``tree_digest`` under the reference's padded shape ``(R, Ep, ell)``:

* ``tree_digest(elems, valid, seeds)`` — the reference's contract: each
  range's keys packed into one row of a padded ``(R, E)`` matrix with a 0/1
  valid mask.  On CUDA tensors it runs the masked-rows kernels of
  ``csrc/tow_sketch.cu`` (K3's).
* ``tree_digest_ranges(keys, lo, cnt, seeds, width=...)`` — the walk's
  entry, where row r is ``keys[lo[r] : lo[r] + cnt[r]]`` of one sorted key array
  already on the device.  On CUDA tensors the ragged-rows kernel reads only
  those keys: no padded matrix, mask or index matrix is built.  Its work list
  (``range_tiles``, items of ``ragged_tile`` keys) is made on the host from
  ``lo``/``cnt`` and uploaded in one copy.  On CPU tensors it is ``range_rows`` then the plain version —
  exactly the padded route.

A CUDA tensor launches the kernel or raises; CPU tensors run
``tree_digest_plain``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .platform import (
    check_launch,
    count_launch,
    current_stream_ptr,
    load_kernel_lib,
    note_variant,
    require,
    sm_count,
)
from .tow_sketch import launch_rows
# tree_digest shares tow_sketch's kernel, and so its plain version:
# (R, E) rows and mask -> (R, ell), the same returns
from .tow_sketch import sketch_rows_plain as tree_digest_plain

__all__ = [
    "range_rows",
    "range_tiles",
    "ragged_tile",
    "tree_digest",
    "tree_digest_plain",
    "tree_digest_ranges",
    "tree_digest_ranges_plain",
]

RANGE_TILE = 512       # most keys a warp takes of one ragged row
_MIN_TILE = 32         # one group of 32 keys
_WARPS_PER_SM = 32     # the items a launch aims to give every SM


def ragged_tile(total_keys: int, sms: int) -> int:
    """Keys per warp item of the ragged kernel: the power of two in
    ``[32, RANGE_TILE]`` that cuts ``total_keys`` into about 32 items per
    SM, so a small level is not left to a few warps walking long rows."""
    want = max(1, -(-int(total_keys) // (sms * _WARPS_PER_SM)))
    return min(RANGE_TILE, max(_MIN_TILE, 1 << (want - 1).bit_length()))


def _padded_len(E: int, tile: int) -> int:
    return max(tile, ((E + tile - 1) // tile) * tile)


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
    Ep = _padded_len(E, tile)
    note_variant("tree_digest", (R, Ep, ell))
    if elems.device.type != "cuda":
        return tree_digest_plain(elems, valid, seeds)
    out = launch_rows(elems, seeds, valid)
    count_launch("tree_digest", (R, Ep, ell))
    return out


def range_rows(keys: torch.Tensor, lo_idx: np.ndarray, counts: np.ndarray, width: int):
    """Pack range slices of the key array ``keys`` into a ``(len(lo_idx),
    width)`` int32 matrix + bool mask, on ``keys``' device: row r holds
    ``keys[lo_idx[r] : lo_idx[r] + counts[r]]`` then zeros (a row with count
    0 is all padding)."""
    dev = keys.device
    lo = torch.from_numpy(np.ascontiguousarray(lo_idx, dtype=np.int64)).to(dev)
    cnt = torch.from_numpy(np.ascontiguousarray(counts, dtype=np.int64)).to(dev)
    col = torch.arange(width, dtype=torch.int64, device=dev)
    valid = col[None, :] < cnt[:, None]
    if keys.numel() == 0:
        return torch.zeros(valid.shape, dtype=torch.int32, device=dev), valid
    idx = (lo[:, None] + col).clamp_(max=keys.numel() - 1)
    return torch.where(valid, keys[idx], 0), valid


def range_tiles(lo_idx: np.ndarray, counts: np.ndarray, tile: int = RANGE_TILE):
    """The ragged kernel's work list, as one int32 array: ``lo`` (R), ``cnt``
    (R), then one ``(row, start, length)`` triple per tail tile.  Item r < R
    is the head of row r, ``keys[lo[r] : lo[r] + min(cnt[r], tile)]``; a row
    longer than ``tile`` continues in tail tiles of ``tile`` keys (the last
    one shorter), in row order.  Returns ``(desc, n_tail)``."""
    lo = np.asarray(lo_idx, dtype=np.int64)
    cnt = np.asarray(counts, dtype=np.int64)
    n_tail = np.maximum(-(-cnt // tile) - 1, 0)
    rows = np.repeat(np.arange(len(cnt), dtype=np.int64), n_tail)
    first = np.cumsum(n_tail) - n_tail          # index of each row's first tail
    k = np.arange(len(rows), dtype=np.int64) - np.repeat(first, n_tail) + 1
    start = lo[rows] + k * tile
    length = np.minimum(cnt[rows] - k * tile, tile)
    tail = np.stack([rows, start, length], axis=1).reshape(-1)
    desc = np.concatenate([lo, cnt, tail]).astype(np.int32)
    return desc, len(rows)


def _check_ranges(keys, lo, cnt, width):
    if lo.shape != cnt.shape or lo.ndim != 1:
        raise ValueError(f"lo {lo.shape} and cnt {cnt.shape}: expected two equal (R,)")
    if len(cnt) and (cnt.min() < 0 or lo.min() < 0):
        raise ValueError("negative range bound")
    if len(cnt) and int(cnt.max()) > width:
        raise ValueError(f"a range of {int(cnt.max())} keys exceeds width {width}")
    if len(cnt) and int((lo + cnt).max()) > keys.shape[0]:
        raise ValueError(f"a range ends past the {keys.shape[0]} keys")


def tree_digest_ranges_plain(keys, lo, cnt, seeds, *, width: int) -> torch.Tensor:
    """Plain version of ``tree_digest_ranges``: the padded ``(R, width)``
    rows of ``range_rows`` through ``tree_digest_plain``."""
    return tree_digest_plain(*range_rows(keys, lo, cnt, width), seeds)


def tree_digest_ranges(
    keys: torch.Tensor,
    lo,
    cnt,
    seeds: torch.Tensor,
    *,
    ell: int = 32,
    width: int,
    tile: int = 512,
) -> torch.Tensor:
    """Per-range ToW sketches of ragged ranges of one key array -> ``(R,
    ell)`` int32, equal to ``tree_digest(*range_rows(keys, lo, cnt, width),
    seeds)``.

    ``keys``: ``(N,)`` int32 bit patterns (the walk's sorted keys, both sides
    stacked); ``lo``, ``cnt``: ``(R,)`` host integer arrays (numpy), row r =
    ``keys[lo[r] : lo[r] + cnt[r]]``, a row with ``cnt`` 0 comes back zero;
    ``width`` (at least every ``cnt``) and ``tile`` only key the ledgers, as
    the padded form's row length would: ``("tree_digest", (R, Ep, ell))``.
    """
    if seeds.shape[0] != ell:
        raise ValueError(f"{seeds.shape[0]} seeds for ell={ell}")
    lo = np.asarray(lo, dtype=np.int64)
    cnt = np.asarray(cnt, dtype=np.int64)
    _check_ranges(keys, lo, cnt, width)
    R = len(cnt)
    Ep = _padded_len(width, tile)
    note_variant("tree_digest", (R, Ep, ell))
    if keys.device.type != "cuda":
        return tree_digest_ranges_plain(keys, lo, cnt, seeds, width=width)
    dev = keys.device
    require(keys, "keys", torch.int32, 1, dev)
    require(seeds, "seeds", torch.int32, 1, dev)
    if keys.shape[0] >= 1 << 31:
        raise ValueError(f"{keys.shape[0]} keys: the ragged kernel indexes with int32")
    tile_keys = ragged_tile(int(cnt.sum()), sm_count(dev))
    desc_np, n_tail = range_tiles(lo, cnt, tile_keys)
    desc = torch.from_numpy(desc_np).to(dev)
    fn = load_kernel_lib("tow_sketch").tow_ranges_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((R, ell), dtype=torch.int32, device=dev)   # the launch fills it
    with torch.cuda.device(dev):
        rc = fn(keys.data_ptr(), desc.data_ptr(), seeds.data_ptr(), out.data_ptr(),
                R, n_tail, ell, tile_keys, current_stream_ptr())
    check_launch("tree_digest", rc)
    count_launch("tree_digest", (R, Ep, ell))
    return out
