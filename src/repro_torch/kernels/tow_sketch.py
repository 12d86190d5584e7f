"""Tug-of-War sketches: all ℓ sketches in one pass over the set.

``Y_i = Σ_e valid_e · (1 − 2·(mix32(mix32(e, 0x5EED) ^ seed_i, 0x7077) & 1))``
— the two-round mix32 ±1 family of ``core.tow`` (the ±(2d²−2d)/ℓ variance
contract is validated for this family by the reference's kernel tests).

On CUDA tensors the hand-written masked-rows kernels of
``csrc/tow_sketch.cu`` run; on CPU tensors ``tow_sketch_plain`` runs.  A
CUDA tensor launches the kernel or raises.  The kernels have a row axis:
``launch_rows`` sketches R padded rows in one launch, and both
``tow_sketch`` (one row) and the tree front end's padded ``tree_digest``
(R range rows) launch through it, each counting its own launches.  The same
source holds the ragged-rows kernel behind ``tree_digest_ranges``.
"""
from __future__ import annotations

import ctypes

import torch

from .bin_xorsum import as_u32, mix32
from .platform import (
    check_launch,
    count_launch,
    current_stream_ptr,
    load_kernel_lib,
    note_variant,
    require,
)

_PLAIN_KEYS = 1 << 22   # keys per step of the plain version's temporaries


def sketch_rows_plain(
    elems: torch.Tensor, valid: torch.Tensor, seeds: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``(R, E)`` rows and mask ->
    ``(R, ell)`` int32 sketches, blocks of rows at a time, one pass over the
    block per seed."""
    R, E = elems.shape
    s = as_u32(seeds)
    out = torch.zeros((R, seeds.shape[0]), dtype=torch.int64, device=elems.device)
    step = max(1, _PLAIN_KEYS // max(E, 1))
    for r0 in range(0, R, step):
        h1 = mix32(elems[r0 : r0 + step], 0x5EED)
        v = (valid[r0 : r0 + step] != 0).to(torch.int64)
        for i in range(seeds.shape[0]):
            signs = 1 - 2 * (mix32(h1 ^ s[i], 0x7077) & 1)
            out[r0 : r0 + step, i] = (signs * v).sum(dim=1)
    return out.to(torch.int32)


def tow_sketch_plain(
    elems: torch.Tensor, seeds: torch.Tensor, valid: torch.Tensor | None = None
) -> torch.Tensor:
    """Plain PyTorch version of ``tow_sketch`` (same returns)."""
    if valid is None:
        valid = torch.ones(elems.shape, dtype=torch.bool, device=elems.device)
    return sketch_rows_plain(elems[None, :], valid[None, :], seeds)[0]


def launch_rows(
    elems: torch.Tensor, seeds: torch.Tensor, valid: torch.Tensor | None = None
) -> torch.Tensor:
    """(R, E) padded key rows on the card -> (R, ell) int32 sketches in one
    launch of ``csrc/tow_sketch.cu``.  Counts nothing: each public wrapper
    ledgers the launch under its own name."""
    dev = elems.device
    require(elems, "elems", torch.int32, 2, dev)
    require(seeds, "seeds", torch.int32, 1, dev)
    R, E = elems.shape
    ell = seeds.shape[0]
    vptr = None
    if valid is not None:
        if valid.dtype != torch.bool:
            valid = valid != 0
        valid = valid.contiguous()
        require(valid, "valid", torch.bool, 2, dev)
        if valid.shape != (R, E):
            raise ValueError(f"valid {tuple(valid.shape)} != elems {(R, E)}")
        vptr = valid.data_ptr()
    fn = load_kernel_lib("tow_sketch").tow_sketch_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_int,
                                                                     ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((R, ell), dtype=torch.int32, device=dev)   # the launch fills it
    with torch.cuda.device(dev):
        rc = fn(elems.data_ptr(), vptr, seeds.data_ptr(), out.data_ptr(),
                R, E, ell, current_stream_ptr())
    check_launch("tow_sketch", rc)
    return out


def tow_sketch(
    elems: torch.Tensor,
    seeds: torch.Tensor,
    valid: torch.Tensor | None = None,
    *,
    ell: int = 128,
) -> torch.Tensor:
    """ℓ ToW sketches Y_i = Σ_s f_i(s) of a key set -> (ell,) int32.

    ``elems``: (E,) int32 bit patterns; ``seeds``: (ell,) int32 bit
    patterns; ``valid`` (optional, (E,)) marks which entries are real set
    members: callers that pad their sets to a shape bucket — the warm
    phase-0 path (DESIGN.md §12) — pass an explicit mask so the variant
    depends only on the padded length, not the set size.
    """
    if seeds.shape[0] != ell:
        raise ValueError(f"{seeds.shape[0]} seeds for ell={ell}")
    note_variant("tow_sketch", (elems.shape[0], ell, valid is not None))
    if elems.device.type != "cuda":
        return tow_sketch_plain(elems, seeds, valid)
    out = launch_rows(elems[None, :], seeds, None if valid is None else valid[None, :])
    count_launch("tow_sketch", (1, elems.shape[0], ell))
    return out[0]
