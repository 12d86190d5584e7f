"""Tug-of-War sketches: all ℓ sketches in one pass over the set.

``Y_i = Σ_e valid_e · (1 − 2·(mix32(mix32(e, 0x5EED) ^ seed_i, 0x7077) & 1))``
— the two-round mix32 ±1 family of ``core.tow`` (the ±(2d²−2d)/ℓ variance
contract is validated for this family by the reference's kernel tests).

On CUDA tensors the hand-written kernel ``csrc/tow_sketch.cu`` runs; on CPU
tensors ``tow_sketch_plain`` runs.  A CUDA tensor launches the kernel or
raises.  The kernel has a row axis, so ``tow_sketch_rows`` sketches R
padded rows in one launch; ``tow_sketch`` is its single-row form.
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

_PLAIN_CHUNK = 1 << 15   # keys per step of the plain version's (chunk, ell) temporaries


def tow_sketch_plain(
    elems: torch.Tensor, seeds: torch.Tensor, valid: torch.Tensor | None = None
) -> torch.Tensor:
    """Plain PyTorch version of ``tow_sketch`` (same returns)."""
    s = as_u32(seeds)[None, :]
    out = torch.zeros(seeds.shape[0], dtype=torch.int64, device=elems.device)
    for lo in range(0, elems.shape[0], _PLAIN_CHUNK):
        h1 = mix32(elems[lo : lo + _PLAIN_CHUNK], 0x5EED)[:, None]
        signs = 1 - 2 * (mix32(h1 ^ s, 0x7077) & 1)
        if valid is not None:
            signs = signs * (valid[lo : lo + _PLAIN_CHUNK] != 0).to(torch.int64)[:, None]
        out += signs.sum(dim=0)
    return out.to(torch.int32)


def tow_sketch_rows(
    elems: torch.Tensor, seeds: torch.Tensor, valid: torch.Tensor | None = None
) -> torch.Tensor:
    """(R, E) padded key rows -> (R, ell) int32 sketches, one launch."""
    if elems.device.type != "cuda":
        out = torch.zeros((elems.shape[0], seeds.shape[0]), dtype=torch.int32)
        for r in range(elems.shape[0]):
            out[r] = tow_sketch_plain(
                elems[r], seeds, None if valid is None else valid[r]
            )
        return out
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
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.zeros((R, ell), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = fn(elems.data_ptr(), vptr, seeds.data_ptr(), out.data_ptr(),
                R, E, ell, current_stream_ptr())
    check_launch("tow_sketch", rc)
    count_launch("tow_sketch", (R, E, ell))
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
    return tow_sketch_rows(
        elems[None, :], seeds, None if valid is None else valid[None, :]
    )[0]
