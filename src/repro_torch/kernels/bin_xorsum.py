"""Hash-partition + parity bitmap + per-bin XOR fold.

``bin_parity_xorsum_units`` is the first device stage of every PBS round
(DESIGN.md §5): each unit's elements are hashed into ``n_bins`` bins with
the protocol's multiply-shift hash ``(mix32(e, seed) * n) >> 32``
(``core.hashing.hash_to_range``), and per bin the count parity and the XOR
of the member keys come back.  ``bin_parity_xorsum`` is the single-set form
behind ``ops.encode_group``, binning with the historical ``mix32(e, seed) %
n`` (``ref.bin_parity_xorsum_ref``).

On CUDA tensors the hand-written kernels of ``csrc/bin_xorsum.cu`` run
(shared-memory ``atomicXor`` scatter; K1's short rows several to a block,
its long rows one thread-block cluster each; K5's one set over every SM in
clusters of two, the partial tables merged after); on CPU tensors the
``*_plain`` versions — the same functions in plain PyTorch ops — run.  The
dispatch is on the tensors' device and nothing else: a CUDA tensor
launches the kernel or raises.

``bin_parity_xorsum_units_packed`` is the entry of the main path.  It
returns the parity bitmaps in the packed layout of ``kernels.gf2_matmul``
(``(U, ceil(n/32))`` int32 words, bin b = bit b % 32 of word b // 32, pad
bits 0), which ``ops.sketch_groups`` hands straight to the packed GF(2)
product.  ``bin_parity_xorsum_units`` keeps the reference's ``(U, n)``
contract by unpacking them.

**uint32 convention.**  Keys, seeds and XOR folds live on the device as
*int32 bit patterns* (torch's uint32 has no shifts).  The kernel
reinterprets them as ``uint32_t``; the plain hash primitives below widen to
an int64 carrier holding the value in ``[0, 2^32)`` and mask with
``& 0xFFFFFFFF`` after every add and multiply — never a signed shift on
hash state.
"""
from __future__ import annotations

import ctypes

import torch

from .gf2_matmul import pack_bits_plain, packed_words, unpack_bits
from .platform import (
    check_launch,
    count_launch,
    current_stream_ptr,
    load_kernel_lib,
    require,
)

_M32 = 0xFFFFFFFF


def as_u32(x) -> torch.Tensor:
    """Any integer tensor of 32-bit patterns -> int64 carrier in [0, 2^32)."""
    return x.to(torch.int64) & _M32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 carrier in [0, 2^32) -> int32 bit pattern."""
    return (((x & _M32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def mix32(x: torch.Tensor, seed) -> torch.Tensor:
    """murmur3 fmix32 on an int64 carrier; returns values in [0, 2^32).

    ``seed`` may be a python int or a tensor of 32-bit patterns (per-unit
    seeds, broadcast against ``x``).
    """
    x = as_u32(x)
    if isinstance(seed, torch.Tensor):
        s = (as_u32(seed) * 0x9E3779B9) & _M32
    else:
        s = (int(seed) * 0x9E3779B9) & _M32
    x = (x + s) & _M32
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _M32
    x = x ^ (x >> 16)
    return x


def mulshift_bins(h: torch.Tensor, size: int) -> torch.Tensor:
    """Bias-free range reduction ``(h * size) >> 32`` of a [0, 2^32) carrier;
    exact match of ``core.hashing.hash_to_range`` for size < 2^16."""
    if not 0 < size < (1 << 16):
        raise ValueError(f"range size {size} outside (0, 2^16)")
    return (as_u32(h) * int(size)) >> 32


def xor_bits_to_u32(xor_bits: torch.Tensor) -> torch.Tensor:
    """(..., 32) 0/1 bit planes -> (...,) int32 bit patterns of the folds."""
    shifts = torch.arange(32, dtype=torch.int64, device=xor_bits.device)
    return to_i32(torch.sum((xor_bits.to(torch.int64) & 1) << shifts, dim=-1))


def _fold_plain(e: torch.Tensor, v: torch.Tensor, bins: torch.Tensor, n_bins: int):
    """Per-row bin parity and XOR fold of (U, E) keys ``e`` (int64 carrier)
    with 0/1 int64 mask ``v`` into ``bins``.  One ``scatter_add`` of the mask
    gives the counts; the fold is 32 more, one per key bit plane, each
    reduced mod 2."""
    zeros = torch.zeros((e.shape[0], n_bins), dtype=torch.int64, device=e.device)
    parity = (zeros.scatter_add(1, bins, v) & 1).to(torch.int32)
    xors = torch.zeros_like(zeros)
    for bit in range(32):
        plane = zeros.scatter_add(1, bins, ((e >> bit) & 1) * v) & 1
        xors |= plane << bit
    return parity, to_i32(xors)


def bin_parity_xorsum_units_plain(
    elems: torch.Tensor, valid: torch.Tensor, seeds: torch.Tensor, *, n_bins: int
):
    """Plain PyTorch version of ``bin_parity_xorsum_units`` (same returns)."""
    e = as_u32(elems)
    bins = mulshift_bins(mix32(e, seeds.reshape(-1, 1)), n_bins)
    return _fold_plain(e, (valid != 0).to(torch.int64), bins, n_bins)


def bin_parity_xorsum_plain(elems: torch.Tensor, *, n_bins: int, seed: int):
    """Plain PyTorch version of ``bin_parity_xorsum`` (same returns)."""
    e = as_u32(elems).reshape(1, -1)
    bins = torch.remainder(mix32(e, seed), n_bins)
    parity, xors = _fold_plain(e, torch.ones_like(e), bins, n_bins)
    return parity[0], xors[0]


def bin_parity_xorsum_units_packed_plain(
    elems: torch.Tensor, valid: torch.Tensor, seeds: torch.Tensor, *, n_bins: int
):
    """Plain PyTorch version of ``bin_parity_xorsum_units_packed``."""
    parity, xors = bin_parity_xorsum_units_plain(elems, valid, seeds, n_bins=n_bins)
    return pack_bits_plain(parity), xors


_MAX_BINS = 28000   # one table of 2 n words must stay within 227 KB


def _check_bins(n_bins: int) -> None:
    if not 0 < n_bins <= _MAX_BINS:
        raise ValueError(f"n_bins={n_bins} outside (0, {_MAX_BINS}]")


def _launch_units(elems, valid, seeds, n_bins):
    dev = elems.device
    require(elems, "elems", torch.int32, 2, dev)
    require(valid, "valid", torch.bool, 2, dev)
    require(seeds, "seeds", torch.int32, 1, dev)
    U, E = elems.shape
    if valid.shape != (U, E) or seeds.shape != (U,):
        raise ValueError(
            f"shapes disagree: elems {tuple(elems.shape)}, valid "
            f"{tuple(valid.shape)}, seeds {tuple(seeds.shape)}"
        )
    _check_bins(n_bins)
    fn = load_kernel_lib("bin_xorsum").bin_xorsum_units_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    # the kernel writes every word of both outputs, masked rows included
    parity = torch.empty((U, packed_words(n_bins)), dtype=torch.int32, device=dev)
    xors = torch.empty((U, n_bins), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = fn(
            elems.data_ptr(), valid.data_ptr(), seeds.data_ptr(),
            parity.data_ptr(), xors.data_ptr(), U, E, n_bins,
            current_stream_ptr(),
        )
    check_launch("bin_xorsum_units", rc)
    count_launch("bin_xorsum_units", (U, E, n_bins))
    return parity, xors


def bin_parity_xorsum_units_packed(
    elems: torch.Tensor, valid: torch.Tensor, seeds: torch.Tensor, *, n_bins: int
):
    """Batched bin/parity/XOR-fold over U packed units in one kernel launch,
    parity packed.

    ``elems``: (U, E) int32 bit patterns of the uint32 keys; ``valid``:
    (U, E) bool (or any integer 0/1 mask) — false marks padding, and a fully
    masked row yields an all-zero output row; ``seeds``: (U,) int32 bit
    patterns of the per-unit binning seeds.

    Returns ``(parity (U, ceil(n_bins/32)) int32 words, xors (U, n_bins)
    int32 bit patterns)``.
    """
    if elems.device.type != "cuda":
        return bin_parity_xorsum_units_packed_plain(elems, valid, seeds, n_bins=n_bins)
    if valid.dtype != torch.bool:
        valid = valid != 0
    return _launch_units(elems, valid.contiguous(), seeds, n_bins)


def bin_parity_xorsum_units(
    elems: torch.Tensor, valid: torch.Tensor, seeds: torch.Tensor, *, n_bins: int
):
    """The reference's contract: ``(parity (U, n_bins) int32 0/1, xors (U,
    n_bins) int32 bit patterns)`` — ``bin_parity_xorsum_units_packed`` with
    the parity unpacked.  The XOR folds come back packed, as every caller of
    the reference's bit-plane form repacked them at once."""
    if elems.device.type != "cuda":
        return bin_parity_xorsum_units_plain(elems, valid, seeds, n_bins=n_bins)
    words, xors = bin_parity_xorsum_units_packed(elems, valid, seeds, n_bins=n_bins)
    return unpack_bits(words, n_bins), xors


def fastmod_magic(n_bins: int) -> int:
    """The reciprocal K5 bins with: ``M = floor((2^64 - 1) / n) + 1`` mod 2^64,
    so that ``h % n == ((M * h mod 2^64) * n) >> 64`` for every 32-bit h
    (Lemire's direct remainder)."""
    return (((1 << 64) - 1) // n_bins + 1) & ((1 << 64) - 1)


def set_plan(E: int, n_bins: int, device: torch.device) -> dict:
    """K5's launch geometry at ``(E, n_bins)`` on ``device``: grid, threads
    a block, cluster size, shared bytes a block, the partial tables the
    merge stage folds (1: no merge) and the table layout ("wide": a parity
    word a bin; "packed": parity bits packed 32 to a word)."""
    _check_bins(n_bins)
    fn = load_kernel_lib("bin_xorsum").bin_parity_xorsum_plan
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        check_launch("bin_parity_xorsum_plan", fn(E, n_bins, out))
    plan = dict(zip(("grid", "threads", "cluster", "smem", "partials"), out))
    plan["table"] = "packed" if out[5] else "wide"
    return plan


def bin_parity_xorsum(elems: torch.Tensor, *, n_bins: int, seed: int):
    """One set of uint32 keys (``(E,)`` int32 bit patterns, every entry a
    member) -> ``(parity (n_bins,) int32, xors (n_bins,) int32 bit
    patterns)``, binned by ``mix32(e, seed) % n_bins``.  On a CUDA tensor
    the set is folded over the whole card (``set_plan``): one launch, and
    a merge of the partial tables where there is more than one.  The
    reference returns ``(n_bins, 32)`` bit planes; the folds come back
    packed here, as ``encode_group`` keeps them."""
    _check_bins(n_bins)
    if elems.device.type != "cuda":
        return bin_parity_xorsum_plain(elems, n_bins=n_bins, seed=seed)
    dev = elems.device
    require(elems, "elems", torch.int32, 1, dev)
    E = elems.shape[0]
    plan = set_plan(E, n_bins, dev)
    fn = load_kernel_lib("bin_xorsum").bin_parity_xorsum_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_uint, ctypes.c_uint64] + [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    parity = torch.empty(n_bins, dtype=torch.int32, device=dev)
    xors = torch.empty(n_bins, dtype=torch.int32, device=dev)
    # partial tables: n fold words and ceil(n/32) packed parity words each
    words = plan["partials"] * (n_bins + packed_words(n_bins)) if plan["partials"] > 1 else 0
    part = torch.empty(words, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = fn(elems.data_ptr(), int(seed) & _M32, fastmod_magic(n_bins), parity.data_ptr(),
                xors.data_ptr(), part.data_ptr(), words, E, n_bins, current_stream_ptr())
    check_launch("bin_parity_xorsum", rc)
    count_launch("bin_parity_xorsum", (E, n_bins))
    return parity, xors
