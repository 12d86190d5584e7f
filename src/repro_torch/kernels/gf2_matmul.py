"""GF(2) dense matmul: ``C = (A @ B) mod 2`` on 0/1 matrices, bit-packed.

This one function is the BCH sketch of every round after the DESIGN.md §3
reformulation: ``sketches = (parity_bitmaps @ syndrome_matrix) mod 2`` with
A = (units, n) bitmaps and B = (n, t*m) precomputed powers-of-alpha bits
(or a column slice of it for rateless increments).

**The packed layout** (one definition, shared by K1's parity output and both
operands here).  A 0/1 row of length K is stored as ``ceil(K/32)`` int32
words: entry ``k`` is bit ``k % 32`` of word ``k // 32``, LSB first, and
the pad bits of the last word are 0.  A is packed per row, ``(M,
ceil(K/32))``; B is packed **per column**, as ``Bt (N, ceil(K/32))``.
``pack_bits`` / ``unpack_bits`` convert (``pack_bits_np`` on the host, for
the constant matrices ``ops`` caches).

Entry points:

* ``gf2_matmul_packed(a_words, bt_words, k)`` -> (M, N) int32: the kernel
  body of ``csrc/gf2_matmul.cu`` on CUDA tensors (regime picked from the
  shape, see the source), ``gf2_matmul_packed_plain`` on CPU tensors.  The
  main path calls it with K1's packed parity and a cached packed B.
* ``gf2_matmul(a, b)`` on 0/1 int32 matrices, the reference's contract: on
  CUDA it packs A and B with the packing kernel of the same source, then
  runs the packed body; on CPU, ``gf2_matmul_plain``.

A CUDA tensor launches the kernels or raises.
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
    require,
)

_M32 = 0xFFFFFFFF
TILE_MAX_WORDS = 64      # the tile regime stages W <= 64 words a row
TILE_MIN_ROWS = 256      # below this many rows the warp regime spreads wider


def packed_words(k: int) -> int:
    """Words of one packed row of ``k`` entries."""
    return (int(k) + 31) // 32


def pack_bits_np(bits: np.ndarray) -> np.ndarray:
    """Host packing: (..., K) 0/1 -> (..., ceil(K/32)) int32 words."""
    bits = np.asarray(bits)
    k = bits.shape[-1]
    pad = packed_words(k) * 32 - k
    b = np.pad((bits & 1).astype(np.uint64), [(0, 0)] * (bits.ndim - 1) + [(0, pad)])
    b = b.reshape(bits.shape[:-1] + (packed_words(k), 32))
    words = np.sum(b << np.arange(32, dtype=np.uint64), axis=-1)
    return words.astype(np.uint32).view(np.int32)


def pack_bits_plain(bits: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``pack_bits``."""
    k = bits.shape[-1]
    w = packed_words(k)
    b = torch.nn.functional.pad((bits & 1).to(torch.int64), (0, w * 32 - k))
    b = b.reshape(bits.shape[:-1] + (w, 32))
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = torch.sum(b << shifts, dim=-1)
    return (((words & _M32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def unpack_bits(words: torch.Tensor, k: int) -> torch.Tensor:
    """(..., ceil(k/32)) int32 words -> (..., k) 0/1 int32 (tensor ops, any
    device; off the main path)."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = ((words.to(torch.int64) & _M32)[..., None] >> shifts) & 1
    return bits.reshape(words.shape[:-1] + (-1,))[..., :k].to(torch.int32)


def _pack_launch(bits: torch.Tensor, rows: int, k: int, sr: int, sk: int) -> torch.Tensor:
    """Pack ``rows`` rows of ``k`` 0/1 entries, entry (r, j) at element
    offset ``r * sr + j * sk`` of ``bits``, with the packing kernel."""
    dev = bits.device
    fn = load_kernel_lib("gf2_matmul").gf2_pack_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 2 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((rows, packed_words(k)), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = fn(bits.data_ptr(), out.data_ptr(), rows, k, sr, sk, current_stream_ptr())
    check_launch("gf2_pack_bits", rc)
    count_launch("gf2_pack_bits", (rows, k))
    return out


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(R, K) 0/1 int32 -> (R, ceil(K/32)) int32 words in the packed layout:
    the packing kernel (a ``__ballot_sync`` over coalesced reads) on CUDA,
    ``pack_bits_plain`` on the CPU."""
    if bits.device.type != "cuda":
        return pack_bits_plain(bits)
    require(bits, "bits", torch.int32, 2, bits.device)
    R, K = bits.shape
    return _pack_launch(bits, R, K, K, 1)


def pack_columns(b: torch.Tensor) -> torch.Tensor:
    """(K, N) 0/1 int32 -> Bt (N, ceil(K/32)) words: B packed per column."""
    if b.device.type != "cuda":
        return pack_bits_plain(b.t())
    require(b, "b", torch.int32, 2, b.device)
    K, N = b.shape
    return _pack_launch(b, N, K, 1, N)


def gf2_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a float32 product of the 0/1 matrices is an
    exact integer count while K < 2^24; its low bit is the GF(2) product."""
    if a.shape[1] != b.shape[0] or a.shape[1] >= (1 << 24):
        raise ValueError(f"cannot multiply {tuple(a.shape)} @ {tuple(b.shape)}")
    counts = (a & 1).to(torch.float32) @ (b & 1).to(torch.float32)
    return counts.to(torch.int32) & 1


def gf2_matmul_packed_plain(a_words: torch.Tensor, bt_words: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version of ``gf2_matmul_packed``: unpack both operands
    with shifts, then the float32 product ``& 1``."""
    _check_packed(a_words, bt_words, k)
    return gf2_matmul_plain(unpack_bits(a_words, k), unpack_bits(bt_words, k).t())


def _check_packed(a_words, bt_words, k):
    w = packed_words(k)
    if a_words.dim() != 2 or bt_words.dim() != 2 or a_words.shape[1] != w \
            or bt_words.shape[1] != w:
        raise ValueError(
            f"packed operands {tuple(a_words.shape)}, {tuple(bt_words.shape)} "
            f"do not hold K = {k} ({w} words a row)"
        )


def gf2_matmul_packed(a_words: torch.Tensor, bt_words: torch.Tensor, k: int) -> torch.Tensor:
    """(A @ B) mod 2 from A packed per row ``(M, ceil(k/32))`` and B packed
    per column ``(N, ceil(k/32))`` -> (M, N) int32 0/1."""
    if a_words.device.type != "cuda":
        return gf2_matmul_packed_plain(a_words, bt_words, k)
    dev = a_words.device
    require(a_words, "a_words", torch.int32, 2, dev)
    require(bt_words, "bt_words", torch.int32, 2, dev)
    _check_packed(a_words, bt_words, k)
    M, W = a_words.shape
    N = bt_words.shape[0]
    regime = 0 if M >= TILE_MIN_ROWS and W <= TILE_MAX_WORDS else 1
    fn = load_kernel_lib("gf2_matmul").gf2_matmul_packed_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((M, N), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = fn(a_words.data_ptr(), bt_words.data_ptr(), out.data_ptr(), M, W, N, regime,
                current_stream_ptr())
    check_launch("gf2_matmul", rc)
    count_launch("gf2_matmul", (M, int(k), N))
    return out


def gf2_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(A @ B) mod 2 for 0/1 int32 matrices of any shape -> (M, N) int32."""
    if a.device.type != "cuda":
        return gf2_matmul_plain(a, b)
    dev = a.device
    require(a, "a", torch.int32, 2, dev)
    require(b, "b", torch.int32, 2, dev)
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dims disagree: {tuple(a.shape)} @ {tuple(b.shape)}")
    return gf2_matmul_packed(pack_bits(a), pack_columns(b), a.shape[1])
