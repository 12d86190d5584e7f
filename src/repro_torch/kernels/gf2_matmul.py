"""GF(2) dense matmul: ``C = (A @ B) mod 2`` on 0/1 int32 matrices.

This one function is the BCH sketch of every round after the DESIGN.md §3
reformulation: ``sketches = (parity_bitmaps @ syndrome_matrix) mod 2`` with
A = (units, n) bitmaps and B = (n, t*m) precomputed powers-of-alpha bits
(or a column slice of it for rateless increments).

On CUDA tensors the hand-written kernel ``csrc/gf2_matmul.cu`` runs (the
reduction axis bit-packed 32 to a word; AND + XOR + one popcount parity);
on CPU tensors ``gf2_matmul_plain`` runs.  A CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from .platform import (
    check_launch,
    count_launch,
    current_stream_ptr,
    load_kernel_lib,
    require,
)


def gf2_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a float32 product of the 0/1 matrices is an
    exact integer count while K < 2^24; its low bit is the GF(2) product."""
    if a.shape[1] != b.shape[0] or a.shape[1] >= (1 << 24):
        raise ValueError(f"cannot multiply {tuple(a.shape)} @ {tuple(b.shape)}")
    counts = (a & 1).to(torch.float32) @ (b & 1).to(torch.float32)
    return counts.to(torch.int32) & 1


def gf2_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(A @ B) mod 2 for 0/1 int32 matrices of any shape -> (M, N) int32."""
    if a.device.type != "cuda":
        return gf2_matmul_plain(a, b)
    dev = a.device
    require(a, "a", torch.int32, 2, dev)
    require(b, "b", torch.int32, 2, dev)
    (M, K), (K2, N) = a.shape, b.shape
    if K != K2:
        raise ValueError(f"inner dims disagree: {tuple(a.shape)} @ {tuple(b.shape)}")
    fn = load_kernel_lib("gf2_matmul").gf2_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((M, N), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, K, N,
                current_stream_ptr())
    check_launch("gf2_matmul", rc)
    count_launch("gf2_matmul", (M, K, N))
    return out
