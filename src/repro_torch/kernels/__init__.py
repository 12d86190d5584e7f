"""Kernel layer for the PBS hot loops (DESIGN.md §3), for NVIDIA Hopper.

One module per kernel (+ ``ops.py`` protocol-level wrappers, ``ref.py``
pure-numpy oracles).  Each kernel module holds the wrapper, which launches
the hand-written CUDA C++ kernel from ``csrc/`` on CUDA tensors, and the
kernel's plain PyTorch version, which the wrapper uses on CPU tensors only.
"""
from .bin_xorsum import (
    bin_parity_xorsum,
    bin_parity_xorsum_plain,
    bin_parity_xorsum_units,
    bin_parity_xorsum_units_packed,
    bin_parity_xorsum_units_packed_plain,
    bin_parity_xorsum_units_plain,
    mix32,
    mulshift_bins,
    xor_bits_to_u32,
)
from .gf2_matmul import (
    gf2_matmul,
    gf2_matmul_packed,
    gf2_matmul_packed_plain,
    gf2_matmul_plain,
    pack_bits,
    pack_bits_plain,
    unpack_bits,
)
from .ops import (
    bch_decode_batched,
    chien_eval_matmul,
    encode_group,
    encode_groups,
    pack_bits_to_field,
    sketch_groups,
    sketch_groups_range,
    tow_estimate,
)
from .platform import launch_counts, reset_launch_counts, resolve_device
from .tow_sketch import tow_sketch, tow_sketch_plain
from .tree_digest import (
    tree_digest,
    tree_digest_plain,
    tree_digest_ranges,
    tree_digest_ranges_plain,
)

__all__ = [
    "bch_decode_batched",
    "bin_parity_xorsum",
    "bin_parity_xorsum_plain",
    "bin_parity_xorsum_units",
    "bin_parity_xorsum_units_packed",
    "bin_parity_xorsum_units_packed_plain",
    "bin_parity_xorsum_units_plain",
    "chien_eval_matmul",
    "encode_group",
    "encode_groups",
    "gf2_matmul",
    "gf2_matmul_packed",
    "gf2_matmul_packed_plain",
    "gf2_matmul_plain",
    "launch_counts",
    "mix32",
    "mulshift_bins",
    "pack_bits",
    "pack_bits_plain",
    "pack_bits_to_field",
    "reset_launch_counts",
    "resolve_device",
    "sketch_groups",
    "sketch_groups_range",
    "tow_estimate",
    "tow_sketch",
    "tow_sketch_plain",
    "tree_digest",
    "tree_digest_plain",
    "tree_digest_ranges",
    "tree_digest_ranges_plain",
    "unpack_bits",
    "xor_bits_to_u32",
]
