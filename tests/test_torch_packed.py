"""The bit-packed parity hand-off of the port, on the CPU: the packing
helpers, K1's packed entry, K2's packed entry and the sketches built from
packed words, each against the JAX package (the Pallas kernels in interpret
mode) and the numpy oracle, exactly.

On CPU tensors the wrappers run their kernels' plain versions; the CUDA
kernels are held against the same plain versions on the card by
``chip_smoke.py``.  Tolerance: 0 everywhere (integer / GF(2) arithmetic).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bch import BCHCode
from repro.kernels import ref
from repro.kernels.bin_xorsum import bin_parity_xorsum_units as units_jax
from repro.kernels.bin_xorsum import xor_bits_to_u32 as xor_bits_to_u32_jax
from repro.kernels.gf2_matmul import gf2_matmul as gf2_matmul_jax
from repro.kernels.ops import sketch_groups as sketch_groups_jax
from repro.kernels.ops import sketch_groups_range as sketch_groups_range_jax
from repro_torch.core.bch import BCHCode as BCHCodePort
from repro_torch.kernels.bin_xorsum import (
    bin_parity_xorsum_units,
    bin_parity_xorsum_units_packed,
    bin_parity_xorsum_units_packed_plain,
)
from repro_torch.kernels.gf2_matmul import (
    gf2_matmul_packed,
    gf2_matmul_packed_plain,
    pack_bits,
    pack_bits_np,
    pack_bits_plain,
    pack_columns,
    packed_words,
    unpack_bits,
)
from repro_torch.kernels.ops import sketch_groups, sketch_groups_range
from repro_torch.kernels.platform import upload

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _keys(rng, size):
    return rng.integers(0, 1 << 32, size=size, dtype=np.uint64).astype(np.uint32)


# ---- the packed layout -------------------------------------------------------


@pytest.mark.parametrize("k", [1, 31, 32, 33, 511, 8191])
def test_pack_round_trip_and_zero_pad_bits(k):
    rng = np.random.default_rng(k)
    bits = rng.integers(0, 2, size=(5, k)).astype(np.int32)
    bits[0] = 1                                  # all ones: pad bits must stay 0
    words = pack_bits_plain(torch.from_numpy(bits))
    assert words.dtype == torch.int32 and words.shape == (5, packed_words(k))
    assert np.array_equal(words.numpy(), pack_bits_np(bits))
    assert torch.equal(pack_bits(torch.from_numpy(bits)), words)
    assert np.array_equal(unpack_bits(words, k).numpy(), bits)
    # entry j is bit j % 32 of word j // 32, LSB first
    u = words.numpy().view(np.uint32)
    j = k - 1
    assert np.array_equal((u[:, j // 32] >> np.uint32(j % 32)) & 1, bits[:, j])
    if k % 32:
        assert not (u[:, -1] >> np.uint32(k % 32)).any()
    # B packed per column is the packing of its transpose
    assert np.array_equal(pack_columns(torch.from_numpy(bits.T.copy())).numpy(),
                          pack_bits_np(bits))


# ---- K1: packed parity ---------------------------------------------------------


def _units_case(n_bins, U=7, E=300):
    """Ragged rows, a fully masked row holding junk, a padding unit (all
    masked), a full row, a row with a real key 0, per-unit seeds."""
    rng = np.random.default_rng(n_bins + U)
    elems = _keys(rng, (U, E))
    counts = rng.integers(1, E, size=U)
    counts[0], counts[1], counts[2] = 0, E, E // 2
    valid = (np.arange(E)[None, :] < counts[:, None]).astype(np.int32)
    valid[U - 1] = 0                             # a padding unit
    elems[2, 3] = 0                              # a real key 0
    return elems, valid, _keys(rng, U)


@pytest.mark.parametrize("n_bins", [63, 127, 255, 511, 8191])
def test_packed_units_parity_matches_jax(n_bins):
    elems, valid, seeds = _units_case(n_bins)
    p_jax, xb_jax = units_jax(
        jnp.asarray(elems), jnp.asarray(valid), jnp.asarray(seeds), n_bins=n_bins
    )
    p_ref, x_ref = ref.bin_parity_xorsum_units_ref(elems, valid, seeds, n_bins)
    assert np.array_equal(np.asarray(p_jax), p_ref)
    te, tv, ts = upload(elems, CPU), torch.from_numpy(valid != 0), upload(seeds, CPU)
    words, xors = bin_parity_xorsum_units_packed(te, tv, ts, n_bins=n_bins)
    assert words.dtype == torch.int32 and words.shape == (7, packed_words(n_bins))
    assert np.array_equal(words.numpy(), pack_bits_np(np.asarray(p_jax)))
    assert np.array_equal(xors.numpy().view(np.uint32),
                          np.asarray(xor_bits_to_u32_jax(xb_jax)))
    assert np.array_equal(xors.numpy().view(np.uint32), x_ref)
    assert not words[0].any() and not words[-1].any() and not xors[-1].any()
    w2, x2 = bin_parity_xorsum_units_packed_plain(te, tv, ts, n_bins=n_bins)
    assert torch.equal(w2, words) and torch.equal(x2, xors)
    # the reference contract is the packed entry unpacked
    parity, x3 = bin_parity_xorsum_units(te, tv, ts, n_bins=n_bins)
    assert torch.equal(parity, unpack_bits(words, n_bins)) and torch.equal(x3, xors)


def test_packed_units_key_zero_flips_parity_only():
    n_bins = 127
    elems, valid, seeds = _units_case(n_bins)
    te, ts = upload(elems, CPU), upload(seeds, CPU)
    with_zero, xz = bin_parity_xorsum_units_packed(te, torch.from_numpy(valid != 0), ts,
                                                   n_bins=n_bins)
    valid[2, 3] = 0
    without, xw = bin_parity_xorsum_units_packed(te, torch.from_numpy(valid != 0), ts,
                                                 n_bins=n_bins)
    assert torch.equal(xz, xw)
    flipped = unpack_bits(with_zero ^ without, n_bins)
    assert int(flipped.sum()) == 1 and int(flipped[2].sum()) == 1


# ---- K2: packed GF(2) product ----------------------------------------------------


@pytest.mark.parametrize(
    "m,k,n",
    [
        (1, 127, 91),
        (8, 255, 88),
        (17, 511, 153),
        (64, 1023, 110),
        (3, 2047, 187),
        (130, 300, 260),
        (5, 64, 640),
        (300, 511, 90),
        (1, 8191, 208),
        (4, 100, 33),
        (2, 33, 7),
    ],
)
def test_gf2_matmul_packed_matches_jax(m, k, n):
    rng = np.random.default_rng(m * 7919 + k + n)
    a = rng.integers(0, 2, (m, k)).astype(np.int32)
    b = rng.integers(0, 2, (k, n)).astype(np.int32)
    aw, bt = torch.from_numpy(pack_bits_np(a)), torch.from_numpy(pack_bits_np(b.T))
    got = gf2_matmul_packed(aw, bt, k)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    exp = np.asarray(gf2_matmul_jax(jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(got.numpy(), exp)
    assert np.array_equal(got.numpy(), ref.gf2_matmul_ref(a, b))
    assert torch.equal(gf2_matmul_packed_plain(aw, bt, k), got)


def test_gf2_matmul_packed_rejects_wrong_word_count():
    aw = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="packed operands"):
        gf2_matmul_packed(aw, torch.zeros((4, 3), dtype=torch.int32), 127)


# ---- sketches from packed words ------------------------------------------------


@pytest.mark.parametrize("n,t", [(63, 7), (255, 8), (511, 10), (8191, 16)])
def test_sketch_groups_from_packed_words(n, t):
    code, code_p = BCHCode(n, t), BCHCodePort(n, t)
    rng = np.random.default_rng(n * t)
    bitmaps = rng.integers(0, 2, (6, n)).astype(np.int32)
    bitmaps[2] = 0
    exp = np.asarray(sketch_groups_jax(jnp.asarray(bitmaps), code))
    words = torch.from_numpy(pack_bits_np(bitmaps))
    assert np.array_equal(sketch_groups(words, code_p).numpy(), exp)
    assert np.array_equal(sketch_groups(torch.from_numpy(bitmaps), code_p).numpy(), exp)
    assert not sketch_groups(words, code_p)[2].any()


@pytest.mark.parametrize("n,t0,t1", [(63, 7, 14), (255, 8, 32), (127, 3, 6), (511, 10, 40)])
def test_sketch_groups_range_from_packed_words_concat_equals_full(n, t0, t1):
    code1, code1_p = BCHCode(n, t1), BCHCodePort(n, t1)
    rng = np.random.default_rng(n + t1)
    bitmaps = rng.integers(0, 2, (5, n)).astype(np.int32)
    words = torch.from_numpy(pack_bits_np(bitmaps))
    full = sketch_groups(words, code1_p)
    prefix = sketch_groups(words, BCHCodePort(n, t0))
    inc = sketch_groups_range(words, code1_p, t0)
    assert torch.equal(torch.cat([prefix, inc], dim=1), full)
    exp_inc = np.asarray(sketch_groups_range_jax(jnp.asarray(bitmaps), code1, t0))
    assert np.array_equal(inc.numpy(), exp_inc)
    assert torch.equal(sketch_groups_range(torch.from_numpy(bitmaps), code1_p, t0), inc)


def test_sketch_groups_rejects_rows_of_another_width():
    with pytest.raises(ValueError, match="neither"):
        sketch_groups(torch.zeros((2, 100), dtype=torch.int32), BCHCodePort(127, 5))
