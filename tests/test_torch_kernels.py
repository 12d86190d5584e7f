"""K1-K5 of the port on the CPU: plain PyTorch version == JAX wrapper (the
Pallas kernel in interpret mode) == numpy oracle (kernels/ref.py), exactly.

On CPU tensors each wrapper of the port runs its kernel's plain version, so
these tests go through the public wrappers.  The CUDA kernels themselves are
held against the same plain versions on the card by ``chip_smoke.py``.
Tolerance: 0 everywhere (integer / GF(2) arithmetic).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bch import BCHCode, sketch_from_positions
from repro.core.hashing import hash_to_range
from repro.kernels import ref
from repro.kernels.bin_xorsum import bin_parity_xorsum as bin_parity_xorsum_jax
from repro.kernels.bin_xorsum import bin_parity_xorsum_units as units_jax
from repro.kernels.bin_xorsum import xor_bits_to_u32 as xor_bits_to_u32_jax
from repro.kernels.gf2_matmul import gf2_matmul as gf2_matmul_jax
from repro.kernels.ops import chien_eval_matmul as chien_eval_matmul_jax
from repro.kernels.ops import encode_group as encode_group_jax
from repro.kernels.ops import sketch_groups as sketch_groups_jax
from repro.kernels.ops import sketch_groups_range as sketch_groups_range_jax
from repro.kernels.tow_sketch import tow_sketch as tow_sketch_jax
from repro_torch.core.bch import BCHCode as BCHCodePort
from repro_torch.kernels import ref as ref_port
from repro_torch.kernels.bin_xorsum import (
    bin_parity_xorsum,
    bin_parity_xorsum_plain,
    bin_parity_xorsum_units,
    bin_parity_xorsum_units_plain,
    fastmod_magic,
    mix32,
    mulshift_bins,
    to_i32,
    xor_bits_to_u32,
)
from repro_torch.kernels.gf2_matmul import gf2_matmul, gf2_matmul_plain
from repro_torch.kernels.ops import (
    bch_decode_batched,
    chien_eval_matmul,
    encode_group,
    encode_groups,
    pack_bits_to_field,
    sketch_groups,
    sketch_groups_range,
)
from repro_torch.kernels.platform import upload
from repro_torch.kernels.tow_sketch import tow_sketch, tow_sketch_plain
from repro_torch.kernels.tree_digest import tree_digest

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _bit_planes(xors: torch.Tensor) -> np.ndarray:
    """(...,) int32 bit patterns of the folds -> (..., 32) 0/1 int32 bit
    planes, the reference's form (the inverse of ``xor_bits_to_u32``)."""
    return ((_u32(xors)[..., None] >> np.arange(32, dtype=np.uint32)) & 1).astype(np.int32)


def _keys(rng, size):
    # the whole uint32 range, so about half the keys are >= 2^31 (negative
    # as int32 bit patterns)
    return rng.integers(0, 1 << 32, size=size, dtype=np.uint64).astype(np.uint32)


# ---- hash primitives --------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 42, 0x9E3779B9, 0xFFFFFFFF])
def test_mix32_matches_oracles(seed):
    keys = _keys(np.random.default_rng(seed & 0xFF), 2000)
    keys[:4] = [0, 1, 0x7FFFFFFF, 0xFFFFFFFF]
    assert (keys >= 1 << 31).any()
    got = mix32(upload(keys, CPU), seed).numpy()
    assert np.array_equal(got, ref.mix32_ref(keys, seed).astype(np.int64))
    assert np.array_equal(got, ref_port.mix32_ref(keys, seed).astype(np.int64))
    # per-element tensor seeds (the per-unit form) agree with the scalar form
    seeds = upload(np.full(len(keys), seed, np.uint32), CPU)
    assert np.array_equal(mix32(upload(keys, CPU), seeds).numpy(), got)
    assert np.array_equal(_u32(to_i32(torch.from_numpy(got))), got.astype(np.uint32))


@pytest.mark.parametrize("size", [3, 63, 255, 16383])
def test_mulshift_bins_matches_hash_to_range(size):
    keys = _keys(np.random.default_rng(size), 3000)
    for seed in (7, 0xC0FFEE11):
        got = mulshift_bins(mix32(upload(keys, CPU), seed), size).numpy()
        assert np.array_equal(got, hash_to_range(keys, size, seed))


def test_xor_bits_to_u32_matches_jax():
    bits = np.random.default_rng(1).integers(0, 2, size=(5, 7, 32)).astype(np.int32)
    got = _u32(xor_bits_to_u32(torch.from_numpy(bits)))
    assert np.array_equal(got, np.asarray(xor_bits_to_u32_jax(jnp.asarray(bits))))
    assert np.array_equal(_bit_planes(upload(got, CPU)), bits)


# ---- K1: bin_parity_xorsum_units -------------------------------------------


def _units_case(n_bins, U=6, E=257):
    rng = np.random.default_rng(n_bins)
    counts = rng.integers(0, E, size=U)
    counts[0], counts[1] = 0, E           # fully masked row + full row
    elems = np.zeros((U, E), np.uint32)
    valid = np.zeros((U, E), np.int32)
    for u, c in enumerate(counts):
        elems[u, :c] = _keys(rng, int(c))
        valid[u, :c] = 1
    elems[0] = _keys(rng, E)              # masked row holds junk, not zeros
    seeds = _keys(rng, U)
    return elems, valid, seeds


@pytest.mark.parametrize("n_bins", [63, 127, 8191])
def test_bin_parity_xorsum_units_three_way(n_bins):
    elems, valid, seeds = _units_case(n_bins)
    p_ref, x_ref = ref.bin_parity_xorsum_units_ref(elems, valid, seeds, n_bins)
    p_jax, xb_jax = units_jax(
        jnp.asarray(elems), jnp.asarray(valid), jnp.asarray(seeds), n_bins=n_bins
    )
    te, ts = upload(elems, CPU), upload(seeds, CPU)
    for tv in (torch.from_numpy(valid), torch.from_numpy(valid != 0)):
        parity, xors = bin_parity_xorsum_units(te, tv, ts, n_bins=n_bins)
        assert parity.dtype == torch.int32 and xors.dtype == torch.int32
        assert np.array_equal(parity.numpy(), p_ref)
        assert np.array_equal(_u32(xors), x_ref)
        assert np.array_equal(parity.numpy(), np.asarray(p_jax))
        assert np.array_equal(_u32(xors), np.asarray(xor_bits_to_u32_jax(xb_jax)))
    assert not parity[0].any() and not xors[0].any()      # masked row: zeros
    p2, x2 = bin_parity_xorsum_units_plain(te, tv, ts, n_bins=n_bins)
    assert torch.equal(p2, parity) and torch.equal(x2, xors)
    p3, x3 = ref_port.bin_parity_xorsum_units_ref(elems, valid, seeds, n_bins)
    assert np.array_equal(p3, p_ref) and np.array_equal(x3, x_ref)


# ---- K2: gf2_matmul ----------------------------------------------------------


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
    ],
)
def test_gf2_matmul_sweep(m, k, n):
    rng = np.random.default_rng(m * 1000 + n)
    a = rng.integers(0, 2, (m, k)).astype(np.int32)
    b = rng.integers(0, 2, (k, n)).astype(np.int32)
    got = gf2_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref.gf2_matmul_ref(a, b))
    assert np.array_equal(got.numpy(), np.asarray(gf2_matmul_jax(jnp.asarray(a), jnp.asarray(b))))
    assert torch.equal(got, gf2_matmul_plain(torch.from_numpy(a), torch.from_numpy(b)))


@pytest.mark.parametrize("n,t", [(63, 7), (255, 8), (511, 10)])
def test_syndrome_matmul_and_sketch_groups(n, t):
    """The main-path use: (2U, n) parity bitmaps x (n, t*m) syndrome matrix."""
    code, code_p = BCHCode(n, t), BCHCodePort(n, t)
    rng = np.random.default_rng(n + t)
    bitmaps = rng.integers(0, 2, (16, n)).astype(np.int32)
    bitmaps[3] = 0
    P = code.field.syndrome_matrix(t).astype(np.int32)
    bits = gf2_matmul(torch.from_numpy(bitmaps), torch.from_numpy(P))
    assert np.array_equal(bits.numpy(), ref.gf2_matmul_ref(bitmaps, P))
    exp = np.asarray(sketch_groups_jax(jnp.asarray(bitmaps), code))
    got = sketch_groups(torch.from_numpy(bitmaps), code_p)
    assert np.array_equal(got.numpy(), exp)
    assert np.array_equal(
        pack_bits_to_field(bits, code.m).numpy(), exp
    )


@pytest.mark.parametrize("n,t0,t1", [(63, 7, 14), (255, 8, 32), (127, 3, 6)])
def test_sketch_groups_range_concat_equals_full(n, t0, t1):
    code1, code1_p = BCHCode(n, t1), BCHCodePort(n, t1)
    rng = np.random.default_rng(t1)
    bitmaps = torch.from_numpy(rng.integers(0, 2, (9, n)).astype(np.int32))
    full = sketch_groups(bitmaps, code1_p)
    prefix = sketch_groups(bitmaps, BCHCodePort(n, t0))
    inc = sketch_groups_range(bitmaps, code1_p, t0)
    assert torch.equal(torch.cat([prefix, inc], dim=1), full)
    exp_inc = np.asarray(sketch_groups_range_jax(jnp.asarray(bitmaps.numpy()), code1, t0))
    assert np.array_equal(inc.numpy(), exp_inc)


def test_encode_groups_matches_pieces():
    elems, valid, seeds = _units_case(127)
    code = BCHCodePort(127, 5)
    parity, xors, sk = encode_groups(
        upload(elems, CPU), torch.from_numpy(valid), upload(seeds, CPU), code
    )
    p_ref, x_ref = ref.bin_parity_xorsum_units_ref(elems, valid, seeds, 127)
    assert np.array_equal(parity.numpy(), p_ref) and np.array_equal(_u32(xors), x_ref)
    assert np.array_equal(
        sk.numpy(), np.asarray(sketch_groups_jax(jnp.asarray(p_ref), BCHCode(127, 5)))
    )


# ---- K3: tow_sketch ----------------------------------------------------------


@pytest.mark.parametrize("ell", [32, 128])
@pytest.mark.parametrize("n_elems", [5, 2048, 7001])
def test_tow_sketch_sweep(ell, n_elems):
    rng = np.random.default_rng(ell + n_elems)
    elems, seeds = _keys(rng, n_elems), _keys(rng, ell)
    got = tow_sketch(upload(elems, CPU), upload(seeds, CPU), ell=ell)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref.tow_sketch_ref(elems, seeds))
    assert np.array_equal(got.numpy(), ref_port.tow_sketch_ref(elems, seeds))
    assert np.array_equal(
        got.numpy(), np.asarray(tow_sketch_jax(jnp.asarray(elems), jnp.asarray(seeds), ell=ell))
    )


def test_tow_sketch_valid_mask_at_bucketed_length():
    """Padding to a pow2 bucket with an explicit mask contributes nothing."""
    rng = np.random.default_rng(9)
    n_real, bucket, ell = 3001, 4096, 128
    elems, seeds = _keys(rng, bucket), _keys(rng, ell)   # junk in the padding
    valid = np.zeros(bucket, np.int32)
    valid[:n_real] = 1
    exp = ref.tow_sketch_ref(elems[:n_real], seeds)
    te, ts = upload(elems, CPU), upload(seeds, CPU)
    for tv in (torch.from_numpy(valid), torch.from_numpy(valid != 0)):
        assert np.array_equal(tow_sketch(te, ts, tv, ell=ell).numpy(), exp)
        assert np.array_equal(tow_sketch_plain(te, ts, tv).numpy(), exp)
    got_jax = tow_sketch_jax(
        jnp.asarray(elems), jnp.asarray(seeds), jnp.asarray(valid), ell=ell
    )
    assert np.array_equal(np.asarray(got_jax), exp)
    # the row form (the tree front end's tree_digest) agrees at one row
    rows = tree_digest(te[None, :], torch.from_numpy(valid)[None, :], ts, ell=ell)
    assert np.array_equal(rows[0].numpy(), exp)


# ---- K5: bin_parity_xorsum (single set, mod-n bins) ---------------------------


def _bin_parity_xorsum_three_way(elems, n_bins, seed):
    p_ref, xb_ref, x_ref = ref.bin_parity_xorsum_ref(elems, n_bins, seed)
    p_jax, xb_jax = bin_parity_xorsum_jax(jnp.asarray(elems), n_bins=n_bins, seed=seed)
    te = upload(elems, CPU)
    parity, xors = bin_parity_xorsum(te, n_bins=n_bins, seed=seed)
    assert parity.dtype == torch.int32 and xors.dtype == torch.int32
    assert parity.shape == (n_bins,) and xors.shape == (n_bins,)
    xor_bits = _bit_planes(xors)
    for got, exp in ((parity.numpy(), p_ref), (xor_bits, xb_ref),
                     (parity.numpy(), np.asarray(p_jax)), (xor_bits, np.asarray(xb_jax))):
        assert np.array_equal(got, exp)
    assert np.array_equal(_u32(xors), x_ref)
    p3, x3 = bin_parity_xorsum_plain(te, n_bins=n_bins, seed=seed)
    assert torch.equal(p3, parity) and torch.equal(x3, xors)
    p4, xb4, x4 = ref_port.bin_parity_xorsum_ref(elems, n_bins, seed)
    assert np.array_equal(p4, p_ref) and np.array_equal(xb4, xb_ref)
    assert np.array_equal(x4, x_ref)
    return parity, xors


@pytest.mark.parametrize("n_bins", [63, 127, 255, 1023, 8191, 28000])
@pytest.mark.parametrize("n_elems", [0, 1, 100, 1000, 5000, 8193])
def test_bin_parity_xorsum_sweep(n_bins, n_elems):
    rng = np.random.default_rng(n_bins + n_elems)
    elems = rng.integers(1, 1 << 32, size=n_elems, dtype=np.uint64).astype(np.uint32)
    _bin_parity_xorsum_three_way(elems, n_bins, 42)


@pytest.mark.parametrize("seed", [0, 7, 0xFFFFFFFF])
def test_bin_parity_xorsum_key_zero_flips_parity_only(seed):
    """A real key 0 is a member: its bin's parity flips, its fold does not
    change (the reference pads with a mask, not with zeros)."""
    rng = np.random.default_rng(3)
    elems = np.concatenate([[0, 0x80000000, 0xFFFFFFFF], _keys(rng, 997)]).astype(np.uint32)
    parity, xors = _bin_parity_xorsum_three_way(elems, 127, seed)
    p_wo, x_wo, _ = ref.bin_parity_xorsum_ref(elems[1:], 127, seed)
    zero_bin = int(ref.mix32_ref(np.zeros(1, np.uint32), seed)[0] % 127)
    assert parity[zero_bin] != p_wo[zero_bin]
    assert np.array_equal(np.delete(parity.numpy(), zero_bin), np.delete(p_wo, zero_bin))
    assert np.array_equal(_bit_planes(xors), x_wo)


def test_bin_parity_xorsum_rejects_too_many_bins():
    with pytest.raises(ValueError, match="n_bins"):
        bin_parity_xorsum(torch.zeros(4, dtype=torch.int32), n_bins=28001, seed=1)


def test_encode_group_end_to_end():
    code, code_p = BCHCode(127, 9), BCHCodePort(127, 9)
    rng = np.random.default_rng(1)
    elems = rng.integers(1, 1 << 32, size=500, dtype=np.uint64).astype(np.uint32)
    parity, xors, sketch = encode_group(upload(elems, CPU), code_p, seed=3)
    p_jax, x_jax, sk_jax = encode_group_jax(jnp.asarray(elems), code, seed=3)
    p_ref, _, xors_ref = ref.bin_parity_xorsum_ref(elems, 127, 3)
    assert np.array_equal(parity.numpy(), p_ref) and np.array_equal(_u32(xors), xors_ref)
    assert np.array_equal(parity.numpy(), np.asarray(p_jax))
    assert np.array_equal(_u32(xors), np.asarray(x_jax))
    assert np.array_equal(sketch.numpy(), np.asarray(sk_jax))
    assert np.array_equal(sketch.numpy(), sketch_from_positions(code, np.nonzero(p_ref)[0]))


def test_chien_matmul_finds_roots():
    code, code_p = BCHCode(127, 7), BCHCodePort(127, 7)
    gf = code.field
    rng = np.random.default_rng(2)
    pos = rng.choice(127, size=5, replace=False)
    lam = np.zeros(8, dtype=np.int64)      # Lambda(x) = prod (1 - alpha^p x)
    lam[0] = 1
    for p in pos:
        nxt = lam.copy()
        nxt[1:] ^= gf.mul(lam[:-1], gf.pow_alpha(p))
        lam = nxt
    bits = np.stack([gf.to_bits(lam).reshape(-1), rng.integers(0, 2, 8 * 7)]).astype(np.int32)
    ev = chien_eval_matmul(torch.from_numpy(bits), code_p)
    assert ev.shape == (2, 127, 7) and ev.dtype == torch.int32
    assert np.array_equal(ev.numpy(), np.asarray(chien_eval_matmul_jax(jnp.asarray(bits), code)))
    roots = np.nonzero(~ev[0].numpy().any(axis=1))[0]
    assert set(roots.tolist()) == set(pos.tolist())


def test_kernel_pipeline_vs_protocol_roundtrip():
    """encode_group on both sides -> XOR of sketches -> batched decode ->
    bins recover the difference, as the reference's pipeline does."""
    code, code_p = BCHCode(255, 11), BCHCodePort(255, 11)
    rng = np.random.default_rng(3)
    base = np.unique(rng.integers(1, 1 << 32, size=4000, dtype=np.uint64).astype(np.uint32))
    a, b = base, base[:-6]
    pa, xa, ska = encode_group(upload(a, CPU), code_p, seed=11)
    pb, xb, skb = encode_group(upload(b, CPU), code_p, seed=11)
    for got, exp in zip((pa, xa, ska, pb, xb, skb),
                        (*encode_group_jax(jnp.asarray(a), code, seed=11),
                         *encode_group_jax(jnp.asarray(b), code, seed=11))):
        assert np.array_equal(got.numpy().view(np.uint32), np.asarray(exp).view(np.uint32))
    ok, pos, cnt = bch_decode_batched((ska ^ skb)[None, :], n=255, t=11)
    assert bool(ok[0])
    recovered = {int(_u32(xa ^ xb)[p]) for p in pos[0][: int(cnt[0])].tolist()}
    assert len(recovered & (set(a.tolist()) ^ set(b.tolist()))) >= 4


@pytest.mark.parametrize("n_bins", [1, 2, 3, 63, 255, 8191, 28000])
def test_fastmod_magic_is_an_exact_remainder(n_bins):
    """K5 bins by ``h % n`` with the reciprocal the wrapper passes in, as the
    kernel takes it: the low 64 bits of M * h, then their product with n
    in two 32-bit halves — equal to ``h % n`` for every 32-bit h."""
    magic = fastmod_magic(n_bins)
    assert 0 <= magic < 1 << 64
    rng = np.random.default_rng(n_bins)
    edges = [0, 1, n_bins - 1, n_bins, n_bins + 1, 1 << 31, (1 << 32) - 1]
    for h in edges + rng.integers(0, 1 << 32, size=10_000, dtype=np.uint64).tolist():
        h = int(h)
        low = (magic * h) % (1 << 64)
        assert (low * n_bins) >> 64 == h % n_bins
        assert ((low >> 32) * n_bins + (((low & 0xFFFFFFFF) * n_bins) >> 32)) >> 32 == h % n_bins
