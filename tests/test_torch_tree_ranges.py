"""K4's ragged entry on the CPU: ``tree_digest_ranges`` (row r =
``keys[lo[r] : lo[r] + cnt[r]]`` of one key array, the tree walk's form) ==
the JAX ``tree_digest`` (Pallas in interpret mode) on the reference's
``repro.tree.partition._range_matrix`` of the same ranges == the numpy
oracle, and the host work list of its CUDA kernel (``range_tiles``) covers
every key of every row exactly once.

The CUDA kernel itself is held against the same plain version, and against
the padded entry, on the card by ``chip_smoke.py``.  Tolerance: 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.tree_digest import tree_digest as tree_digest_jax
from repro.tree import partition as ref_tree
from repro_torch.kernels import platform
from repro_torch.kernels.platform import pow2_bucket, upload
from repro_torch.kernels.tree_digest import (
    RANGE_TILE,
    ragged_tile,
    range_rows,
    range_tiles,
    tree_digest,
    tree_digest_ranges,
    tree_digest_ranges_plain,
)

torch.set_num_threads(1)
CPU = torch.device("cpu")
TILE = 512   # TreeConfig().tile: the row-length floor of the ledger key


def _keys(rng, n):
    return np.sort(rng.choice(1 << 32, size=n, replace=False).astype(np.uint32))


def _ranges(case, rng):
    """(keys, lo, cnt) of each ragged case, as the walk hands them over."""
    if case == "zero_rows":
        keys = _keys(rng, 900)
        cnt = np.array([0, 40, 0, 0, 300, 1, 0, 33], dtype=np.int64)
        lo = np.array([0, 0, 40, 40, 41, 341, 342, 342], dtype=np.int64)
        return keys, lo, cnt
    if case == "last_key":
        keys = _keys(rng, 700)
        return keys, np.array([0, 100, 650], dtype=np.int64), np.array([100, 550, 50])
    if case == "stacked":                  # both sides, b's keys from len(a)
        a, b = _keys(rng, 600), _keys(rng, 450)
        bounds = np.array([0, 1 << 30, 1 << 31, 3 << 30, 1 << 32], dtype=np.int64)
        la, lb = np.searchsorted(a, bounds), np.searchsorted(b, bounds)
        rows = 4
        lo = np.zeros(2 * rows, np.int64)
        cnt = np.zeros(2 * rows, np.int64)
        lo[:rows], cnt[:rows] = la[:-1], np.diff(la)
        lo[rows:], cnt[rows:] = lb[:-1] + len(a), np.diff(lb)
        return np.concatenate([a, b]), lo, cnt
    if case == "pow2_rows":                # 5 ranges padded to 8 rows
        keys = _keys(rng, 500)
        cnt = np.array([70, 0, 130, 64, 200, 0, 0, 0], dtype=np.int64)
        lo = np.concatenate([[0], np.cumsum(cnt[:5])[:-1], [0, 0, 0]]).astype(np.int64)
        return keys, lo, cnt
    if case == "long_rows":                # rows over several kernel tiles
        keys = _keys(rng, 2 * RANGE_TILE + 1500)
        cnt = np.array([2 * RANGE_TILE + 1, RANGE_TILE, RANGE_TILE - 1, 0, 1499])
        lo = np.array([0, 0, 2 * RANGE_TILE + 1, 5, 2 * RANGE_TILE + 1])
        return keys, lo.astype(np.int64), cnt.astype(np.int64)
    if case == "empty_keys":
        return np.zeros(0, np.uint32), np.zeros(8, np.int64), np.zeros(8, np.int64)
    raise AssertionError(case)


CASES = ["zero_rows", "last_key", "stacked", "pow2_rows", "long_rows", "empty_keys"]


@pytest.mark.parametrize("case", CASES)
def test_ranges_equal_jax_on_reference_matrix(case):
    rng = np.random.default_rng(CASES.index(case) + 40)
    keys, lo, cnt = _ranges(case, rng)
    width = pow2_bucket(max(int(cnt.max()), 1), TILE)
    seeds = rng.integers(0, 1 << 32, size=32, dtype=np.uint64).astype(np.uint32)
    mat, valid = ref_tree._range_matrix(keys, lo, cnt, width)
    want = np.asarray(tree_digest_jax(jnp.asarray(mat), jnp.asarray(valid),
                                      jnp.asarray(seeds), ell=32, tile=TILE))
    oracle = np.stack([ref.tow_sketch_ref(keys[lo[r]: lo[r] + cnt[r]], seeds)
                       for r in range(len(cnt))])
    tk, ts = upload(keys, CPU), upload(seeds, CPU)
    got = tree_digest_ranges(tk, lo, cnt, ts, ell=32, width=width, tile=TILE)
    assert got.dtype == torch.int32 and got.shape == (len(cnt), 32)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), oracle)
    assert not got[torch.from_numpy(cnt == 0)].any()           # empty rows: zeros
    assert torch.equal(got, tree_digest_ranges_plain(tk, lo, cnt, ts, width=width))
    assert torch.equal(got, tree_digest(*range_rows(tk, lo, cnt, width), ts, tile=TILE))
    for dt in (np.int32, np.int64):                            # either index type
        assert torch.equal(got, tree_digest_ranges(tk, lo.astype(dt), cnt.astype(dt), ts,
                                                   width=width, tile=TILE))


@pytest.mark.parametrize("ell", [8, 64])
def test_ranges_other_ell_equal_oracle(ell):
    rng = np.random.default_rng(ell)
    keys, lo, cnt = _ranges("long_rows", rng)
    seeds = rng.integers(0, 1 << 32, size=ell, dtype=np.uint64).astype(np.uint32)
    got = tree_digest_ranges(upload(keys, CPU), lo, cnt, upload(seeds, CPU), ell=ell,
                             width=pow2_bucket(int(cnt.max()), TILE))
    oracle = np.stack([ref.tow_sketch_ref(keys[lo[r]: lo[r] + cnt[r]], seeds)
                       for r in range(len(cnt))])
    assert np.array_equal(got.numpy(), oracle)


def test_ranges_ledger_the_padded_variant():
    """The ragged entry keys the variant ledger exactly as the padded entry
    does for the same rows and ``width``: ``("tree_digest", (R, Ep, ell))``."""
    rng = np.random.default_rng(3)
    keys, lo, cnt = _ranges("pow2_rows", rng)
    tk, ts = upload(keys, CPU), torch.zeros(32, dtype=torch.int32)
    platform.clear_variant_ledger()
    before = platform.retrace_count()
    tree_digest(*range_rows(tk, lo, cnt, 512), ts, tile=TILE)
    assert platform.retrace_count() - before == 1
    tree_digest_ranges(tk, lo, cnt, ts, width=512, tile=TILE)      # same key: no new one
    tree_digest_ranges(tk, lo, cnt, ts, width=300, tile=TILE)      # Ep = 512 too
    assert platform.retrace_count() - before == 1
    assert ("tree_digest", (len(cnt), 512, 32)) in platform._SEEN_VARIANTS
    tree_digest_ranges(tk, lo, cnt, ts, width=1024, tile=TILE)     # Ep = 1024: new
    assert platform.retrace_count() - before == 2
    tree_digest(*range_rows(tk, lo, cnt, 1024), ts, tile=TILE)
    assert platform.retrace_count() - before == 2


def test_ranges_reject_bad_bounds():
    keys = upload(np.arange(10, dtype=np.uint32), CPU)
    seeds = torch.zeros(32, dtype=torch.int32)
    lo, cnt = np.array([0, 4]), np.array([4, 6])
    with pytest.raises(ValueError, match="width"):
        tree_digest_ranges(keys, lo, cnt, seeds, width=5)
    with pytest.raises(ValueError, match="past"):
        tree_digest_ranges(keys, np.array([0, 5]), cnt, seeds, width=8)
    with pytest.raises(ValueError, match="seeds"):
        tree_digest_ranges(keys, lo, cnt, seeds[:8], width=8)
    with pytest.raises(ValueError, match="negative"):
        tree_digest_ranges(keys, np.array([0, -1]), cnt, seeds, width=8)


@pytest.mark.parametrize("tile", [32, RANGE_TILE])
def test_range_tiles_cover_every_key_once(tile):
    """The host work list of the ragged kernel: item r < R is the head of row
    r, then (row, start, length) tail tiles; together they hold every key
    of every row exactly once, each item at most ``tile`` keys long."""
    rng = np.random.default_rng(tile)
    cnt = rng.integers(0, 5 * tile, size=40)
    cnt[:6] = [0, 1, tile - 1, tile, tile + 1, 3 * tile]
    lo = rng.integers(0, 10_000, size=40)
    desc, n_tail = range_tiles(lo, cnt, tile)
    R = len(cnt)
    assert desc.dtype == np.int32 and len(desc) == 2 * R + 3 * n_tail
    assert np.array_equal(desc[:R], lo) and np.array_equal(desc[R: 2 * R], cnt)
    tail = desc[2 * R:].reshape(-1, 3)
    assert n_tail == int(np.maximum(-(-cnt // tile) - 1, 0).sum())
    covered = [[] for _ in range(R)]
    for r in range(R):
        covered[r].extend(range(lo[r], lo[r] + min(cnt[r], tile)))
    for row, start, length in tail:
        assert 0 < length <= tile
        covered[row].extend(range(start, start + length))
    for r in range(R):
        assert sorted(covered[r]) == list(range(lo[r], lo[r] + cnt[r])), r


def test_ragged_tile_fills_the_card_within_bounds():
    """Items of a power of two in [32, RANGE_TILE] keys, about 32 per SM:
    a 2-million-key root level keeps the longest items, a small level gets
    one group of 32 keys an item."""
    assert ragged_tile(1_990_000, 132) == RANGE_TILE
    assert ragged_tile(13_460, 132) == 32
    assert ragged_tile(0, 132) == 32
    assert ragged_tile(132 * 32 * 100, 132) == 128
    sizes = [ragged_tile(n, 132) for n in range(0, 3_000_000, 9_973)]
    assert sizes == sorted(sizes)
    assert all(t in (32, 64, 128, 256, 512) for t in sizes)


def test_ragged_kernel_entry_point_in_source():
    text = (platform.CSRC / "tow_sketch.cu").read_text()
    for name in ("tow_sketch_launch", "tow_ranges_launch"):
        assert f'extern "C" int {name}(' in text, name
