"""``repro_torch.core.sets`` against the numpy functions it stands in for.

Each function must return exactly what ``np.unique``, ``np.setdiff1d`` and
``np.setxor1d`` return on 1-D arrays: the same values, in the same
(sorted) order, with the same dtype.  Tolerance: none (integer arrays).
"""
import numpy as np
import pytest

from repro_torch.core.sets import setdiff_keys, setxor_keys, unique_keys

CASES = [
    # (size of a, size of b, value range, dtype)
    (0, 0, 10, np.uint32),
    (0, 5, 10, np.uint32),
    (5, 0, 10, np.uint32),
    (1, 1, 2, np.uint32),
    (200, 150, 64, np.uint32),            # many repeats on both sides
    (5000, 4000, 1 << 32, np.uint32),     # nearly all distinct, the key sets' case
    (3000, 3000, 1 << 12, np.int64),
]


def _draw(rng, n, hi, dtype):
    return rng.integers(0, hi, size=n, dtype=np.uint64).astype(dtype)


@pytest.mark.parametrize("na,nb,hi,dtype", CASES)
def test_matches_numpy(na, nb, hi, dtype):
    rng = np.random.default_rng(na * 7 + nb)
    a, b = _draw(rng, na, hi, dtype), _draw(rng, nb, hi, dtype)
    if na and nb:
        b[: nb // 3] = a[: nb // 3]          # shared keys
    for got, want in ((unique_keys(a), np.unique(a)),
                      (setdiff_keys(a, b), np.setdiff1d(a, b)),
                      (setdiff_keys(b, a), np.setdiff1d(b, a)),
                      (setxor_keys(a, b), np.setxor1d(a, b))):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_extremes_and_lists():
    """The largest key, a value past every key of the other side, and list
    input."""
    top = np.uint32(0xFFFFFFFF)
    a = np.array([top, 0, 5, 5, top], dtype=np.uint32)
    b = np.array([5, 7], dtype=np.uint32)
    np.testing.assert_array_equal(setdiff_keys(a, b), np.setdiff1d(a, b))
    np.testing.assert_array_equal(setxor_keys(a, b), np.setxor1d(a, b))
    np.testing.assert_array_equal(unique_keys([3, 1, 3]), np.unique([3, 1, 3]))
    assert unique_keys(a).dtype == np.uint32
