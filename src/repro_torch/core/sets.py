"""Set operations on 1-D key arrays, by sorting.

From numpy 2.3 on, ``np.unique`` (and ``np.setdiff1d`` and
``np.setxor1d``, which call it) finds the distinct values of an integer
array through a hash table.  On 10^6 distinct uint32 keys that takes about
0.5 s on an H100 machine's host, where sorting takes a few hundredths of
a second; every session, tree walk and sync epoch at |A| = 10^6 calls
them on whole sets.  These functions return exactly what the numpy
functions return for 1-D arrays (sorted, the input's dtype), whatever the
numpy version.
"""
from __future__ import annotations

import numpy as np


def unique_keys(x) -> np.ndarray:
    """``np.unique(x)``: the distinct values of ``x``, flattened and sorted."""
    s = np.sort(np.asarray(x).ravel())
    if s.size > 1:
        keep = np.empty(s.size, dtype=bool)
        keep[0] = True
        np.not_equal(s[1:], s[:-1], out=keep[1:])
        s = s[keep]
    return s


def _minus(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The values of sorted distinct ``a`` not in sorted distinct ``b``."""
    if not a.size or not b.size:
        return a
    at = np.searchsorted(b, a)
    np.minimum(at, b.size - 1, out=at)
    return a[b[at] != a]


def setdiff_keys(a, b) -> np.ndarray:
    """``np.setdiff1d(a, b)``: the distinct values of ``a`` not in ``b``, sorted."""
    return _minus(unique_keys(a), unique_keys(b))


def setxor_keys(a, b) -> np.ndarray:
    """``np.setxor1d(a, b)``: the values in exactly one of ``a`` and ``b``, sorted."""
    ua, ub = unique_keys(a), unique_keys(b)
    return np.sort(np.concatenate([_minus(ua, ub), _minus(ub, ua)]))
