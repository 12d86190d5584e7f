"""The baselines the paper evaluates against (PinSketch, Difference Digest,
Graphene, PinSketch/WP), carried over to ``repro_torch.core.baselines``.

The schemes are host protocols (numpy) in both packages.  The tests of
``tests/test_baselines.py`` run here against the port, with their
parameters; then every scheme's ``BaselineResult`` is held equal to the
reference's, field for field, on the same seeded inputs (tolerance 0), and
an IBF's cell arrays after the same inserts equal the reference's.
"""
import dataclasses

import numpy as np
import pytest

import repro.core.baselines as ref
from repro.core.simdata import make_pair
from repro_torch.core.baselines import (
    IBF,
    BaselineResult,
    ddigest_reconcile,
    graphene_reconcile,
    pinsketch_decode,
    pinsketch_encode,
    pinsketch_reconcile,
    pinsketch_wp_reconcile,
)


def _td(a, b):
    return set(int(x) for x in a) ^ set(int(x) for x in b)


# ---------------------------------------------------------------------------
# the reference's tests, on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [0, 1, 5, 20])
def test_pinsketch(d):
    rng = np.random.default_rng(d)
    a, b = make_pair(3000, d, rng)
    r = pinsketch_reconcile(a, b, t=max(d, 1) + 2)
    assert r.success and r.diff == _td(a, b)
    assert r.bytes_sent == ((max(d, 1) + 2) * 32 + 7) // 8


def test_pinsketch_overload_detected():
    rng = np.random.default_rng(5)
    a, b = make_pair(3000, 30, rng)
    r = pinsketch_reconcile(a, b, t=10)  # d > t: must not silently succeed
    assert not r.success


def test_ibf_peel_roundtrip():
    rng = np.random.default_rng(2)
    a, b = make_pair(5000, 25, rng)
    ibf_a = IBF(80, 4, seed=1)
    ibf_a.insert_all(a)
    ibf_b = IBF(80, 4, seed=1)
    ibf_b.insert_all(b)
    ok, rec = ibf_a.subtract(ibf_b).peel()
    assert ok and rec == _td(a, b)


@pytest.mark.parametrize("d", [5, 50, 300])
def test_ddigest(d):
    rng = np.random.default_rng(d)
    a, b = make_pair(20000, d, rng)
    r = ddigest_reconcile(a, b, d_plan=int(1.38 * d) + 2)
    assert r.success and r.diff == _td(a, b)


@pytest.mark.parametrize("d", [10, 100])
def test_graphene(d):
    rng = np.random.default_rng(d)
    a, b = make_pair(20000, d, rng)
    r = graphene_reconcile(a, b, d_plan=int(1.38 * d) + 2)
    assert r.success and r.diff == _td(a, b)


def test_pinsketch_wp():
    rng = np.random.default_rng(9)
    a, b = make_pair(20000, 60, rng)
    r = pinsketch_wp_reconcile(a, b, d_plan=60, t=13)
    assert r.success and r.diff == _td(a, b)
    assert r.rounds <= 3


# ---------------------------------------------------------------------------
# port == reference, field for field
# ---------------------------------------------------------------------------

# scheme -> (port function, reference function, keyword arguments from d)
SCHEMES = {
    "pinsketch": (pinsketch_reconcile, ref.pinsketch_reconcile,
                  lambda d: {"t": max(d, 1) + 2}),
    "pinsketch_wp": (pinsketch_wp_reconcile, ref.pinsketch_wp_reconcile,
                     lambda d: {"d_plan": max(d, 1), "t": 13, "seed": 4}),
    "ddigest": (ddigest_reconcile, ref.ddigest_reconcile,
                lambda d: {"d_plan": int(1.38 * d) + 2, "seed": 3}),
    "graphene": (graphene_reconcile, ref.graphene_reconcile,
                 lambda d: {"d_plan": int(1.38 * d) + 2, "seed": 5}),
}
CASES = [(s, d, None) for s in SCHEMES for d in (0, 1, 5, 20, 100)]
# PinSketch with t far below d: both packages must report the same failure
CASES.append(("pinsketch", 100, {"t": 10}))


@pytest.mark.parametrize("scheme,d,kw", CASES,
                         ids=[f"{s}-d{d}" + ("-overload" if kw else "") for s, d, kw in CASES])
def test_result_equals_reference(scheme, d, kw):
    port_fn, ref_fn, kw_of = SCHEMES[scheme]
    kw = kw or kw_of(d)
    a, b = make_pair(6000, d, np.random.default_rng(1000 + d))
    got, want = port_fn(a, b, **kw), ref_fn(a, b, **kw)
    assert isinstance(got, BaselineResult)
    assert [f.name for f in dataclasses.fields(got)] == [
        f.name for f in dataclasses.fields(want)] == ["diff", "success", "bytes_sent", "rounds"]
    for f in ("diff", "success", "bytes_sent", "rounds"):
        assert getattr(got, f) == getattr(want, f), f
    if kw is not None and scheme == "pinsketch" and kw.get("t") == 10:
        assert not got.success
    elif scheme != "pinsketch" or d + 2 <= kw["t"]:
        assert got.success and got.diff == _td(a, b)


def test_ibf_cells_and_sketches_equal_reference():
    """The same inserts leave the same cells; the same set gives the same
    PinSketch syndromes, and their XOR decodes to the same difference."""
    a, b = make_pair(5000, 25, np.random.default_rng(2))
    for cells, k, seed in ((80, 4, 1), (301, 3, 7)):
        mine, theirs = IBF(cells, k, seed=seed), ref.IBF(cells, k, seed=seed)
        mine.insert_all(a)
        theirs.insert_all(a)
        mine.insert_all(b[:100], sign=-1)
        theirs.insert_all(b[:100], sign=-1)
        for arr in ("id_sum", "hash_sum", "count"):
            got, want = getattr(mine, arr), getattr(theirs, arr)
            assert got.dtype == want.dtype and np.array_equal(got, want), arr
        assert mine.bytes == theirs.bytes
    sk_a, sk_b = pinsketch_encode(a, 27), pinsketch_encode(b, 27)
    assert np.array_equal(sk_a, ref.pinsketch_encode(a, 27))
    assert np.array_equal(sk_b, ref.pinsketch_encode(b, 27))
    ok, found = pinsketch_decode(sk_a ^ sk_b, a, 27)
    rok, rfound = ref.pinsketch_decode(sk_a ^ sk_b, a, 27)
    assert ok == rok and np.array_equal(found, rfound)
