"""The port's numpy protocol layer (repro_torch.core) == repro.core, exactly.

The port keeps its own copy of the numpy-only protocol modules (it imports
nothing of the JAX package); these tests hold the copy to the original on
seeded inputs, function by function and end to end.  Tolerance: 0.
"""
import numpy as np
import pytest
import torch

from repro.core import bch as bch_ref
from repro.core import gf2m as gf_ref
from repro.core import hashing as hash_ref
from repro.core import pbs as pbs_ref
from repro.core import tow as tow_ref
from repro.core.markov import optimize_parameters as optimize_ref
from repro_torch.core import bch as bch_port
from repro_torch.core import gf2m as gf_port
from repro_torch.core import hashing as hash_port
from repro_torch.core import pbs as pbs_port
from repro_torch.core import tow as tow_port
from repro_torch.core.markov import optimize_parameters as optimize_port
from repro_torch.core.simdata import make_pair, make_pair_two_sided

torch.set_num_threads(1)


def _keys(seed, size):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, size=size, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 0xDEADBEEF])
def test_mix32_and_hash_to_range(seed):
    keys = _keys(seed & 0xFFFF, 4096)
    assert np.array_equal(hash_port.mix32(keys, seed), hash_ref.mix32(keys, seed))
    for size in (3, 63, 255, 16383):
        assert np.array_equal(
            hash_port.hash_to_range(keys, size, seed),
            hash_ref.hash_to_range(keys, size, seed),
        )
    assert hash_port.derive_seed(seed, 2, 7) == hash_ref.derive_seed(seed, 2, 7)


@pytest.mark.parametrize("m,t", [(6, 7), (8, 8), (9, 10)])
def test_syndrome_matrices(m, t):
    fp, fr = gf_port.get_field(m), gf_ref.get_field(m)
    assert np.array_equal(fp.exp, fr.exp) and np.array_equal(fp.log, fr.log)
    assert np.array_equal(fp.syndrome_matrix(t), fr.syndrome_matrix(t))
    assert np.array_equal(
        fp.syndrome_matrix_range(t // 2, t), fr.syndrome_matrix_range(t // 2, t)
    )


@pytest.mark.parametrize("n,t", [(63, 8), (127, 13), (255, 9)])
def test_batched_decode(n, t):
    cp, cr = bch_port.BCHCode(n, t), bch_ref.BCHCode(n, t)
    rng = np.random.default_rng(t)
    sketches = []
    for _ in range(24):
        pos = rng.choice(n, size=int(rng.integers(0, t + 4)), replace=False)
        sp = bch_port.sketch_from_positions(cp, pos)
        assert np.array_equal(sp, bch_ref.sketch_from_positions(cr, pos))
        sketches.append(sp)
    sk = np.stack(sketches)
    ok_p, pos_p = bch_port.batched_decode(cp, sk)
    ok_r, pos_r = bch_ref.batched_decode(cr, sk)
    assert np.array_equal(ok_p, ok_r)
    for a, b in zip(pos_p, pos_r):
        assert np.array_equal(a, b)


def test_tow_sketches():
    keys = np.unique(_keys(3, 3000))
    assert np.array_equal(tow_port.tow_seeds(77, 128), tow_ref.tow_seeds(77, 128))
    assert np.array_equal(
        tow_port.tow_sketches(keys, 77, 128), tow_ref.tow_sketches(keys, 77, 128)
    )


@pytest.mark.parametrize("d", [5, 50, 500])
def test_plans(d):
    cfg_p, cfg_r = pbs_port.PBSConfig(seed=3), pbs_ref.PBSConfig(seed=3)
    pp, pr = pbs_port.plan_from_d_known(cfg_p, d), pbs_ref.plan_from_d_known(cfg_r, d)
    for f in ("n", "t", "g", "m", "d_est", "seed_groups", "est_bytes"):
        if hasattr(pr, f):
            assert getattr(pp, f) == getattr(pr, f), f
    assert optimize_port(d) == optimize_ref(d)


@pytest.mark.parametrize(
    "case",
    [
        ("one-sided", 4000, 60, 11, 60, False),
        ("estimator", 5000, 90, 12, None, False),
        ("two-sided rateless wrong d", 4000, 300, 13, 30, True),
    ],
    ids=lambda c: c[0],
)
def test_reconcile_end_to_end(case):
    _, size, d, seed, d_known, rateless = case
    rng = np.random.default_rng(seed)
    if rateless:
        a, b = make_pair_two_sided(size, d // 2, d - d // 2, rng)
    else:
        a, b = make_pair(size, d, rng)
    got = pbs_port.reconcile(
        a, b, pbs_port.PBSConfig(seed=seed, rateless=rateless), d_known=d_known
    )
    exp = pbs_ref.reconcile(
        a, b, pbs_ref.PBSConfig(seed=seed, rateless=rateless), d_known=d_known
    )
    fields = ("diff", "rounds", "success", "bytes_sent", "estimator_bytes",
              "bytes_per_round", "n", "t", "g", "d_est", "decode_failures",
              "fake_rejections")
    for f in fields:
        assert getattr(got, f) == getattr(exp, f), f
    assert got.success and got.diff == pbs_ref.true_diff(a, b)
