"""The port's ``ReconcileServer`` in its three non-default modes, each held
against the JAX package's server (results and integer ledgers) on the CPU:
rateless recovery at a 10x-underestimated d̂, ``degrade=True`` escalation,
and one ``continuous=True`` epoch over the resident stores.  Tolerance: 0.
"""
import numpy as np
import torch

from repro.core.pbs import PBSConfig, reconcile, true_diff
from repro.core.simdata import make_pair
from repro.recon import ReconcileServer as RefServer
from repro_torch.recon import ReconcileServer as PortServer

from _torch_port import (
    assert_oracle,
    assert_same_ledgers,
    assert_same_result,
    run_both,
    submit_all,
)

torch.set_num_threads(1)


def test_rateless_underestimated_d():
    a, b = make_pair(3000, 100, np.random.default_rng(10))
    cases = [(a, b, PBSConfig(seed=3, rateless=True), 10)]
    port, got, _, _ = run_both(cases, degrade=True)
    assert_oracle(got, cases)
    assert got[0].success and got[0].diff == true_diff(a, b)
    assert port.stats["parity_extensions"] > 0
    assert port.stats["sessions_degraded"] == 0
    assert port.stats["store_builds"] == 1
    # extension levels cost two launches each on top of two per cohort-round
    extra = port.stats["kernel_launches"] - 2 * port.stats["cohort_rounds"]
    assert extra > 0 and extra % 2 == 0


def test_rateless_rides_with_honest_neighbour():
    a1, b1 = make_pair(3000, 100, np.random.default_rng(10))
    a2, b2 = make_pair(2000, 10, np.random.default_rng(12))
    cases = [
        (a1, b1, PBSConfig(seed=3, rateless=True), 10),
        (a2, b2, PBSConfig(seed=3), 10),          # same cohort, not rateless
    ]
    _, got, _, _ = run_both(cases)
    assert_oracle(got, cases)


def _degradation_inputs():
    rng = np.random.default_rng(11)
    univ = rng.choice(1 << 20, size=4000, replace=False).astype(np.uint32)
    a, b = univ[:3500], univ[500:]
    return a, b, PBSConfig(seed=5, max_rounds=2), 250


def test_degrade_escalation():
    a, b, cfg, dk = _degradation_inputs()
    port, got, _, _ = run_both([(a, b, cfg, dk)], degrade=True)
    assert got[0].success and got[0].diff == true_diff(a, b)
    assert port.stats["sessions_degraded"] >= 1
    # without degradation the same inputs fail, identically in both
    _, plain, _, _ = run_both([(a, b, cfg, dk)])
    assert not plain[0].success


def _churn(rng, base, n_add, n_remove):
    removed = rng.permutation(base)[:n_remove]
    added = rng.integers(1, 1 << 32, size=n_add, dtype=np.uint64).astype(np.uint32)
    return added, removed


def test_continuous_epoch_patches_resident_stores():
    cfgs = [
        PBSConfig(seed=2001 + s, n_override=127, t_override=7, g_override=3)
        for s in range(2)
    ]
    dks = [12, None]                      # one pinned, one estimator session
    cases = [
        (*make_pair(500, 12, np.random.default_rng(2001 + 31 * s)), cfgs[s], dks[s])
        for s in range(2)
    ]
    port, ref = PortServer(device="cpu", continuous=True), RefServer(continuous=True)
    submit_all(port, cases)
    submit_all(ref, cases)
    got, exp = port.run(), ref.run()
    for sid in exp:
        assert_same_result(got[sid], exp[sid], sid)
    assert_same_ledgers(port, ref)
    assert port.stats["store_builds"] > 0

    rng = np.random.default_rng(7)
    muts = {}
    for s in range(2):
        st = ref.sessions[s].state
        muts[s] = (*_churn(rng, st.a, 4, 3), *_churn(rng, st.b, 5, 2))
    assert port.advance_epoch(muts) == ref.advance_epoch(muts) == 1
    got, exp = port.run(), ref.run()
    assert_same_ledgers(port, ref)
    assert port.stats["store_builds"] == 0 and port.stats["h2d_store_bytes"] == 0
    assert port.stats["h2d_delta_bytes"] > 0 and port.stats["epoch"] == 1
    for s in range(2):
        assert_same_result(got[s], exp[s], s)
        sp, sr = port.sessions[s].state, ref.sessions[s].state
        assert np.array_equal(sp.a, sr.a) and np.array_equal(sp.b, sr.b)
        oracle = reconcile(sp.a, sp.b, cfgs[s], d_known=dks[s])
        assert got[s].success and got[s].diff == oracle.diff == true_diff(sp.a, sp.b)
        assert got[s].bytes_per_round == oracle.bytes_per_round
    # the patched device rows hold exactly the host mirror's live elements
    for store in port._batch._stores.values():
        for side in store.sides.values():
            flat = side.flat.numpy().view(np.uint32)
            assert np.array_equal(side.cnt.numpy(), side.cnt_host)
            for row, (s0, c) in enumerate(zip(side.start_host, side.cnt_host)):
                assert np.array_equal(flat[s0 : s0 + c], side.flat_host[s0 : s0 + c])
