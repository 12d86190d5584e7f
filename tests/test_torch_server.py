"""The slice as a whole, on the CPU: the port's ``ReconcileServer`` ==
``repro.recon.ReconcileServer`` == ``repro.core.pbs.reconcile`` on every
``ReconcileResult`` field, and the servers' integer ``stats`` ledgers equal.

Cases are those of ``tests/test_recon_batch.py`` that need no wire
endpoints.  Tolerance: 0.
"""
import numpy as np
import torch

from repro.core.pbs import PBSConfig, true_diff
from repro.core.simdata import make_pair, make_pair_two_sided
from repro_torch.kernels import platform
from repro_torch.recon import ReconcileServer, reconcile_batch

from _torch_port import assert_oracle, run_both, submit_all

torch.set_num_threads(1)
SIZES = {5: 1500, 50: 4000, 500: 5000}


def _mixed_cases():
    cases = []
    for i, d in enumerate(sorted(SIZES)):
        a, b = make_pair(SIZES[d], d, np.random.default_rng(d))
        cases.append((a, b, PBSConfig(seed=10 + i), d))
    return cases


def test_mixed_d_three_way():
    cases = _mixed_cases()
    _, got, _, _ = run_both(cases)
    assert_oracle(got, cases)
    for sid, (a, b, _, _) in enumerate(cases):
        assert got[sid].success and got[sid].diff == true_diff(a, b)


def test_estimator_and_two_sided_three_way():
    a1, b1 = make_pair(5000, 80, np.random.default_rng(2))
    a2, b2 = make_pair_two_sided(5000, 30, 20, np.random.default_rng(3))
    cases = [(a1, b1, PBSConfig(seed=8), None), (a2, b2, PBSConfig(seed=2), 50)]
    port, got, ref, _ = run_both(cases)
    assert_oracle(got, cases)
    assert got[0].estimator_bytes > 0
    for sid, (a, b, _, _) in enumerate(cases):
        assert got[sid].success and got[sid].diff == true_diff(a, b)
    # phase 0 pinned the same plan from the same ToW numerators
    for sp, sr in zip(port.sessions, ref.sessions):
        assert (sp.plan.n, sp.plan.t, sp.plan.g, sp.plan.d_est) == (
            sr.plan.n, sr.plan.t, sr.plan.g, sr.plan.d_est)


def test_forced_overload_splits_without_perturbing_neighbours():
    a_f, b_f = make_pair(5000, 40, np.random.default_rng(17))
    cfg_f = PBSConfig(seed=6, n_override=255, t_override=8, g_override=1, max_rounds=12)
    cases = [
        (*make_pair(2000, 10, np.random.default_rng(7)), PBSConfig(seed=21), 10),
        (a_f, b_f, cfg_f, 40),
        (*make_pair(3000, 25, np.random.default_rng(9)), PBSConfig(seed=23), 25),
    ]
    _, got, _, _ = run_both(cases)
    assert_oracle(got, cases)
    assert got[1].decode_failures >= 1 and got[1].rounds > 1
    assert got[1].success and got[1].diff == true_diff(a_f, b_f)


def test_round_budget_failure():
    a, b = make_pair(2000, 30, np.random.default_rng(5))
    cfg = PBSConfig(seed=4, n_override=63, t_override=2, g_override=1, max_rounds=2)
    cases = [(a, b, cfg, 30)]
    _, got, _, _ = run_both(cases)
    assert_oracle(got, cases)
    assert not got[0].success


def test_reconcile_batch_convenience_order():
    pairs = [make_pair(1200, d, np.random.default_rng(40 + d)) for d in (3, 7, 11)]
    results = reconcile_batch(
        pairs, cfgs=PBSConfig(seed=5), d_knowns=[3, 7, 11], device="cpu"
    )
    for (a, b), res in zip(pairs, results):
        assert res.success and res.diff == true_diff(a, b)


def test_retraces_cold_then_warm():
    """The variant ledger counts on a cold start and reads 0 on an identical
    second server — a ledger nothing increments would not."""
    cases = _mixed_cases()[:2]
    platform.clear_variant_ledger()
    cold = ReconcileServer(device="cpu")
    submit_all(cold, cases)
    cold.run()
    assert cold.stats["retraces"] > 0
    by_fn = platform.retrace_counts()
    assert by_fn["execute_round"] > 0 and by_fn["bch_decode_batched"] > 0
    warm = ReconcileServer(device="cpu")
    submit_all(warm, cases)
    warm.run()
    assert warm.stats["retraces"] == 0
    assert warm.stats["cohort_rounds"] == cold.stats["cohort_rounds"] > 0


def test_second_run_is_idempotent():
    cases = _mixed_cases()[:1]
    server = ReconcileServer(device="cpu")
    submit_all(server, cases)
    first = server.run()
    stats = dict(server.stats)
    again = server.run()
    assert again == first
    assert server.stats["rounds"] == stats["rounds"]
    assert server.stats["h2d_bytes"] == stats["h2d_bytes"]
