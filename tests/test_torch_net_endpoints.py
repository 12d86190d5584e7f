"""The port's wire pair (``repro_torch.net``) against the numpy oracles and
the JAX package's pair.

Alice and Bob run as separate port endpoints on the CPU exchanging only
``repro_torch.wire`` frames; every session's result — diff, rounds,
per-round *measured* byte ledger, split/fake counters, estimator bytes —
must equal ``repro_torch.core.pbs.reconcile`` and ``repro.core.pbs.reconcile``
(clones of tests/test_net_endpoints.py, the wire case of
tests/test_recon_batch.py and the pair half of
tests/test_protocol_conformance.py).  Then the same seeded sessions through
the port pair, the JAX pair and the oracle; and mixed pairs, a port
endpoint facing a JAX endpoint over the reference's transport.  Tolerance:
0 everywhere.
"""
import numpy as np
import pytest

import repro.core.pbs as ref_pbs
import repro.net as ref_net
import repro_torch.core.pbs as port_pbs
from repro_torch.core.pbs import PBSConfig, true_diff
from repro_torch.core.simdata import make_pair, make_pair_two_sided
from repro_torch.net import (
    AliceEndpoint,
    BobEndpoint,
    InMemoryDuplex,
    ReliableTransport,
    SimulatedChannel,
    run_pair,
    tcp_loopback_pair,
)
from repro_torch.recon import ReconcileServer

from _torch_port import RESULT_FIELDS

LEDGER_FIELDS = ("diff", "bytes_per_round", "bytes_sent", "estimator_bytes", "rounds",
                 "success", "decode_failures", "fake_rejections")
_EMPTY = np.zeros(0, dtype=np.uint32)


def _assert_oracle(got, a, b, cfg, dk):
    """Every ledger field == the port's oracle == the reference's oracle."""
    exp = port_pbs.reconcile(a, b, cfg, d_known=dk)
    ref = ref_pbs.reconcile(a, b, ref_pbs.PBSConfig(**vars(cfg)), d_known=dk)
    for f in LEDGER_FIELDS:
        assert getattr(got, f) == getattr(exp, f) == getattr(ref, f), f
    return exp


def _mixed_cases():
    """Sessions spanning several cohorts, estimator path, two-sided diffs."""
    cases = []
    for i, d in enumerate((5, 50)):
        a, b = make_pair(1500, d, np.random.default_rng(d))
        cases.append((a, b, PBSConfig(seed=10 + i), d))
    a, b = make_pair_two_sided(2000, 20, 12, np.random.default_rng(3))
    cases.append((a, b, PBSConfig(seed=2), 32))
    a, b = make_pair(2500, 40, np.random.default_rng(8))
    cases.append((a, b, PBSConfig(seed=5), None))   # ToW phase 0 on the wire
    return cases


def _run_cases(cases, ta, tb):
    alice, bob = AliceEndpoint(ta, device="cpu"), BobEndpoint(tb, device="cpu")
    for a, b, cfg, dk in cases:
        alice.submit(a, cfg=cfg, d_known=dk)
        bob.submit(b, cfg=cfg, d_known=dk)
    return alice, bob, run_pair(alice, bob)


def test_endpoints_in_memory_match_oracle():
    cases = _mixed_cases()
    ta, tb = InMemoryDuplex.pair()
    alice, bob, results = _run_cases(cases, ta, tb)
    for sid, (a, b, cfg, dk) in enumerate(cases):
        exp = _assert_oracle(results[sid], a, b, cfg, dk)
        assert exp.success and exp.diff == true_diff(a, b)
    assert alice.verified == bob.verified == [True] * len(cases)

    sa, sb = alice.wire_stats, bob.wire_stats
    assert sa["frame_bytes_out"] == sb["frame_bytes_in"]
    assert sa["frame_bytes_in"] == sb["frame_bytes_out"]
    assert sa["protocol_frame_bytes"] == sb["protocol_frame_bytes"]
    ledger = sum(results[s].bytes_sent for s in range(len(cases)))
    assert sa["protocol_frame_bytes"] >= ledger
    assert sa["protocol_frame_bytes"] - ledger < 32 * max(
        r.rounds for r in results.values()
    )
    est = sum(results[s].estimator_bytes for s in range(len(cases)))
    assert sa["estimator_frame_bytes"] == est
    # launch bookkeeping at the dispatch sites: 2 per cohort encode a side,
    # Bob one decode per cohort-round, Alice none
    assert alice.launches["kernel_launches"] == bob.launches["kernel_launches"] > 0
    assert alice.launches["kernel_launches"] % 2 == 0
    assert alice.launches["decode_launches"] == 0
    assert bob.launches["decode_launches"] == alice.launches["kernel_launches"] // 2


def test_endpoints_loopback_socket_match_oracle():
    cases = _mixed_cases()[:2]
    ta, tb = tcp_loopback_pair()
    try:
        alice, bob, results = _run_cases(cases, ta, tb)
        for sid, (a, b, cfg, dk) in enumerate(cases):
            exp = _assert_oracle(results[sid], a, b, cfg, dk)
            assert exp.success and exp.diff == true_diff(a, b)
        assert bob.verified == [True] * len(cases)
        assert alice.wire_stats["transport_bytes_out"] == alice.wire_stats["frame_bytes_out"]
    finally:
        ta.close()
        tb.close()


def test_endpoints_overload_split_and_budget_failure():
    a1, b1 = make_pair(2000, 10, np.random.default_rng(7))
    a2, b2 = make_pair(2500, 40, np.random.default_rng(17))
    cfg2 = PBSConfig(seed=6, n_override=255, t_override=8, g_override=1, max_rounds=12)
    a3, b3 = make_pair(2000, 30, np.random.default_rng(5))
    cfg3 = PBSConfig(seed=4, n_override=63, t_override=2, g_override=1, max_rounds=2)
    cases = [
        (a1, b1, PBSConfig(seed=21), 10),
        (a2, b2, cfg2, 40),
        (a3, b3, cfg3, 30),
    ]
    ta, tb = InMemoryDuplex.pair()
    alice, bob, results = _run_cases(cases, ta, tb)
    for sid, (a, b, cfg, dk) in enumerate(cases):
        _assert_oracle(results[sid], a, b, cfg, dk)
    assert results[1].decode_failures >= 1 and results[1].success
    assert not results[2].success
    assert bob.verified == [True, True, False]
    assert len(bob.sessions[1].state.units) == len(alice.sessions[1].state.units)


def test_endpoints_survive_lossy_channel_with_retransmits():
    a, b = make_pair(1200, 15, np.random.default_rng(11))
    cfg = PBSConfig(seed=9)
    ca, cb = SimulatedChannel.pair(loss=0.3, latency=0.001, seed=77)
    ra = ReliableTransport(ca, timeout=0.02)
    rb = ReliableTransport(cb, timeout=0.02)
    alice, bob = AliceEndpoint(ra, device="cpu"), BobEndpoint(rb, device="cpu")
    alice.submit(a, cfg=cfg, d_known=15)
    bob.submit(b, cfg=cfg, d_known=15)
    results = run_pair(alice, bob)
    _assert_oracle(results[0], a, b, cfg, 15)
    assert results[0].success and results[0].diff == true_diff(a, b)
    assert ca.dropped + cb.dropped >= 1
    assert ra.retransmits + rb.retransmits >= 1
    assert ca.bytes_out + cb.bytes_out > (
        alice.wire_stats["frame_bytes_out"] + bob.wire_stats["frame_bytes_out"]
    )


@pytest.mark.parametrize("transport", ["memory", "loopback"])
def test_wire_endpoints_match_engine_and_oracle_across_d(transport):
    """The multi-session grid (several code cohorts) over both transports:
    per session equal to the oracle, and the measured wire ledger equal to
    the port's batched engine's accounting."""
    sizes = {5: 1500, 50: 4000, 500: 8000}
    cases = []
    for i, d in enumerate(sorted(sizes)):
        a, b = make_pair(sizes[d], d, np.random.default_rng(d))
        cases.append((a, b, PBSConfig(seed=10 + i), d))
    ta, tb = InMemoryDuplex.pair() if transport == "memory" else tcp_loopback_pair()
    try:
        alice, bob, results = _run_cases(cases, ta, tb)
    finally:
        ta.close()
        tb.close()
    server = ReconcileServer(device="cpu")
    for a, b, cfg, d in cases:
        server.submit(a, b, cfg=cfg, d_known=d)
    engine = server.run()
    for sid, (a, b, cfg, d) in enumerate(cases):
        exp = _assert_oracle(results[sid], a, b, cfg, d)
        assert exp.success and exp.diff == true_diff(a, b)
        assert (results[sid].n, results[sid].t, results[sid].g) == (exp.n, exp.t, exp.g)
        assert results[sid].bytes_per_round == engine[sid].bytes_per_round
        assert results[sid].bytes_sent == engine[sid].bytes_sent
    assert bob.verified == [True] * len(cases)


# ---------------------------------------------------------------------------
# the pair half of tests/test_protocol_conformance.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "seed,d,size,know_d", [(5150, 7, 500, True), (9091, 33, 700, False)]
)
def test_seeded_pair_roundtrip(seed, d, size, know_d):
    d = max(1, min(d, size // 4))
    rng = np.random.default_rng(seed)
    a, b = make_pair(max(size, 4 * d), d, rng)
    cfg = PBSConfig(seed=seed & 0xFFFF)
    dk = d if know_d else None
    ta, tb = InMemoryDuplex.pair()
    _, _, results = _run_cases([(a, b, cfg, dk)], ta, tb)
    _assert_oracle(results[0], a, b, cfg, dk)


def _queue_fingerprint(st_):
    return [(u.uid, u.group, u.filters, u.done) for u in st_.units]


def _run_trace(pbs, rng, cfg, d: int):
    """Alice's state machine and Bob's frame-mirror rule (what
    ``BobEndpoint._handle_outcome`` applies) over one random (ok,
    checksum-settled) trace, on the ``core.pbs`` module ``pbs``; their
    queues must stay identical.  Returns (budget round, Alice's state,
    the fingerprint after every round)."""
    plan = pbs.plan_from_d_known(cfg, d)
    st_a = pbs.new_session_state(_EMPTY, _EMPTY, plan)
    st_b = pbs.new_session_state(_EMPTY, _EMPTY, plan)
    n = plan.n
    prints = []
    budget_hit_round = None
    for rnd in range(1, cfg.max_rounds + 3):
        live_a = pbs.session_live(st_a, cfg, rnd)
        assert live_a == pbs.session_live(st_b, cfg, rnd), rnd
        if not live_a:
            budget_hit_round = rnd
            break
        active_a, active_b = st_a.active_units(), st_b.active_units()
        k = len(active_a)
        ok = rng.random(k) > 0.3
        settle = rng.random(k) > 0.4
        csum_b = np.where(settle, 0, 1).astype(np.uint64)
        _, done = pbs.apply_round_outcomes(
            st_a, active_a, ok, [np.zeros(0, dtype=np.int64)] * k,
            np.zeros((k, n), np.uint32), np.zeros((k, n), np.uint32),
            np.zeros(k, dtype=np.uint64), csum_b, plan=plan, bin_seed=0, rnd=rnd,
        )
        for slot, u in enumerate(active_b):
            if not ok[slot]:
                pbs.queue_split(st_b, u, rnd, cfg.seed)
            elif done[slot]:
                u.done = True
        st_a.rounds = st_b.rounds = rnd
        assert _queue_fingerprint(st_a) == _queue_fingerprint(st_b), rnd
        assert done == list(ok & settle)
        prints.append(_queue_fingerprint(st_a))
    return budget_hit_round, st_a, prints


@pytest.mark.parametrize("seed", [7, 42, 1234])
def test_trace_alice_and_bob_mirrors_stay_identical(seed):
    kw = dict(seed=seed, n_override=127, t_override=5, g_override=4, max_rounds=6)
    cfg = PBSConfig(**kw)
    budget_round, st_a, prints = _run_trace(port_pbs, np.random.default_rng(seed), cfg, 20)
    assert budget_round is not None
    uids = [u.uid for u in st_a.units]
    assert sorted(uids) == list(range(len(uids)))
    for u in st_a.units:
        if u.uid >= cfg.g_override:
            assert len(u.filters) >= 1
    assert len(st_a.units) == cfg.g_override + 3 * st_a.decode_failures
    # the reference's state machine walks the same trace to the same queues
    ref_round, _, ref_prints = _run_trace(
        ref_pbs, np.random.default_rng(seed), ref_pbs.PBSConfig(**kw), 20)
    assert (ref_round, ref_prints) == (budget_round, prints)


def test_trace_budget_exhaustion_ordering():
    cfg = PBSConfig(seed=1, n_override=63, t_override=2, g_override=2, max_rounds=3)
    plan = port_pbs.plan_from_d_known(cfg, 6)
    st_a = port_pbs.new_session_state(_EMPTY, _EMPTY, plan)
    st_b = port_pbs.new_session_state(_EMPTY, _EMPTY, plan)
    for rnd in range(1, cfg.max_rounds + 1):
        assert port_pbs.session_live(st_a, cfg, rnd) and port_pbs.session_live(st_b, cfg, rnd)
        active = st_a.active_units()
        k = len(active)
        _, done = port_pbs.apply_round_outcomes(
            st_a, active, np.zeros(k, dtype=bool), [np.zeros(0, dtype=np.int64)] * k,
            np.zeros((k, plan.n), np.uint32), np.zeros((k, plan.n), np.uint32),
            np.zeros(k, np.uint64), np.zeros(k, np.uint64),
            plan=plan, bin_seed=0, rnd=rnd,
        )
        assert done == [False] * k
        for u in st_b.active_units():
            port_pbs.queue_split(st_b, u, rnd, cfg.seed)
    assert not port_pbs.session_live(st_a, cfg, cfg.max_rounds + 1)
    assert not port_pbs.session_live(st_b, cfg, cfg.max_rounds + 1)
    assert st_a.active_units() and st_b.active_units()
    assert _queue_fingerprint(st_a) == _queue_fingerprint(st_b)
    assert len(st_a.active_units()) == 2 * 3 ** cfg.max_rounds


# ---------------------------------------------------------------------------
# port pair == JAX pair == oracle; mixed pairs
# ---------------------------------------------------------------------------


def _three_cases():
    cases = []
    a, b = make_pair(1200, 12, np.random.default_rng(61))
    cases.append((a, b, PBSConfig(seed=31), 12))
    a, b = make_pair_two_sided(1500, 9, 6, np.random.default_rng(62))
    cases.append((a, b, PBSConfig(seed=32), 15))
    a, b = make_pair(1800, 25, np.random.default_rng(63))
    cases.append((a, b, PBSConfig(seed=33), None))
    return cases


def _drive(alice, bob, cases, runner):
    for a, b, cfg, dk in cases:
        alice.submit(a, cfg=cfg, d_known=dk)
        bob.submit(b, cfg=cfg, d_known=dk)
    return runner(alice, bob)


def test_port_pair_equals_jax_pair_and_oracle():
    cases = _three_cases()
    ref_cases = [(a, b, ref_pbs.PBSConfig(**vars(cfg)), dk) for a, b, cfg, dk in cases]
    ta, tb = InMemoryDuplex.pair()
    pa, pb = AliceEndpoint(ta, device="cpu"), BobEndpoint(tb, device="cpu")
    got = _drive(pa, pb, cases, run_pair)
    ra_t, rb_t = ref_net.InMemoryDuplex.pair()
    ra, rb = ref_net.AliceEndpoint(ra_t), ref_net.BobEndpoint(rb_t)
    want = _drive(ra, rb, ref_cases, ref_net.run_pair)
    assert got.keys() == want.keys()
    for sid, (a, b, cfg, dk) in enumerate(cases):
        for f in RESULT_FIELDS:
            assert getattr(got[sid], f) == getattr(want[sid], f), (sid, f)
        _assert_oracle(got[sid], a, b, cfg, dk)
    assert pa.verified == pb.verified == ra.verified == rb.verified == [True] * len(cases)
    # both pairs framed the same bytes in every category
    assert pa.wire_stats == ra.wire_stats
    assert pb.wire_stats == rb.wire_stats


@pytest.mark.parametrize("port_side", ["alice", "bob"])
def test_mixed_pair_interoperates(port_side):
    """Frames are the contract: a port endpoint faces a JAX endpoint over
    the reference's ``InMemoryDuplex``, and every session equals the
    oracle."""
    cases = _three_cases()
    ref_cases = [(a, b, ref_pbs.PBSConfig(**vars(cfg)), dk) for a, b, cfg, dk in cases]
    ta, tb = ref_net.InMemoryDuplex.pair()
    if port_side == "alice":
        alice, bob = AliceEndpoint(ta, device="cpu"), ref_net.BobEndpoint(tb)
    else:
        alice, bob = ref_net.AliceEndpoint(ta), BobEndpoint(tb, device="cpu")
    for (a, b, cfg, dk), (_, _, rcfg, _) in zip(cases, ref_cases):
        alice.submit(a, cfg=cfg if port_side == "alice" else rcfg, d_known=dk)
        bob.submit(b, cfg=rcfg if port_side == "alice" else cfg, d_known=dk)
    results = run_pair(alice, bob)
    for sid, (a, b, cfg, dk) in enumerate(cases):
        _assert_oracle(results[sid], a, b, cfg, dk)
    assert alice.verified == bob.verified == [True] * len(cases)
    assert alice.wire_stats["frame_bytes_out"] == bob.wire_stats["frame_bytes_in"]


def test_no_device_means_the_card():
    import torch

    ta, tb = InMemoryDuplex.pair()
    if torch.cuda.is_available():
        assert AliceEndpoint(ta).device.type == "cuda"
        assert BobEndpoint(tb).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        AliceEndpoint(ta)
    with pytest.raises(RuntimeError, match="CUDA"):
        BobEndpoint(tb)
    assert AliceEndpoint(ta, device="cpu").device.type == "cpu"
