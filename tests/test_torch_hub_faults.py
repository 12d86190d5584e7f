"""The port's hub under faults: dropped, silent, evicted, crashed and
resumed peers, against the numpy oracles and the JAX package's hub.

Clones of the hub cases of tests/test_net_transport_faults.py, the
hub/resume rows of tests/test_resilience.py, the mid-ladder resume of
tests/test_rateless.py and the out-of-regime eviction of
tests/test_tree_conformance.py, with the reference's deadlines and fault
plans unchanged.  Scenarios whose outcome does not depend on timing run on
the port's hub and on the JAX hub at once and are held equal (results,
outcomes, ``stats``, ``wire_stats``); the deadline-driven ones run on the
port alone.  Every surviving session equals both packages'
``core.pbs.reconcile``.  Tolerance: 0.
"""
import threading
import time

import numpy as np
import pytest

from repro_torch.core.pbs import PBSConfig, reconcile, true_diff
from repro_torch.core.simdata import make_pair
from repro_torch.net import (
    AliceEndpoint,
    ChaosTransport,
    FaultPlan,
    HubEndpoint,
    InMemoryDuplex,
    ReliableTransport,
    SimulatedChannel,
    Transport,
    TransportError,
    TransportTimeout,
    classify_error,
    run_hub,
)
from repro_torch.net.hub import _drive_hub
from repro_torch.tree import TreeConfig, leaf_slices, partition_pair
from repro_torch.wire.frames import WireError

from _torch_hub import (
    assert_oracle,
    assert_same_outcomes,
    assert_same_results,
    assert_same_stats,
    both,
    close_after,
)

# the replayed outcome frame of one round barrier (1 session, g <= 8 units)
# is far under this; the replay ledger must stay within it per resume
_BARRIER_FRAME_BOUND = 64


def _hub(**kw):
    return HubEndpoint(device="cpu", **kw)


def _alice(t, **kw):
    return AliceEndpoint(t, device="cpu", **kw)


# ---------------------------------------------------------------------------
# one of N peers drops at each protocol phase (port hub == JAX hub)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "mode,n_sends,phase",
    [
        ("known", 0, "before round 1"),
        ("known", 1, "after round-1 sketches, before outcome"),
        ("known", 2, "after round 1, at the verify exchange"),
        ("est", 0, "before the phase-0 ToW sketch"),
        ("est", 1, "after phase 0, before round 1"),
    ],
)
def test_hub_peer_drop_at_each_phase(mode, n_sends, phase):
    ah, bh = make_pair(600, 6, np.random.default_rng(11))
    ad, bd = make_pair(600, 5, np.random.default_rng(13))
    dk = 5 if mode == "known" else None

    def scenario(pkg):
        hub = pkg.hub(recv_deadline=15.0)
        cfg_h, cfg_d = pkg.PBSConfig(seed=21), pkg.PBSConfig(seed=31)
        th_a, th_b = pkg.net.InMemoryDuplex.pair()
        ch_ok = hub.add_peer(th_b, label="healthy")
        hub.submit(ch_ok, bh, cfg=cfg_h, d_known=6)
        ep_ok = pkg.alice(th_a, channel=ch_ok)
        ep_ok.submit(ah, cfg=cfg_h, d_known=6)
        td_a, td_b = pkg.net.InMemoryDuplex.pair()
        ch_bad = hub.add_peer(td_b, label="dropper")
        hub.submit(ch_bad, bd, cfg=cfg_d, d_known=dk)
        ep_bad = pkg.alice(close_after(pkg, td_a, n_sends), channel=ch_bad)
        ep_bad.submit(ad, cfg=cfg_d, d_known=dk)
        return (hub, *pkg.net.run_hub(hub, {ch_ok: ep_ok, ch_bad: ep_bad}))

    (hub, outcomes, results, errors), (rhub, routcomes, rresults, rerrors) = both(scenario)
    ch_ok, ch_bad = 1, 2
    got = results[ch_ok][0]
    exp = assert_oracle(got, ah, bh, PBSConfig(seed=21), 6)
    assert exp.diff == true_diff(ah, bh), phase
    assert outcomes[ch_ok].ok and outcomes[ch_ok].verified == [True], phase
    assert not outcomes[ch_bad].ok, phase
    assert isinstance(outcomes[ch_bad].error, TransportError), phase
    assert all(s.failed for s in outcomes[ch_bad].sessions), phase
    assert isinstance(errors.get(ch_bad), TransportError), phase
    assert ch_bad in hub.stale_channels
    assert_same_results(results, rresults)
    assert_same_outcomes(outcomes, routcomes)
    assert_same_stats(hub.stats, rhub.stats)
    assert errors.keys() == rerrors.keys()


# ---------------------------------------------------------------------------
# stragglers and evictions (deadline-driven: the port hub alone)
# ---------------------------------------------------------------------------


def test_hub_admission_straggler_does_not_stall_other_joiners():
    """A silent estimator joiner must not delay the other peers' phase-0
    admission: the ToW exchanges are polled round-robin."""
    hub = _hub(recv_deadline=2.0)
    ts_a, ts_b = InMemoryDuplex.pair()
    ch_silent = hub.add_peer(ts_b, label="silent-est")
    a0, b0 = make_pair(500, 5, np.random.default_rng(29))
    hub.submit(ch_silent, b0, cfg=PBSConfig(seed=51))

    ah, bh = make_pair(700, 9, np.random.default_rng(31))
    cfg_h = PBSConfig(seed=53)
    th_a, th_b = InMemoryDuplex.pair()
    ch_ok = hub.add_peer(th_b, label="healthy-est")
    hub.submit(ch_ok, bh, cfg=cfg_h)
    ep_ok = _alice(th_a, channel=ch_ok)
    ep_ok.submit(ah, cfg=cfg_h)

    outcomes, results, errors = run_hub(hub, {ch_ok: ep_ok})
    exp = assert_oracle(results[ch_ok][0], ah, bh, cfg_h, None)
    assert exp.diff == true_diff(ah, bh)
    assert outcomes[ch_ok].ok and outcomes[ch_ok].verified == [True]
    assert not outcomes[ch_silent].ok
    assert isinstance(outcomes[ch_silent].error, TransportError)
    assert "admission deadline" in str(outcomes[ch_silent].error)


def test_hub_straggler_on_lossy_simulated_channel():
    """A peer behind a 100%-loss SimulatedChannel is a straggler: the hub's
    barrier deadline evicts it; the in-memory peer is untouched."""
    hub = _hub(recv_deadline=2.0)
    ah, bh = make_pair(600, 6, np.random.default_rng(19))
    cfg_h = PBSConfig(seed=41)
    th_a, th_b = InMemoryDuplex.pair()
    ch_ok = hub.add_peer(th_b)
    hub.submit(ch_ok, bh, cfg=cfg_h, d_known=6)
    ep_ok = _alice(th_a, channel=ch_ok)
    ep_ok.submit(ah, cfg=cfg_h, d_known=6)

    ca, cb = SimulatedChannel.pair(loss=1.0, seed=7)
    rt_hub = ReliableTransport(cb, timeout=0.02, max_retries=5)
    ch_slow = hub.add_peer(rt_hub, label="straggler")
    a2, b2 = make_pair(600, 5, np.random.default_rng(23))
    hub.submit(ch_slow, b2, cfg=PBSConfig(seed=43), d_known=5)

    outcomes, results, errors = run_hub(hub, {ch_ok: ep_ok})
    assert_oracle(results[ch_ok][0], ah, bh, cfg_h, 6)
    assert outcomes[ch_ok].ok
    assert not outcomes[ch_slow].ok
    assert isinstance(outcomes[ch_slow].error, TransportError)
    assert "deadline" in str(outcomes[ch_slow].error)


@pytest.mark.parametrize("kind", ["memory", "tcp", "simulated"])
def test_evict_mid_protocol_fails_peer_cleanly_no_hang(kind):
    """Evicting a peer while it is mid-exchange surfaces a clean, prompt
    TransportError on the peer's thread on every transport flavor, while a
    healthy neighbor completes equal to the oracle."""
    from repro_torch.net import tcp_loopback_pair

    if kind == "memory":
        ta, th = InMemoryDuplex.pair()
    elif kind == "tcp":
        ta, th = tcp_loopback_pair()
    else:
        ca, cb = SimulatedChannel.pair(latency=0.001)
        ta = ReliableTransport(ca, timeout=0.02, max_retries=100)
        th = ReliableTransport(cb, timeout=0.02, max_retries=100)

    cfg = PBSConfig(seed=3, n_override=127, t_override=7, g_override=4)
    av, bv = make_pair(700, 60, np.random.default_rng(5))
    hub = _hub(recv_deadline=30.0)
    ch_bad = hub.add_peer(th, label="victim")
    hub.submit(ch_bad, bv, cfg=cfg, d_known=60)
    ep_bad = _alice(ta, channel=ch_bad)
    ep_bad.submit(av, cfg=cfg, d_known=60)

    ah, bh = make_pair(700, 60, np.random.default_rng(6))
    cfg_h = PBSConfig(seed=4, n_override=127, t_override=7, g_override=4)
    to_a, to_h = InMemoryDuplex.pair()
    ch_ok = hub.add_peer(to_h, label="healthy")
    hub.submit(ch_ok, bh, cfg=cfg_h, d_known=60)
    ep_ok = _alice(to_a, channel=ch_ok)
    ep_ok.submit(ah, cfg=cfg_h, d_known=60)

    def on_barrier(rnd):
        peer = hub._peers[ch_bad]
        if rnd >= 1 and not peer.retired:
            hub._evict(peer, TransportError("operator eviction"))

    hub.on_barrier = on_barrier
    seen: dict = {}

    def drive_victim():
        t0 = time.monotonic()
        try:
            ep_bad.run()
            seen["res"] = "completed"
        except TransportError as e:
            seen["err"] = e
        seen["dt"] = time.monotonic() - t0

    ok_res: dict = {}
    th_bad = threading.Thread(target=drive_victim, daemon=True)
    th_ok = threading.Thread(target=lambda: ok_res.update(r=ep_ok.run()), daemon=True)
    th_bad.start()
    th_ok.start()
    outcomes = hub.serve()
    th_bad.join(timeout=15.0)
    th_ok.join(timeout=15.0)

    assert not th_bad.is_alive(), f"{kind}: victim thread leaked"
    assert not th_ok.is_alive(), f"{kind}: healthy thread leaked"
    assert "err" in seen, f"{kind}: victim never saw the eviction: {seen}"
    assert isinstance(seen["err"], TransportError), kind
    assert not isinstance(seen["err"], TransportTimeout), kind
    assert seen["dt"] < 15.0, f"{kind}: not prompt: {seen['dt']:.1f}s"
    assert not outcomes[ch_bad].ok
    assert outcomes[ch_bad].error_kind == "transport"
    assert ch_bad in hub.stale_channels
    exp = assert_oracle(ok_res["r"][0], ah, bh, cfg_h, 60)
    assert outcomes[ch_ok].ok and outcomes[ch_ok].verified == [True]
    assert exp.diff == true_diff(ah, bh)


# ---------------------------------------------------------------------------
# crash -> reconnect -> resume against a live hub
# ---------------------------------------------------------------------------


def _crash_pair(seed=7, size=3000, cut=400, cfg_seed=3):
    rng = np.random.default_rng(seed)
    univ = rng.choice(1 << 20, size=size, replace=False).astype(np.uint32)
    a, b = univ[: size - cut], univ[cut:]
    return a, b, len(np.setxor1d(a, b)), cfg_seed


def _resume_scenario(a, b, cfg_kw, dk, plan_kw, hub_kw=None, tree=False):
    """One peer whose transport crashes under ``FaultPlan(**plan_kw)``,
    reconnects over a fresh duplex and resumes through ``MSG_RESUME``."""
    def scenario(pkg):
        cfg = pkg.PBSConfig(**cfg_kw)
        t_a_raw, t_h = pkg.net.InMemoryDuplex.pair()
        t_a = pkg.net.ChaosTransport(t_a_raw, pkg.net.FaultPlan(**plan_kw))
        hub = pkg.hub(**(hub_kw or dict(resume_window=30.0, recv_deadline=10.0)))
        ch = hub.add_peer(t_h, label="crasher")
        ep = pkg.alice(t_a, channel=ch)
        if tree:
            hub.submit_tree(ch, b, cfg=cfg)
            ep.submit_tree(a, cfg)
        else:
            hub.submit(ch, b, cfg=cfg, d_known=dk)
            ep.submit(a, cfg=cfg, d_known=dk)
        pending: dict = {}

        def on_barrier(rnd):
            if "t" in pending and hub._peers[ch].suspended:
                hub.resume_peer(ch, pending.pop("t"))

        hub.on_barrier = on_barrier
        state: dict = {}

        def drive():
            try:
                state["res"] = ep.run()
                return
            except pkg.net.TransportError as e:
                state["crash"] = e
            na, nh = pkg.net.InMemoryDuplex.pair()
            pending["t"] = nh
            ep.resume(na)
            state["res"] = ep.resume_run()

        th = threading.Thread(target=drive, daemon=True)
        th.start()
        outcomes = hub.serve()
        th.join(timeout=60)
        assert not th.is_alive(), "peer thread leaked"
        assert "crash" in state, "scripted crash never fired"
        return hub, ep, outcomes, state["res"], ch

    return scenario


@pytest.mark.parametrize(
    "crash_after,case",
    [
        (1, "replay: outcome frame died in flight, hub one barrier behind"),
        (2, "equal barriers: crash between completed rounds"),
    ],
)
def test_crash_resume_byte_identical(crash_after, case):
    a, b, d, s = _crash_pair()
    (hub, ep, outcomes, res, ch), ref = both(
        _resume_scenario(a, b, dict(seed=s), d, dict(crash_after_sends=crash_after)))
    outcome, st = outcomes[ch], hub.stats
    assert outcome.ok and outcome.verified == [True], case
    assert outcome.error_kind == "resumed", case
    assert ep.resumes == 1 and st["peers_resumed"] == 1
    assert st.get("peers_failed", 0) == 0
    oracle = assert_oracle(res[0], a, b, PBSConfig(seed=s), d)
    assert oracle.success

    aw, hw = ep.wire_stats, hub._peers[ch].wire_stats()
    assert aw["resume_frame_bytes"] == hw["resume_frame_bytes"] > 0
    if crash_after == 1:
        assert 0 < st["resume_replay_bytes"] <= _BARRIER_FRAME_BOUND
        assert aw["protocol_frame_bytes"] == (
            hw["protocol_frame_bytes"] + st["resume_replay_bytes"])
    else:
        assert st["resume_replay_bytes"] == 0
        assert aw["protocol_frame_bytes"] == hw["protocol_frame_bytes"]
    rhub, rep, routcomes, rres, _ = ref
    assert_same_results(res, rres)
    assert_same_outcomes(outcomes, routcomes)
    assert_same_stats(st, rhub.stats)
    assert aw == rep.wire_stats


@pytest.mark.parametrize("crash_after", [2, 3])
def test_crash_resume_mid_ladder_stays_byte_identical(crash_after):
    """A peer crashing while the rateless ladder is in flight resumes at
    equal barriers or replays its one committed outcome frame; either way
    the ledger equals the rateless oracle (and the JAX hub's run)."""
    a, b = make_pair(3000, 100, np.random.default_rng(10))
    kw = dict(seed=3, rateless=True)
    (hub, ep, outcomes, res, ch), ref = both(
        _resume_scenario(a, b, kw, 10, dict(crash_after_sends=crash_after)))
    oracle = assert_oracle(res[0], a, b, PBSConfig(**kw), 10)
    assert oracle.success and oracle.diff == true_diff(a, b)
    assert outcomes[ch].ok and outcomes[ch].verified == [True]
    assert outcomes[ch].error_kind == "resumed"
    assert hub.stats["sessions_degraded"] == 0
    assert hub.stats["parity_extensions"] > 0
    rhub, _, routcomes, rres, _ = ref
    assert_same_results(res, rres)
    assert_same_outcomes(outcomes, routcomes)
    assert_same_stats(hub.stats, rhub.stats)


class _DeliverThenFail(Transport):
    """The hub's side of a link whose ``fail_at``-th send reaches the peer
    and still raises (an ACK lost on the way back, a corrupted inbound
    datagram met while waiting for it): the sender cannot tell whether the
    frame arrived."""

    def __init__(self, inner: Transport, fail_at: int):
        super().__init__()
        self._inner = inner
        self._fail_at = fail_at
        self._sends = 0

    def send(self, data: bytes) -> None:
        self._inner.send(data)
        self.bytes_out += len(data)
        self._sends += 1
        if self._sends == self._fail_at:
            raise TransportError("send failed after delivery")

    def recv(self, timeout=None) -> bytes:
        data = self._inner.recv(timeout)
        self.bytes_in += len(data)
        return data

    def close(self) -> None:
        self._inner.close()


def test_reply_delivered_then_send_fails_resumes_by_replay():
    """The hub's round-1 reply reaches the peer but its send raises: the
    hub suspends the peer at barrier 0 while she completes round 1 and
    commits barrier 1.  The hub keeps the round's outcome context from
    before the send, so her resume one barrier ahead replays her outcome
    frame instead of failing as unresumable, and the result equals the
    oracle."""
    a, b, d, s = _crash_pair()
    cfg = PBSConfig(seed=s)
    t_a, t_h_raw = InMemoryDuplex.pair()
    hub = _hub(resume_window=30.0, recv_deadline=10.0)
    ch = hub.add_peer(_DeliverThenFail(t_h_raw, fail_at=1), label="lost-ack")
    hub.submit(ch, b, cfg=cfg, d_known=d)
    ep = _alice(t_a, channel=ch)
    ep.submit(a, cfg=cfg, d_known=d)
    pending: dict = {}

    def on_barrier(rnd):
        if "t" in pending and hub._peers[ch].suspended:
            hub.resume_peer(ch, pending.pop("t"))

    hub.on_barrier = on_barrier
    state: dict = {}

    def drive():
        try:
            state["res"] = ep.run()
            return
        except TransportError as e:
            state["crash"] = e
        state["barrier"] = ep._rnd
        na, nh = InMemoryDuplex.pair()
        pending["t"] = nh
        ep.resume(na)
        state["res"] = ep.resume_run()

    th = threading.Thread(target=drive, daemon=True)
    th.start()
    outcomes = hub.serve()
    th.join(timeout=60)
    assert not th.is_alive()
    assert "crash" in state and state["barrier"] == 1
    assert outcomes[ch].ok and outcomes[ch].error_kind == "resumed"
    st = hub.stats
    assert st["peers_resumed"] == 1 and 0 < st["resume_replay_bytes"] <= _BARRIER_FRAME_BOUND
    assert_oracle(state["res"][0], a, b, cfg, d)


def test_silent_crash_suspends_at_deadline_then_resumes():
    """A peer going dark (silent crash) is caught by the hub's barrier
    deadline, suspended as resumable, and resumes cleanly."""
    a, b, d, s = _crash_pair(seed=9, size=2400, cut=300, cfg_seed=4)
    cfg = PBSConfig(seed=s)
    t_a_raw, t_h = InMemoryDuplex.pair()
    t_a = ChaosTransport(t_a_raw, FaultPlan(crash_after_sends=2, crash_silent=True))
    hub = _hub(resume_window=30.0, recv_deadline=1.0)
    ch = hub.add_peer(t_h, label="dark")
    hub.submit(ch, b, cfg=cfg, d_known=d)
    ep = _alice(t_a, channel=ch)
    ep.submit(a, cfg=cfg, d_known=d)
    pending: dict = {}
    kinds: list = []

    def on_barrier(rnd):
        if "t" in pending and hub._peers[ch].suspended:
            kinds.append(classify_error(hub._peers[ch].suspend_err))
            hub.resume_peer(ch, pending.pop("t"))

    hub.on_barrier = on_barrier
    state: dict = {}

    def drive():
        try:
            ep.run()
            return
        except TransportError:
            pass
        na, nh = InMemoryDuplex.pair()
        pending["t"] = nh
        ep.resume(na)
        state["res"] = ep.resume_run()

    th = threading.Thread(target=drive, daemon=True)
    th.start()
    outcomes = hub.serve()
    th.join(timeout=60)
    assert not th.is_alive()
    assert kinds == ["deadline"]
    assert outcomes[ch].ok and outcomes[ch].error_kind == "resumed"
    assert hub.stats["peers_resumed"] == 1
    assert_oracle(state["res"][0], a, b, cfg, d)


def test_resume_rejected_on_diverged_transcript():
    """A reconnecting peer whose transcript digest diverged is refused at
    the handshake (evicted as a wire failure), never re-attached."""
    a, b, d, s = _crash_pair(seed=13, size=2400, cut=300, cfg_seed=6)
    cfg = PBSConfig(seed=s)
    t_a_raw, t_h = InMemoryDuplex.pair()
    t_a = ChaosTransport(t_a_raw, FaultPlan(crash_after_sends=2))
    hub = _hub(resume_window=30.0, recv_deadline=5.0)
    ch = hub.add_peer(t_h, label="diverged")
    hub.submit(ch, b, cfg=cfg, d_known=d)
    ep = _alice(t_a, channel=ch)
    ep.submit(a, cfg=cfg, d_known=d)
    pending: dict = {}
    hub_err: list = []

    def on_barrier(rnd):
        if "t" in pending and hub._peers[ch].suspended:
            try:
                hub.resume_peer(ch, pending.pop("t"))
            except WireError as e:
                hub_err.append(e)

    hub.on_barrier = on_barrier
    alice_err: list = []

    def drive():
        try:
            ep.run()
            return
        except TransportError:
            pass
        ep._digest ^= 0x1          # simulated divergence / stale snapshot
        na, nh = InMemoryDuplex.pair()
        pending["t"] = nh
        try:
            ep.resume(na)
            ep.resume_run()
        except (TransportError, WireError) as e:
            alice_err.append(e)

    th = threading.Thread(target=drive, daemon=True)
    th.start()
    outcomes = hub.serve()
    th.join(timeout=60)
    assert not th.is_alive()
    assert hub_err and "diverged" in str(hub_err[0])
    assert alice_err, "the refused peer must fail fast, not hang"
    assert not outcomes[ch].ok
    assert outcomes[ch].error_kind == "wire"
    assert hub.stats["peers_resumed"] == 0
    assert ch in hub.stale_channels


def test_suspension_expires_into_classified_eviction():
    """A suspended peer that never reconnects hardens into an eviction
    once the resume window lapses, keeping the root failure's class."""
    a, b, d, s = _crash_pair(seed=17, size=2400, cut=300, cfg_seed=8)
    cfg = PBSConfig(seed=s)
    t_a_raw, t_h = InMemoryDuplex.pair()
    t_a = ChaosTransport(t_a_raw, FaultPlan(crash_after_sends=2))
    hub = _hub(resume_window=0.3, recv_deadline=5.0)
    ch = hub.add_peer(t_h, label="gone")
    hub.submit(ch, b, cfg=cfg, d_known=d)
    ep = _alice(t_a, channel=ch)
    ep.submit(a, cfg=cfg, d_known=d)
    seen: list = []

    def drive():
        try:
            ep.run()
        except TransportError as e:
            seen.append(e)

    th = threading.Thread(target=drive, daemon=True)
    th.start()
    outcomes = hub.serve()
    th.join(timeout=60)
    assert not th.is_alive()
    assert seen, "the peer's run must fail with a TransportError"
    assert not outcomes[ch].ok
    assert "resume window" in str(outcomes[ch].error)
    assert outcomes[ch].error_kind == "transport"
    st = hub.stats
    assert st["peers_failed"] == 1
    assert st["peers_failed_by_kind"] == {"transport": 1}
    assert st["peers_resumed"] == 0


# ---------------------------------------------------------------------------
# graceful degradation and the estimator's regime guard (port == JAX)
# ---------------------------------------------------------------------------


def test_degradation_completes_exhausted_session_on_the_hub():
    """The hub part of the reference's degradation test: a 4x-low d̂ with a
    2-round budget finishes only through the escalation ladder; the
    outcome is tagged ``degraded`` and the ledger equals the in-process
    server's with ``degrade=True`` (the degradation oracle)."""
    from repro_torch.recon import ReconcileServer

    rng = np.random.default_rng(11)
    univ = rng.choice(1 << 20, size=4000, replace=False).astype(np.uint32)
    a, b = univ[:3500], univ[500:]
    kw, dk = dict(seed=5, max_rounds=2), 250
    srv = ReconcileServer(degrade=True, device="cpu")
    srv.submit(a, b, cfg=PBSConfig(**kw), d_known=dk)
    oracle = srv.run()[0]
    assert oracle.success and oracle.diff == true_diff(a, b)

    def scenario(pkg):
        th_a, th_h = pkg.net.InMemoryDuplex.pair()
        hub = pkg.hub(degrade=True, recv_deadline=20.0)
        ch = hub.add_peer(th_h)
        hub.submit(ch, b, cfg=pkg.PBSConfig(**kw), d_known=dk)
        ep = pkg.alice(th_a, channel=ch, degrade=True)
        ep.submit(a, cfg=pkg.PBSConfig(**kw), d_known=dk)
        outcomes, results, errors = pkg.net.run_hub(hub, {ch: ep})
        assert not errors, errors
        return hub, outcomes, results

    (hub, outcomes, results), (rhub, routcomes, rresults) = both(scenario)
    r = results[1][0]
    assert r.success and r.diff == true_diff(a, b)
    assert r.bytes_per_round == oracle.bytes_per_round
    assert r.bytes_sent == oracle.bytes_sent
    assert hub.stats["sessions_degraded"] >= 1
    assert outcomes[1].ok and outcomes[1].error_kind == "degraded"
    assert_same_results(results, rresults)
    assert_same_outcomes(outcomes, routcomes)
    assert_same_stats(hub.stats, rhub.stats)


def test_hub_evicts_out_of_regime_estimator_as_estimate():
    rng = np.random.default_rng(81)
    a_ok, b_ok = make_pair(600, 12, rng)
    univ = rng.choice(1 << 32, size=700, replace=False).astype(np.uint32)
    a_bad, b_bad = np.unique(univ[:380]), np.unique(univ[330:])   # d ~ |A|

    def scenario(pkg):
        hub = pkg.hub(recv_deadline=20.0)
        alices = {}
        for label, a, b in (("inregime", a_ok, b_ok), ("outofregime", a_bad, b_bad)):
            ta, tb = pkg.net.InMemoryDuplex.pair()
            ch = hub.add_peer(tb, label=label)
            hub.submit(ch, b)
            ep = pkg.alice(ta, channel=ch)
            ep.submit(a)
            alices[ch] = ep
        return (hub, *pkg.net.run_hub(hub, alices))

    (hub, outcomes, results, errors), (rhub, routcomes, rresults, _) = both(scenario)
    ch_ok, ch_bad = 1, 2
    assert outcomes[ch_ok].ok and ch_ok not in errors
    assert_oracle(results[ch_ok][0], a_ok, b_ok, PBSConfig(), None)
    assert results[ch_ok][0].diff == true_diff(a_ok, b_ok)
    assert not outcomes[ch_bad].ok
    assert outcomes[ch_bad].error_kind == "estimate"
    assert hub.stats["peers_failed_by_kind"].get("estimate") == 1
    assert_same_results({ch_ok: results[ch_ok]}, {ch_ok: rresults[ch_ok]})
    assert_same_outcomes(outcomes, routcomes)
    assert_same_stats(hub.stats, rhub.stats)


# ---------------------------------------------------------------------------
# the chaos epochs (3 seeded epochs; the 20-epoch soak is not cloned)
# ---------------------------------------------------------------------------

_CFG = dict(n_override=127, t_override=7, g_override=4)


def _fresh_elems(rng, k):
    return rng.integers(1, 1 << 32, size=k, dtype=np.uint64).astype(np.uint32)


def _chaos_soak(epochs, *, crash_epochs=(1,), corrupt_op=None, seed=0, deadline=4.0):
    """A 6-peer continuous port hub under scripted chaos (the reference's
    ``_chaos_soak``): peer 0 crash-restarts by clean disconnect and 1 by
    silent crash in each of ``crash_epochs``, resuming mid-epoch; 2 rides a
    lossy/duplicating/reordering ARQ channel with a partition window; 3
    rides ARQ with an optional scripted corruption; 4 re-estimates d̂ every
    epoch; 5 is clean."""
    peers, d = 6, 60
    rng = np.random.default_rng(seed)
    hub = _hub(recv_deadline=deadline, continuous=True, resume_window=60.0)
    alices: dict = {}
    cfgs: dict = {}
    dks: dict = {}
    conn: dict = {}
    roles: dict = {}
    plan2 = FaultPlan(seed=seed + 50, loss=0.08, burst_every=40, burst_len=2,
                      dup=0.06, reorder=0.06, partitions=((120, 126),))
    plan3 = (FaultPlan(seed=seed + 60, corrupt_at=(corrupt_op,))
             if corrupt_op is not None else FaultPlan(seed=seed + 60))
    for p in range(peers):
        a, b = make_pair(700, d, np.random.default_rng(seed + 101 * p))
        dk = None if p == 4 else d
        cfg = PBSConfig(seed=seed + p, **_CFG)
        if p in (2, 3):
            raw_a, raw_h = InMemoryDuplex.pair()
            chaos = ChaosTransport(raw_a, plan2 if p == 2 else plan3)
            ta = ReliableTransport(chaos, timeout=0.02, max_retries=400, seed=p)
            th = ReliableTransport(raw_h, timeout=0.02, max_retries=400, seed=100 + p)
        else:
            ta, th = InMemoryDuplex.pair()
            chaos = None
            if p == 1:
                chaos = ChaosTransport(ta, FaultPlan(crash_silent=True))
                ta = chaos
        ch = hub.add_peer(th, label=f"peer{p}")
        hub.submit(ch, b, cfg=cfg, d_known=dk)
        ep = _alice(ta, channel=ch, continuous=True)
        ep.submit(a, cfg=cfg, d_known=dk)
        alices[ch] = ep
        cfgs[ch], dks[ch] = cfg, dk
        conn[ch] = {"ta": ta, "chaos": chaos}
        roles[f"p{p}"] = ch

    ch0, ch1, ch2, ch3 = roles["p0"], roles["p1"], roles["p2"], roles["p3"]
    pending: dict = {}
    suspend_kinds: dict = {ch: [] for ch in alices}
    trigger = {"armed": False}

    def on_barrier(rnd):
        if trigger["armed"] and rnd >= 1:
            trigger["armed"] = False
            conn[ch0]["ta"].close()           # clean disconnect
            conn[ch1]["chaos"]._crash()       # dark peer: deadline path
        for ch in list(pending):
            if hub._peers[ch].suspended:
                suspend_kinds[ch].append(classify_error(hub._peers[ch].suspend_err))
                hub.resume_peer(ch, pending.pop(ch))

    hub.on_barrier = on_barrier

    def _mk(ch, fn):
        def call():
            try:
                return fn()
            except TransportError:
                pass
            raw_a, nh = InMemoryDuplex.pair()
            if ch == ch1:
                chaos = ChaosTransport(raw_a, FaultPlan(crash_silent=True))
                conn[ch].update(ta=chaos, chaos=chaos)
                ta = chaos
            else:
                conn[ch].update(ta=raw_a, chaos=None)
                ta = raw_a
            pending[ch] = nh
            alices[ch].resume(ta)
            return alices[ch].resume_run()
        return call

    outcomes, results, errors = _drive_hub(
        hub, {ch: _mk(ch, ep.run) for ch, ep in alices.items()}, join_timeout=120.0)
    assert not errors, errors
    assert all(o.ok for o in outcomes.values())
    uploads0 = hub.stats["store_uploads"]
    sess_ids = {ch: id(hub._peers[ch].sessions[0]) for ch in alices}
    resumes_expected = 0

    for e in range(1, epochs + 1):
        hub_muts, alice_muts = {}, {}
        for ch, ep in alices.items():
            b_cur = hub._peers[ch].sessions[0].state.b
            hub_muts[ch] = {0: (_fresh_elems(rng, 24), rng.permutation(b_cur)[:24])}
            a_base = ep.sessions[0].state.a
            alice_muts[ch] = {0: (_fresh_elems(rng, 6), rng.permutation(a_base)[:6])}
        hub.advance_epoch(hub_muts)
        for ch, ep in alices.items():
            ep.advance_epoch(alice_muts.get(ch, {}))
        crash = e in crash_epochs
        if crash:
            trigger["armed"] = True
            resumes_expected += 2
        outcomes, results, errors = _drive_hub(
            hub, {ch: _mk(ch, ep.run_epoch) for ch, ep in alices.items()},
            join_timeout=120.0)
        st = hub.stats
        assert not errors, (e, errors)
        assert st["store_builds"] == 0, (e, st)
        assert st["store_uploads"] == uploads0
        assert st.get("peers_failed", 0) == 0, (e, st)
        for ch in alices:
            assert id(hub._peers[ch].sessions[0]) == sess_ids[ch]
        if crash:
            assert outcomes[ch0].error_kind == "resumed", e
            assert outcomes[ch1].error_kind == "resumed", e
            assert suspend_kinds[ch0][-1] == "transport"
            assert suspend_kinds[ch1][-1] == "deadline"
        assert st["peers_resumed"] >= resumes_expected, (e, st)
        for ch, ep in alices.items():
            assert outcomes[ch].ok and outcomes[ch].verified == [True], (
                e, ch, outcomes[ch].error)
            a_e = ep.sessions[0].state.a
            b_e = hub._peers[ch].sessions[0].state.b
            oracle = assert_oracle(results[ch][0], a_e, b_e, cfgs[ch], dks[ch])
            if crash:
                assert oracle.rounds >= 2, "crash epoch must be multi-round"
            assert oracle.success and oracle.diff == true_diff(a_e, b_e)

    st = hub.stats
    extra = 1 if corrupt_op is not None else 0
    assert st["peers_resumed"] == resumes_expected + extra, st
    assert st["resume_replay_bytes"] <= _BARRIER_FRAME_BOUND * st["peers_resumed"]
    assert hub._peers[ch0].resumes == len(crash_epochs)
    assert hub._peers[ch1].resumes == len(crash_epochs)
    assert not hub.stale_channels
    chaos2 = conn[ch2]["chaos"]
    assert chaos2 is not None and not chaos2.crashed
    assert chaos2.dropped > 0 and chaos2.duplicated > 0
    assert chaos2.reordered > 0
    if corrupt_op is not None:
        assert suspend_kinds[ch3] and suspend_kinds[ch3][-1] == "transport"
        assert hub._peers[ch3].resumes == 1
    return hub


def test_chaos_epochs_fast():
    """3 seeded epochs with the K=2 crash-restart in epoch 1."""
    _chaos_soak(3, crash_epochs=(1,), seed=42)


# ---------------------------------------------------------------------------
# tree-phase crashes (cold-start front end)
# ---------------------------------------------------------------------------


def _tree_pair(seed=23):
    """A pair whose walk is multi-level (d > leaf_d), sorted unique."""
    a, b = make_pair(600, 120, np.random.default_rng(seed))
    return np.unique(a), np.unique(b), PBSConfig(seed=seed)


def _leaf_oracle(a, b, cfg):
    leaves, stats = partition_pair(a, b, TreeConfig(), device="cpu")
    return leaves, stats, [
        reconcile(a_sub, b_sub, cfg, d_known=leaf.d_plan)
        for a_sub, b_sub, leaf in zip(leaf_slices(a, leaves), leaf_slices(b, leaves), leaves)
    ]


def test_mid_tree_crash_evicts_cleanly_then_fresh_channel_readmits():
    """A peer dying mid-walk is a hard eviction — the tree phase holds no
    resumption record — and the same client re-admits from scratch on a
    fresh channel, equal to the in-process walk."""
    a, b, cfg = _tree_pair()
    leaves, stats, oracles = _leaf_oracle(a, b, cfg)
    assert stats.levels >= 2, "walk too shallow to crash mid-tree"

    t_a_raw, t_h = InMemoryDuplex.pair()
    t_a = ChaosTransport(t_a_raw, FaultPlan(crash_after_sends=1))
    hub = _hub(resume_window=30.0, recv_deadline=2.0)
    ch1 = hub.add_peer(t_h, label="treecrash")
    hub.submit_tree(ch1, b, cfg=cfg)
    ep1 = _alice(t_a, channel=ch1)
    ep1.submit_tree(a, cfg)
    seen: list = []

    def drive():
        try:
            ep1.run()
        except TransportError as e:
            seen.append(e)

    th = threading.Thread(target=drive, daemon=True)
    th.start()
    outcomes = hub.serve()
    th.join(timeout=60)
    assert not th.is_alive() and seen
    assert not outcomes[ch1].ok
    assert outcomes[ch1].error_kind == "transport"
    assert outcomes[ch1].tree_leaves is None
    assert not hub._peers[ch1].suspended
    assert ch1 in hub.stale_channels
    st = hub.stats
    assert st["peers_resumed"] == 0
    assert st["peers_failed_by_kind"] == {"transport": 1}

    ta2, th2 = InMemoryDuplex.pair()
    ch2 = hub.add_peer(th2, label="retry")
    hub.submit_tree(ch2, b, cfg=cfg)
    ep2 = _alice(ta2, channel=ch2)
    ep2.submit_tree(a, cfg)
    state: dict = {}
    th2d = threading.Thread(target=lambda: state.update(res=ep2.run()), daemon=True)
    th2d.start()
    outcomes2 = hub.serve()
    th2d.join(timeout=60)
    assert not th2d.is_alive()
    assert outcomes2[ch2].ok
    assert outcomes2[ch2].tree_leaves == ep2.tree_leaves == len(leaves)
    for sid, want in enumerate(oracles):
        assert_same_results({sid: state["res"][sid]}, {sid: want})
    got = set().union(*(r.diff for r in state["res"].values()))
    assert got == true_diff(a, b)


def test_post_tree_crash_resumes_via_msg_resume():
    """Once the walk has settled into leaf sessions, a crash is an ordinary
    mid-protocol crash: the peer resumes through MSG_RESUME with no re-walk
    and no re-admission, equal to the JAX hub's run."""
    a, b, cfg = _tree_pair(seed=29)
    leaves, stats, oracles = _leaf_oracle(a, b, cfg)
    crash_after = stats.levels + 1     # the second send after the walk
    (hub, ep, outcomes, res, ch), ref = both(_resume_scenario(
        a, b, dict(seed=29), None, dict(crash_after_sends=crash_after), tree=True))
    assert outcomes[ch].ok and outcomes[ch].error_kind == "resumed"
    assert ep.resumes == 1 and hub.stats["peers_resumed"] == 1
    assert hub.stats.get("peers_failed", 0) == 0
    assert outcomes[ch].tree_leaves == stats.leaves
    assert ep.wire_stats["tree_frame_bytes"] == stats.digest_bytes
    for sid, want in enumerate(oracles):
        assert res[sid].success
        assert_same_results({sid: res[sid]}, {sid: want})
    rhub, rep, routcomes, rres, _ = ref
    assert_same_results(res, rres)
    assert_same_outcomes(outcomes, routcomes)
    assert_same_stats(hub.stats, rhub.stats)
