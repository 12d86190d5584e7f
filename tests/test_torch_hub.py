"""The port's multi-peer hub (``repro_torch.net.hub``) against the JAX
package's hub and the numpy oracles.

Clones of tests/test_hub.py, the hub case of
tests/test_protocol_conformance.py, the hub case of tests/test_rateless.py
and the tree-peer hub case of tests/test_tree_conformance.py: each scenario
runs on the port's hub (``device="cpu"``, the plain versions of the
kernels) and on the JAX hub, and the two are held equal — every result,
every ``PeerOutcome``, the hub's ``stats`` (``kernel_launches`` included:
the fused 2 encode + 1 decode launches per cohort-round, whatever the peer
count) and every peer's ``wire_stats`` — and both against
``core.pbs.reconcile``.  Then mixed hubs, a port hub serving JAX peers and
a JAX hub serving port peers: frames are the contract.  Tolerance: 0.
"""
import threading

import numpy as np
import pytest

from repro_torch.core.pbs import PBSConfig, true_diff
from repro_torch.core.simdata import make_pair, make_pair_two_sided, random_set
from repro_torch.net import (
    HubEndpoint,
    InMemoryDuplex,
    TransportError,
    run_hub,
)
from repro_torch.net.transport import FrameStream
from repro_torch.wire import frames as wf
from repro_torch.wire.frames import WireError

from _torch_hub import (
    PORT,
    REF,
    assert_oracle,
    assert_same_outcomes,
    assert_same_results,
    assert_same_stats,
    both,
    close_after,
)


def _silent_after_phase0(pkg):
    class SilentAfterPhase0(pkg.Alice):
        """A straggler: completes submission/phase 0, then never sends a
        round frame — the hub's round barrier must evict it at the deadline
        while the other peers' round proceeds."""

        def run(self):
            self._phase0()
            return {}

    return SilentAfterPhase0


def _eight_peer_specs():
    rng_seed = 100
    return [
        (make_pair(700, 5, np.random.default_rng(rng_seed)), dict(seed=1), 5),
        (make_pair(800, 12, np.random.default_rng(rng_seed + 1)), dict(seed=2), 12),
        (make_pair(900, 10, np.random.default_rng(rng_seed + 2)), dict(seed=3), None),
        (make_pair_two_sided(800, 8, 6, np.random.default_rng(rng_seed + 3)),
         dict(seed=4), 14),
        (make_pair(1000, 20, np.random.default_rng(rng_seed + 4)), dict(seed=5), None),
        (make_pair(1200, 40, np.random.default_rng(rng_seed + 5)),
         dict(seed=6, n_override=255, t_override=8, g_override=1), 40),
    ]


def _eight_peers(kind):
    specs = _eight_peer_specs()
    a7, b7 = make_pair(800, 9, np.random.default_rng(106))
    a8, b8 = make_pair(800, 8, np.random.default_rng(107))

    def scenario(pkg):
        pair = (pkg.net.InMemoryDuplex.pair if kind == "memory"
                else pkg.net.tcp_loopback_pair)
        pairs = [pair() for _ in range(8)]
        hub = pkg.hub(recv_deadline=20.0)
        alices = {}
        try:
            for i, ((a, b), kw, dk) in enumerate(specs):
                ta, tb = pairs[i]
                cfg = pkg.PBSConfig(**kw)
                ch = hub.add_peer(tb)
                hub.submit(ch, b, cfg=cfg, d_known=dk)
                ep = pkg.alice(ta, channel=ch)
                ep.submit(a, cfg=cfg, d_known=dk)
                alices[ch] = ep
            # peer 7: straggler (estimator phase 0 completes, then silence)
            ta7, tb7 = pairs[6]
            ch7 = hub.add_peer(tb7, label="straggler")
            hub.submit(ch7, b7, cfg=pkg.PBSConfig(seed=7))
            ep7 = pkg.alice(ta7, cls=_silent_after_phase0(pkg), channel=ch7)
            ep7.submit(a7, cfg=pkg.PBSConfig(seed=7))
            alices[ch7] = ep7
            # peer 8: disconnects after its round-1 sketches frame
            ta8, tb8 = pairs[7]
            ch8 = hub.add_peer(tb8, label="dropper")
            hub.submit(ch8, b8, cfg=pkg.PBSConfig(seed=8), d_known=8)
            ep8 = pkg.alice(close_after(pkg, ta8, 1), channel=ch8)
            ep8.submit(a8, cfg=pkg.PBSConfig(seed=8), d_known=8)
            alices[ch8] = ep8
            outcomes, results, errors = pkg.net.run_hub(hub, alices)
        finally:
            for ta, tb in pairs:
                ta.close()
                tb.close()
        return hub, alices, outcomes, results, errors

    return scenario


@pytest.mark.parametrize(
    "kind",
    # as in the reference: the real-socket variant is the slow tier
    ["memory", pytest.param("loopback", marks=pytest.mark.slow)],
)
def test_hub_eight_peers_acceptance(kind):
    (hub, alices, outcomes, results, errors), ref = both(_eight_peers(kind))
    specs = _eight_peer_specs()
    healthy = list(outcomes)[:6]
    ch7, ch8 = list(outcomes)[6:]

    # every surviving peer: equal to both oracles
    for ch, ((a, b), kw, dk) in zip(healthy, specs):
        exp = assert_oracle(results[ch][0], a, b, PBSConfig(**kw), dk)
        assert exp.diff == true_diff(a, b), ch
        assert outcomes[ch].ok and outcomes[ch].verified == [True], ch
    assert results[healthy[5]][0].decode_failures >= 1

    assert not outcomes[ch7].ok
    assert isinstance(outcomes[ch7].error, TransportError)
    assert all(s.failed for s in outcomes[ch7].sessions)
    assert not outcomes[ch8].ok
    assert isinstance(outcomes[ch8].error, TransportError)
    assert isinstance(errors[ch8], TransportError)
    assert ch7 in hub.stale_channels and ch8 in hub.stale_channels

    # the fusion ledger: 2 encode launches + 1 decode a cohort-round,
    # shared by every peer
    st = hub.stats
    live_keys = {s.code_key for ch in healthy + [ch8] for s in outcomes[ch].sessions}
    assert st["store_uploads"] == len(live_keys), (st, live_keys)
    assert st["kernel_launches"] == 2 * st["cohort_rounds"]
    assert st["decode_launches"] == st["cohort_rounds"]
    assert st["cohort_rounds"] < sum(results[ch][0].rounds for ch in healthy)

    # ... and the port hub equals the JAX hub on all of it
    rhub, _, routcomes, rresults, rerrors = ref
    assert_same_results({ch: results[ch] for ch in healthy},
                        {ch: rresults[ch] for ch in healthy})
    assert_same_stats(st, rhub.stats)
    assert_same_outcomes({ch: outcomes[ch] for ch in healthy},
                         {ch: routcomes[ch] for ch in healthy})
    assert_same_outcomes(outcomes, routcomes, wire=False)
    assert errors.keys() == rerrors.keys()


def test_hub_peer_joining_between_rounds_is_byte_identical():
    """A peer admitted after global round 1 reconciles equal to a pair that
    started alone (local round numbering via rnd0), on both hubs."""
    a1, b1 = make_pair(1500, 40, np.random.default_rng(17))
    a2, b2 = make_pair(900, 10, np.random.default_rng(23))
    kw1 = dict(seed=6, n_override=255, t_override=8, g_override=1)

    def scenario(pkg):
        hub = pkg.hub(recv_deadline=30.0)
        cfg1, cfg2 = pkg.PBSConfig(**kw1), pkg.PBSConfig(seed=29)
        ta, tb = pkg.net.InMemoryDuplex.pair()
        ch1 = hub.add_peer(tb)
        hub.submit(ch1, b1, cfg=cfg1, d_known=40)
        ep1 = pkg.alice(ta, channel=ch1)
        ep1.submit(a1, cfg=cfg1, d_known=40)
        joined: dict = {}

        def on_barrier(rnd):
            if rnd == 1 and not joined:
                ta2, tb2 = pkg.net.InMemoryDuplex.pair()
                ch = hub.add_peer(tb2, label="late")
                hub.submit(ch, b2, cfg=cfg2, d_known=10)
                ep = pkg.alice(ta2, channel=ch)
                ep.submit(a2, cfg=cfg2, d_known=10)
                res: dict = {}
                th = threading.Thread(target=lambda: res.update(r=ep.run()), daemon=True)
                th.start()
                joined.update(ch=ch, th=th, res=res)

        hub.on_barrier = on_barrier
        outcomes, results, errors = pkg.net.run_hub(hub, {ch1: ep1})
        joined["th"].join(60)
        assert not errors and "r" in joined["res"]
        results[joined["ch"]] = joined["res"]["r"]
        return hub, outcomes, results, joined["ch"]

    (hub, outcomes, results, ch2), (rhub, routcomes, rresults, _) = both(scenario)
    ch1 = 1
    assert_oracle(results[ch1][0], a1, b1, PBSConfig(**kw1), 40)
    exp2 = assert_oracle(results[ch2][0], a2, b2, PBSConfig(seed=29), 10)
    assert exp2.diff == true_diff(a2, b2)
    assert outcomes[ch2].ok and outcomes[ch2].verified == [True]
    assert outcomes[ch2].sessions[0].rnd0 >= 1  # really joined mid-run
    assert_same_results(results, rresults)
    assert_same_outcomes(outcomes, routcomes)
    assert_same_stats(hub.stats, rhub.stats)


def test_hub_rejects_wrong_and_stale_channel_ids():
    """A frame tagged with any channel other than the peer's own evicts
    only that peer; a retired channel's id is never handed out again."""
    hub = HubEndpoint(recv_deadline=2.0, device="cpu")
    ta, tb = InMemoryDuplex.pair()
    ch = hub.add_peer(tb)
    a, b = make_pair(400, 4, np.random.default_rng(5))
    hub.submit(ch, b, cfg=PBSConfig(seed=3), d_known=4)
    inner = wf.encode_tow_sketch(np.zeros(128, np.int64), 400)
    ta.send(wf.encode_mux(ch + 17, inner))
    out = hub.serve()
    assert not out[ch].ok
    assert "channel" in str(out[ch].error)
    assert ch in hub.stale_channels

    hub2 = HubEndpoint(recv_deadline=30.0, device="cpu")
    ta2, tb2 = InMemoryDuplex.pair()
    ch2 = hub2.add_peer(tb2)
    hub2.submit(ch2, b, cfg=PBSConfig(seed=3), d_known=4)
    ep = PORT.alice(ta2, channel=ch2)
    ep.submit(a, cfg=PBSConfig(seed=3), d_known=4)
    outcomes, results, errors = run_hub(hub2, {ch2: ep})
    assert outcomes[ch2].ok and not errors
    assert_oracle(results[ch2][0], a, b, PBSConfig(seed=3), 4)
    assert ch2 in hub2.stale_channels
    ta3, tb3 = InMemoryDuplex.pair()
    assert hub2.add_peer(tb3) != ch2


def test_unmultiplexed_frame_on_channel_stream_rejected():
    """A bare (non-mux) frame on a channel-tagged stream is a WireError on
    the receiving side — peers cannot bypass the envelope."""
    ta, tb = InMemoryDuplex.pair()
    stream = FrameStream(tb, channel=1)
    ta.send(wf.encode_dhat(7))            # no envelope
    with pytest.raises(WireError, match="unmultiplexed"):
        stream.recv(timeout=1.0)
    ta.send(wf.encode_mux(1, wf.encode_dhat(7)))
    msg_type, payload = stream.recv(timeout=1.0)
    assert msg_type == wf.MSG_DHAT and wf.decode_dhat(payload) == 7


# ---------------------------------------------------------------------------
# generated sessions, rateless peers, a tree peer: port hub == JAX hub
# ---------------------------------------------------------------------------


def _gen_case(rng):
    """One random session (tests/test_protocol_conformance.py's generator):
    duplicate-free sets, random d, random seed, known d or estimator."""
    size = int(rng.integers(300, 1200))
    kind = rng.integers(0, 3)
    if kind == 0:
        d = int(rng.integers(1, 30))
        a, b = make_pair(size, d, rng)
    elif kind == 1:
        da, db = int(rng.integers(1, 15)), int(rng.integers(1, 15))
        a, b = make_pair_two_sided(size, da, db, rng)
        d = da + db
    else:
        base = random_set(size + 20, rng)
        a = base[:size]
        b = np.unique(np.concatenate([a[: size - 10], base[size:]]))
        d = len(true_diff(a, b))
    cfg = dict(seed=int(rng.integers(0, 1 << 16)))
    d_known = None if rng.random() < 0.3 else max(1, d)
    return a, b, cfg, d_known


def _plain_hub(cases, **hub_kw):
    """One hub serving one peer per (a, b, cfg kwargs, d_known) case."""
    def scenario(pkg):
        hub = pkg.hub(recv_deadline=30.0, **hub_kw)
        alices = {}
        for a, b, kw, dk in cases:
            cfg = pkg.PBSConfig(**kw)
            ta, tb = pkg.net.InMemoryDuplex.pair()
            ch = hub.add_peer(tb)
            hub.submit(ch, b, cfg=cfg, d_known=dk)
            ep = pkg.alice(ta, channel=ch)
            ep.submit(a, cfg=cfg, d_known=dk)
            alices[ch] = ep
        outcomes, results, errors = pkg.net.run_hub(hub, alices)
        assert not errors, errors
        return hub, alices, outcomes, results

    return scenario


@pytest.mark.parametrize("seed", [303])
def test_generated_sessions_hub_path_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    cases = [_gen_case(rng) for _ in range(3)]
    (hub, _, outcomes, results), (rhub, _, routcomes, rresults) = both(_plain_hub(cases))
    for ch, (a, b, kw, dk) in zip(outcomes, cases):
        exp = assert_oracle(results[ch][0], a, b, PBSConfig(**kw), dk)
        assert outcomes[ch].ok and outcomes[ch].verified == [exp.success]
    st = hub.stats
    assert st["kernel_launches"] == 2 * st["cohort_rounds"]
    assert st["store_uploads"] == len({s.code_key for o in outcomes.values() for s in o.sessions})
    assert_same_results(results, rresults)
    assert_same_outcomes(outcomes, routcomes)
    assert_same_stats(st, rhub.stats)


def test_hub_rateless_peers_match_oracle():
    """Wrong-d̂ rateless peers recover over the shared cohort ladder (one
    incremental dispatch and one extended decode per cohort per level,
    fused across peers) while an honest rateless peer rides along."""
    ra, rb = make_pair(3000, 100, np.random.default_rng(10))
    ha, hb = make_pair(2000, 50, np.random.default_rng(12))
    cases = [(ra, rb, dict(seed=3, rateless=True), 10),
             (ha, hb, dict(seed=5, rateless=True), 50)]
    (hub, alices, outcomes, results), (rhub, ralices, routcomes, rresults) = both(
        _plain_hub(cases))
    for ch, (a, b, kw, dk) in zip(outcomes, cases):
        exp = assert_oracle(results[ch][0], a, b, PBSConfig(**kw), dk)
        assert exp.diff == true_diff(a, b), ch
        assert outcomes[ch].ok and outcomes[ch].verified == [True], ch
        assert outcomes[ch].error_kind is None, ch
    st = hub.stats
    assert st["parity_extensions"] > 0 and st["sessions_degraded"] == 0
    assert alices[1].parity_extensions > 0 and alices[2].parity_extensions == 0
    # the ladder's launches: 2 a cohort per level, 1 decode a cohort per
    # level on top of the cohort-rounds'
    assert st["kernel_launches"] > 2 * st["cohort_rounds"]
    assert st["decode_launches"] > st["cohort_rounds"]
    assert_same_results(results, rresults)
    assert_same_outcomes(outcomes, routcomes)
    assert_same_stats(st, rhub.stats)


def _clustered_pair(rng):
    """All of the difference packed into one 2^12-wide window (the tree
    conformance suite's ``clustered`` shape)."""
    shared = rng.choice(1 << 32, size=600, replace=False).astype(np.uint64)
    lo = int(rng.integers(0, (1 << 32) - (1 << 12)))
    hot = lo + rng.choice(1 << 12, size=90, replace=False)
    a = np.concatenate([shared, hot[:45].astype(np.uint64)])
    b = np.concatenate([shared, hot[45:].astype(np.uint64)])
    return np.unique(a.astype(np.uint32)), np.unique(b.astype(np.uint32))


def test_hub_tree_peer_coexists_with_plain_peers():
    """A cold-start tree peer beside a known-d and an estimator peer: the
    union of its leaf diffs is the true difference, its walk's shape
    surfaces in ``PeerOutcome`` and the hub stats, and the port hub's
    ``stats`` equal the JAX hub's key for key — ``kernel_launches``
    included, which counts the cohort encodes only, never the tree
    digests (the reference's hub ledgers none)."""
    a3, b3 = _clustered_pair(np.random.default_rng(51))
    plain = []
    for i, dk in ((0, 9), (1, None)):
        a, b = make_pair(600, 9, np.random.default_rng(100 + i))
        plain.append((a, b, dict(seed=10 + i), dk))

    def scenario(pkg):
        hub = pkg.hub(recv_deadline=30.0)
        alices = {}
        for a, b, kw, dk in plain:
            cfg = pkg.PBSConfig(**kw)
            ta, tb = pkg.net.InMemoryDuplex.pair()
            ch = hub.add_peer(tb)
            hub.submit(ch, b, cfg=cfg, d_known=dk)
            ep = pkg.alice(ta, channel=ch)
            ep.submit(a, cfg=cfg, d_known=dk)
            alices[ch] = ep
        cfg3, tcfg3 = pkg.PBSConfig(seed=12), pkg.TreeConfig(seed=7)
        ta, tb = pkg.net.InMemoryDuplex.pair()
        ch3 = hub.add_peer(tb, label="coldstart")
        hub.submit_tree(ch3, b3, cfg=cfg3, tree=tcfg3)
        ep3 = pkg.alice(ta, channel=ch3)
        ep3.submit_tree(a3, cfg3, tcfg3)
        alices[ch3] = ep3
        outcomes, results, errors = pkg.net.run_hub(hub, alices)
        assert not errors, errors
        return hub, alices, outcomes, results

    (hub, alices, outcomes, results), (rhub, ralices, routcomes, rresults) = both(scenario)
    assert all(o.ok for o in outcomes.values())
    for ch, (a, b, kw, dk) in zip((1, 2), plain):
        assert_oracle(results[ch][0], a, b, PBSConfig(**kw), dk)
        assert outcomes[ch].tree_leaves is None
    tr = PORT.tree.tree_reconcile(a3, b3, PBSConfig(seed=12), PORT.TreeConfig(seed=7),
                                  device="cpu")
    diff3 = set()
    for r in results[3].values():
        assert r.success
        diff3 |= r.diff
    assert diff3 == true_diff(a3, b3)
    assert_same_results(results[3], tr.results)
    assert outcomes[3].tree_leaves == tr.stats.leaves
    assert outcomes[3].tree_depth == tr.stats.depth
    st = hub.stats
    assert st["tree_leaves"] == tr.stats.leaves
    assert st["tree_digest_bytes"] == tr.stats.digest_bytes
    assert st["tree_levels"] == tr.stats.levels
    assert st["kernel_launches"] == 2 * st["cohort_rounds"]
    # the tree peer's own ledger counts its walk: one digest a level
    assert alices[3].launches["kernel_launches"] > st["tree_levels"]
    assert_same_results(results, rresults)
    assert_same_outcomes(outcomes, routcomes)
    assert_same_stats(st, rhub.stats)


# ---------------------------------------------------------------------------
# mixed hubs: frames are the contract
# ---------------------------------------------------------------------------


def _mixed_cases():
    cases = []
    a, b = make_pair(1200, 12, np.random.default_rng(61))
    cases.append((a, b, dict(seed=31), 12))
    a, b = make_pair_two_sided(1500, 9, 6, np.random.default_rng(62))
    cases.append((a, b, dict(seed=32), 15))
    a, b = make_pair(1800, 25, np.random.default_rng(63))
    cases.append((a, b, dict(seed=33), None))
    a, b = make_pair(2000, 60, np.random.default_rng(64))
    cases.append((a, b, dict(seed=34, rateless=True), 8))
    return cases


@pytest.mark.parametrize("hub_side", ["port", "jax"])
def test_mixed_hub_interoperates(hub_side):
    """A port hub serving JAX peers, and a JAX hub serving port peers, over
    the hub's own package's transports: every session equals the oracle,
    and the run equals the all-port hub's."""
    hub_pkg, peer_pkg = (PORT, REF) if hub_side == "port" else (REF, PORT)
    cases = _mixed_cases()
    hub = hub_pkg.hub(recv_deadline=30.0)
    alices = {}
    for a, b, kw, dk in cases:
        ta, tb = hub_pkg.net.InMemoryDuplex.pair()
        ch = hub.add_peer(tb)
        hub.submit(ch, b, cfg=hub_pkg.PBSConfig(**kw), d_known=dk)
        ep = peer_pkg.alice(ta, channel=ch)
        ep.submit(a, cfg=peer_pkg.PBSConfig(**kw), d_known=dk)
        alices[ch] = ep
    outcomes, results, errors = hub_pkg.net.run_hub(hub, alices)
    assert not errors, errors
    for ch, (a, b, kw, dk) in zip(outcomes, cases):
        assert_oracle(results[ch][0], a, b, PBSConfig(**kw), dk)
        assert outcomes[ch].ok and outcomes[ch].verified == [True]
        assert alices[ch].wire_stats["frame_bytes_out"] == outcomes[ch].wire_stats[
            "frame_bytes_in"]
        assert alices[ch].wire_stats["frame_bytes_in"] == outcomes[ch].wire_stats[
            "frame_bytes_out"]
    assert hub.stats["parity_extensions"] > 0
    phub, _, poutcomes, presults = _plain_hub(cases)(PORT)
    assert_same_results(results, presults)
    assert_same_outcomes(outcomes, poutcomes)
    assert_same_stats(hub.stats, phub.stats)


def test_no_device_means_the_card():
    import torch

    if torch.cuda.is_available():
        assert HubEndpoint().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        HubEndpoint()
    assert HubEndpoint(device="cpu").device.type == "cpu"
