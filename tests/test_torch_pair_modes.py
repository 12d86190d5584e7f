"""The port's wire pair in its other modes, against the JAX package and the
oracles: rateless recovery over ``MSG_PARITY`` (the pair cases of
tests/test_rateless.py), the tree front end over ``MSG_TREE`` (the wire case
of tests/test_tree_conformance.py, against the port's in-process
``tree_reconcile``), and one continuous-sync epoch over ``MSG_EPOCH`` with
seeded churn, port pair == JAX pair.  Everything runs on the CPU;
tolerance 0.
"""
import numpy as np
import pytest

import repro.core.pbs as ref_pbs
import repro.net as ref_net
from repro_torch.core.pbs import MAX_PARITY_EXTENSIONS, PBSConfig, reconcile, true_diff
from repro_torch.core.simdata import make_pair
from repro_torch.net import AliceEndpoint, BobEndpoint, InMemoryDuplex, run_pair, run_pair_epoch
from repro_torch.net.endpoint import encode_round_rows_ext
from repro_torch.tree import TreeConfig, leaf_slices, tree_reconcile
from repro_torch.wire import frames as wf
from repro_torch.wire.frames import WireError

from _torch_port import RESULT_FIELDS

_EMPTY = np.zeros(0, dtype=np.uint32)


def _pair(**kw):
    ta, tb = InMemoryDuplex.pair()
    return AliceEndpoint(ta, device="cpu", **kw), BobEndpoint(tb, device="cpu", **kw)


def _wrongd_inputs():
    """A 10x-underestimated d̂: every group overloads round 1."""
    a, b = make_pair(2500, 100, np.random.default_rng(10))
    return a, b, PBSConfig(seed=3, rateless=True), 10


def test_pair_rateless_wrongd_recovers_without_replan():
    a, b, cfg, dk = _wrongd_inputs()
    oracle = reconcile(a, b, cfg, d_known=dk)
    alice, bob = _pair()
    alice.submit(a, cfg=cfg, d_known=dk)
    bob.submit(b, cfg=cfg, d_known=dk)
    res = run_pair(alice, bob)[0]
    assert res.success and res.diff == true_diff(a, b)
    assert res.bytes_per_round == oracle.bytes_per_round
    assert res.bytes_sent == oracle.bytes_sent
    assert res.decode_failures == oracle.decode_failures
    assert alice.parity_extensions == bob.parity_extensions > 0
    assert alice.sessions_degraded == bob.sessions_degraded == 0
    assert bob.verified == [True]
    # the JAX pair walks the same ladder to the same result and frames
    ta, tb = ref_net.InMemoryDuplex.pair()
    ra, rb = ref_net.AliceEndpoint(ta), ref_net.BobEndpoint(tb)
    rcfg = ref_pbs.PBSConfig(**vars(cfg))
    ra.submit(a, cfg=rcfg, d_known=dk)
    rb.submit(b, cfg=rcfg, d_known=dk)
    want = ref_net.run_pair(ra, rb)[0]
    for f in RESULT_FIELDS:
        assert getattr(res, f) == getattr(want, f), f
    assert alice.parity_extensions == ra.parity_extensions
    assert alice.wire_stats == ra.wire_stats and bob.wire_stats == rb.wire_stats


def test_pair_rateless_honest_path_stays_byte_identical():
    a, b = make_pair(2500, 100, np.random.default_rng(10))
    cfg = PBSConfig(seed=3, rateless=True)
    oracle = reconcile(a, b, cfg, d_known=100)
    alice, bob = _pair()
    alice.submit(a, cfg=cfg, d_known=100)
    bob.submit(b, cfg=cfg, d_known=100)
    res = run_pair(alice, bob)[0]
    assert res.success and res.diff == true_diff(a, b)
    assert res.bytes_per_round == oracle.bytes_per_round
    assert res.bytes_sent == oracle.bytes_sent
    assert alice.parity_extensions == bob.parity_extensions
    assert alice.sessions_degraded == bob.sessions_degraded == 0


def test_bob_rejects_out_of_band_parity_frames():
    _, bob = _pair()
    with pytest.raises(WireError, match="no round in flight"):
        bob._handle_parity(b"\x01\x01")
    bob._ctx = {
        "live": [], "ctx": {}, "per": {}, "plans": [], "sk_a": {},
        "fail": {}, "level": 0, "acc": {},
    }
    with pytest.raises(WireError, match="no extension pending"):
        bob._handle_parity(b"\x01\x01")
    bob._ctx = {"fail": {0: [0]}, "level": MAX_PARITY_EXTENSIONS}
    with pytest.raises(WireError, match="cap"):
        bob._handle_parity(b"\x01" + bytes([MAX_PARITY_EXTENSIONS + 1]))


def test_bob_rejects_stale_round_parity():
    """A MSG_PARITY frame stamped with a stale round number fails the serve
    loop with a clean WireError instead of corrupting the ladder."""

    class _StaleParityAlice(AliceEndpoint):
        def _rateless_ladder(self, rnd, plans, per, live, ent_of):
            fail = {}
            for sid in live:
                bad = [s for s in range(len(per[sid].active)) if not ent_of[sid][0][s]]
                if bad:
                    fail[sid] = bad
            assert fail, "scenario must overload at least one group"
            part_plans = [plan for plan in plans
                          if any(sess.sid in fail for sess, *_ in plan.members)]
            inc_of = encode_round_rows_ext(part_plans, self.side, 1, self.device)
            parts = [sid for sid in live if sid in fail and sid in inc_of]
            blocks = [(inc_of[sid][0][fail[sid]], per[sid].plan.store.m) for sid in parts]
            self._stream.send(wf.encode_parity(rnd + 7, 1, blocks))
            self._expect(wf.MSG_ROUND_REPLY)    # Bob dies first
            raise AssertionError("unreachable")

    a, b, cfg, dk = _wrongd_inputs()
    ta, tb = InMemoryDuplex.pair()
    alice, bob = _StaleParityAlice(ta, device="cpu"), BobEndpoint(tb, device="cpu")
    alice.submit(a, cfg=cfg, d_known=dk)
    bob.submit(b, cfg=cfg, d_known=dk)
    with pytest.raises(WireError, match="parity frame for round"):
        run_pair(alice, bob)


def test_wire_pair_byte_identical_to_inprocess_walk():
    rng = np.random.default_rng(41)
    base = rng.choice(1 << 32, size=1000, replace=False).astype(np.uint32)
    a, b = np.unique(base[:640]), np.unique(base[360:])     # heavy divergence
    oracle = true_diff(a, b)
    cfg, tcfg = PBSConfig(seed=3), TreeConfig(seed=5)
    alice, bob = _pair()
    alice.submit_tree(a, cfg, tcfg)
    bob.submit_tree(b, cfg, tcfg)
    res = run_pair(alice, bob)
    diff, pbs_bytes = set(), 0
    for r in res.values():
        assert r.success
        diff |= r.diff
        pbs_bytes += r.bytes_sent
    assert diff == oracle

    tr = tree_reconcile(a, b, cfg, tcfg, device="cpu")
    ws_a, ws_b = alice.wire_stats, bob.wire_stats
    assert ws_a["tree_frame_bytes"] == ws_b["tree_frame_bytes"]
    assert ws_a["tree_frame_bytes"] == tr.tree_bytes == tr.stats.digest_bytes
    assert alice.tree_leaves == bob.tree_leaves == tr.stats.leaves
    assert alice.tree_depth == bob.tree_depth == tr.stats.depth
    assert pbs_bytes == tr.pbs_bytes
    # one tree_digest_ranges launch a level a side, ledgered at the call
    levels = tr.stats.levels
    assert levels == alice.tree_depth + 1
    enc = alice.launches["kernel_launches"] - levels
    assert enc > 0 and enc == bob.launches["kernel_launches"] - levels
    for sid, (a_sub, b_sub, leaf) in enumerate(
            zip(leaf_slices(a, tr.leaves), leaf_slices(b, tr.leaves), tr.leaves)):
        exp = reconcile(a_sub, b_sub, cfg, d_known=leaf.d_plan)
        assert res[sid].diff == exp.diff, sid
        assert res[sid].bytes_per_round == exp.bytes_per_round, sid
        assert res[sid].bytes_sent == exp.bytes_sent, sid
        assert res[sid].rounds == exp.rounds, sid
        assert res[sid] == tr.results[sid], sid


def _epoch_pairs():
    """Admission sessions of a continuous pair: known d and an estimator."""
    out = []
    for i, (d, dk) in enumerate(((8, 8), (20, None))):
        a, b = make_pair(1200, d, np.random.default_rng(70 + i))
        out.append((a, b, PBSConfig(seed=40 + i), dk))
    return out


def _run_epochs(alice_cls, bob_cls, duplex, run, run_epoch, cfg_cls, churn, **kw):
    ta, tb = duplex()
    alice, bob = alice_cls(ta, continuous=True, **kw), bob_cls(tb, continuous=True, **kw)
    for a, b, cfg, dk in _epoch_pairs():
        alice.submit(a, cfg=cfg_cls(**vars(cfg)), d_known=dk)
        bob.submit(b, cfg=cfg_cls(**vars(cfg)), d_known=dk)
    res0 = run(alice, bob)
    add_a, rem_b = churn
    # epoch 1: Alice folds her diff and adds keys to session 0, Bob drops
    # keys of session 1; session 0 re-estimates over MSG_EPOCH
    alice.advance_epoch({0: (add_a, _EMPTY)}, d_known={0: None})
    bob.advance_epoch({1: (_EMPTY, rem_b)}, d_known={0: None})
    res1 = run_epoch(alice, bob)
    return alice, bob, res0, res1


def test_pair_epoch_with_churn_matches_jax_pair():
    rng = np.random.default_rng(77)
    add_a = rng.choice(1 << 32, size=9, replace=False).astype(np.uint32)
    rem_b = np.sort(_epoch_pairs()[1][1])[rng.choice(1000, size=7, replace=False)]
    got = _run_epochs(AliceEndpoint, BobEndpoint, InMemoryDuplex.pair, run_pair,
                      run_pair_epoch, PBSConfig, (add_a, rem_b), device="cpu")
    want = _run_epochs(ref_net.AliceEndpoint, ref_net.BobEndpoint, ref_net.InMemoryDuplex.pair,
                       ref_net.run_pair, ref_net.run_pair_epoch, ref_pbs.PBSConfig,
                       (add_a, rem_b))
    alice, bob, res0, res1 = got
    for g, w in zip(got[2:], want[2:]):
        assert g.keys() == w.keys()
        for sid in w:
            for f in RESULT_FIELDS:
                assert getattr(g[sid], f) == getattr(w[sid], f), (sid, f)
    assert alice.wire_stats == want[0].wire_stats and bob.wire_stats == want[1].wire_stats
    assert alice.wire_stats["epoch_envelope_bytes"] > 0
    # each epoch's result equals a fresh oracle session over that epoch's
    # sets (both sessions re-estimate d̂ in epoch 1)
    for sid in (0, 1):
        a1, b1 = alice.sessions[sid].state.a, bob.sessions[sid].state.b
        exp = reconcile(a1, b1, alice.sessions[sid].plan.cfg, d_known=None)
        assert res1[sid].diff == exp.diff == true_diff(a1, b1), sid
        assert res1[sid].bytes_per_round == exp.bytes_per_round, sid
        assert res1[sid].estimator_bytes == exp.estimator_bytes, sid
    assert res1[0].diff == set(add_a.tolist())
    assert res1[1].diff == set(rem_b.tolist())
    assert alice.verified == bob.verified == [True, True]
