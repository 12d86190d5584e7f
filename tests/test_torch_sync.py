"""The port's continuous-sync path (``repro_torch.sync``) against the JAX
package and the numpy oracles.

The facade exports the reference's names; clones of
tests/test_sync_properties.py (the delta-patched stores plan and reconcile
equal to a from-scratch rebuild; store-level mutation units), the fast
churn soak of tests/test_sync_churn.py (a 4-peer continuous hub, port hub
== JAX hub every epoch), the warm hub epoch soak of
tests/test_warm_cache.py and the continuous tree cold start of
tests/test_tree_conformance.py.  Each epoch's results equal both
packages' ``core.pbs.reconcile``; the server traces run the port's and the
JAX package's continuous servers in lockstep and hold their results and
ledgers equal.  Tolerance: 0.
"""
import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

import repro.recon as ref_recon
import repro.sync as ref_sync
import repro_torch.sync as port_sync
from repro_torch.core.pbs import (
    PBSConfig,
    new_session_state,
    plan_from_d_known,
    true_diff,
)
from repro_torch.core.simdata import make_pair
from repro_torch.recon import ReconcileServer
from repro_torch.recon.session import (
    ReconSession,
    SessionBatch,
    StoreCapacityError,
    apply_churn,
)

from _torch_hub import (
    PORT,
    REF,
    assert_oracle,
    assert_same_outcomes,
    assert_same_results,
    assert_same_stats,
    both,
)
from _torch_port import assert_same_ledgers, assert_same_result

_EMPTY = np.zeros(0, dtype=np.uint32)


def test_facade_exports_the_reference_names():
    assert port_sync.__all__ == ref_sync.__all__
    assert len(port_sync.__all__) == 19
    for name in port_sync.__all__:
        obj = getattr(port_sync, name)
        assert obj.__module__.startswith("repro_torch."), (name, obj.__module__)
    assert port_sync.HubEndpoint is PORT.net.HubEndpoint
    assert port_sync.run_hub_epoch is PORT.net.run_hub_epoch


# ---------------------------------------------------------------------------
# the delta path == a from-scratch rebuild (tests/test_sync_properties.py)
# ---------------------------------------------------------------------------


def _fresh_elems(rng, k):
    return rng.integers(1, 1 << 32, size=k, dtype=np.uint64).astype(np.uint32)


def _churn(rng, base, n_add, n_remove):
    removed = rng.permutation(base)[:n_remove]
    added = _fresh_elems(rng, n_add)
    return added, removed


def _live_rows(ss):
    """The live element prefix of every store row, from the host mirror."""
    return [ss.flat_host[ss.start_host[r] : ss.start_host[r] + ss.cnt_host[r]]
            for r in range(len(ss.cnt_host))]


def _fresh_batch_like(batch):
    """A from-scratch SessionBatch over the same current session states."""
    sessions = [
        ReconSession(sid=s.sid, plan=s.plan,
                     state=new_session_state(s.state.a, s.state.b, s.plan),
                     rnd0=s.rnd0, failed=s.failed)
        for s in batch.sessions
    ]
    return SessionBatch(sessions, sides=batch.sides, mutable=batch.mutable, device="cpu")


def _assert_store_rows_equal(mutated, fresh):
    """Every row's live element set in the patched store equals the freshly
    packed store's, and the device copy equals the host mirror."""
    assert mutated.row_of == fresh.row_of
    for side in mutated.sides:
        ms, fs = mutated.sides[side], fresh.sides[side]
        np.testing.assert_array_equal(ms.cnt_host, fs.cnt_host)
        flat = ms.flat.cpu().numpy().view(np.uint32)
        for row, (m_row, f_row) in enumerate(zip(_live_rows(ms), _live_rows(fs))):
            np.testing.assert_array_equal(np.sort(m_row), np.sort(f_row))
            s = ms.start_host[row]
            np.testing.assert_array_equal(flat[s : s + ms.cnt_host[row]], m_row)


def _assert_plan_parity(batch):
    """The mutated batch's round-1 plans equal a from-scratch rebuild's:
    same cohorts, members, widths and overlay arrays."""
    fresh = _fresh_batch_like(batch)
    plans_m, plans_f = batch.plan_round(1), fresh.plan_round(1)
    assert len(plans_m) == len(plans_f)
    for pm, pf in zip(plans_m, plans_f):
        assert (pm.store.n, pm.store.t, pm.store.m) == (pf.store.n, pf.store.t, pf.store.m)
        assert pm.units == pf.units
        assert (pm.width_a, pm.width_b) == (pf.width_a, pf.width_b)
        assert [(s.sid, base, len(active), seed) for s, base, active, seed in pm.members] == [
            (s.sid, base, len(active), seed) for s, base, active, seed in pf.members]
        assert pm.arrays.keys() == pf.arrays.keys()
        for key in pm.arrays:
            np.testing.assert_array_equal(pm.arrays[key], pf.arrays[key], err_msg=key)
        _assert_store_rows_equal(pm.store, pf.store)


def _run_trace(seed, epochs, *, sessions=2, size=500, d=12, pinned=True):
    """A random epoch-mutation trace through the port's continuous server and
    the JAX package's in lockstep: plan parity with a rebuild, every result
    equal to the oracle and to the reference, the ledgers equal."""
    rng = np.random.default_rng(seed)
    port = ReconcileServer(continuous=True, device="cpu")
    ref = ref_recon.ReconcileServer(continuous=True)
    cfgs, dks = [], []
    for s in range(sessions):
        a, b = make_pair(size, d, np.random.default_rng(seed + 31 * s))
        dk = d if s % 2 == 0 else None
        kw = (dict(seed=seed + s, n_override=127, t_override=7, g_override=3)
              if pinned else dict(seed=seed + s))
        cfg = PBSConfig(**kw)
        port.submit(a, b, cfg=cfg, d_known=dk)
        ref.submit(a, b, cfg=REF.PBSConfig(**kw), d_known=dk)
        cfgs.append(cfg)
        dks.append(dk)
    got, want = port.run(), ref.run()
    for sid in want:
        assert_same_result(got[sid], want[sid], sid)
    assert port.stats["store_builds"] > 0

    for _ in range(epochs):
        muts = {}
        for s in range(sessions):
            st_ = port.sessions[s].state
            muts[s] = (*_churn(rng, st_.a, int(rng.integers(0, 6)), int(rng.integers(0, 6))),
                       *_churn(rng, st_.b, int(rng.integers(0, 6)), int(rng.integers(0, 6))))
        port.advance_epoch(muts)
        ref.advance_epoch(muts)
        if pinned:
            _assert_plan_parity(port._batch)
        got, want = port.run(), ref.run()
        stats = port.stats
        if pinned:
            assert stats["store_builds"] == 0, stats
            assert stats["store_compactions"] == 0, stats
            assert stats["h2d_delta_bytes"] > 0
            assert stats["h2d_store_bytes"] == 0
        assert_same_ledgers(port, ref)
        for s in range(sessions):
            a_e, b_e = port.sessions[s].state.a, port.sessions[s].state.b
            np.testing.assert_array_equal(a_e, ref.sessions[s].state.a)
            np.testing.assert_array_equal(b_e, ref.sessions[s].state.b)
            oracle = assert_oracle(got[s], a_e, b_e, cfgs[s], dks[s])
            assert oracle.success and oracle.diff == true_diff(a_e, b_e)
            assert (got[s].n, got[s].t, got[s].g, got[s].d_est) == (
                oracle.n, oracle.t, oracle.g, oracle.d_est)
            assert_same_result(got[s], want[s], s)
    return port


def test_delta_trace_matches_rebuild_seeded():
    _run_trace(2001, epochs=3, pinned=True)


def test_delta_trace_unpinned_counts_rebuilds():
    """Without pinned layouts the estimator session re-plans per epoch;
    results stay oracle-equal and a layout shift is a counted rebuild."""
    server = _run_trace(2002, epochs=2, sessions=2, pinned=False)
    assert server._batch.store_builds >= 1
    assert server._batch.store_build_bytes > 0


def test_epoch_with_zero_churn_is_d0():
    """An epoch with no mutations reconciles d = 0 equal to the oracle."""
    server = ReconcileServer(continuous=True, device="cpu")
    a, b = make_pair(400, 10, np.random.default_rng(5))
    cfg = PBSConfig(seed=3, n_override=127, t_override=7, g_override=2)
    server.submit(a, b, cfg=cfg, d_known=10)
    server.run()
    server.advance_epoch()                   # fold only: A becomes B
    results = server.run()
    sess = server.sessions[0]
    assert np.array_equal(np.sort(sess.state.a), np.sort(sess.state.b))
    oracle = assert_oracle(results[0], sess.state.a, sess.state.b, cfg, 10)
    assert oracle.diff == set()
    assert server.stats["store_builds"] == 0


@settings(max_examples=3, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**20))
def test_delta_trace_matches_rebuild_hypothesis(seed):
    _run_trace(seed, epochs=2, sessions=1, size=350, d=8, pinned=True)


# ---------------------------------------------------------------------------
# store-level units: mutation lanes, compaction, counters
# ---------------------------------------------------------------------------


def _one_session_batch(pkg, size=300, d=8, seed=0, mutable=True, g=2):
    a, b = make_pair(size, d, np.random.default_rng(seed))
    cfg = pkg.PBSConfig(seed=seed, n_override=127, t_override=7, g_override=g)
    plan = pkg.pbs.plan_from_d_known(cfg, d)
    sess = pkg.session.ReconSession(sid=0, plan=plan,
                                    state=pkg.pbs.new_session_state(a, b, plan))
    return pkg.session.SessionBatch([sess], mutable=mutable, **pkg.dev), sess


def test_apply_mutations_patches_in_place():
    rng = np.random.default_rng(1)
    batch, sess = _one_session_batch(PORT)
    rbatch, rsess = _one_session_batch(REF)
    store = batch.store_for(sess.code_key)
    rbatch.store_for(rsess.code_key)
    gen0 = store.generation
    flat_id = id(store.sides["a"].flat_host)
    removed = rng.permutation(sess.state.a)[:5]
    added = _fresh_elems(rng, 5)
    batch.apply_mutations(sess, "a", added, removed)
    rbatch.apply_mutations(rsess, "a", added, removed)
    assert batch.store_for(sess.code_key) is store
    assert store.generation > gen0
    assert id(store.sides["a"].flat_host) == flat_id   # patched, not repacked
    assert batch.store_builds == 1 and batch.store_patches == 1
    assert batch.store_delta_bytes > 0
    assert (batch.store_builds, batch.store_patches, batch.store_delta_bytes) == (
        rbatch.store_builds, rbatch.store_patches, rbatch.store_delta_bytes)
    new_a = apply_churn(sess.state.a, added, removed)
    live = np.concatenate(_live_rows(store.sides["a"]))
    np.testing.assert_array_equal(np.sort(live), new_a)
    flat = store.sides["a"].flat.cpu().numpy().view(np.uint32)
    np.testing.assert_array_equal(flat, store.sides["a"].flat_host)


def test_apply_mutations_rejects_absent_removal():
    batch, sess = _one_session_batch(PORT)
    store = batch.store_for(sess.code_key)
    absent = np.setdiff1d(_fresh_elems(np.random.default_rng(9), 64), sess.state.a)[:1]
    with pytest.raises(ValueError, match="not resident"):
        batch.apply_mutations(sess, "a", _EMPTY, absent)
    assert store.generation == 0


def test_capacity_overflow_triggers_compaction():
    batch, sess = _one_session_batch(PORT, size=64, g=1)
    store = batch.store_for(sess.code_key)
    cap = int(store.sides["a"].cap_host[0])
    added = _fresh_elems(np.random.default_rng(2), cap)
    batch.apply_mutations(sess, "a", added, _EMPTY)
    assert batch.store_compactions == 1
    assert sess.code_key not in batch._stores          # discarded, not patched
    sess.state = new_session_state(apply_churn(sess.state.a, added, _EMPTY),
                                   sess.state.b, sess.plan)
    rebuilt = batch.store_for(sess.code_key)
    assert batch.store_builds == 2
    assert rebuilt is not store


def test_submit_after_epochs_resets_stats_marks():
    """submit() discards the batch and its counters: the next run's ledger
    diffs against the new batch (a visible rebuild, never negative delta
    bytes), equal to the JAX server's."""
    cfg_kw = dict(seed=9, n_override=127, t_override=7, g_override=2)
    a, b = make_pair(300, 8, np.random.default_rng(8))
    a2, b2 = make_pair(300, 8, np.random.default_rng(18))
    mut = {0: (*_churn(np.random.default_rng(1), a, 3, 3), _EMPTY, _EMPTY)}
    servers = []
    for server, cfg in ((ReconcileServer(continuous=True, device="cpu"), PBSConfig(**cfg_kw)),
                        (ref_recon.ReconcileServer(continuous=True), REF.PBSConfig(**cfg_kw))):
        server.submit(a, b, cfg=cfg, d_known=8)
        server.run()
        server.advance_epoch(mut)
        server.run()
        assert server.stats["h2d_delta_bytes"] > 0
        server.submit(a2, b2, cfg=cfg, d_known=8)
        server.run()
        servers.append(server)
    st_ = servers[0].stats
    assert st_["store_builds"] >= 1
    assert st_["h2d_delta_bytes"] == 0
    assert_same_ledgers(*servers)


def test_cohort_round_trip_migration_rebuilds_fresh():
    """A session that migrates out of a cohort and later back in never
    reuses the stale rows it left behind."""
    from repro_torch.recon.session import advance_session

    a, b = make_pair(300, 8, np.random.default_rng(3))
    cfg1 = PBSConfig(seed=1, n_override=127, t_override=7, g_override=2)
    cfg2 = PBSConfig(seed=1, n_override=255, t_override=8, g_override=2)
    plan1, plan2 = plan_from_d_known(cfg1, 8), plan_from_d_known(cfg2, 8)
    sess = ReconSession(sid=0, plan=plan1, state=new_session_state(a, b, plan1))
    batch = SessionBatch([sess], mutable=True, device="cpu")
    key1, key2 = sess.code_key, (plan2.n, plan2.t)
    batch.store_for(key1)

    rng = np.random.default_rng(4)
    a2 = apply_churn(a, _fresh_elems(rng, 5), rng.permutation(a)[:5])
    advance_session(batch, sess, plan2, new_a=a2)    # migrate K1 -> K2
    assert key1 not in batch._stores
    batch.store_for(key2)
    a3 = apply_churn(a2, _fresh_elems(rng, 5), rng.permutation(a2)[:5])
    advance_session(batch, sess, plan1, new_a=a3)    # ...and back: K2 -> K1
    assert key1 not in batch._stores and key2 not in batch._stores
    store = batch.store_for(key1)
    live = np.concatenate(_live_rows(store.sides["a"]))
    np.testing.assert_array_equal(np.sort(live), np.sort(a3))


def test_one_shot_store_has_no_mutation_lanes():
    batch, sess = _one_session_batch(PORT, mutable=False)
    store = batch.store_for(sess.code_key)
    assert store.sides["a"].flat_host is None
    with pytest.raises(StoreCapacityError, match="without mutation lanes"):
        store.apply_side_mutations("a", {0: ([1], [])})


def _session_for(pkg, sid, size, d, seed, n, t):
    cfg = pkg.PBSConfig(seed=seed, n_override=n, t_override=t, g_override=2)
    plan = pkg.pbs.plan_from_d_known(cfg, d)
    a, b = make_pair(size, d, np.random.default_rng(seed))
    return pkg.session.ReconSession(sid=sid, plan=plan,
                                    state=pkg.pbs.new_session_state(a, b, plan))


def _invalidation_ledger(pkg):
    """store_builds / upload / build bytes through add_sessions (one value
    per step), for holding the port's counters against the reference's."""
    s0 = _session_for(pkg, 0, 300, 8, seed=1, n=127, t=7)
    s1 = _session_for(pkg, 1, 300, 8, seed=2, n=255, t=8)
    batch = pkg.session.SessionBatch([s0, s1], **pkg.dev)
    out = [batch.store_upload_bytes(), batch.store_builds]
    store0, store1 = batch.store_for(s0.code_key), batch.store_for(s1.code_key)
    out += [batch.store_builds, batch.store_upload_bytes(), store0.h2d_bytes,
            store1.h2d_bytes]
    s2 = _session_for(pkg, 2, 300, 8, seed=3, n=127, t=7)
    batch.add_sessions([s2])
    out += [s1.code_key in batch._stores, s0.code_key in batch._stores]
    assert batch.store_for(s1.code_key) is store1
    rebuilt = batch.store_for(s0.code_key)
    out += [batch.store_builds, rebuilt.h2d_bytes, batch.store_upload_bytes(),
            batch.store_build_bytes, (s2.sid, 0) in rebuilt.row_of,
            (s0.sid, 0) in rebuilt.row_of, rebuilt is not store0]
    return out


def test_add_sessions_invalidates_only_affected_cohorts():
    s0 = _session_for(PORT, 0, 300, 8, seed=1, n=127, t=7)
    s1 = _session_for(PORT, 1, 300, 8, seed=2, n=255, t=8)
    batch = SessionBatch([s0, s1], device="cpu")
    assert batch.store_upload_bytes() == 0      # accounting never builds
    assert batch.store_builds == 0
    store0 = batch.store_for(s0.code_key)
    store1 = batch.store_for(s1.code_key)
    assert batch.store_builds == 2
    assert batch.store_upload_bytes() == store0.h2d_bytes + store1.h2d_bytes
    assert batch.store_build_bytes == batch.store_upload_bytes()
    s2 = _session_for(PORT, 2, 300, 8, seed=3, n=127, t=7)
    batch.add_sessions([s2])
    assert batch.sessions == [s0, s1, s2]
    assert s1.code_key in batch._stores         # untouched cohort survives
    assert s0.code_key not in batch._stores     # affected cohort dropped
    assert batch.store_for(s1.code_key) is store1
    assert batch.store_builds == 2
    rebuilt = batch.store_for(s0.code_key)
    assert rebuilt is not store0
    assert batch.store_builds == 3
    assert (s2.sid, 0) in rebuilt.row_of and (s0.sid, 0) in rebuilt.row_of
    assert batch.store_upload_bytes() == rebuilt.h2d_bytes + store1.h2d_bytes
    assert batch.store_build_bytes == store0.h2d_bytes + store1.h2d_bytes + rebuilt.h2d_bytes
    # the same steps on the reference's batch give the same ledger
    assert _invalidation_ledger(PORT) == _invalidation_ledger(REF)


def test_add_sessions_rebuild_skips_finished_sessions():
    s0 = _session_for(PORT, 0, 300, 8, seed=4, n=127, t=7)
    s1 = _session_for(PORT, 1, 300, 8, seed=5, n=127, t=7)
    batch = SessionBatch([s0, s1], device="cpu")
    batch.store_for(s0.code_key)
    for u in s1.state.units:                    # s1 finishes: all units done
        u.done = True
    s2 = _session_for(PORT, 2, 300, 8, seed=6, n=127, t=7)
    batch.add_sessions([s2])
    rebuilt = batch.store_for(s0.code_key)
    assert (s0.sid, 0) in rebuilt.row_of and (s2.sid, 0) in rebuilt.row_of
    assert (s1.sid, 0) not in rebuilt.row_of


# ---------------------------------------------------------------------------
# the continuous hub under churn (tests/test_sync_churn.py, fast variant)
# ---------------------------------------------------------------------------


def _churn_epochs(epochs, *, d0_at=None, seed=0, deadline=20.0):
    """A 4-peer continuous hub across ``epochs`` churn epochs (d = 0 at
    ``d0_at``); returns a scenario giving, per epoch, the hub's stats,
    outcomes, results and each peer's epoch sets."""
    def scenario(pkg):
        peers, d = 4, 20
        rng = np.random.default_rng(seed)
        hub = pkg.hub(recv_deadline=deadline, continuous=True)
        alices, cfgs, dks = {}, {}, {}
        for p in range(peers):
            a, b = make_pair(700, d, np.random.default_rng(seed + 101 * p))
            dk = None if p == 3 else d
            cfg = pkg.PBSConfig(seed=seed + p, n_override=127, t_override=7, g_override=4)
            ta, tb = pkg.net.InMemoryDuplex.pair()
            ch = hub.add_peer(tb, label=f"peer{p}")
            hub.submit(ch, b, cfg=cfg, d_known=dk)
            ep = pkg.alice(ta, channel=ch, continuous=True)
            ep.submit(a, cfg=cfg, d_known=dk)
            alices[ch] = ep
            cfgs[ch], dks[ch] = cfg, dk
        outcomes, results, errors = pkg.net.run_hub(hub, alices)
        assert not errors and all(o.ok for o in outcomes.values())
        store_bytes = hub._batch.store_upload_bytes()
        runs = [(hub.stats, outcomes, results, None)]
        for e in range(1, epochs + 1):
            quiet = e == d0_at
            hub_muts, alice_muts = {}, {}
            for ch, ep in alices.items():
                if quiet:
                    continue
                b_cur = hub._peers[ch].sessions[0].state.b
                hub_muts[ch] = {0: (_fresh_elems(rng, 8), rng.permutation(b_cur)[:8])}
                a_base = ep.sessions[0].state.a
                alice_muts[ch] = {0: (_fresh_elems(rng, 2), rng.permutation(a_base)[:2])}
            hub.advance_epoch(hub_muts)
            for ch, ep in alices.items():
                ep.advance_epoch(alice_muts.get(ch, {}))
            outcomes, results, errors = pkg.net.run_hub_epoch(hub, alices)
            assert not errors, errors
            sets = {ch: (ep.sessions[0].state.a, hub._peers[ch].sessions[0].state.b)
                    for ch, ep in alices.items()}
            runs.append((hub.stats, outcomes, results, sets))
        return runs, store_bytes, cfgs, dks

    return scenario


def test_churn_epochs_fast():
    """3 seeded epochs (d = 0 epoch included): zero store rebuilds after
    epoch 0, cumulative delta H2D <= 25% of rebuilding every epoch, every
    epoch equal to the oracle and to the JAX hub's."""
    epochs, d0_at = 3, 2
    (runs, store_bytes, cfgs, dks), (rruns, rstore_bytes, _, _) = both(
        _churn_epochs(epochs, d0_at=d0_at, seed=42))
    assert store_bytes == rstore_bytes > 0
    assert runs[0][0]["store_uploads"] == 1          # one cohort across all peers
    delta = []
    for e, ((stats, outcomes, results, sets), (rstats, routcomes, rresults, _)) in enumerate(
            zip(runs, rruns)):
        assert_same_stats(stats, rstats)
        assert_same_outcomes(outcomes, routcomes)
        assert_same_results(results, rresults, e)
        if e == 0:
            continue
        assert stats["store_builds"] == 0 and stats["store_compactions"] == 0, (e, stats)
        assert stats["store_uploads"] == 1
        if e == d0_at:
            assert stats["h2d_delta_bytes"] == 0
        else:
            assert 0 < stats["h2d_delta_bytes"] < store_bytes
        delta.append(stats["h2d_delta_bytes"])
        for ch, (a_e, b_e) in sets.items():
            assert outcomes[ch].ok and outcomes[ch].verified == [True]
            oracle = assert_oracle(results[ch][0], a_e, b_e, cfgs[ch], dks[ch])
            assert oracle.success and oracle.diff == true_diff(a_e, b_e), (e, ch)
            if e == d0_at:
                assert oracle.diff == set()
    assert sum(delta) / (epochs * store_bytes) <= 0.25, (delta, store_bytes)


def test_hub_epoch_soak_retraces_zero_after_warmup():
    """A 4-peer continuous port hub across 3 churn epochs: epoch 1 may
    still meet new executor variants, epochs 2 and 3 report
    ``retraces == 0`` in the hub stats."""
    from repro_torch.core.simdata import make_pair as mk

    peers, d = 4, 20
    rng = np.random.default_rng(77)
    hub = PORT.hub(recv_deadline=30.0, continuous=True)
    alices, cfgs, dks = {}, {}, {}
    for p in range(peers):
        a, b = mk(700, d, np.random.default_rng(77 + 101 * p))
        dk = None if p == 3 else d
        cfg = PBSConfig(seed=77 + p, n_override=127, t_override=7, g_override=4)
        ta, tb = PORT.net.InMemoryDuplex.pair()
        ch = hub.add_peer(tb, label=f"peer{p}")
        hub.submit(ch, b, cfg=cfg, d_known=dk)
        ep = PORT.alice(ta, channel=ch, continuous=True)
        ep.submit(a, cfg=cfg, d_known=dk)
        alices[ch] = ep
        cfgs[ch], dks[ch] = cfg, dk
    outcomes, _, errors = PORT.net.run_hub(hub, alices)
    assert not errors and all(o.ok for o in outcomes.values())
    assert "retraces" in hub.stats

    retraces = []
    for _ in range(1, 4):
        hub_muts, alice_muts = {}, {}
        for ch, ep in alices.items():
            b_cur = hub._peers[ch].sessions[0].state.b
            hub_muts[ch] = {0: (_fresh_elems(rng, 8), rng.permutation(b_cur)[:8])}
            a_cur = ep.sessions[0].state.a
            alice_muts[ch] = {0: (_fresh_elems(rng, 2), rng.permutation(a_cur)[:2])}
        hub.advance_epoch(hub_muts)
        for ch, ep in alices.items():
            ep.advance_epoch(alice_muts[ch])
        outcomes, results, errors = PORT.net.run_hub_epoch(hub, alices)
        assert not errors and all(o.ok for o in outcomes.values())
        for ch, ep in alices.items():
            assert_oracle(results[ch][0], ep.sessions[0].state.a,
                          hub._peers[ch].sessions[0].state.b, cfgs[ch], dks[ch])
        retraces.append(hub.stats["retraces"])
    assert retraces[1:] == [0, 0], retraces


# ---------------------------------------------------------------------------
# a tree cold start rejoining the delta path (pair, port == JAX)
# ---------------------------------------------------------------------------


def test_continuous_cold_start_rejoins_delta_mode():
    """Epoch 0 routes through the tree (no sane d̂ exists); the next epoch
    runs the ordinary delta path with per-leaf estimator rebinding."""
    rng = np.random.default_rng(62)
    shared = rng.choice(1 << 32, size=600, replace=False).astype(np.uint64)
    lo = int(rng.integers(0, (1 << 32) - (1 << 12)))
    hot = lo + rng.choice(1 << 12, size=90, replace=False)
    a = np.unique(np.concatenate([shared, hot[:45].astype(np.uint64)]).astype(np.uint32))
    b = np.unique(np.concatenate([shared, hot[45:].astype(np.uint64)]).astype(np.uint32))
    churn = rng.choice(1 << 32, size=6, replace=False).astype(np.uint32)

    def scenario(pkg):
        cfg = pkg.PBSConfig(seed=9)
        ta, tb = pkg.net.InMemoryDuplex.pair()
        alice = pkg.alice(ta, continuous=True)
        bob = pkg.bob(tb, continuous=True)
        alice.submit_tree(a, cfg)
        bob.submit_tree(b, cfg)
        res0 = pkg.net.run_pair(alice, bob)
        sid_big = max(res0, key=lambda s: len(alice.sessions[s].state.a))
        rebind = {sid: None for sid in res0}
        alice.advance_epoch({sid_big: (churn, _EMPTY)}, d_known=rebind)
        bob.advance_epoch({}, d_known=rebind)
        res1 = pkg.net.run_pair_epoch(alice, bob)
        return alice, bob, res0, res1

    (alice, bob, res0, res1), (ralice, rbob, rres0, rres1) = both(scenario)
    diff0 = set()
    for r in res0.values():
        assert r.success
        diff0 |= r.diff
    assert diff0 == true_diff(a, b)
    assert alice.tree_leaves == bob.tree_leaves >= 1
    diff1 = set()
    for sid, r in res1.items():
        assert r.success
        diff1 |= r.diff
        assert_oracle(r, alice.sessions[sid].state.a, bob.sessions[sid].state.b,
                      alice.sessions[sid].plan.cfg, None)
    assert diff1 == set(int(x) for x in churn) - set(int(x) for x in b)
    assert_same_results(res0, rres0)
    assert_same_results(res1, rres1)
    assert alice.wire_stats == ralice.wire_stats and bob.wire_stats == rbob.wire_stats
