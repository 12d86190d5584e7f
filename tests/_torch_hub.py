"""Shared helpers of the ``test_torch_hub*`` and ``test_torch_sync`` suites.

Each package's hub-side API sits behind one namespace (``PORT``: the
port on ``device="cpu"``, ``REF``: the JAX package), so one scenario
runs unchanged on the port's hub and on the reference's, and the two runs
are held together: results, outcomes, ``stats`` and ``wire_stats`` must be
equal (tolerance 0; only ``retraces``, each package's own compilation
ledger, may differ).
"""
import threading
from types import SimpleNamespace

import numpy as np

import repro.core.pbs as ref_pbs
import repro.net as ref_net
import repro.obs as ref_obs
import repro.recon.session as ref_session
import repro.tree as ref_tree
import repro_torch.core.pbs as port_pbs
import repro_torch.net as port_net
import repro_torch.obs as port_obs
import repro_torch.recon.session as port_session
import repro_torch.tree as port_tree
from repro.core.simdata import make_pair

from _torch_port import RESULT_FIELDS


def _pkg(name, net, pbs, tree, session, obs, dev):
    ns = SimpleNamespace(
        name=name, net=net, pbs=pbs, tree=tree, session=session, obs=obs, dev=dev,
        Alice=net.AliceEndpoint, PBSConfig=pbs.PBSConfig, TreeConfig=tree.TreeConfig,
    )
    ns.hub = lambda **kw: net.HubEndpoint(**dev, **kw)
    ns.alice = lambda t, cls=None, **kw: (cls or net.AliceEndpoint)(t, **dev, **kw)
    ns.bob = lambda t, **kw: net.BobEndpoint(t, **dev, **kw)
    return ns


PORT = _pkg("port", port_net, port_pbs, port_tree, port_session, port_obs, {"device": "cpu"})
REF = _pkg("jax", ref_net, ref_pbs, ref_tree, ref_session, ref_obs, {})


def both(scenario):
    """``scenario(PORT)`` and ``scenario(REF)`` on two threads at once (their
    barrier deadlines overlap instead of adding up); returns (port, ref) and
    re-raises the first failure."""
    out, err = {}, {}

    def run(pkg):
        try:
            out[pkg.name] = scenario(pkg)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            err[pkg.name] = e

    ths = [threading.Thread(target=run, args=(p,), daemon=True) for p in (PORT, REF)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in ths), "a scenario hung"
    for name in ("port", "jax"):
        if name in err:
            raise err[name]
    return out["port"], out["jax"]


def assert_same_results(got, want, tag=""):
    """Per channel (or per sid), every ``ReconcileResult`` field equal."""
    assert got.keys() == want.keys(), tag
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, dict):
            assert_same_results(g, w, (tag, k))
            continue
        for f in RESULT_FIELDS:
            assert getattr(g, f) == getattr(w, f), (tag, k, f)


def assert_oracle(got, a, b, cfg, dk):
    """One result equal to both packages' ``core.pbs.reconcile``."""
    exp = port_pbs.reconcile(a, b, cfg, d_known=dk)
    ref = ref_pbs.reconcile(a, b, ref_pbs.PBSConfig(**vars(cfg)), d_known=dk)
    for f in RESULT_FIELDS:
        assert getattr(got, f) == getattr(exp, f) == getattr(ref, f), f
    return exp


def assert_same_stats(port_stats, ref_stats):
    """The hub ledgers equal key for key; ``retraces`` counts each
    package's own compilations and is only required to exist."""
    assert port_stats.keys() == ref_stats.keys()
    for k in ref_stats:
        if k != "retraces":
            assert port_stats[k] == ref_stats[k], (k, port_stats[k], ref_stats[k])


def assert_same_outcomes(port_out, ref_out, wire=True):
    """Per channel: the disposition, verdicts, taxonomy, tree summary, the
    mirrored sessions' count and (``wire``) every framed-byte ledger."""
    assert port_out.keys() == ref_out.keys()
    for ch in ref_out:
        p, r = port_out[ch], ref_out[ch]
        assert (p.ok, p.verified, p.error_kind, p.tree_depth, p.tree_leaves) == (
            r.ok, r.verified, r.error_kind, r.tree_depth, r.tree_leaves), ch
        assert len(p.sessions) == len(r.sessions), ch
        assert (p.error is None) == (r.error is None), ch
        if wire:
            assert p.wire_stats == r.wire_stats, ch


def close_after(pkg, inner, n_sends):
    """Disconnect injection: pass through ``n_sends`` frames, then close the
    underlying transport and fail — a peer vanishing mid-protocol."""
    Transport, TransportError_ = pkg.net.Transport, pkg.net.TransportError

    class CloseAfter(Transport):
        def __init__(self):
            super().__init__()
            self._left = n_sends

        def send(self, data: bytes) -> None:
            if self._left <= 0:
                inner.close()
                raise TransportError_("simulated mid-protocol disconnect")
            self._left -= 1
            inner.send(data)

        def recv(self, timeout=None) -> bytes:
            return inner.recv(timeout)

        def close(self) -> None:
            inner.close()

        @property
        def bytes_out(self) -> int:  # type: ignore[override]
            return inner.bytes_out

        @property
        def bytes_in(self) -> int:  # type: ignore[override]
            return inner.bytes_in

        @bytes_out.setter
        def bytes_out(self, v):  # Transport.__init__ assigns 0
            pass

        @bytes_in.setter
        def bytes_in(self, v):
            pass

    return CloseAfter()


def crash_resume_hub(pkg, tracer=None, arq_peer=False, seed=23):
    """The reference obs suite's chaos hub (``tests/test_obs.py``
    ``_crash_resume_hub``) on ``pkg``'s hub: two peers under seeded chaos,
    peer 0 crashes after one send and resumes over a fresh duplex, peer 1
    (``arq_peer``) sits behind a lossy seeded ARQ channel.  One shared
    ``tracer`` covers hub, endpoints, transports and injectors.  Each result
    equals ``core.pbs.reconcile`` (diff, ``bytes_sent``).  Returns (hub,
    alices by channel, outcomes, results by channel, ch0, ch1)."""
    net, cfg_of = pkg.net, pkg.PBSConfig
    rng = np.random.default_rng(seed)
    univ = rng.choice(1 << 20, size=3000, replace=False).astype(np.uint32)
    cfg_kw = dict(n_override=127, t_override=7, g_override=4)
    hub = pkg.hub(resume_window=30.0, recv_deadline=10.0, tracer=tracer)
    alices, pending, oracles = {}, {}, {}

    a0, b0 = univ[:2600], univ[400:]
    d0 = len(np.setxor1d(a0, b0))
    cfg0 = cfg_of(seed=seed, **cfg_kw)
    raw0, th0 = net.InMemoryDuplex.pair()
    t0 = net.ChaosTransport(raw0, net.FaultPlan(crash_after_sends=1), tracer=tracer)
    ch0 = hub.add_peer(th0, label="crasher")
    hub.submit(ch0, b0, cfg=cfg0, d_known=d0)
    alices[ch0] = pkg.alice(t0, channel=ch0, tracer=tracer)
    alices[ch0].submit(a0, cfg=cfg0, d_known=d0)
    oracles[ch0] = (a0, b0, cfg0, d0)

    ch1 = None
    if arq_peer:
        a1, b1 = make_pair(700, 60, np.random.default_rng(seed + 1))
        cfg1 = cfg_of(seed=seed + 1, **cfg_kw)
        raw1, rawh1 = net.InMemoryDuplex.pair()
        chaos1 = net.ChaosTransport(
            raw1, net.FaultPlan(seed=seed + 50, loss=0.15, dup=0.05), tracer=tracer)
        t1 = net.ReliableTransport(chaos1, timeout=0.02, max_retries=400, seed=1,
                                   tracer=tracer)
        th1 = net.ReliableTransport(rawh1, timeout=0.02, max_retries=400, seed=101,
                                    tracer=tracer)
        ch1 = hub.add_peer(th1, label="lossy")
        hub.submit(ch1, b1, cfg=cfg1, d_known=60)
        alices[ch1] = pkg.alice(t1, channel=ch1, tracer=tracer)
        alices[ch1].submit(a1, cfg=cfg1, d_known=60)
        oracles[ch1] = (a1, b1, cfg1, 60)

    def on_barrier(rnd):
        if "t" in pending and hub._peers[ch0].suspended:
            hub.resume_peer(ch0, pending.pop("t"))

    hub.on_barrier = on_barrier

    def drive0():
        try:
            return alices[ch0].run()
        except net.TransportError:
            pass
        na, nh = net.InMemoryDuplex.pair()
        pending["t"] = nh
        alices[ch0].resume(na)
        return alices[ch0].resume_run()

    fns = {ch0: drive0}
    if ch1 is not None:
        fns[ch1] = alices[ch1].run
    state, threads = {}, []
    for ch, fn in fns.items():
        def runner(ch=ch, fn=fn):
            state[ch] = fn()
        th = threading.Thread(target=runner, daemon=True)
        threads.append(th)
        th.start()
    outcomes = hub.serve()
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive(), "peer thread leaked"
    for ch, (a, b, cfg, dk) in oracles.items():
        res = state[ch][0]
        oracle = ref_pbs.reconcile(a, b, ref_pbs.PBSConfig(**vars(cfg)), d_known=dk)
        assert res.success and res.diff == oracle.diff
        assert res.bytes_sent == oracle.bytes_sent
    return hub, alices, outcomes, state, ch0, ch1
