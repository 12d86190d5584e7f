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

import repro.core.pbs as ref_pbs
import repro.net as ref_net
import repro.recon.session as ref_session
import repro.tree as ref_tree
import repro_torch.core.pbs as port_pbs
import repro_torch.net as port_net
import repro_torch.recon.session as port_session
import repro_torch.tree as port_tree

from _torch_port import RESULT_FIELDS


def _pkg(name, net, pbs, tree, session, dev):
    ns = SimpleNamespace(
        name=name, net=net, pbs=pbs, tree=tree, session=session, dev=dev,
        Alice=net.AliceEndpoint, PBSConfig=pbs.PBSConfig, TreeConfig=tree.TreeConfig,
    )
    ns.hub = lambda **kw: net.HubEndpoint(**dev, **kw)
    ns.alice = lambda t, cls=None, **kw: (cls or net.AliceEndpoint)(t, **dev, **kw)
    ns.bob = lambda t, **kw: net.BobEndpoint(t, **dev, **kw)
    return ns


PORT = _pkg("port", port_net, port_pbs, port_tree, port_session, {"device": "cpu"})
REF = _pkg("jax", ref_net, ref_pbs, ref_tree, ref_session, {})


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
