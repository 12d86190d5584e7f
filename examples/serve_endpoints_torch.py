"""Two-endpoint PBS reconciliation on the PyTorch/CUDA port: Alice and Bob
exchanging real bytes.

The twin of ``examples/serve_endpoints.py`` on ``repro_torch``: the same
multi-session workload three ways (DESIGN.md §9), each side encoding its
rounds on its ``device``:

1. **in-memory duplex** — the pure-protocol path: mixed session sizes, an
   estimator-path session (ToW phase 0 on the wire, host numpy), and a
   deliberately BCH-overloaded session whose 3-way split both endpoints
   mirror;
2. **TCP loopback socket** — the same sessions over a real socket;
3. **lossy simulated channel** — 25% datagram loss under the stop-and-wait
   ``ReliableTransport``, forcing retransmissions.

Every session's result is asserted byte-identical to the port's
in-process oracle ``repro_torch.core.pbs.reconcile``, and the printed
ledgers are *measured* from the frames that crossed the transport.

Run:  PYTHONPATH=src python examples/serve_endpoints_torch.py [--device cpu]
(default device: the CUDA card.)
"""
import argparse
import pathlib
import sys
import time

if __name__ == "__main__":  # standalone: make src/ importable
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.core.pbs import PBSConfig, reconcile, true_diff
from repro_torch.core.simdata import make_pair, make_pair_two_sided
from repro_torch.kernels.platform import resolve_device
from repro_torch.net import (
    AliceEndpoint,
    BobEndpoint,
    InMemoryDuplex,
    ReliableTransport,
    SimulatedChannel,
    run_pair,
    tcp_loopback_pair,
)


def workload():
    sessions = []
    for i, (size, d) in enumerate([(2000, 5), (3000, 20), (1500, 8)]):
        a, b = make_pair(size, d, np.random.default_rng(100 + i))
        sessions.append((f"d={d}", a, b, PBSConfig(seed=i), d))
    a, b = make_pair_two_sided(2500, 18, 12, np.random.default_rng(9))
    sessions.append(("two-sided,est", a, b, PBSConfig(seed=31), None))
    a, b = make_pair(2500, 40, np.random.default_rng(17))
    cfg = PBSConfig(seed=6, n_override=255, t_override=8, g_override=1)
    sessions.append(("overload,split", a, b, cfg, 40))
    return sessions


def drive(label, sessions, ta, tb, device):
    alice, bob = AliceEndpoint(ta, device=device), BobEndpoint(tb, device=device)
    for _, a, b, cfg, dk in sessions:
        alice.submit(a, cfg=cfg, d_known=dk)
        bob.submit(b, cfg=cfg, d_known=dk)
    t0 = time.perf_counter()
    results = run_pair(alice, bob)
    wall = time.perf_counter() - t0

    print(f"\n[{label}] served {len(sessions)} sessions in {wall:.1f}s")
    print(f"{'sid':>3} {'label':<15} {'rounds':>6} {'wire B':>7} {'est B':>6}  exact==oracle")
    for sid, (name, a, b, cfg, dk) in enumerate(sessions):
        r = results[sid]
        oracle = reconcile(a, b, cfg, d_known=dk)
        assert r.success and r.diff == true_diff(a, b)
        assert r.bytes_per_round == oracle.bytes_per_round, "wire ledger != oracle"
        assert r.estimator_bytes == oracle.estimator_bytes
        print(f"{sid:>3} {name:<15} {r.rounds:>6} {r.bytes_sent:>7} "
              f"{r.estimator_bytes:>6}  ok")
    assert bob.verified == [True] * len(sessions)
    ws = alice.wire_stats
    print(f"    frames {ws['frames_out']}→ / ←{ws['frames_in']}, "
          f"protocol {ws['protocol_frame_bytes']} B framed "
          f"(+{ws['estimator_frame_bytes']} B estimator, "
          f"+{ws['verify_frame_bytes']} B verify)")
    return alice, bob, results


def main(device=None):
    """All three transports on ``device`` (None: the card, and raise without
    one).  Returns, per transport, the sessions, the results by sid and
    both endpoints' ``wire_stats`` (and the lossy channel's drop and
    retransmit counts)."""
    device = resolve_device(device)
    sessions = workload()
    out = {}

    def keep(name, sess, alice, bob, results, **extra):
        out[name] = {"sessions": sess, "results": results, "alice": alice.wire_stats,
                     "bob": bob.wire_stats, **extra}

    ta, tb = InMemoryDuplex.pair()
    keep("memory", sessions, *drive("in-memory duplex", sessions, ta, tb, device))

    ta, tb = tcp_loopback_pair()
    try:
        alice, bob, results = drive("tcp loopback 127.0.0.1", sessions, ta, tb, device)
        ws = alice.wire_stats
        assert ws["transport_bytes_out"] == ws["frame_bytes_out"]
        keep("tcp", sessions, alice, bob, results)
    finally:
        ta.close()
        tb.close()

    one = sessions[:1]
    ca, cb = SimulatedChannel.pair(loss=0.25, latency=0.001, seed=42)
    ra, rb = ReliableTransport(ca, timeout=0.02), ReliableTransport(cb, timeout=0.02)
    alice, bob, results = drive("lossy channel (25% loss, ARQ)", one, ra, rb, device)
    print(f"    channel dropped {ca.dropped + cb.dropped} datagrams, "
          f"ARQ retransmitted {ra.retransmits + rb.retransmits}")
    keep("lossy", one, alice, bob, results, dropped=ca.dropped + cb.dropped,
         retransmits=ra.retransmits + rb.retransmits)

    print("\nall transports: results byte-identical to core.pbs.reconcile")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
