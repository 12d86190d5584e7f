"""Batched reconciliation serving on the PyTorch/CUDA port: mixed sessions
through ``repro_torch.recon``.

The twin of ``examples/serve_batch.py`` on ``repro_torch``: many concurrent
Alice↔Bob pairs of different sizes and difference cardinalities, some with
unknown d (ToW phase 0 on the card), one deliberately BCH-overloaded so the
3-way split fires mid-batch — driven end-to-end by the port's
``ReconcileServer``.  Every round, the planner packs all live units of all
sessions into per-code cohorts and the round executor runs the bin/sketch
kernels and the batched decoder for the whole fleet at once (DESIGN.md §5).

Run:  PYTHONPATH=src python examples/serve_batch_torch.py [--device cpu]
(default device: the CUDA card.)
"""
import argparse
import pathlib
import sys
import time

if __name__ == "__main__":  # standalone: make src/ importable
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.core.pbs import PBSConfig, true_diff
from repro_torch.core.simdata import make_pair, make_pair_two_sided
from repro_torch.kernels.platform import resolve_device
from repro_torch.recon import ReconcileServer


def workload():
    """(label, a, b, cfg, d_known) per session, in submission order."""
    rng = np.random.default_rng(0)
    sessions = []
    # plain sessions with mixed sizes / difference cardinalities
    for i, (size, d) in enumerate(
        [(2000, 5), (3000, 20), (1500, 8), (4000, 60), (2500, 12), (3500, 40)]
    ):
        a, b = make_pair(size, d, np.random.default_rng(100 + i))
        sessions.append((f"d={d}", a, b, PBSConfig(seed=i), d))
    # two-sided + estimator-path sessions (d unknown -> ToW phase 0)
    a, b = make_pair_two_sided(3000, 25, 15, rng)
    sessions.append(("two-sided,est", a, b, PBSConfig(seed=31), None))
    # one overloaded session: d far above t in a single group -> 3-way split
    a, b = make_pair(2500, 40, np.random.default_rng(17))
    cfg = PBSConfig(seed=6, n_override=255, t_override=8, g_override=1)
    sessions.append(("overload,split", a, b, cfg, 40))
    return sessions


def main(device=None):
    """Serve the workload on ``device`` (None: the card, and raise without
    one).  Returns the workload, the results by sid and the server's stats."""
    server = ReconcileServer(device=resolve_device(device))
    sessions = workload()
    sids = [server.submit(a, b, cfg=cfg, d_known=dk) for _, a, b, cfg, dk in sessions]

    t0 = time.perf_counter()
    results = server.run()
    wall = time.perf_counter() - t0

    print(f"served {len(sessions)} sessions on {server.device} in {wall:.1f}s "
          f"({len(sessions) / wall:.2f} sessions/s)")
    print(f"{'sid':>3} {'label':<15} {'rounds':>6} {'bytes':>7} "
          f"{'bytes/d':>8} {'splits':>6}  exact")
    for sid, (label, a, b, _, _) in zip(sids, sessions):
        r = results[sid]
        td = true_diff(a, b)
        d = max(1, len(td))
        assert r.success and r.diff == td
        print(f"{sid:>3} {label:<15} {r.rounds:>6} {r.bytes_sent:>7} "
              f"{r.bytes_sent / d:>8.1f} {r.decode_failures:>6}  ok")
    total = sum(results[s].bytes_sent for s in sids)
    print(f"total protocol bytes: {total:,}")

    # the transfer/launch ledger of the device-resident pipeline
    # (DESIGN.md §5): element stores upload once, rounds ship only small
    # gather/overlay arrays, and the fused two-side encode halves launches
    st = server.stats
    print(f"device ledger: {st['h2d_store_bytes']:,} B store upload + "
          f"{st['h2d_round_bytes']:,} B round overlays "
          f"({st['h2d_ratio']:.1f}x less H2D than re-packing per round)")
    print(f"  {st['kernel_launches']} fused kernel launches vs "
          f"{st['legacy_kernel_launches']} legacy over "
          f"{st['cohort_rounds']} cohort-rounds; "
          f"phase0 {st['phase0_s'] * 1e3:.0f} ms, "
          f"device {st['device_s'] * 1e3:.0f} ms, "
          f"host {st['host_s'] * 1e3:.0f} ms")
    return {"sessions": sessions, "results": {i: results[s] for i, s in enumerate(sids)},
            "stats": st}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
