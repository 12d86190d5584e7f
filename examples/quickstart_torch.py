"""Quickstart on the PyTorch/CUDA port: the paper's protocol end-to-end,
oracle and engine.

The twin of ``examples/quickstart.py`` on ``repro_torch``: Alice and Bob
hold two large key sets differing in d elements; PBS lets Alice learn the
difference in O(d) time and ~2x the information-theoretic minimum bytes.
The same pair then runs through the port's batched ``ReconcileServer``
(phase-0 ToW estimate, then the fused bin/sketch kernels and the batched
decoder on the card) — byte-identical to the port's numpy oracle
``repro_torch.core.pbs.reconcile``, asserted.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
(default device: the CUDA card; ``--device cpu`` runs the kernels' plain
PyTorch versions.)
"""
import argparse
import pathlib
import sys

if __name__ == "__main__":  # standalone: make src/ importable
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.core.pbs import PBSConfig, reconcile, true_diff
from repro_torch.core.simdata import make_pair_two_sided
from repro_torch.kernels.platform import resolve_device
from repro_torch.recon import ReconcileServer


def main(device=None):
    """Run the quickstart on ``device`` (None: the card, and raise without
    one).  Returns the sets, the oracle's and the engine's results and the
    server's stats."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    # 100k-element sets differing in 600 keys (400 only-Alice, 200 only-Bob)
    A, B = make_pair_two_sided(100_000, 400, 200, rng)
    d = len(true_diff(A, B))
    print(f"|A|={len(A):,} |B|={len(B):,} d={d}")

    res = reconcile(A, B, PBSConfig(seed=7))
    assert res.success and res.diff == true_diff(A, B)

    minimum = d * 4  # d * log|U| bits = 4 bytes per element
    print(f"reconciled in {res.rounds} round(s)")
    print(f"  protocol bytes : {res.bytes_sent:,} "
          f"({res.bytes_sent / minimum:.2f}x the theoretical minimum)")
    print(f"  estimator bytes: {res.estimator_bytes} (ToW, 128 sketches)")
    print(f"  parameters     : n={res.n} t={res.t} g={res.g} "
          f"(optimized for d_hat={res.d_est:.0f})")
    print(f"  naive transfer : {4 * len(B):,} bytes "
          f"({4 * len(B) / res.bytes_sent:.0f}x more)")

    # the same pair through the batched engine on the device: identical
    # bytes, plus the transfer/launch ledger of the device-resident pipeline
    server = ReconcileServer(device=device)
    sid = server.submit(A, B, cfg=PBSConfig(seed=7))
    engine = server.run()[sid]
    assert engine.diff == res.diff and engine.bytes_sent == res.bytes_sent
    st = server.stats
    print(f"batched engine on {device} (byte-identical, asserted):")
    print(f"  H2D bytes      : {st['h2d_store_bytes']:,} store (once) + "
          f"{st['h2d_round_bytes']:,}/run overlays "
          f"= {st['h2d_ratio']:.1f}x less than re-packing per round")
    print(f"  kernel launches: {st['kernel_launches']} fused "
          f"(legacy {st['legacy_kernel_launches']}) over "
          f"{st['cohort_rounds']} cohort-rounds")
    print(f"  time           : phase0 {st['phase0_s'] * 1e3:.0f} ms, "
          f"device {st['device_s'] * 1e3:.0f} ms, "
          f"host {st['host_s'] * 1e3:.0f} ms")
    return {"a": A, "b": B, "oracle": res, "engine": engine, "stats": st}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
