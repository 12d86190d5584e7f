"""Elastic failure recovery with PBS-reconciled state on the PyTorch/CUDA
port.

The twin of ``examples/elastic_recovery.py``: a 4-node fleet trains; node
2 dies mid-run and rejoins later with a stale checkpoint and a stale data
ledger.  Recovery reconciles BOTH with PBS (shard manifests +
consumed-sample ids, ``repro_torch.launch.elastic.plan_recovery``) and
fetches only what changed; the recovered checkpoint is then loaded onto
the device and held against the fleet's parameters there.

Run:  PYTHONPATH=src python examples/elastic_recovery_torch.py [--device cpu]
(default device: the CUDA card.)
"""
import argparse
import pathlib
import sys
import tempfile

if __name__ == "__main__":  # standalone: make src/ importable
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.data import DataConfig, Ledger, global_batch
from repro_torch.kernels.platform import resolve_device
from repro_torch.launch.elastic import (
    ElasticConfig,
    Membership,
    NodeState,
    plan_recovery,
    viable_grid,
)


def main(device=None):
    """Run the scenario; the recovered parameters land on ``device`` (None:
    the card, and raise without one).  Returns the ``RecoveryPlan`` and the
    restored step."""
    dev = resolve_device(device)
    root = pathlib.Path(tempfile.mkdtemp(prefix="elastic_demo_"))
    rng = np.random.default_rng(0)
    dcfg = DataConfig(vocab=32_000, seq_len=64, global_batch=64)

    # a stand-in model state: 32 MB of parameters in 8 leaves
    params = {f"layer{i}": rng.standard_normal((1_000_000,)).astype(np.float32)
              for i in range(8)}

    t = [0.0]
    fleet = Membership([0, 1, 2, 3], ElasticConfig(), clock=lambda: t[0])
    fleet_ledger, node2_ledger = Ledger(), Ledger()

    # --- steps 0..199: everyone healthy; node 2 dies at step 188
    n_steps, fail_at = 200, 188
    for step in range(n_steps):
        t[0] += 1.0
        ids = global_batch(step, dcfg)["ids"]
        fleet_ledger.record(ids)
        for n in (0, 1, 3):
            fleet.heartbeat(n, step_time=1.0)
        if step < fail_at:
            node2_ledger.record(ids)
            fleet.heartbeat(2, step_time=1.0)
        if step == fail_at - 1:
            save_checkpoint(root / "node2", step + 1,
                            {"params": params, "step": np.int64(step + 1)})
        # healthy nodes keep checkpointing; params drift a little each time
        if (step + 1) % 50 == 0 or step == n_steps - 1:
            drifted = {k: (v + 0.001 * (step + 1)) if k in ("layer0", "layer5") else v
                       for k, v in params.items()}
            params = drifted
            save_checkpoint(root / "healthy", step + 1,
                            {"params": params, "step": np.int64(step + 1)})
        fleet.sweep()

    assert fleet.nodes[2].state == NodeState.DEAD
    print(f"node 2 DEAD; alive={fleet.alive()} -> grid {viable_grid(len(fleet.alive()) * 64)}")

    # --- node 2 rejoins: PBS-reconcile checkpoint manifest + data ledger
    fleet.heartbeat(2)
    plan = plan_recovery(root / "node2", root / "healthy",
                         node2_ledger, fleet_ledger, seed=11)
    fleet.admit(2)
    print(f"recovery: fetched {plan.shards_to_fetch} shards "
          f"({plan.payload_bytes / 2**20:.1f} MiB payload), "
          f"skipping {plan.samples_to_skip} already-consumed samples")
    print(f"  reconciliation cost: {plan.pbs_bytes:,} B (PBS) vs "
          f"{plan.naive_bytes:,} B naive -> {plan.naive_bytes / plan.pbs_bytes:.0f}x saved, "
          f"{plan.rounds} round(s)")

    tree, step = restore_checkpoint(root / "node2")
    on_dev = {k: torch.from_numpy(v).to(dev) for k, v in tree["params"].items()}
    want = {k: torch.from_numpy(v).to(dev) for k, v in params.items()}
    assert step == 200 and all(torch.equal(on_dev[k], want[k]) for k in want)
    print(f"node 2 restored to step {step} on {dev}; alive={fleet.alive()} "
          f"-> grid {viable_grid(len(fleet.alive()) * 64)}")
    return {"plan": plan, "step": step}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
