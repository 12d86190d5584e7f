"""Elastic cluster runtime: membership, failure recovery, straggler mitigation.

This module is the control-plane glue that makes the framework runnable at
1000+ nodes.  It is deliberately hardware-free (pure Python state machines +
the PBS protocol) so the same logic drives both the LocalClusterSim used in
tests/examples and a real multi-host deployment (where transports become
RPCs and `torch.distributed` restarts processes).

Design (DESIGN.md §4):

* **Membership / failure detection** — heartbeat table with a deadline;
  a missed deadline marks the node SUSPECT then DEAD; mesh re-formation is
  triggered when the alive set changes (elastic rescale to the largest
  (data × model) grid that the alive count supports).
* **Recovery via PBS** — a (re)joining node reconciles (a) its checkpoint
  manifest and (b) its data-ledger against a healthy peer with PBS —
  O(d) decode, ~2× optimal bytes — then fetches exactly the missing shards
  (`repro_torch.checkpoint.sync_checkpoint`).  Piecewise reconciliability means
  shard fetches START while reconciliation of the remaining groups is still
  in flight (paper §1.3: the first round reconciles >95% of the diff).
* **Straggler mitigation** — per-step duration tracking; a node whose EWMA
  exceeds ``straggler_factor ×`` the fleet median is flagged; the scheduler
  first shrinks its data shard (work stealing), then evicts it from the mesh
  (the elastic path above).  Deterministic data assignment makes both safe.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum

import numpy as np


class NodeState(Enum):
    ALIVE = "alive"
    SUSPECT = "suspect"
    DEAD = "dead"
    JOINING = "joining"


@dataclass
class Node:
    node_id: int
    state: NodeState = NodeState.ALIVE
    last_heartbeat: float = 0.0
    step_ewma: float = 0.0
    steps_done: int = 0


@dataclass
class ElasticConfig:
    heartbeat_interval: float = 1.0
    suspect_after: float = 3.0      # missed-heartbeat seconds -> SUSPECT
    dead_after: float = 10.0        # -> DEAD, mesh re-forms
    straggler_factor: float = 1.5
    ewma: float = 0.3


def viable_grid(n: int, model: int = 16) -> tuple[int, int]:
    """Largest (data, model) grid with data*model <= n hosts*chips — data
    shrinks first (gradient accumulation keeps global batch constant)."""
    model = min(model, n)
    while n // model == 0:
        model //= 2
    return max(1, n // model), model


class Membership:
    """Heartbeat-driven membership table."""

    def __init__(self, node_ids, cfg: ElasticConfig | None = None, clock=time.monotonic):
        self.cfg = cfg or ElasticConfig()
        self.clock = clock
        now = clock()
        self.nodes = {i: Node(i, NodeState.ALIVE, now) for i in node_ids}
        self.generation = 0

    def heartbeat(self, node_id: int, step_time: float | None = None):
        n = self.nodes.setdefault(node_id, Node(node_id, NodeState.JOINING))
        n.last_heartbeat = self.clock()
        if n.state is NodeState.SUSPECT:
            n.state = NodeState.ALIVE
        elif n.state is NodeState.DEAD:
            n.state = NodeState.JOINING  # must PBS-sync state before admit()
        if step_time is not None:
            a = self.cfg.ewma
            n.step_ewma = step_time if n.step_ewma == 0 else (1 - a) * n.step_ewma + a * step_time
            n.steps_done += 1

    def sweep(self) -> bool:
        """Update states; returns True if the alive set changed (re-mesh)."""
        now = self.clock()
        changed = False
        for n in self.nodes.values():
            dt = now - n.last_heartbeat
            if n.state == NodeState.ALIVE and dt > self.cfg.suspect_after:
                n.state = NodeState.SUSPECT
            if n.state in (NodeState.ALIVE, NodeState.SUSPECT) and dt > self.cfg.dead_after:
                n.state = NodeState.DEAD
                changed = True
        if changed:
            self.generation += 1
        return changed

    def admit(self, node_id: int):
        """JOINING -> ALIVE after recovery completes (PBS sync done)."""
        n = self.nodes[node_id]
        n.state = NodeState.ALIVE
        n.last_heartbeat = self.clock()
        self.generation += 1

    def alive(self) -> list[int]:
        return sorted(i for i, n in self.nodes.items() if n.state == NodeState.ALIVE)

    def stragglers(self) -> list[int]:
        alive = [self.nodes[i] for i in self.alive() if self.nodes[i].step_ewma > 0]
        if len(alive) < 3:
            return []
        med = float(np.median([n.step_ewma for n in alive]))
        return [n.node_id for n in alive
                if n.step_ewma > self.cfg.straggler_factor * med]


@dataclass
class RecoveryPlan:
    shards_to_fetch: int
    payload_bytes: int
    pbs_bytes: int
    naive_bytes: int
    rounds: int
    samples_to_skip: int


def plan_recovery(local_ckpt_root, healthy_ckpt_root, local_ledger, fleet_ledger,
                  *, seed: int = 0) -> RecoveryPlan:
    """Everything a rejoining node needs, via two PBS reconciliations."""
    from repro_torch.checkpoint.manager import sync_checkpoint

    rep = sync_checkpoint(healthy_ckpt_root, local_ckpt_root, seed=seed)
    missing, _extra, res = local_ledger.reconcile(fleet_ledger, seed=seed + 1)
    local_ledger.merge(missing)
    return RecoveryPlan(
        shards_to_fetch=rep.shards_fetched,
        payload_bytes=rep.payload_bytes,
        pbs_bytes=rep.pbs_bytes + res.bytes_sent + res.estimator_bytes,
        naive_bytes=rep.naive_bytes + 4 * max(1, len(fleet_ledger.consumed)),
        rounds=max(rep.rounds, res.rounds),
        samples_to_skip=len(missing),
    )
