"""Deterministic synthetic data pipeline + PBS-reconciled consumption ledger.

The pipeline is the substrate a real deployment needs for elastic,
exactly-once data feeding at 1000-node scale:

* **Deterministic sharded batches** — sample ``i`` of the global stream is
  generated from ``mix32(i)`` alone, so any host can produce any shard of any
  step without coordination; host assignment is a pure function of
  (step, host, n_hosts).  Elastic rescale = change n_hosts; no data is
  re-shuffled through a coordinator.
* **Consumption ledger** — each host records consumed sample ids.  After a
  failure/rescale, a (re)joining host must learn exactly which samples the
  fleet already consumed this epoch.  The fleet's ledger is huge (billions)
  but the *difference* against the joiner's stale ledger is small — a set
  reconciliation problem, solved with PBS in O(d) time and ~2× optimal bytes
  (``Ledger.reconcile``), instead of shipping the full ledger.

Samples are 32-bit ids (the paper's universe); token content is derived from
the id, so reconciling ids reconciles data exactly.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.hashing import mix32
from repro_torch.core.pbs import PBSConfig, reconcile


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


def sample_tokens(ids: np.ndarray, cfg: DataConfig) -> np.ndarray:
    """Tokens for each sample id — pure function of the id (exactly-once safe)."""
    pos = np.arange(cfg.seq_len, dtype=np.uint32)[None, :]
    base = mix32(ids.astype(np.uint32), cfg.seed ^ 0xD474)
    toks = mix32(base[:, None] + pos * np.uint32(0x9E3779B9), cfg.seed ^ 0x70C5)
    return (toks % np.uint32(cfg.vocab)).astype(np.int32)


def step_sample_ids(step: int, cfg: DataConfig) -> np.ndarray:
    start = np.uint32(1 + step * cfg.global_batch)  # id 0 excluded (PBS universe)
    return (start + np.arange(cfg.global_batch, dtype=np.uint32)).astype(np.uint32)


def host_shard(ids: np.ndarray, host: int, n_hosts: int) -> np.ndarray:
    per = len(ids) // n_hosts
    return ids[host * per : (host + 1) * per]


def global_batch(step: int, cfg: DataConfig) -> dict:
    """The full (tokens, labels) batch for one step."""
    ids = step_sample_ids(step, cfg)
    toks = sample_tokens(ids, cfg)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = toks[:, 0]
    return {"tokens": toks, "labels": labels, "ids": ids}


@dataclass
class Ledger:
    """Per-host consumed-sample-id set with PBS reconciliation."""

    consumed: set = field(default_factory=set)

    def record(self, ids: np.ndarray):
        self.consumed.update(int(x) for x in np.asarray(ids).ravel())

    def as_array(self) -> np.ndarray:
        return np.fromiter(self.consumed, dtype=np.uint32, count=len(self.consumed))

    def reconcile(self, fleet: "Ledger", seed: int = 0):
        """Learn the fleet's consumed set (PBS; returns (missing_here,
        extra_here, ReconcileResult with byte ledger))."""
        res = reconcile(self.as_array(), fleet.as_array(), PBSConfig(seed=seed))
        missing = {s for s in res.diff if s not in self.consumed}
        extra = {s for s in res.diff if s in self.consumed}
        return missing, extra, res

    def merge(self, missing):
        self.consumed.update(missing)
