"""Fault-tolerant sharded checkpointing with PBS-reconciled manifests.

Layout of a checkpoint directory::

    step_000120/
      MANIFEST.json        # {"step":…, "shards": {shard_id: {leaf, slot, hash, bytes}}}
      <shard_id>.npy       # one block of one flattened leaf (BLOCK_BYTES each)

Shards are content-addressed: ``shard_id = blake2b(leaf_path, slot)`` and the
manifest records a content hash per shard.  Writes are atomic (tmp dir +
``os.replace``); a crash mid-save never corrupts the previous checkpoint.

**PBS integration (the paper's technique as a first-class feature).**  A
recovering / rejoining host holds an older or partial checkpoint; instead of
shipping the full manifest (O(#shards · entry) bytes) the two hosts run the
PBS set-reconciliation protocol over 32-bit shard *signatures*
(hash(shard_id, content_hash)): ``d`` = number of differing shards is tiny
after a short outage, so PBS finds the exact missing/stale set in O(d)
decode time and ~2× the information-theoretic minimum bytes (paper §1.3),
and only those shards' payloads move.  ``sync_checkpoint`` below does this
end-to-end on real directories and reports the byte ledger vs. a naive
manifest exchange.

Elastic re-sharding: shards store *global* leaf blocks, so the checkpoint
format is mesh-independent.

The port's copy of ``repro.checkpoint.manager``: the same layout, shard
ids, content hashes and manifests, so a checkpoint written by either
package restores bit-equal in the other.  Leaves may be numpy arrays or
torch tensors (copied to the host).  A bfloat16 leaf — a torch tensor, or
an ``ml_dtypes`` array from the reference — is stored as its 16-bit
pattern under the manifest dtype ``"bfloat16"``, the bytes the reference
writes; ``restore_checkpoint`` returns it as a CPU ``torch.bfloat16``
tensor (numpy has no bfloat16 without ``ml_dtypes``, which the port does
not need) and every other leaf as a numpy array.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

import torch

from repro_torch.core.pbs import PBSConfig, reconcile

BLOCK_BYTES = 1 << 22  # 4 MiB shards


# ---------------------------------------------------------------------------
# tree <-> flat leaves
# ---------------------------------------------------------------------------


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    out[prefix] = tree
    return out


def _unflatten(leaves: dict):
    tree: dict = {}
    for path, v in leaves.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _shard_id(leaf: str, slot: int) -> str:
    return hashlib.blake2b(f"{leaf}#{slot}".encode(), digest_size=10).hexdigest()


def _content_hash(arr: np.ndarray) -> str:
    return hashlib.blake2b(arr.tobytes(), digest_size=10).hexdigest()


def _host_array(arr) -> tuple:
    """(numpy array of the leaf's bytes, dtype name): a torch tensor copied
    to the host, a bfloat16 one as its int16 bit pattern under
    ``"bfloat16"``."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    a = np.asarray(arr)
    return a, str(a.dtype)


def signature(shard_id: str, content_hash: str) -> int:
    """32-bit signature of a manifest entry — the PBS set element."""
    h = hashlib.blake2b(f"{shard_id}:{content_hash}".encode(), digest_size=4)
    sig = int.from_bytes(h.digest(), "little")
    return sig or 1  # 0 is excluded from the PBS universe (paper §2.1)


# ---------------------------------------------------------------------------
# save / restore
# ---------------------------------------------------------------------------


@dataclass
class Manifest:
    step: int
    shards: dict            # shard_id -> {leaf, slot, hash, bytes, shape?, dtype?}
    leaves: dict            # leaf -> {shape, dtype, n_slots}

    def signatures(self) -> np.ndarray:
        return np.array(
            [signature(s, e["hash"]) for s, e in self.shards.items()], dtype=np.uint32
        )

    def by_signature(self) -> dict:
        return {signature(s, e["hash"]): s for s, e in self.shards.items()}


def save_checkpoint(root: str | Path, step: int, tree, *, keep: int = 3) -> Manifest:
    """Atomic sharded save of a tree of numpy arrays or torch tensors (on
    any device)."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:08d}"
    tmp = Path(tempfile.mkdtemp(dir=root, prefix=".tmp_save_"))
    leaves = _flatten(tree)
    shards, leaf_meta = {}, {}
    try:
        for leaf, arr in leaves.items():
            a, dtype = _host_array(arr)
            # byte-level blocks: dtype-agnostic (bf16 etc. survive the trip)
            flat = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
            per = BLOCK_BYTES
            n_slots = max(1, -(-flat.size // per))
            leaf_meta[leaf] = {
                "shape": list(a.shape), "dtype": dtype, "n_slots": n_slots, "per": per,
            }
            for slot in range(n_slots):
                blk = flat[slot * per : (slot + 1) * per]
                sid = _shard_id(leaf, slot)
                np.save(tmp / f"{sid}.npy", blk)
                shards[sid] = {
                    "leaf": leaf, "slot": slot,
                    "hash": _content_hash(blk), "bytes": int(blk.nbytes),
                }
        man = {"step": step, "time": time.time(), "shards": shards, "leaves": leaf_meta}
        (tmp / "MANIFEST.json").write_text(json.dumps(man))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(root, keep)
    return Manifest(step, shards, leaf_meta)


def _gc(root: Path, keep: int):
    steps = sorted(p for p in root.iterdir() if p.name.startswith("step_"))
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(root: str | Path) -> int | None:
    root = Path(root)
    if not root.exists():
        return None
    steps = sorted(
        int(p.name.split("_")[1]) for p in root.iterdir()
        if p.name.startswith("step_") and (p / "MANIFEST.json").exists()
    )
    return steps[-1] if steps else None


def load_manifest(root: str | Path, step: int) -> Manifest:
    d = Path(root) / f"step_{step:08d}"
    man = json.loads((d / "MANIFEST.json").read_text())
    return Manifest(man["step"], man["shards"], man["leaves"])


def restore_checkpoint(root: str | Path, step: int | None = None):
    """Rebuild the global pytree from shards (mesh-independent)."""
    root = Path(root)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {root}")
    d = root / f"step_{step:08d}"
    man = load_manifest(root, step)
    leaves = {}
    for leaf, meta in man.leaves.items():
        parts = []
        for slot in range(meta["n_slots"]):
            sid = _shard_id(leaf, slot)
            parts.append(np.load(d / f"{sid}.npy"))
        flat = np.concatenate(parts) if len(parts) > 1 else parts[0]
        if meta["dtype"] == "bfloat16":
            bits = flat.view(np.int16).reshape(meta["shape"])
            leaves[leaf] = torch.from_numpy(bits.copy()).view(torch.bfloat16)
        else:
            leaves[leaf] = flat.view(np.dtype(meta["dtype"])).reshape(meta["shape"])
    return _unflatten(leaves), step


# ---------------------------------------------------------------------------
# PBS-reconciled checkpoint sync
# ---------------------------------------------------------------------------


@dataclass
class SyncReport:
    step: int
    shards_fetched: int
    shards_deleted: int
    payload_bytes: int
    pbs_bytes: int            # reconciliation protocol bytes (both directions)
    naive_bytes: int          # full-manifest exchange cost
    rounds: int
    success: bool


def reconcile_manifests(local: Manifest, remote: Manifest, seed: int = 0):
    """PBS set reconciliation over shard signatures.

    Returns (to_fetch shard_ids, to_delete shard_ids, ReconcileResult).
    Alice = the local (stale) host; it learns the symmetric difference and
    resolves each differing signature against the remote manifest.
    """
    a = local.signatures()
    b = remote.signatures()
    res = reconcile(a, b, PBSConfig(seed=seed))
    by_sig_remote = remote.by_signature()
    by_sig_local = local.by_signature()
    to_fetch = [by_sig_remote[s] for s in res.diff if s in by_sig_remote]
    to_delete = [
        by_sig_local[s] for s in res.diff
        if s in by_sig_local and by_sig_local[s] not in remote.shards
    ]
    return to_fetch, to_delete, res


def sync_checkpoint(src_root: str | Path, dst_root: str | Path, *, seed: int = 0) -> SyncReport:
    """Bring dst up to date with src's latest checkpoint, moving only the
    shards PBS identifies as different."""
    src_root, dst_root = Path(src_root), Path(dst_root)
    step = latest_step(src_root)
    assert step is not None, f"nothing to sync from {src_root}"
    remote = load_manifest(src_root, step)

    local_step = latest_step(dst_root)
    if local_step is None:
        local = Manifest(-1, {}, {})
        src_dir = src_root / f"step_{step:08d}"
        dst_dir = dst_root / f"step_{step:08d}"
        shutil.copytree(src_dir, dst_dir, dirs_exist_ok=True)
        payload = sum(e["bytes"] for e in remote.shards.values())
        return SyncReport(step, len(remote.shards), 0, payload, 0,
                          _manifest_bytes(remote), 1, True)
    local = load_manifest(dst_root, local_step)

    to_fetch, to_delete, res = reconcile_manifests(local, remote, seed)
    src_dir = src_root / f"step_{step:08d}"
    tmp = Path(tempfile.mkdtemp(dir=dst_root, prefix=".tmp_sync_"))
    try:
        # start from the local checkpoint's shards (hardlink-as-copy), then patch
        local_dir = dst_root / f"step_{local_step:08d}"
        for f in local_dir.glob("*.npy"):
            shutil.copy2(f, tmp / f.name)
        payload = 0
        for sid in to_fetch:
            shutil.copy2(src_dir / f"{sid}.npy", tmp / f"{sid}.npy")
            payload += remote.shards[sid]["bytes"]
        for sid in to_delete:
            p = tmp / f"{sid}.npy"
            if p.exists():
                p.unlink()
        shutil.copy2(src_dir / "MANIFEST.json", tmp / "MANIFEST.json")
        final = dst_root / f"step_{step:08d}"
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return SyncReport(
        step=step,
        shards_fetched=len(to_fetch),
        shards_deleted=len(to_delete),
        payload_bytes=payload,
        pbs_bytes=res.bytes_sent + res.estimator_bytes,
        naive_bytes=_manifest_bytes(remote),
        rounds=res.rounds,
        success=res.success,
    )


def _manifest_bytes(man: Manifest) -> int:
    return len(json.dumps(man.shards).encode())
