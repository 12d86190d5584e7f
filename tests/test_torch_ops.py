"""The operations modules the training driver runs, ported to
``repro_torch``: ``checkpoint`` (atomic sharded saves, PBS-reconciled
manifests), ``data`` (the deterministic pipeline and the consumption
ledger) and ``launch.elastic`` (membership, recovery plans).

First the 12 tests of ``tests/test_fault_tolerance.py`` on the port, then
the two packages against each other: the same data, checkpoints that
restore bit-equal across packages with equal manifests (d = 0 under
``reconcile_manifests``), equal recovery plans, and bfloat16 leaves with
``ml_dtypes`` unimportable.  Everything is exact (tolerance 0).
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

import repro.checkpoint as ref_ckpt
import repro.data as ref_data
import repro.launch.elastic as ref_elastic
from repro_torch.checkpoint import (
    latest_step,
    load_manifest,
    reconcile_manifests,
    restore_checkpoint,
    save_checkpoint,
    sync_checkpoint,
)
from repro_torch.data import DataConfig, Ledger, global_batch, host_shard, step_sample_ids
from repro_torch.launch.elastic import (
    ElasticConfig,
    Membership,
    NodeState,
    plan_recovery,
    viable_grid,
)

SRC = str(Path(__file__).resolve().parents[1] / "src")


def _tree(rng, scale=1.0):
    return {
        "emb": {"w": (rng.normal(size=(2000, 64)) * scale).astype(np.float32)},
        "layers": {"q": rng.normal(size=(3, 64, 64)).astype(np.float32)},
        "step": np.int32(7),
    }


# ---------------------------------------------------------------------------
# checkpoints (tests/test_fault_tolerance.py on the port)
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    save_checkpoint(tmp_path, 5, tree)
    out, step = restore_checkpoint(tmp_path)
    assert step == 5
    np.testing.assert_array_equal(out["emb"]["w"], tree["emb"]["w"])
    np.testing.assert_array_equal(out["layers"]["q"], tree["layers"]["q"])
    assert out["step"] == 7


def test_checkpoint_gc_keeps_latest(tmp_path):
    rng = np.random.default_rng(0)
    for s in range(6):
        save_checkpoint(tmp_path, s, _tree(rng), keep=3)
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.iterdir()
                   if p.name.startswith("step_"))
    assert steps == [3, 4, 5]
    assert latest_step(tmp_path) == 5


def test_checkpoint_bfloat16_leaves(tmp_path):
    tree = {"w": torch.ones((17, 5), dtype=torch.bfloat16) * 1.5}
    save_checkpoint(tmp_path, 1, tree)
    out, _ = restore_checkpoint(tmp_path)
    assert out["w"].dtype == torch.bfloat16 and tuple(out["w"].shape) == (17, 5)
    assert torch.equal(out["w"].float(), torch.full((17, 5), 1.5))


def test_pbs_manifest_sync_moves_only_changed_shards(tmp_path):
    rng = np.random.default_rng(1)
    tree = {"w": rng.normal(size=(4_000_000,)).astype(np.float32)}  # ~16 MB, 4 shards
    save_checkpoint(tmp_path / "src", 1, tree)
    r0 = sync_checkpoint(tmp_path / "src", tmp_path / "dst")
    assert r0.shards_fetched == 4

    tree["w"] = tree["w"].copy()
    tree["w"][0] += 1.0                      # touches exactly one 4MiB block
    save_checkpoint(tmp_path / "src", 2, tree)
    r = sync_checkpoint(tmp_path / "src", tmp_path / "dst")
    assert r.success and r.shards_fetched == 1
    assert r.payload_bytes <= 4 * 2**20 + 1024
    assert r.pbs_bytes < r.naive_bytes       # beats shipping the manifest
    out, step = restore_checkpoint(tmp_path / "dst")
    assert step == 2
    np.testing.assert_array_equal(out["w"], tree["w"])


def test_manifest_reconcile_identical_is_free(tmp_path):
    rng = np.random.default_rng(2)
    tree = _tree(rng)
    save_checkpoint(tmp_path / "a", 3, tree)
    save_checkpoint(tmp_path / "b", 3, tree)
    ma = load_manifest(tmp_path / "a", 3)
    mb = load_manifest(tmp_path / "b", 3)
    fetch, delete, res = reconcile_manifests(ma, mb)
    assert fetch == [] and delete == [] and res.success


def test_checkpoint_atomicity_no_tmp_left(tmp_path):
    rng = np.random.default_rng(3)
    save_checkpoint(tmp_path, 1, _tree(rng))
    assert not [p for p in tmp_path.iterdir() if p.name.startswith(".tmp")]


# ---------------------------------------------------------------------------
# data pipeline + ledger
# ---------------------------------------------------------------------------


def test_data_determinism_and_sharding():
    cfg = DataConfig(vocab=1000, seq_len=16, global_batch=32)
    b1, b2 = global_batch(4, cfg), global_batch(4, cfg)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].min() >= 0 and b1["tokens"].max() < 1000
    ids = step_sample_ids(4, cfg)
    parts = [host_shard(ids, h, 4) for h in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts), ids)
    parts8 = [host_shard(ids, h, 8) for h in range(8)]
    np.testing.assert_array_equal(np.concatenate(parts8), ids)


def test_ledger_reconcile_exactly_once():
    cfg = DataConfig(vocab=100, seq_len=4, global_batch=64)
    fleet, node = Ledger(), Ledger()
    for s in range(30):
        ids = step_sample_ids(s, cfg)
        fleet.record(ids)
        if s < 25:
            node.record(ids)
    missing, extra, res = node.reconcile(fleet)
    assert res.success and len(missing) == 5 * 64 and not extra
    node.merge(missing)
    assert node.consumed == fleet.consumed
    assert res.bytes_sent + res.estimator_bytes < 4 * len(fleet.consumed)


@settings(max_examples=20, deadline=None)
@given(
    n_common=st.integers(0, 300),
    n_miss=st.integers(0, 40),
    seed=st.integers(0, 2**31 - 1),
)
def test_ledger_reconcile_property(n_common, n_miss, seed):
    rng = np.random.default_rng(seed)
    univ = rng.choice(np.arange(1, 1 << 20, dtype=np.uint32),
                      size=n_common + n_miss, replace=False)
    fleet, node = Ledger(), Ledger()
    fleet.record(univ)
    node.record(univ[: n_common])
    missing, extra, res = node.reconcile(fleet, seed=seed & 0xFFFF)
    assert res.success
    assert missing == set(int(x) for x in univ[n_common:])
    assert not extra


# ---------------------------------------------------------------------------
# elastic membership
# ---------------------------------------------------------------------------


def test_membership_failure_and_rejoin():
    t = [0.0]
    m = Membership([0, 1, 2, 3], ElasticConfig(), clock=lambda: t[0])
    for _ in range(12):
        t[0] += 1.0
        for n in (0, 1, 3):
            m.heartbeat(n, step_time=1.0)
        m.sweep()
    assert m.nodes[2].state == NodeState.DEAD
    assert m.alive() == [0, 1, 3]
    gen = m.generation
    m.heartbeat(2)                      # rejoins
    assert m.nodes[2].state == NodeState.JOINING
    m.admit(2)
    assert m.alive() == [0, 1, 2, 3] and m.generation == gen + 1


def test_straggler_detection():
    t = [0.0]
    m = Membership(range(8), ElasticConfig(straggler_factor=1.5), clock=lambda: t[0])
    for _ in range(10):
        t[0] += 1.0
        for n in range(8):
            m.heartbeat(n, step_time=2.0 if n == 5 else 1.0)
    assert m.stragglers() == [5]


@pytest.mark.parametrize("n,expect", [(256, (16, 16)), (255, (15, 16)), (17, (1, 16)), (8, (1, 8))])
def test_viable_grid(n, expect):
    assert viable_grid(n, 16) == expect
    assert ref_elastic.viable_grid(n, 16) == expect


# ---------------------------------------------------------------------------
# the two packages against each other
# ---------------------------------------------------------------------------


def test_data_pipeline_equals_reference():
    for kw in (dict(vocab=1000, seq_len=16, global_batch=32),
               dict(vocab=151_936, seq_len=64, global_batch=8, seed=3)):
        for step in (0, 1, 57):
            got = global_batch(step, DataConfig(**kw))
            want = ref_data.global_batch(step, ref_data.DataConfig(**kw))
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def _mixed_tree(rng):
    """float32, int32, uint8 and 0-d leaves, and a bfloat16 leaf of more
    than one 4 MiB block (the reference holds it as an ml_dtypes array, the
    port as a torch tensor: the same bits)."""
    bf = rng.standard_normal((1100, 2000)).astype(np.float32)
    bf_ref = bf.astype(ml_dtypes.bfloat16)
    bf_port = torch.from_numpy(bf_ref.view(np.int16).copy()).view(torch.bfloat16)
    base = {"emb": {"w": rng.standard_normal((300, 64)).astype(np.float32)},
            "codes": rng.integers(0, 256, 5000).astype(np.uint8),
            "step": np.asarray(12, np.int32),
            "meta": {"consumed": np.arange(1, 100, dtype=np.uint32)}}
    ref_tree = {**base, "bf": bf_ref}
    port_tree = {**base, "bf": bf_port,
                 "emb": {"w": torch.from_numpy(base["emb"]["w"].copy())}}
    return ref_tree, port_tree


def _leaf_bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x


def _assert_same_bits(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same_bits(a[k], b[k], f"{path}/{k}")
        return
    x, y = _leaf_bits(a), _leaf_bits(b)
    assert x.shape == y.shape and x.dtype == y.dtype, (path, x.dtype, y.dtype)
    np.testing.assert_array_equal(x, y)


def test_checkpoints_cross_packages_bit_equal(tmp_path):
    ref_tree, port_tree = _mixed_tree(np.random.default_rng(5))
    m_ref = ref_ckpt.save_checkpoint(tmp_path / "ref", 4, ref_tree)
    m_port = save_checkpoint(tmp_path / "port", 4, port_tree)
    assert m_port.shards == m_ref.shards and m_port.leaves == m_ref.leaves
    assert m_ref.leaves["bf"]["dtype"] == "bfloat16" and m_ref.leaves["bf"]["n_slots"] == 2
    # the port restores the reference's files, the reference the port's
    got, step = restore_checkpoint(tmp_path / "ref")
    assert step == 4 and got["bf"].dtype == torch.bfloat16
    _assert_same_bits(got, ref_tree)
    got_ref, _ = ref_ckpt.restore_checkpoint(tmp_path / "port")
    _assert_same_bits(got_ref, ref_tree)
    # manifests from disk: equal, and PBS finds nothing to move
    ma, mb = load_manifest(tmp_path / "ref", 4), ref_ckpt.load_manifest(tmp_path / "port", 4)
    assert ma.shards == mb.shards and ma.leaves == mb.leaves
    fetch, delete, res = reconcile_manifests(ma, load_manifest(tmp_path / "port", 4))
    assert fetch == [] and delete == [] and res.success and len(res.diff) == 0
    fetch, delete, res = ref_ckpt.reconcile_manifests(mb, ref_ckpt.load_manifest(
        tmp_path / "ref", 4))
    assert fetch == [] and delete == [] and res.success and len(res.diff) == 0


def test_recovery_plans_equal_across_packages(tmp_path):
    """``plan_recovery`` on the same directories and ledgers: the same plan
    in both packages (the syncs write into separate copies)."""
    rng = np.random.default_rng(6)
    tree = {"w": rng.normal(size=(3_000_000,)).astype(np.float32)}
    cfg = DataConfig(vocab=100, seq_len=4, global_batch=64)
    plans = []
    for name, pkg_save, pkg_plan, pkg_ledger in (
            ("port", save_checkpoint, plan_recovery, Ledger),
            ("ref", ref_ckpt.save_checkpoint, ref_elastic.plan_recovery, ref_data.Ledger)):
        root = tmp_path / name
        pkg_save(root / "stale", 1, tree)
        newer = {"w": tree["w"].copy()}
        newer["w"][:10] += 1.0
        pkg_save(root / "healthy", 2, newer)
        local, fleet = pkg_ledger(), pkg_ledger()
        for s in range(12):
            ids = step_sample_ids(s, cfg)
            fleet.record(ids)
            if s < 9:
                local.record(ids)
        plans.append(vars(pkg_plan(root / "stale", root / "healthy", local, fleet, seed=5)))
        assert local.consumed == fleet.consumed
    assert plans[0] == plans[1]
    assert plans[0]["shards_to_fetch"] == 1 and plans[0]["samples_to_skip"] == 3 * 64


def test_bfloat16_checkpoints_without_ml_dtypes(tmp_path):
    """In a process where ``ml_dtypes`` cannot be imported (and neither JAX
    nor the reference package is), the port writes and restores bfloat16
    leaves, and restores the reference's bfloat16 checkpoint bit-equal."""
    rng = np.random.default_rng(8)
    bf = rng.standard_normal((70, 30)).astype(ml_dtypes.bfloat16)
    ref_ckpt.save_checkpoint(tmp_path / "ref", 3, {"bf": bf, "f": np.ones(4, np.float32)})
    np.save(tmp_path / "bits.npy", bf.view(np.int16))
    code = textwrap.dedent(f"""
        import sys
        sys.modules["ml_dtypes"] = None          # import ml_dtypes now raises
        import numpy as np, torch
        from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
        try:
            import ml_dtypes  # noqa: F401
            raise SystemExit("ml_dtypes importable")
        except ImportError:
            pass
        bits = np.load({str(tmp_path / "bits.npy")!r})
        got, step = restore_checkpoint({str(tmp_path / "ref")!r})
        assert step == 3 and got["bf"].dtype == torch.bfloat16
        assert np.array_equal(got["bf"].view(torch.int16).numpy(), bits)
        w = torch.randn(33, 17).to(torch.bfloat16)
        save_checkpoint({str(tmp_path / "port")!r}, 1, {{"w": w, "bf": got["bf"]}})
        back, _ = restore_checkpoint({str(tmp_path / "port")!r})
        assert torch.equal(back["w"].view(torch.int16), w.view(torch.int16))
        bad = [m for m in sys.modules if m in ("jax", "ml_dtypes") or m.startswith("repro.")]
        assert not [m for m in bad if sys.modules[m] is not None], bad
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env={"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
    # and the reference restores what that process wrote, with ml_dtypes
    out, _ = ref_ckpt.restore_checkpoint(tmp_path / "port")
    assert out["bf"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(out["bf"].view(np.int16), bf.view(np.int16))
