"""The tree front end of the port on the CPU (DESIGN.md §15): its
``tree_digest`` (K4's plain version), ``level_digests``, ``partition_pair``
and ``tree_reconcile`` == the JAX package's (Pallas in interpret mode) ==
the numpy oracles (``level_digests_ref``, per-leaf ``core.pbs.reconcile``).

Pairs are the adversarial shapes of ``tests/test_tree_conformance.py`` at
the same sizes.  The CUDA kernel itself is held against the same plain
version on the card by ``chip_smoke.py``.  Tolerance: 0 everywhere.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pbs import PBSConfig as RefPBSConfig
from repro.core.pbs import reconcile as ref_reconcile
from repro.core.pbs import true_diff
from repro.core.simdata import make_pair
from repro.kernels import ref
from repro.kernels.tree_digest import tree_digest as tree_digest_jax
from repro.obs import Recorder as RefRecorder
from repro.tree import partition as ref_tree
from repro_torch.core.pbs import PBSConfig, reconcile
from repro_torch.kernels import platform
from repro_torch.kernels.platform import upload
from repro_torch.kernels.tow_sketch import tow_sketch
from repro_torch.kernels.tree_digest import tree_digest, tree_digest_plain
from repro_torch.obs import Recorder
from repro_torch.tree import partition as port_tree

from _torch_port import assert_same_result

torch.set_num_threads(1)
CPU = torch.device("cpu")
SPAN = 1 << 32
SHAPES = ["disjoint", "identical", "near_total", "skewed", "clustered"]
TREE_METRICS = ("server.tree_levels", "server.tree_leaves", "server.tree_digest_bytes",
                "server.tree_bytes_per_diff")


def _uniq(x):
    return np.unique(np.asarray(x, dtype=np.uint32))


def _shape_pair(shape, rng):
    """The adversarial pairs of ``test_tree_conformance._shape_pair``."""
    if shape == "disjoint":
        univ = rng.choice(1 << 32, size=520, replace=False).astype(np.uint32)
        return _uniq(univ[:260]), _uniq(univ[260:])
    if shape == "identical":
        a = _uniq(rng.choice(1 << 32, size=500, replace=False))
        return a, a.copy()
    if shape == "near_total":
        univ = rng.choice(1 << 32, size=700, replace=False).astype(np.uint32)
        return _uniq(univ[:380]), _uniq(univ[330:])
    if shape == "skewed":
        lo = int(rng.integers(0, (1 << 32) - (1 << 16)))
        band = lo + rng.choice(1 << 16, size=700, replace=False)
        return _uniq(band[:640]), _uniq(np.concatenate([band[60:640], band[640:]]))
    if shape == "clustered":
        shared = rng.choice(1 << 32, size=600, replace=False).astype(np.uint64)
        lo = int(rng.integers(0, (1 << 32) - (1 << 12)))
        hot = lo + rng.choice(1 << 12, size=90, replace=False)
        return (_uniq(np.concatenate([shared, hot[:45].astype(np.uint64)])),
                _uniq(np.concatenate([shared, hot[45:].astype(np.uint64)])))
    raise AssertionError(shape)


def _cold():
    """Forget every compiled/ledgered tree_digest variant in both packages,
    so cold ``retraces`` compare equal whatever ran before in the process."""
    tree_digest_jax.clear_cache()
    platform.clear_variant_ledger()


def _leaf_tuples(leaves):
    return [(leaf.lo, leaf.hi, leaf.d_plan) for leaf in leaves]


# ---- K4: tree_digest ----------------------------------------------------------


@pytest.mark.parametrize("R,E", [(1, 700), (5, 512), (8, 1300), (3, 40)])
def test_tree_digest_three_way(R, E):
    """Ragged prefixes, a scattered mask, a fully masked row, junk in the
    padding, and a row length that is not a multiple of the tile."""
    rng = np.random.default_rng(R * 1000 + E)
    elems = rng.integers(0, 1 << 32, size=(R, E), dtype=np.uint64).astype(np.uint32)
    valid = (np.arange(E)[None, :] < rng.integers(0, E + 1, size=R)[:, None]).astype(np.int32)
    valid[0] = rng.integers(0, 2, size=E)
    if R > 1:
        valid[1] = 0
    seeds = rng.integers(0, 1 << 32, size=32, dtype=np.uint64).astype(np.uint32)
    exp = np.stack([ref.tow_sketch_ref(elems[r][valid[r] != 0], seeds) for r in range(R)])
    jax_out = np.asarray(tree_digest_jax(jnp.asarray(elems), jnp.asarray(valid),
                                         jnp.asarray(seeds), ell=32, tile=512))
    te, ts = upload(elems, CPU), upload(seeds, CPU)
    for tv in (torch.from_numpy(valid), torch.from_numpy(valid != 0)):
        got = tree_digest(te, tv, ts, ell=32, tile=512)
        assert got.dtype == torch.int32 and got.shape == (R, 32)
        assert np.array_equal(got.numpy(), exp)
        assert np.array_equal(got.numpy(), jax_out)
        assert torch.equal(tree_digest_plain(te, tv, ts), got)
    if R > 1:
        assert not got[1].any()                  # fully masked row: zeros
    if R == 1:                                   # one row == phase 0's tow_sketch
        assert torch.equal(got[0], tow_sketch(te[0], ts, torch.from_numpy(valid[0]), ell=32))


def test_tree_digest_variant_key_is_the_reference_padded_shape():
    platform.clear_variant_ledger()
    before = platform.retrace_count()
    seeds = torch.zeros(32, dtype=torch.int32)
    for E in (300, 512, 511):                   # all pad to Ep = 512
        tree_digest(torch.zeros((4, E), dtype=torch.int32),
                    torch.zeros((4, E), dtype=torch.bool), seeds)
    tree_digest(torch.zeros((4, 513), dtype=torch.int32),
                torch.zeros((4, 513), dtype=torch.bool), seeds)   # Ep = 1024
    assert platform.retrace_count() - before == 2
    with pytest.raises(ValueError, match="seeds"):
        tree_digest(torch.zeros((4, 8), dtype=torch.int32),
                    torch.zeros((4, 8), dtype=torch.bool), seeds[:8])


# ---- level digests ------------------------------------------------------------


def test_range_rows_equal_reference_matrix():
    rng = np.random.default_rng(5)
    elems = _uniq(rng.choice(1 << 32, size=300, replace=False))
    lo_idx = np.array([0, 17, 250, 300, 0], dtype=np.int64)
    counts = np.array([5, 100, 50, 0, 0], dtype=np.int64)
    for keys in (elems, elems[:0]):
        c = counts if len(keys) else np.zeros_like(counts)
        mat, valid = port_tree._range_rows(upload(keys, CPU), lo_idx, c, 128)
        mat_r, valid_r = ref_tree._range_matrix(keys, lo_idx, c, 128)
        assert np.array_equal(mat.numpy().view(np.uint32), mat_r)
        assert np.array_equal(valid.numpy().astype(np.int32), valid_r)


@pytest.mark.parametrize("seed", [0, 7])
def test_level_digests_match_reference_and_oracle(seed):
    rng = np.random.default_rng(seed)
    elems = _uniq(rng.choice(1 << 32, size=800, replace=False))
    quarter = SPAN // 4
    frontiers = [
        [(0, SPAN)],
        [(i * quarter, (i + 1) * quarter) for i in range(4)],
        [(i * (SPAN // 16), (i + 1) * (SPAN // 16)) for i in range(0, 16, 2)],
    ]
    for frontier in frontiers:
        launches = {}
        got = port_tree.level_digests(
            elems, frontier, port_tree.TreeConfig(seed=seed), device="cpu", launches=launches
        )
        assert launches == {"kernel_launches": 1}
        for exp in (ref_tree.level_digests(elems, frontier, ref_tree.TreeConfig(seed=seed)),
                    ref_tree.level_digests_ref(elems, frontier, ref_tree.TreeConfig(seed=seed)),
                    port_tree.level_digests_ref(elems, frontier, port_tree.TreeConfig(seed=seed))):
            for g, e in zip(got, exp):
                assert g.dtype == np.int64 and np.array_equal(g, e), frontier


def test_tree_seeds_pinned():
    for kw in ({}, {"seed": 9, "ell": 8}, {"seed": 123, "ell": 64}):
        assert np.array_equal(port_tree.tree_seeds(port_tree.TreeConfig(**kw)),
                              ref_tree.tree_seeds(ref_tree.TreeConfig(**kw)))
    assert port_tree.tree_seeds(port_tree.TreeConfig())[:4].tolist() == [
        823971694, 1798308538, 3327552836, 3773815693]
    assert port_tree.tree_seeds(port_tree.TreeConfig(seed=9, ell=8))[-2:].tolist() == [
        1139649114, 264846178]
    assert port_tree.TreeConfig() == port_tree.TreeConfig(
        **{f: getattr(ref_tree.TreeConfig(), f) for f in port_tree.TreeConfig.__dataclass_fields__})


# ---- the walk -----------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
def test_partition_pair_matches_reference(shape):
    """Leaves and every ``TreeStats`` field equal, cold and warm; one launch
    per level; a warm re-walk meets no new variant."""
    a, b = _shape_pair(shape, np.random.default_rng(31))
    _cold()
    for _ in range(2):                           # cold walk, then warm re-walk
        leaves, stats = port_tree.partition_pair(a, b, port_tree.TreeConfig(seed=2), device="cpu")
        leaves_r, stats_r = ref_tree.partition_pair(a, b, ref_tree.TreeConfig(seed=2))
        assert _leaf_tuples(leaves) == _leaf_tuples(leaves_r)
        assert vars(stats) == vars(stats_r)
        assert stats.launches == stats.levels
    assert stats.retraces == 0


@pytest.mark.parametrize("shape", SHAPES)
def test_tree_reconcile_matches_reference_and_oracle(shape):
    a, b = _shape_pair(shape, np.random.default_rng(11))
    rec, rec_r = Recorder(), RefRecorder()
    tr = port_tree.tree_reconcile(a, b, PBSConfig(seed=3), port_tree.TreeConfig(seed=5),
                                  device="cpu", recorder=rec)
    tr_r = ref_tree.tree_reconcile(a, b, RefPBSConfig(seed=3), ref_tree.TreeConfig(seed=5),
                                   recorder=rec_r)
    assert tr.success and tr_r.success
    assert tr.diff == tr_r.diff == true_diff(a, b)
    assert _leaf_tuples(tr.leaves) == _leaf_tuples(tr_r.leaves)
    assert (tr.tree_bytes, tr.pbs_bytes) == (tr_r.tree_bytes, tr_r.pbs_bytes)
    assert tr.tree_bytes == tr.stats.digest_bytes > 0
    assert tr.results.keys() == tr_r.results.keys() == set(range(len(tr.leaves)))
    subs_a = port_tree.leaf_slices(_uniq(a), tr.leaves)
    subs_b = port_tree.leaf_slices(_uniq(b), tr.leaves)
    for sid, (a_sub, b_sub, leaf) in enumerate(zip(subs_a, subs_b, tr.leaves)):
        assert_same_result(tr.results[sid], tr_r.results[sid], sid)
        assert_same_result(tr.results[sid],
                           reconcile(a_sub, b_sub, PBSConfig(seed=3), d_known=leaf.d_plan), sid)
    for name in TREE_METRICS:                    # the published server.tree_* metrics
        assert rec.value(name) == rec_r.value(name), name
    assert rec.value("server.tree_levels") == tr.stats.levels
    assert rec.value("server.tree_bytes_per_diff") == tr.bytes_per_diff()


def test_tree_reconcile_rateless_leaf_recovery():
    """``rateless=True`` (the case of ``test_rateless.py``): equal to the
    reference leaf for leaf, and no dearer than the escalation path."""
    a, b = make_pair(6000, 300, np.random.default_rng(42))
    legacy = port_tree.tree_reconcile(a, b, PBSConfig(seed=9), port_tree.TreeConfig(),
                                      device="cpu")
    res = port_tree.tree_reconcile(a, b, PBSConfig(seed=9), port_tree.TreeConfig(),
                                   device="cpu", rateless=True)
    res_r = ref_tree.tree_reconcile(a, b, RefPBSConfig(seed=9), ref_tree.TreeConfig(),
                                    rateless=True)
    assert res.success and res.diff == legacy.diff == true_diff(a, b)
    assert res.total_bytes <= legacy.total_bytes
    assert _leaf_tuples(res.leaves) == _leaf_tuples(res_r.leaves)
    assert (res.tree_bytes, res.pbs_bytes) == (res_r.tree_bytes, res_r.pbs_bytes)
    for sid in res_r.results:
        assert_same_result(res.results[sid], res_r.results[sid], sid)
    a_u, b_u = _uniq(a), _uniq(b)
    for sid, leaf in enumerate(res.leaves[:8]):
        sub = [port_tree.leaf_slices(x, [leaf])[0] for x in (a_u, b_u)]
        exp = ref_reconcile(*sub, RefPBSConfig(seed=9, rateless=True), d_known=leaf.d_plan)
        assert_same_result(res.results[sid], exp, sid)
