"""Error-feedback top-k compression across ranks: the port's twin of
``tests/test_compression.py::test_compression_multidevice_tracks_dense``
(internlm2-1.8b's smoke config on a (data=4, model=2) mesh, 8 ranks as
gloo processes on the CPU), and ``compressed_sync``'s sparse all-gather
over 'data' against a plain numpy sum of the same top-k sets.

The twin starts from the reference's own initial parameters (its
``init_params`` at seed 0, which ``init_train_state`` shards; bfloat16
carried exactly), while ``tests/_jax_mesh_ref.py`` runs the reference's
first step on 8 fake devices beside it, fresh optimizer states, on the reference
test's repeated batch, 8 steps dense and 8 compressed (ratio 0.1, leaves
of 1 024 entries up).

Rules and tolerances, stated before the first run:

* the reference test's own rules: the compressed run's last loss at least
  0.3 below its first, and within 1.0 of the dense run's last; the
  error-feedback buffers hold mass, between 0 and 1e6;
* the first loss (before any update, so the same in both runs) within
  1e-2 absolute of the reference's first loss on its (4, 2) mesh: the
  smoke model computes in bfloat16 and XLA rounds its fused bfloat16 work
  elsewhere than torch's op-by-op run (``test_torch_launch_train.py``'s
  bound for the same comparison);
* ``compressed_sync``: the synced gradient within 1e-6 of its largest
  magnitude of the numpy sum (over data ranks, then model ranks) of each
  rank's top-k entries of gradient + error, and each rank's new error
  exactly its gradient + error with those entries zeroed (the draws have
  no ties at the k-th magnitude).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import _torch_ranks
from repro_torch.launch.ranks import run_ranks

ROOT = Path(__file__).resolve().parents[1]
ARCH = "internlm2-1.8b"
D, M, STEPS = 4, 2, 8
CCFG = {"ratio": 0.1, "min_leaf_size": 1024, "enabled": True}
N, K = 64, 6                               # compressed_sync's leaf: 64 entries, top 6


def unflat(d, prefix):
    out = {}
    for k, v in d.items():
        if k.startswith(prefix + "/"):
            node = out
            parts = k[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
    return out


def reference_params():
    """The reference's initial parameters of the twin, as float32 numpy."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config
    from repro.models.backbone import model_spec
    from repro.models.layers import MeshCtx
    from repro.models.spec import init_params

    spec = model_spec(get_smoke_config(ARCH), MeshCtx(model_size=M, data_size=D))
    params = init_params(spec, jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.float32)), params)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("compression_multirank")
    toks = np.random.default_rng(0).integers(0, 512, (4, 64)).astype(np.int32)
    job = [{"kind": "init", "name": "twin", "arch": ARCH, "mesh": [D, M], "batch": 4,
            "steps": 1}]
    np.savez(tmp / "in.npz", job=json.dumps(job), **{"twin/tokens": toks})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, str(ROOT / "tests" / "_jax_mesh_ref.py"),
                            str(tmp / "in.npz"), str(tmp / "out.npz"), str(D * M)],
                           env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        params = reference_params()
        rng = np.random.default_rng(3)
        gs = rng.standard_normal((D * M, N)).astype(np.float32)
        errs = (0.1 * rng.standard_normal((D * M, N))).astype(np.float32)
        port = run_ranks(_torch_ranks.twin, D * M, tmp / "rdv", device="cpu",
                         args=(D, M, ARCH, params, toks, STEPS, [None, CCFG], gs, errs, K),
                         timeout=150)
        _, err = ref.communicate(timeout=150)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err[-3000:]
    ref_out = dict(np.load(tmp / "out.npz"))
    want = unflat(ref_out, "twin/params")
    for path, a in _flat(params).items():        # the params it shards are these
        assert np.array_equal(_flat(want)[path], a), path
    return {"ref_first": float(ref_out["twin/losses"][0]), "port": port, "gs": gs,
            "errs": errs}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


def test_compression_multirank_tracks_dense(runs):
    dense, comp = (r["losses"] for r in runs["port"][0]["losses"])
    assert comp[-1] < comp[0] - 0.3, comp
    assert abs(comp[-1] - dense[-1]) < 1.0, (dense, comp)
    err = runs["port"][0]["losses"][1]["err_abs_sum"]
    assert 0 < err < 1e6, err


def test_every_rank_reads_the_same_losses(runs):
    first = [run["losses"] for run in runs["port"][0]["losses"]]
    for r in range(D * M):
        assert [run["losses"] for run in runs["port"][r]["losses"]] == first, r


def test_first_loss_matches_reference(runs):
    dense, comp = (r["losses"] for r in runs["port"][0]["losses"])
    assert dense[0] == comp[0]                 # no update yet: the same forward
    assert abs(dense[0] - runs["ref_first"]) <= 1e-2, (dense[0], runs["ref_first"])


def test_sparse_all_gather_sums_every_data_ranks_top_k(runs):
    acc = runs["gs"] + runs["errs"]                              # (world, N)
    top = np.argsort(-np.abs(acc), axis=1)[:, :K]
    sent = np.zeros_like(acc)
    for r in range(D * M):
        sent[r, top[r]] = acc[r, top[r]]
    # rank r = (d, m): sum over data ranks of one model column, then over model
    want = sent.reshape(D, M, N).sum(0).sum(0)
    for r in range(D * M):
        synced, new_err = runs["port"][r]["sync"]
        assert np.abs(synced - want).max() <= 1e-6 * np.abs(want).max(), r
        kept = acc[r].copy()
        kept[top[r]] = 0.0
        assert np.array_equal(new_err, kept), r
