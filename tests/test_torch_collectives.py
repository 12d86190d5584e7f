"""The collectives across ranks (``repro_torch.models.layers``: ``ag_seq``,
``rs_seq``, ``psum_model``, ``pmax_const``, ``combine_partials``, and the
expert-parallel ``all_to_all_ep`` over ('data', 'model') on (1, 2) and
(2, 2)) against the reference's inside ``jax.shard_map(...,
check_vma=False)`` on 2 and 4 fake CPU devices
(``tests/_jax_mesh_ref.py``), forward and backward; the serving side's
whole-vocab logits (``backbone.vocab_logits``) and distributed argmax
(``greedy_token``) on every rank against one rank's; the routed experts'
dispatch (``ffn._moe_core``) on those meshes against one rank's; the rank
launcher (``launch.ranks``) and the mesh (``launch.mesh``); and every
block kind, the encoder and the patch frontend building (or running, on a
'data' axis that needs no collective) above one rank.

The port's ranks run as gloo processes on the CPU, a group of 2 and one of
4 for the module.  Each rank's output and its gradient of
``Σ out · cot`` (its own cotangents) are held against the reference's
``jax.vjp`` of the same body: the reference's transposes are those of the
sum of every rank's objective (all-gather and reduce-scatter each other's,
psum its own, pmax a constant).

Tolerances, stated before the first run: outputs and gradients within
1e-6 of their largest magnitude (float32 sums of up to 4 terms in another
order); ``combine_partials`` returns bfloat16, within one bfloat16 step of
its largest magnitude (2^-8); the whole-vocab logits within 1e-6 of one
rank's (the same float32 products, in shards), their argmax equal; the
experts' outputs within 1e-5 of their largest magnitude of one rank's
(at a capacity factor of 4, which no destination can overflow), the aux
loss within 1e-5 relative.
"""
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_ranks
from repro_torch.configs import get_smoke_config
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch.ranks import choose_backend, run_ranks
from repro_torch.models import backbone, ffn
from repro_torch.models.layers import MeshCtx
from repro_torch.models.spec import params_from_numpy
from repro_torch.serve.engine import make_serve_fns

ROOT = Path(__file__).resolve().parents[1]
NS = (2, 4)
OPS = ("ag", "rs", "psum", "pmax", "combine", "a2a")
A2A_MESH = {2: (1, 2), 4: (2, 2)}
VOCAB = 500


def cases(n, rng):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {
        "ag": {"x": f(n, 2, 3, 5), "cot": f(n, 2, 3 * n, 5)},
        "rs": {"x": f(n, 2, 3 * n, 5), "cot": f(n, 2, 3, 5)},
        "psum": {"x": f(n, 2, 5), "cot": f(n, 2, 5)},
        "pmax": {"x": f(n, 2, 5), "cot": f(n, 2, 5)},
        "combine": {"num": f(n, 2, 3, 1, 4), "m": f(n, 2, 3, 1),
                    "l": (1 + rng.random((n, 2, 3, 1))).astype(np.float32)},
        # the serving side (port only): a vocab of 500 padded to 512, so the
        # last rank's shard ends in padding columns
        "vocab": {"vocab": np.int64(VOCAB), "tok": f(512, 128), "x": f(3, 1, 128)},
        "a2a": {"x": f(n, 3 * n, 4), "cot": f(n, 3 * n, 4)},
        "a2a_mesh": A2A_MESH[n],
        # the routed experts (port only): deepseek-v2's smoke experts, 8 rows a rank
        "moe": {"params": moe_params(rng), "x": f(n, 8, MOE.d_model)},
    }


MOE = get_smoke_config("deepseek-v2-236b").scaled(capacity_factor=4.0)


def moe_params(rng):
    spec = ffn.moe_spec(MOE, MeshCtx())
    return {k: (rng.standard_normal(p.shape) / np.sqrt(p.shape[-2] if len(p.shape) > 1
                                                      else 1)).astype(np.float32)
            for k, p in spec.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    rng = np.random.default_rng(5)
    inputs = {n: cases(n, rng) for n in NS}
    arrays = {f"c{n}/{op}/{k}": v for n in NS for op, kv in inputs[n].items() if op in OPS
              for k, v in kv.items()}
    job = [{"kind": "coll", "name": f"c{n}", "n": n, "a2a": A2A_MESH[n]} for n in NS]
    np.savez(tmp / "in.npz", job=json.dumps(job), **arrays)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, str(ROOT / "tests" / "_jax_mesh_ref.py"),
                            str(tmp / "in.npz"), str(tmp / "out.npz"), "4"],
                           env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    def ranks(n):
        return run_ranks(_torch_ranks.collectives, n, tmp / f"rdv{n}", device="cpu",
                         args=(n, inputs[n]), timeout=120)

    try:
        with ThreadPoolExecutor(len(NS)) as pool:      # both groups at once
            port = dict(zip(NS, pool.map(ranks, NS)))
        _, err = ref.communicate(timeout=120)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err[-3000:]
    return {"ref": dict(np.load(tmp / "out.npz")), "port": port}


def assert_close(got, want, rel, name):
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * scale + 1e-12, (name, err, scale)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("n", NS)
def test_collective_forward_and_backward_match_reference(runs, n, op):
    ref = runs["ref"]
    for r in range(n):
        got = runs["port"][n][r][op]
        if op == "combine":
            assert_close(got["y"], ref[f"c{n}/combine/y"][r], 2.0 ** -8, f"{op} rank {r}")
            continue
        assert_close(got["y"], ref[f"c{n}/{op}/y"][r], 1e-6, f"{op} rank {r} out")
        assert_close(got["dx"], ref[f"c{n}/{op}/dx"][r], 1e-6, f"{op} rank {r} grad")


@pytest.mark.parametrize("n", NS)
def test_transposes_are_the_global_sums(runs, n):
    """Independently of the reference: ``ag_seq``'s gradient on rank r is
    the sum over ranks of their cotangents' r-th sequence block, and
    ``psum_model``'s the sum of every rank's cotangent; ``pmax_const``
    passes no gradient through the max."""
    port = runs["port"][n]
    cot = np.stack([port[r]["ag"]["dx"] for r in range(n)])
    # rebuild from the inputs the ranks saw
    rng = np.random.default_rng(5)
    inputs = {k: cases(k, rng) for k in NS}[n]
    want = inputs["ag"]["cot"].sum(0).reshape(2, n, 3, 5).transpose(1, 0, 2, 3)
    np.testing.assert_allclose(cot, want, rtol=1e-6, atol=1e-6)
    ps = inputs["psum"]["cot"].sum(0)
    for r in range(n):
        np.testing.assert_allclose(port[r]["psum"]["dx"], ps, rtol=1e-6, atol=1e-6)
        mx = inputs["pmax"]["x"].max(0)
        np.testing.assert_allclose(port[r]["pmax"]["dx"], inputs["pmax"]["cot"][r] * mx,
                                   rtol=1e-6, atol=1e-6)
        led = port[r]["ledger"]
        assert led["all_gather"]["calls"] >= 2 and led["reduce_scatter"]["calls"] >= 2


# ---------------------------------------------------------------------------
# the launcher and the mesh
# ---------------------------------------------------------------------------


def test_a_mesh_of_ranks_needs_its_process_group_and_a_meta_mesh_none():
    """No fallback: without a process group of data · model ranks a wider
    mesh raises; a mesh of one rank needs none.  A meta mesh needs none
    either: ``make_production_mesh`` is rank 0's meta record of (data 16,
    model 16), or with ``multi_pod`` of (pod 2, data 16, model 16), its
    coordinates row-major as ``jax.make_mesh`` orders the reference's
    devices; its collectives take meta tensors only."""
    with pytest.raises(RuntimeError, match="process group of 4 ranks"):
        port_mesh.make_local_mesh(2, 2, device="cpu")
    with pytest.raises(ValueError, match="meta mesh"):
        port_mesh.make_local_mesh(2, 2, device="cpu", rank=3)
    one = port_mesh.make_local_mesh(device="cpu")
    assert one.world == 1 and one.backend is None and one.coords == (0, 0)
    x = torch.arange(6.0).reshape(2, 3)
    assert one.all_gather(x, "model", 1) is x and one.all_reduce(x, ("data", "model")) is x
    pod = port_mesh.make_production_mesh()
    assert (pod.axis_names, pod.shape, pod.world) == (("data", "model"),
                                                      {"data": 16, "model": 16}, 256)
    assert pod.device.type == "meta" and pod.backend is None and pod.coords == (0, 0)
    multi = port_mesh.make_production_mesh(multi_pod=True, rank=300)
    assert multi.axis_names == ("pod", "data", "model") and multi.world == 512
    assert multi.coords == (1, 2, 12) and multi.index("pod") == 1   # 300 = 256 + 2·16 + 12
    assert multi.group_ranks("model") == list(range(288, 304))
    assert multi.group_ranks(("pod", "data")) == [p * 256 + d * 16 + 12
                                                 for p in range(2) for d in range(16)]
    # every 'model' group of 16 spans two nodes of 8 cards: the NIC's rate
    assert multi.link("model") == multi.link("data") == "nic"
    assert port_mesh.make_local_mesh(1, 8, device="meta").link("model") == "nvlink"
    y = pod.all_gather(torch.empty(2, 3, device="meta"), "model", 1)
    assert y.shape == (2, 48) and y.device.type == "meta"
    with pytest.raises(ValueError, match="meta tensors"):
        pod.all_reduce(x, "data")
    assert pod.ledger["all_gather"]["calls"] == 1 and "all_reduce" not in pod.ledger


@pytest.mark.parametrize("world,device,asked,cards,want", [
    (2, "cpu", None, 0, "gloo"),
    (4, "cpu", "gloo", 0, "gloo"),
    (2, "cpu", "nccl", 0, ValueError),
    (2, "cuda", None, 2, "nccl"),
    (4, "cuda", None, 8, "nccl"),
    (2, "cuda", None, 1, ValueError),          # ranks sharing a card: ask for gloo by name
    (2, "cuda", "gloo", 1, "gloo"),
    (4, "cuda", "nccl", 1, ValueError),
    (2, "cuda", "mpi", 1, ValueError),
])
def test_backend_rule(monkeypatch, world, device, asked, cards, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if want is ValueError:
        with pytest.raises(ValueError):
            choose_backend(world, device, asked)
    else:
        assert choose_backend(world, device, asked) == want


def test_a_failing_rank_fails_the_call_at_once(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_ranks(_torch_ranks.fail_on, 2, tmp_path, device="cpu", args=(1,), timeout=60)
    assert time.monotonic() - t0 < 40          # rank 0 waited in a barrier: killed


def test_a_hung_rank_times_out(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running"):
        run_ranks(_torch_ranks.sleep_for, 1, tmp_path, device="cpu", args=(300,), timeout=8)
    assert time.monotonic() - t0 < 30


def test_ranks_exiting_alike_exit_the_call(tmp_path):
    with pytest.raises(SystemExit) as e:
        run_ranks(_torch_ranks.exit_with, 1, tmp_path, device="cpu", args=(17,), timeout=60)
    assert e.value.code == 17


# ---------------------------------------------------------------------------
# every block kind and the frontends above one rank
# ---------------------------------------------------------------------------

TWO = MeshCtx(model_size=2)
DP = MeshCtx(data_size=2)


@pytest.mark.parametrize("kind", ["attn_window", "mla_dense", "mla_moe", "ssm", "rglru", "dec"])
@pytest.mark.parametrize("ctx", [TWO, DP], ids=["model2", "data2"])
def test_every_block_kind_builds_above_one_rank(kind, ctx):
    """Every block kind builds above one rank: the dense block, since 6c.i
    the MLA blocks, since 6c.ii the recurrent kinds and since 6c.iii the
    encoder-decoder block (``tests/test_torch_moe_multirank.py``,
    ``tests/test_torch_recurrent_multirank.py`` and
    ``tests/test_torch_frontends_multirank.py`` run them).  On 'data' 2
    the ``dec`` block runs without a collective and equals one rank's."""
    arch = {"mla_dense": "deepseek-v2-236b", "mla_moe": "deepseek-v2-236b",
            "attn_window": "recurrentgemma-2b", "rglru": "recurrentgemma-2b",
            "ssm": "mamba2-780m", "dec": "whisper-tiny"}.get(kind, "qwen2-1.5b")
    cfg = get_smoke_config(arch)
    assert callable(backbone.make_block_fn(cfg, ctx, kind, with_aux=True))
    backbone.make_block_fn(cfg, ctx, "attn")           # the dense block runs
    if kind == "dec" and ctx is DP:
        rng = np.random.default_rng(7)
        p = params_from_numpy(_torch_ranks.draw_tree(backbone.block_spec(cfg, DP, "dec"), rng),
                              "cpu")
        x, mem = (torch.from_numpy(rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32))
                  for _ in range(2))
        got = backbone.make_block_fn(cfg, DP, "dec", memory=mem)(p, x)
        want = backbone.make_block_fn(cfg, MeshCtx(), "dec", memory=mem)(p, x)
        assert torch.equal(got, want)


def test_frontends_encoder_experts_and_serving_run_above_one_rank(runs):
    """The frontends and the encoder run above one rank (sub-item 6c.iii):
    on 'data' 2, which needs no collective, ``encode`` and
    ``embed_inputs(frontend=)`` equal one rank's (the ranks of
    ``tests/test_torch_frontends_multirank.py`` run them over 'model');
    the experts run there (6c.i): ``_moe_core`` on every rank of (1, 2)
    and (2, 2) equals one rank's on the same rows; the dense family's
    serving runs there: ``vocab_logits`` gives every rank the whole padded
    vocab's logits, ``greedy_token`` their argmax, and ``make_serve_fns``
    builds its steps on a 'model' axis of 2."""
    frng = np.random.default_rng(6)
    cfg = get_smoke_config("whisper-tiny")
    pw = params_from_numpy(_torch_ranks.draw_tree(backbone.model_spec(cfg, DP), frng), "cpu")
    frames = torch.from_numpy(frng.standard_normal((2, 8, cfg.d_model)).astype(np.float32))
    assert torch.equal(backbone.encode(pw, frames, DP, cfg),
                       backbone.encode(pw, frames, MeshCtx(), cfg))
    pix = get_smoke_config("pixtral-12b")
    pe = params_from_numpy(_torch_ranks.draw_tree(backbone.embed_spec(pix), frng), "cpu")
    toks = torch.from_numpy(frng.integers(0, pix.vocab, (2, 12)).astype(np.int32))
    toks[:, :pix.n_frontend_tokens] = -1
    fe = torch.from_numpy(frng.standard_normal((2, 12, pix.d_model)).astype(np.float32))
    got = backbone.embed_inputs(pe, toks, DP, pix, frontend=fe)
    assert torch.equal(got, backbone.embed_inputs(pe, toks, MeshCtx(), pix, frontend=fe))
    assert torch.equal(got[:, :pix.n_frontend_tokens], fe[:, :pix.n_frontend_tokens])
    rng = np.random.default_rng(5)          # the inputs the ranks saw
    inputs = {k: cases(k, rng) for k in NS}
    for n in NS:
        mo = inputs[n]["moe"]
        p = {k: torch.from_numpy(v) for k, v in mo["params"].items()}
        x = torch.from_numpy(mo["x"].reshape(-1, MOE.d_model))
        y, aux = ffn._moe_core(p, x, torch.ones(x.shape[0], dtype=torch.bool), MOE, MeshCtx(), 1)
        for r in range(n):
            got = runs["port"][n][r]["moe"]
            np.testing.assert_allclose(got["y"], y[8 * r:8 * (r + 1)].numpy(),
                                       atol=1e-5 * float(y.abs().max()), rtol=0)
            assert got["aux"] == pytest.approx(float(aux), rel=1e-5)
    dense = get_smoke_config("qwen2-1.5b").scaled(vocab=VOCAB)
    for n in NS:
        v = inputs[n]["vocab"]
        whole = backbone.vocab_logits({"tok": torch.from_numpy(v["tok"])},
                                      torch.from_numpy(v["x"])[:, 0], MeshCtx(), dense)
        assert torch.all(whole[:, VOCAB:] == -1e30)
        for r in range(n):
            got = runs["port"][n][r]["vocab"]
            np.testing.assert_allclose(got["logits"], whole.numpy(), rtol=1e-6, atol=1e-6)
            np.testing.assert_array_equal(got["token"], whole.argmax(-1).numpy())
    mesh = port_mesh.LocalMesh(("data", "model"), {"data": 1, "model": 2},
                               torch.device("cpu"))
    sv = make_serve_fns(dense, mesh, batch=2, max_len=16)
    assert sv.ctx.model_size == 2 and sv.batch_ax == ("data",)
    assert tuple(sv.cache_pspec["g0"]["k"].shape) == (2, 2, 2, 16, 32)
