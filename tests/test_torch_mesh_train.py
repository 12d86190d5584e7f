"""The dense training path across ranks: the port's ranks as gloo processes
on the CPU (``repro_torch.launch.ranks.run_ranks``, one group of 2 and one
of 4 ranks for the module) against the reference's ``shard_map`` on fake
CPU devices (``tests/_jax_mesh_ref.py`` in a subprocess, beside them),
and against the port's own one-rank step.

Meshes: (1, 2), (2, 1), (2, 2), and (1, 4) with qwen2's smoke config at
6 query heads (``head_dim`` 32), which 4 does not divide, so the heads pad
to 8 and ``_mask_pad_heads`` zeroes the pads.  Everything is float32.

Tolerances, stated before the first run:

* each rank's layer outputs (``embed_tokens``, ``gqa_apply``,
  ``mlp_apply``) within 1e-5 of the output's largest magnitude, the
  ``ce_loss`` value within 1e-5 relative; every gradient leaf (parameters
  and input) within 1e-4 of its largest magnitude (float32 sums in other
  orders);
* the step: the loss within 1e-5 relative; every synced gradient leaf
  within 1e-4 of its largest magnitude; after one step from one carried
  state (step 10, m ~ N(0, 1e-3), v in [1e-4, 2e-4): above the squared
  gradients, so the Adam update is smooth in them) the parameters and the
  master within 1e-6 absolute, m and v within 1e-4 of the leaf's largest
  entry, grad_norm within 1e-5 relative, lr equal;
* mesh parity (against the port's one-rank step, in the one-rank layout
  of ``train.layout``) and ZeRO-1 against the plain update on the same
  mesh: the same;
* ``shard_params`` then ``gather_params``: exact.
"""
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_ranks
from _torch_ranks import draw_tree
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import attention, backbone, ffn
from repro_torch.models.layers import MeshCtx
from repro_torch.models.spec import params_from_numpy
from repro_torch.optim import OptConfig, build_plan, init_opt_state, sync_gradient
from repro_torch.optim.adamw import opt_state_spec
from repro_torch.train import make_train_step
from repro_torch.train.layout import from_one_rank, to_one_rank

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen2-1.5b"
PAD = {"n_heads": 6, "head_dim": 32}      # 6 heads over 4 ranks: padded to 8
LAYER_MESHES = {"l12": ((1, 2), None), "l22": ((2, 2), None), "l14pad": ((1, 4), PAD)}
STEP_TASKS = {                              # name: (mesh, scale, zero1, in the reference)
    "s12": ((1, 2), None, False, True),
    "s21z": ((2, 1), None, True, True),
    "s22": ((2, 2), None, False, True),
    "s14pad": ((1, 4), PAD, False, True),
    "s21": ((2, 1), None, False, False),
    "s22z": ((2, 2), None, True, False),
}
B, T_LAYER, T_STEP = 4, 16, 32
TIMEOUT = 120


def cfg_of(scale):
    return get_smoke_config(ARCH).scaled(**(scale or {}))


def flat(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat(v, f"{prefix}/{k}", out)
    else:
        out[prefix] = np.asarray(v_np(tree))
    return out


def v_np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


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


def pad_to(a, shape):
    return np.pad(a, [(0, w - h) for h, w in zip(a.shape, shape)])


def layer_task(name, rng):
    (d, m), scale = LAYER_MESHES[name]
    cfg = cfg_of(scale)
    ctx1, ctxm = MeshCtx(), MeshCtx(model_size=m, data_size=d)
    specs1 = {"embed": backbone.embed_spec(cfg), "attn": attention.gqa_spec(cfg, ctx1),
              "mlp": ffn.mlp_spec(cfg)}
    specsm = {"embed": backbone.embed_spec(cfg), "attn": attention.gqa_spec(cfg, ctxm),
              "mlp": ffn.mlp_spec(cfg)}
    params = {k: draw_tree(specs1[k], rng) for k in specs1}
    params = {k: {n: pad_to(a, specsm[k][n].shape) for n, a in params[k].items()}
              for k in params}
    x = rng.standard_normal((B, T_LAYER, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab, (B, T_LAYER)).astype(np.int32)
    targets = rng.integers(0, cfg.vocab, (B, T_LAYER)).astype(np.int32)
    targets[:, :2] = -1
    local = (d * m, B // d, T_LAYER // m, cfg.d_model)
    cot = {k: rng.standard_normal(local).astype(np.float32) for k in ("embed", "attn", "mlp")}
    return {"name": name, "arch": ARCH, "scale": scale, "mesh": (d, m), "params": params,
            "x": x, "tokens": tokens, "targets": targets, "cot": cot}


def carried_state(params1, cfg, rng):
    """A one-rank carried optimizer state of ``params1``: step 10, random m,
    v above the squared gradients, master = the parameters."""
    ocfg = OptConfig(warmup=2, total_steps=20)
    mesh = make_local_mesh(device="cpu")
    bundle = make_train_step(cfg, mesh, ocfg, batch=B)
    p = params_from_numpy(params1, "cpu")
    opt = init_opt_state(p, bundle.plan, ocfg)
    opt["step"].fill_(10)
    for st in _states(opt["leaves"]):
        st["m"].copy_(torch.from_numpy(1e-3 * rng.standard_normal(st["m"].shape)))
        st["v"].copy_(torch.from_numpy(1e-4 * (1 + rng.random(st["v"].shape))))
    return opt


def _states(tree):
    if "m" in tree and not isinstance(tree["m"], dict):
        yield tree
    else:
        for v in tree.values():
            yield from _states(v)


def step_inputs(rng):
    """One-rank parameters and carried state of each config, the batch,
    and each step task's global inputs in its mesh layout."""
    one, tasks = {}, {}
    for scale in (None, PAD):
        cfg = cfg_of(scale)
        spec1 = backbone.model_spec(cfg, MeshCtx())
        params1 = draw_tree(spec1, rng)
        one[json.dumps(scale)] = (params1, carried_state(params1, cfg, rng))
    toks = rng.integers(0, 512, (B, T_STEP)).astype(np.int32)
    labels = rng.integers(0, 512, (B, T_STEP)).astype(np.int32)
    labels[:, :3] = -1
    batch = {"tokens": toks, "labels": labels}
    for name, ((d, m), scale, zero1, _) in STEP_TASKS.items():
        params1, opt1 = one[json.dumps(scale)]
        ocfg = OptConfig(warmup=2, total_steps=20, zero1=zero1)
        pm, om = from_one_rank(params1, opt1, cfg_of(scale), ocfg, {"data": d, "model": m})
        tasks[name] = {"name": name, "arch": ARCH, "scale": scale, "mesh": (d, m),
                       "zero1": zero1, "params": _np(pm), "opt": _np(om), "batch": batch}
    return one, batch, tasks


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def reference_job(layer_tasks, step_tasks, path):
    job, arrays = [], {}
    for t in layer_tasks:
        job.append({"kind": "layers", "name": t["name"], "arch": ARCH, "mesh": t["mesh"],
                    "scale": t["scale"] or {}})
        flat(t["params"], f"{t['name']}/params", arrays)
        for k in ("x", "tokens", "targets"):
            arrays[f"{t['name']}/{k}"] = t[k]
        flat(t["cot"], f"{t['name']}/cot", arrays)
    for t in step_tasks:
        job.append({"kind": "step", "name": t["name"], "arch": ARCH, "mesh": t["mesh"],
                    "scale": t["scale"] or {}, "zero1": t["zero1"]})
        flat(t["params"], f"{t['name']}/params", arrays)
        flat(t["opt"], f"{t['name']}/opt", arrays)
        flat(t["batch"], f"{t['name']}/batch", arrays)
    np.savez(path, job=json.dumps(job), **arrays)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_train")
    rng = np.random.default_rng(11)
    layer_tasks = {n: layer_task(n, rng) for n in LAYER_MESHES}
    one, batch, step_tasks = step_inputs(rng)
    reference_job(layer_tasks.values(), [t for n, t in step_tasks.items() if STEP_TASKS[n][3]],
                  tmp / "in.npz")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, str(ROOT / "tests" / "_jax_mesh_ref.py"),
                            str(tmp / "in.npz"), str(tmp / "out.npz"), "4"],
                           env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    def ranks(world):
        lt = [t for t in layer_tasks.values() if np.prod(t["mesh"]) == world]
        st = [t for t in step_tasks.values() if np.prod(t["mesh"]) == world]
        return run_ranks(_torch_ranks.layers_and_steps, world, tmp / f"rdv{world}",
                         device="cpu", args=(lt, st), timeout=TIMEOUT)

    try:
        with ThreadPoolExecutor(2) as pool:      # both groups at once
            port = dict(zip((2, 4), pool.map(ranks, (2, 4))))
        _, err = ref.communicate(timeout=TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err[-3000:]
    return {"ref": dict(np.load(tmp / "out.npz")), "port": port, "layer_tasks": layer_tasks,
            "step_tasks": step_tasks, "one": one, "batch": batch}


def assert_close(got, want, rel, name):
    got, want = v_np(got), v_np(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= rel * scale + 1e-12, (name, err, scale)


def rank_results(runs, name, kind):
    (d, m) = (LAYER_MESHES[name][0] if kind == "layers" else STEP_TASKS[name][0])
    return runs["port"][d * m], d * m


# ---------------------------------------------------------------------------
# (b) the layers, rank by rank, against the reference's shards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["embed", "attn", "mlp", "ce"])
@pytest.mark.parametrize("name", list(LAYER_MESHES))
def test_layer_per_rank_matches_reference(runs, name, fn):
    res, world = rank_results(runs, name, "layers")
    ref = runs["ref"]
    for r in range(world):
        got = res[r]["layers"][name][fn]
        want_y = ref[f"{name}/{fn}/y"][r]
        if fn == "ce":
            assert abs(float(got["y"]) - float(want_y)) <= 1e-5 * abs(float(want_y)), (r, got["y"])
        else:
            assert_close(got["y"], want_y, 1e-5, f"{name} {fn} rank {r} out")
        for path, g in got["dp"].items():
            assert_close(g, ref[f"{name}/{fn}/dp{path}"][r], 1e-4, f"{name} {fn} rank {r} {path}")
        if got["dx"] is not None:
            assert_close(got["dx"], ref[f"{name}/{fn}/dx"][r], 1e-4, f"{name} {fn} rank {r} dx")


def test_padded_heads_get_zero_gradients(runs):
    """On (1, 4) with 6 heads the last rank holds heads 6 and 7, both pads:
    their wq columns and wo rows get zero gradients there."""
    res, _ = rank_results(runs, "l14pad", "layers")
    dp = res[3]["layers"]["l14pad"]["attn"]["dp"]
    assert not np.any(dp["/wq"]) and not np.any(dp["/wo"]) and not np.any(dp["/bq"])
    assert np.any(res[2]["layers"]["l14pad"]["attn"]["dp"]["/wq"])


# ---------------------------------------------------------------------------
# (c) the whole step against the reference's on the same mesh
# ---------------------------------------------------------------------------

REF_STEPS = [n for n, t in STEP_TASKS.items() if t[3]]


def port_step(runs, name):
    res, _ = rank_results(runs, name, "steps")
    return res[0]["steps"][name]


@pytest.mark.parametrize("name", REF_STEPS)
def test_step_loss_and_synced_gradients_match_reference(runs, name):
    got, ref = port_step(runs, name), runs["ref"]
    want = float(ref[f"{name}/loss"])
    assert abs(got["loss"] - want) <= 1e-5 * abs(want), (got["loss"], want)
    want_g = unflat(ref, f"{name}/grads")
    paths = sorted(flat(want_g, "", {}))
    assert paths == sorted(flat(got["grads"], "", {}))
    for path, w in flat(want_g, "", {}).items():
        assert_close(flat(got["grads"], "", {})[path], w, 1e-4, f"{name} {path}")


def _one_rank(name, params, opt):
    (d, m), scale, zero1, _ = STEP_TASKS[name]
    ocfg = OptConfig(warmup=2, total_steps=20, zero1=zero1)
    return to_one_rank(params, opt, cfg_of(scale), ocfg, {"data": d, "model": m})


def assert_state_close(got, want, label):
    """Parameters and master within 1e-6 absolute, m and v within 1e-4 of
    the leaf's largest entry; both trees in the one-rank layout."""
    (gp, go), (wp, wo) = got, want
    for path, w in flat(wp, "", {}).items():
        g = flat(gp, "", {})[path]
        assert np.abs(g - w).max() <= 1e-6, (label, path, np.abs(g - w).max())
    assert int(go["step"]) == int(wo["step"]) == 11
    gl, wl = flat(go["leaves"], "", {}), flat(wo["leaves"], "", {})
    assert sorted(gl) == sorted(wl)
    for path, w in wl.items():
        if path.endswith("/master"):
            assert np.abs(gl[path] - w).max() <= 1e-6, (label, path)
        else:
            assert_close(gl[path], w, 1e-4, f"{label} {path}")


@pytest.mark.parametrize("name", REF_STEPS)
def test_step_update_matches_reference(runs, name):
    got, ref = port_step(runs, name), runs["ref"]
    for k in ("grad_norm", "loss"):
        want = float(ref[f"{name}/metrics/{k}"])
        assert abs(got["metrics"][k] - want) <= 1e-5 * abs(want), (k, got["metrics"][k], want)
    assert got["metrics"]["lr"] == pytest.approx(float(ref[f"{name}/metrics/lr"]), rel=1e-6)
    ref_opt = unflat(ref, f"{name}/after/opt")
    ref_params = unflat(ref, f"{name}/after/params")
    assert_state_close(_one_rank(name, got["params"], got["opt"]),
                       _one_rank(name, ref_params, ref_opt), name)


# ---------------------------------------------------------------------------
# mesh parity: every mesh against the port's one-rank step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_rank_steps(runs):
    """The port's (1, 1) step of each config from the same state: loss,
    synced gradients, then parameters and state after the step."""
    out = {}
    for scale in (None, PAD):
        cfg = cfg_of(scale)
        params1, opt1 = runs["one"][json.dumps(scale)]
        ocfg = OptConfig(warmup=2, total_steps=20)
        mesh = make_local_mesh(device="cpu")
        bundle = make_train_step(cfg, mesh, ocfg, batch=B)
        p = params_from_numpy(params1, "cpu")
        opt = {"step": opt1["step"].clone(),
               "leaves": {k: v for k, v in _clone(opt1["leaves"]).items()}}
        grads, ce, aux = bundle.grads(p, runs["batch"])
        synced = {k: v for k, v in _map_plan(lambda g, pl: sync_gradient(g, pl), grads,
                                             bundle.plan).items()}
        p, opt, met = bundle.update(p, opt, grads, ce, aux)
        out[json.dumps(scale)] = {"loss": float(met["loss"]), "grads": synced,
                                  "params": p, "opt": opt,
                                  "metrics": {k: float(v) for k, v in met.items()}}
    return out


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _map_plan(fn, tree, plan):
    if isinstance(plan, dict):
        return {k: _map_plan(fn, tree[k], plan[k]) for k in plan}
    return fn(tree, plan)


@pytest.mark.parametrize("name", list(STEP_TASKS))
def test_step_matches_one_rank_step(runs, one_rank_steps, name):
    got = port_step(runs, name)
    (d, m), scale, zero1, _ = STEP_TASKS[name]
    one = one_rank_steps[json.dumps(scale)]
    assert abs(got["loss"] - one["loss"]) <= 1e-5 * abs(one["loss"])
    assert abs(got["metrics"]["grad_norm"] - one["metrics"]["grad_norm"]) <= \
        1e-5 * one["metrics"]["grad_norm"]
    g1, _ = to_one_rank(got["grads"], None, cfg_of(scale), OptConfig(), {"data": d, "model": m})
    for path, w in flat(one["grads"], "", {}).items():
        assert_close(flat(g1, "", {})[path], w, 1e-4, f"{name} {path}")
    assert_state_close(_one_rank(name, got["params"], got["opt"]),
                       (one["params"], one["opt"]), name)


@pytest.mark.parametrize("plain,zero1", [("s21", "s21z"), ("s22", "s22z")])
def test_zero1_matches_plain_update(runs, plain, zero1):
    a, b = port_step(runs, plain), port_step(runs, zero1)
    assert a["metrics"]["grad_norm"] == pytest.approx(b["metrics"]["grad_norm"], rel=1e-5)
    assert_state_close(_one_rank(zero1, b["params"], b["opt"]),
                       _one_rank(plain, a["params"], a["opt"]), f"{zero1} vs {plain}")
    # the ZeRO-1 state holds a 1/D slice of each replicated leaf: smaller per rank
    d, m = STEP_TASKS[zero1][0]
    sizes = {"data": d, "model": m}
    spec = backbone.model_spec(cfg_of(None), MeshCtx(model_size=m, data_size=d))
    zplan = build_plan(spec, ("data", "model"), sizes, OptConfig(zero1=True))
    pplan = build_plan(spec, ("data", "model"), sizes, OptConfig())
    zs = opt_state_spec(spec, zplan, sizes, OptConfig(zero1=True))
    ps = opt_state_spec(spec, pplan, sizes, OptConfig())
    assert zs["leaves"]["final_norm"]["scale"]["m"].shape == \
        ps["leaves"]["final_norm"]["scale"]["m"].shape     # (holders · pad) globally
    assert zplan["final_norm"]["scale"].scatter and zplan["final_norm"]["scale"].chunk * d == \
        pplan["final_norm"]["scale"].chunk


def test_collectives_ran_over_both_axes(runs):
    """The (2, 2) step all-gathered and reduce-scattered (the sequence
    plumbing) and all-reduced (gradients, norms, losses) on every rank;
    ZeRO-1 reduce-scattered over 'data' on top."""
    for r in range(4):
        plain = runs["port"][4][r]["steps"]["s22"]["ledger"]
        zero1 = runs["port"][4][r]["steps"]["s22z"]["ledger"]
        assert {"all_gather", "reduce_scatter", "all_reduce"} <= set(plain), plain
        assert all(plain[k]["calls"] > 0 and plain[k]["bytes"] > 0 for k in plain)
        assert zero1["reduce_scatter"]["calls"] > plain["reduce_scatter"]["calls"]


@pytest.mark.parametrize("name", list(STEP_TASKS))
def test_shard_then_gather_is_exact(runs, name):
    """``shard_params`` of the global parameters and state of the mesh
    layout, then ``gather_params`` on rank 0: the same arrays, bit for bit."""
    params, opt = port_step(runs, name)["round_trip"]
    task = runs["step_tasks"][name]
    for want, got in ((task["params"], params), (task["opt"], opt)):
        w, g = flat(want, "", {}), flat(got, "", {})
        assert sorted(w) == sorted(g)
        for path in w:
            assert np.array_equal(w[path], g[path]), (name, path)


@pytest.mark.parametrize("name", list(STEP_TASKS))
def test_gather_over_model_alone_gives_every_rank_the_whole(runs, name):
    """``gather_params(..., everywhere=True, axes=("model",))`` of the synced
    gradients (replicated over 'data'): every rank holds what rank 0's
    gather over the whole mesh holds, bit for bit."""
    res, world = rank_results(runs, name, "steps")
    want = flat(port_step(runs, name)["grads"], "", {})
    for r in range(world):
        got = flat(res[r]["steps"][name]["over_model"], "", {})
        assert sorted(got) == sorted(want)
        for path in want:
            assert np.array_equal(got[path], want[path]), (name, r, path)
