"""The MoE family across ranks — expert parallelism (``ffn._moe_core``'s
all-to-all dispatch, ``moe_apply``, ``moe_decode``), MLA's sequence-sharded
apply, latent cache and absorbed decode (``attention.mla_*``), the
deepseek training step and ``BatchScheduler`` — the port's ranks as gloo
processes on the CPU (``repro_torch.launch.ranks.run_ranks``, one group of
2 and one of 4 ranks for the module, ``tests/_torch_ranks.py``) against the
reference's ``shard_map`` bodies on fake CPU devices
(``tests/_jax_mesh_ref.py``, two subprocesses beside the ranks), and
against the port's own one-rank result.

The reference is given the weights in its own placement: its ``_moe_core``
runs expert ``e`` on rank ``e % world`` as local expert ``e // world``, so
row ``(e % w) · n_local + e // w`` of its global expert leaves holds expert
``e`` (``to_ref``); the port keeps expert ``e`` at row ``e``, where
``moe_spec``'s contiguous blocks shard it.  Both then compute the same
model.  Given the port's placement, the reference computes another model
above one rank (``test_expert_placement_where_the_reference_permutes_experts``,
Queue C).

Meshes: (1, 2), (2, 1), (2, 2) and (1, 4) (an expert-parallel world of 4,
2 experts a rank).  Configs: the smoke configs of deepseek-v2-236b (8
experts top-2, 1 shared, ``q_lora``) and deepseek-v3-671b (3 layers).
Inputs come from numpy seeds; everything is float32 but the latent
caches, which are bfloat16 in both packages.  No pair is dropped at
capacity in the layer, step and serving tasks (asserted: where a
destination overflows, the two placements drop different pairs); the
forced-drop tests bias the router so that both placements send the same
pairs to the same (relabelled) destinations and overflow them.

Tolerances, stated before the first run:

* each rank's layer outputs and aux losses within 1e-5 of the output's
  largest magnitude; every gradient leaf (parameters and input) within
  1e-4 of its largest magnitude (float32 sums in other orders: the
  reference runs each local expert over all ``world · cap`` masked slots,
  the port over its own rows);
* ``mla_decode``'s outputs and caches: within one bfloat16 step (1/128
  relative and absolute) — the latent caches and the attended latent are
  bfloat16, and the jitted reference rounds elsewhere than the port's ops;
* the dropped-pair counts: exactly equal;
* the step: as in ``tests/test_torch_mesh_train.py`` (loss 1e-5 relative,
  synced gradient leaves 1e-4 of their largest, parameters and master
  1e-6 absolute, m and v 1e-4 of their largest);
* served tokens, ``finished`` flags and counts: exactly equal to the
  reference's and to one rank's; prefill caches within one bfloat16 step;
* ``train.layout`` round trips: exact.
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
from repro_torch.launch.mesh import LocalMesh, make_local_mesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import attention, backbone, ffn
from repro_torch.models.layers import MeshCtx
from repro_torch.models.spec import dim_blocks, init_params, params_from_numpy
from repro_torch.optim import OptConfig, init_opt_state, sync_gradient
from repro_torch.optim.adamw import _state_pad
from repro_torch.serve.engine import cache_spec, make_serve_fns
from repro_torch.serve.scheduler import BatchScheduler, Request
from repro_torch.train import make_train_step
from repro_torch.train.layout import (
    _param_to_state,
    _specs,
    _state_to_param,
    from_one_rank,
    to_one_rank,
)

ROOT = Path(__file__).resolve().parents[1]
V2, V3 = "deepseek-v2-236b", "deepseek-v3-671b"
EXPERTS = ("we_gate", "we_up", "we_down")
MESHES = {"12": (1, 2), "21": (2, 1), "22": (2, 2), "14": (1, 4)}
B, T, MAX_LEN, STEPS = 4, 32, 64, 2
COT_AUX = 0.7
# the step, serving and placement tasks run at a capacity factor of 4:
# ``cap = ceil(4 · pairs / world) + 4`` holds every pair on a world of up to
# 4, so none can drop and each mesh computes one rank's function (at the
# default 1.25 the smoke router's skewed loads overflow a destination, and
# the two placements then drop different pairs)
ROOMY = {"capacity_factor": 4.0}
TIMEOUT = 240


def cfg_of(arch, scale=None):
    return get_smoke_config(arch).scaled(**(scale or {}))


def ctx_of(d, m):
    return MeshCtx(model_size=m, data_size=d)


def sizes(d, m):
    return {"data": d, "model": m}


def f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the two placements
# ---------------------------------------------------------------------------


def ref_rows(e_pad: int, world: int) -> np.ndarray:
    """The row of the reference's placement that holds expert ``e``."""
    nl = e_pad // world
    return np.array([(e % world) * nl + e // world for e in range(e_pad)])


def _map_experts(tree, fn):
    if isinstance(tree, dict):
        return {k: (fn(v) if k in EXPERTS and not isinstance(v, dict) else _map_experts(v, fn))
                for k, v in tree.items()}
    return tree


def to_ref(tree, world):
    """Expert leaves (rows on their last-but-two axis) from the port's
    placement to the reference's."""
    def fn(a):
        a = np.asarray(a)
        ax = a.ndim - 3
        out = np.empty_like(a)
        idx = [slice(None)] * a.ndim
        idx[ax] = ref_rows(a.shape[ax], world)
        out[tuple(idx)] = a
        return out
    return _map_experts(tree, fn)


def from_ref(tree, world):
    def fn(a):
        a = np.asarray(a)
        return np.take(a, ref_rows(a.shape[a.ndim - 3], world), axis=a.ndim - 3)
    return _map_experts(tree, fn)


def opt_to_ref(opt, cfg, ocfg, d, m, back=False):
    """A mesh-layout optimizer state with its expert leaves' flat states
    moved to the reference's placement (``back``: from it)."""
    spec, plan = _specs(cfg, ocfg, sizes(d, m))
    out = {"step": opt["step"], "leaves": {}}

    def walk(st, sp, pl, path):
        if isinstance(sp, dict):
            return {k: walk(st[k], sp[k], pl[k], path + (k,)) for k in sp}
        if path[-1] not in EXPERTS:
            return st
        base = pl.chunk if pl.scatter else int(np.prod(pl.local_shape))
        pad = _state_pad(base, ocfg)
        res = {}
        for key, flat in st.items():
            full = _state_to_param(torch.as_tensor(np.asarray(flat)), sp, pl, sizes(d, m), pad)
            moved = (from_ref if back else to_ref)({"we_gate": full.numpy()}, d * m)["we_gate"]
            res[key] = _param_to_state(torch.from_numpy(moved), sp, pl, sizes(d, m), pad).numpy()
        return res

    out["leaves"] = walk(opt["leaves"], spec, plan, ())
    return out


def bias_router(params, experts, x):
    """Every token's top-k := ``experts``: the router's row 0 strongly favours
    them, and x's feature 0 is large and positive (in place)."""
    r = params["router"]
    r[0, :] = -1.0
    r[0, list(experts)] = 1.0
    x[..., 0] = 8.0


# ---------------------------------------------------------------------------
# tasks
# ---------------------------------------------------------------------------


def layer_task(name, arch, mesh, rng, scale=None, *, moe=True, mla=True, decode=True,
               batch=B, dec_batch=B, placement="ref", bias=None, port=True, ref=True,
               params1=None):
    """A layer task: global float32 weights in the port's placement
    (``params``), the reference's copy in its own placement
    (``ref_params``), inputs and cotangents."""
    d, m = mesh
    cfg = cfg_of(arch, scale)
    ctx = ctx_of(d, m)
    world = d * m
    params, cot = {}, {}
    x = f32(rng, batch, T, cfg.d_model)
    xdec = f32(rng, dec_batch, 1, cfg.d_model) if decode else None
    if moe:
        params["moe"] = params1["moe"] if params1 else draw_tree(ffn.moe_spec(cfg, ctx), rng)
        if bias:
            bias_router(params["moe"], bias, x)
            if decode:
                bias_router(params["moe"], bias, xdec)
        cot["apply"] = f32(rng, world, batch // d, T // m, cfg.d_model)
        if decode:
            cot["decode"] = f32(rng, world, dec_batch // d, 1, cfg.d_model)
    if mla:
        params["mla"] = draw_tree(attention.mla_spec(cfg, ctx), rng)
        cot["mla"] = f32(rng, world, batch // d, T // m, cfg.d_model)
        cot["c_kv"] = f32(rng, world, batch // d, T, cfg.kv_lora)
        cot["k_rope"] = f32(rng, world, batch // d, T, cfg.rope_head_dim)
    ref_params = to_ref(params, world) if placement == "ref" else params
    t = {"name": name, "arch": arch, "scale": scale, "mesh": mesh, "params": params,
         "ref_params": ref_params, "x": x, "xdec": xdec, "cot": cot, "cot_aux": COT_AUX,
         "port": port, "ref": ref}
    if mla and decode:
        t.update(max_len=MAX_LEN, xsteps=[f32(rng, batch, 1, cfg.d_model) for _ in range(STEPS)])
    return t


def layer_tasks(rng):
    tasks = {}
    for arch, tag in ((V2, "v2"), (V3, "v3")):
        for mname, mesh in MESHES.items():
            if arch == V3 and mname in ("21", "14"):
                continue
            tasks[f"{tag}-{mname}"] = layer_task(f"{tag}-{mname}", arch, mesh, rng)
    # forced drops: every token's top-2 experts sit in one destination under
    # both placements ((1, 2): experts 0 and 2 of 8; (2, 2): 0 and 4 of 32)
    tasks["drop-12"] = layer_task("drop-12", V2, (1, 2), rng, mla=False, decode=False,
                                  bias=(0, 2))
    tasks["drop-22"] = layer_task("drop-22", V2, (2, 2), rng, {"n_experts": 32}, mla=False,
                                  dec_batch=32, bias=(0, 4))
    # the reference's expert placement (Queue C): the port's placement given
    # to the reference, on (1, 2) and on a padded (2, 2), beside one device
    qc = layer_task("qc-12", V2, (1, 2), rng, ROOMY, mla=False, decode=False,
                    placement="port")
    tasks["qc-12"] = qc
    tasks["qc-11"] = dict(layer_task("qc-11", V2, (1, 1), rng, ROOMY, mla=False, decode=False,
                                     placement="port", port=False, params1=qc["params"]),
                          x=qc["x"])
    pad6 = dict(ROOMY, n_experts=6)
    pad = layer_task("qc-22pad", V2, (2, 2), rng, pad6, mla=False, decode=False,
                     placement="port")
    pad["params"]["moe"] = padded_moe(pad["params"]["moe"], 6, 8)
    pad["ref_params"] = pad["params"]
    tasks["qc-22pad"] = pad
    six = {k: v[:6] if k in EXPERTS else v for k, v in pad["params"]["moe"].items()}
    rows = ref_rows(8, 4)[:6]           # the padded row the reference runs expert e on
    seen = {k: v[rows] if k in EXPERTS else v for k, v in pad["params"]["moe"].items()}
    for name, p in (("qc-11pad", six), ("qc-11seen", seen)):
        tasks[name] = dict(layer_task(name, V2, (1, 1), rng, pad6, mla=False,
                                      decode=False, placement="port", port=False,
                                      params1={"moe": p}), x=pad["x"])
    return tasks


def padded_moe(p, n, e_pad):
    """MoE weights of ``n`` experts at ``e_pad`` rows: the pad rows zero."""
    return {k: (np.concatenate([v[:n], np.zeros((e_pad - n,) + v.shape[1:], v.dtype)])
                if k in EXPERTS else v) for k, v in p.items()}


def carried_state(params1, cfg, rng):
    """A one-rank carried optimizer state: step 10, random m, v above the
    squared gradients (``test_torch_mesh_train.carried_state``)."""
    ocfg = OptConfig(warmup=2, total_steps=20)
    bundle = make_train_step(cfg, make_local_mesh(device="cpu"), ocfg, batch=B)
    opt = init_opt_state(params_from_numpy(params1, "cpu"), bundle.plan, ocfg)
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


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


# name: (arch, mesh, zero1, scale, in the reference)
STEP_TASKS = {
    "st-v2-12": (V2, (1, 2), False, ROOMY, True),
    "st-v2-21z": (V2, (2, 1), True, ROOMY, True),
    "st-v2-22": (V2, (2, 2), False, ROOMY, True),
    "st-v2-14": (V2, (1, 4), False, ROOMY, True),
    "st-v3-12": (V3, (1, 2), False, ROOMY, True),
    "st-v3-22z": (V3, (2, 2), True, ROOMY, True),
    "st-v2-22pad": (V2, (2, 2), False, dict(ROOMY, n_experts=6), False),
}


def step_tasks(rng):
    one, tasks = {}, {}
    toks = rng.integers(0, 512, (B, T)).astype(np.int32)
    labels = rng.integers(0, 512, (B, T)).astype(np.int32)
    labels[:, :3] = -1
    batch = {"tokens": toks, "labels": labels}
    for name, (arch, (d, m), zero1, scale, in_ref) in STEP_TASKS.items():
        key = json.dumps([arch, scale])
        cfg = cfg_of(arch, scale)
        if key not in one:
            params1 = draw_tree(backbone.model_spec(cfg, MeshCtx()), rng)
            one[key] = (params1, carried_state(params1, cfg, rng))
        params1, opt1 = one[key]
        ocfg = OptConfig(warmup=2, total_steps=20, zero1=zero1)
        pm, om = from_one_rank(params1, opt1, cfg, ocfg, sizes(d, m))
        pm, om = _np(pm), _np(om)
        tasks[name] = {"name": name, "arch": arch, "scale": scale, "mesh": (d, m),
                       "zero1": zero1, "params": pm, "opt": om, "batch": batch, "ref": in_ref,
                       "ref_params": to_ref(pm, d * m),
                       "ref_opt": opt_to_ref(om, cfg, ocfg, d, m)}
    return one, batch, tasks


# serving: prompts of 8 (a full batch, inside rank 0's chunk on (1, 2)) and
# of 20 (an underfull batch padded with copies, crossing the chunk boundary)
SERVE_MAX_LEN, CROSS = 32, 20
LENS, MAX_NEW = (8, 8, 8, 8, CROSS, CROSS), (6, 4, 6, 5, 6, 3)
SERVE_TASKS = {"sv-v2-12": (V2, (1, 2)), "sv-v2-21": (V2, (2, 1)), "sv-v2-22": (V2, (2, 2)),
               "sv-v2-14": (V2, (1, 4)), "sv-v3-12": (V3, (1, 2)), "sv-v3-22": (V3, (2, 2))}


def serve_tasks(rng):
    one, tasks, want = {}, {}, {}
    reqs = [[i, [int(x) for x in rng.integers(0, 512, n)], k]
            for i, (n, k) in enumerate(zip(LENS, MAX_NEW))]
    for name, (arch, (d, m)) in SERVE_TASKS.items():
        cfg = cfg_of(arch, ROOMY)
        if arch not in one:
            one[arch] = draw_tree(backbone.model_spec(cfg, MeshCtx()), rng)
            sched = BatchScheduler(cfg, make_local_mesh(device="cpu"), batch=B,
                                   max_len=SERVE_MAX_LEN, eos_id=-1)
            with torch.no_grad():
                done, st = sched.run(params_from_numpy(one[arch], "cpu"),
                                     [Request(*r) for r in reqs])
            want[arch] = ({rid: (c.tokens, c.finished) for rid, c in done.items()},
                          (st.requests, st.prefill_tokens, st.decode_steps, st.batches))
        pm, _ = from_one_rank(one[arch], None, cfg, OptConfig(), sizes(d, m))
        pm = _np(pm)
        tasks[name] = {"name": name, "arch": arch, "scale": ROOMY, "mesh": (d, m), "batch": B,
                       "max_len": SERVE_MAX_LEN, "eos_id": -1, "requests": reqs,
                       "prefill": CROSS, "params": pm, "ref_params": to_ref(pm, d * m)}
    return tasks, want


# ---------------------------------------------------------------------------
# the runs
# ---------------------------------------------------------------------------


def flat(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat(v, f"{prefix}/{k}", out)
    elif tree is not None:
        out[prefix] = np.asarray(tree.float().numpy() if isinstance(tree, torch.Tensor) else tree)
    return out


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


def reference_job(layers, steps, serves, path):
    job, arrays = [], {}
    for t in layers:
        job.append({"kind": "moe_layers", "name": t["name"], "arch": t["arch"],
                    "scale": t["scale"] or {}, "mesh": t["mesh"], "cot_aux": t["cot_aux"]}
                   | ({"max_len": t["max_len"], "n_steps": STEPS} if "max_len" in t else {}))
        flat(t["ref_params"], f"{t['name']}/params", arrays)
        arrays[f"{t['name']}/x"] = t["x"]
        if t["xdec"] is not None and "moe" in t["params"]:
            arrays[f"{t['name']}/xdec"] = t["xdec"]
        flat(t["cot"], f"{t['name']}/cot", arrays)
        for i, xs in enumerate(t.get("xsteps", ())):
            arrays[f"{t['name']}/xstep{i}"] = xs
    for t in steps:
        job.append({"kind": "step", "name": t["name"], "arch": t["arch"], "mesh": t["mesh"],
                    "scale": t["scale"] or {}, "zero1": t["zero1"]})
        flat(t["ref_params"], f"{t['name']}/params", arrays)
        flat(t["ref_opt"], f"{t['name']}/opt", arrays)
        flat(t["batch"], f"{t['name']}/batch", arrays)
    for t in serves:
        job.append({k: t[k] for k in ("name", "mesh", "batch", "max_len", "eos_id",
                                      "requests", "prefill")}
                   | {"kind": "serve", "arch": t["arch"], "scale": t["scale"]})
        flat(t["ref_params"], f"{t['name']}/params", arrays)
    np.savez(path, job=json.dumps(job), **arrays)


def ranks_body(dev, layers, steps, serves):
    """Layers, then steps, then serving, in one group of ranks."""
    return {"layers": _torch_ranks.moe_layers(dev, layers),
            "steps": _torch_ranks.train_steps(dev, steps),
            "serve": _torch_ranks.serve(dev, serves)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_multirank")
    rng = np.random.default_rng(27)
    layers = layer_tasks(rng)
    one, batch, steps = step_tasks(rng)
    serves, serve_want = serve_tasks(rng)
    # two reference subprocesses, the work split about evenly
    ref_l = [t for t in layers.values() if t["ref"]]
    ref_s = [t for t in steps.values() if t["ref"]]
    parts = [(ref_l[0::2], ref_s[1::2], list(serves.values())[0::2]),
             (ref_l[1::2], ref_s[0::2], list(serves.values())[1::2])]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    refs = []
    for i, (lt, st, sv) in enumerate(parts):
        reference_job(lt, st, sv, tmp / f"in{i}.npz")
        refs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_jax_mesh_ref.py"), str(tmp / f"in{i}.npz"),
             str(tmp / f"out{i}.npz"), "4"], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))

    def port_tasks(world):
        lt = [{k: v for k, v in t.items() if k != "ref_params"} for t in layers.values()
              if t["port"] and np.prod(t["mesh"]) == world]
        st = [{k: v for k, v in t.items() if not k.startswith("ref_")}
              for t in steps.values() if np.prod(t["mesh"]) == world]
        sv = [{k: v for k, v in t.items() if k != "ref_params"} for t in serves.values()
              if np.prod(t["mesh"]) == world]
        return run_ranks(ranks_body, world, tmp / f"rdv{world}", device="cpu",
                         args=(lt, st, sv), timeout=TIMEOUT)

    try:
        with ThreadPoolExecutor(2) as pool:
            port = dict(zip((2, 4), pool.map(port_tasks, (2, 4))))
        errs = [r.communicate(timeout=TIMEOUT)[1] for r in refs]
    finally:
        for r in refs:
            if r.poll() is None:
                r.kill()
                r.wait()
    for r, err in zip(refs, errs):
        assert r.returncode == 0, err[-3000:]
    ref = {}
    for i in range(2):
        ref.update(np.load(tmp / f"out{i}.npz"))
    return {"ref": ref, "port": port, "layers": layers, "steps": steps, "one": one,
            "batch": batch, "serves": serves, "serve_want": serve_want}


def assert_close(got, want, rel, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= rel * scale + 1e-12, (name, err, scale)


def per_rank(runs, group, name):
    t = (runs["layers"] if group == "layers" else runs["steps"] if group == "steps"
         else runs["serves"])[name]
    world = int(np.prod(t["mesh"]))
    return [r[group][name] for r in runs["port"][world]], t


def expert_global(blocks, spec_leaf, mesh):
    """The global array of an expert leaf from every rank's block."""
    d, m = mesh
    out = np.zeros(spec_leaf.shape, np.float32)
    for r, b in enumerate(blocks):
        out[dim_blocks(spec_leaf.shape, spec_leaf.axes, sizes(d, m),
                       {"data": r // m, "model": r % m})] = b
    return out


def summed_global(blocks, spec_leaf, mesh):
    """Every rank's (partial) gradient of a leaf added into the global
    shape: the one-rank gradient of the summed objective."""
    return sum_blocks(blocks, spec_leaf.shape, spec_leaf.axes, mesh)


def sum_blocks(blocks, shape, axes, mesh):
    d, m = mesh
    out = np.zeros(shape, np.float32)
    for r, b in enumerate(blocks):
        out[dim_blocks(shape, axes, sizes(d, m), {"data": r // m, "model": r % m})] += b
    return out


# ---------------------------------------------------------------------------
# the layers against the reference, rank by rank
# ---------------------------------------------------------------------------

LAYER_NAMES = ["v2-12", "v2-21", "v2-22", "v2-14", "v3-12", "v3-22"]


def moe_spec_of(t):
    d, m = t["mesh"]
    return ffn.moe_spec(cfg_of(t["arch"], t["scale"]), ctx_of(d, m))


def check_moe_against_ref(runs, name, key):
    per, t = per_rank(runs, "layers", name)
    ref = runs["ref"]
    d, m = t["mesh"]
    spec = moe_spec_of(t)
    for r, res in enumerate(per):
        got = res[key]
        assert_close(got["y"], ref[f"{name}/{key}/out0"][r], 1e-5, f"{name} {key} y {r}")
        assert abs(got["aux"] - float(ref[f"{name}/{key}/out1"][r])) <= \
            1e-5 * abs(float(ref[f"{name}/{key}/out1"][r])), (name, key, r)
        assert got["dispatch"]["dropped"] == int(ref[f"{name}/{key}/dropped"][r]), (name, r)
        assert_close(got["dx"], ref[f"{name}/{key}/dx"][r], 1e-4, f"{name} {key} dx {r}")
        for leaf in spec:
            if leaf not in EXPERTS:
                assert_close(got["dp"][f"/{leaf}"], ref[f"{name}/{key}/dp/{leaf}"][r], 1e-4,
                             f"{name} {key} d{leaf} rank {r}")
    for leaf in EXPERTS:        # each rank holds other experts: held whole
        mine = expert_global([res[key]["dp"][f"/{leaf}"] for res in per], spec[leaf], (d, m))
        theirs = expert_global(list(ref[f"{name}/{key}/dp/{leaf}"]), spec[leaf], (d, m))
        assert_close(mine, from_ref({leaf: theirs}, d * m)[leaf], 1e-4, f"{name} {key} d{leaf}")
    return per


@pytest.mark.parametrize("key", ["apply", "decode"])
@pytest.mark.parametrize("name", LAYER_NAMES)
def test_moe_per_rank_matches_reference(runs, name, key):
    per = check_moe_against_ref(runs, name, key)
    for res in per:
        assert res[key]["dispatch"]["dropped"] == 0 and res[key]["dispatch"]["calls"] == 1


@pytest.mark.parametrize("name", LAYER_NAMES)
def test_mla_per_rank_matches_reference(runs, name):
    """``mla_apply``: each rank's output shard, its latents over the whole
    sequence, and the gradients of its head-sharded and replicated leaves."""
    per, t = per_rank(runs, "layers", name)
    ref = runs["ref"]
    for r, res in enumerate(per):
        got = res["mla"]
        for i, k in enumerate(("y", "c_kv", "k_rope")):
            assert_close(got[k], ref[f"{name}/mla/out{i}"][r], 1e-5, f"{name} mla {k} {r}")
        assert got["c_kv"].shape[1] == T                     # gathered: the whole sequence
        assert_close(got["dx"], ref[f"{name}/mla/dx"][r], 1e-4, f"{name} mla dx {r}")
        for path, g in got["dp"].items():
            assert_close(g, ref[f"{name}/mla/dp{path}"][r], 1e-4, f"{name} mla d{path} {r}")


@pytest.mark.parametrize("name", LAYER_NAMES)
def test_mla_decode_per_rank_matches_reference(runs, name):
    """``mla_fill_cache`` then two ``mla_decode`` steps past the prompt:
    each rank's outputs and its chunk of the latent cache (the decode's
    position lies in another rank's chunk than the prompt's end on every
    'model' axis above 1)."""
    per, t = per_rank(runs, "layers", name)
    ref = runs["ref"]
    tol = dict(rtol=1 / 128, atol=1 / 128)
    for r, res in enumerate(per):
        got = res["mla_decode"]
        assert got["len"] == T + STEPS
        for i, y in enumerate(got["y"]):
            np.testing.assert_allclose(y, ref[f"{name}/mla_decode/y{i}"][r], **tol,
                                       err_msg=f"{name} step {i} rank {r}")
        for k in ("c_kv", "k_rope"):
            np.testing.assert_allclose(got[k], ref[f"{name}/mla_decode/{k}"][r], **tol,
                                       err_msg=f"{name} {k} rank {r}")


# ---------------------------------------------------------------------------
# the layers against the port's one rank
# ---------------------------------------------------------------------------


def one_rank_layers(t):
    """The port's one-rank layers on the task's global inputs: outputs and
    gradients of the objective every rank's sums to."""
    d, m = t["mesh"]
    world = d * m
    cfg = cfg_of(t["arch"], t["scale"])
    ctx = MeshCtx()
    out = {}

    def rows_sum(cot):            # (world, B/d, …) -> (B, …): summed over 'model'
        c = cot.reshape((d, m) + cot.shape[1:]).sum(1)
        return c.reshape((-1,) + cot.shape[2:])

    def seq_cat(cot):             # (world, B/d, T/m, …) -> (B, T, …)
        c = cot.reshape((d, m) + cot.shape[1:])
        return np.concatenate([np.concatenate(list(c[i]), 1) for i in range(d)], 0)

    moe = ffn.moe_spec(cfg, ctx)
    p1 = {k: v[:cfg.n_experts] if k in EXPERTS else v for k, v in t["params"]["moe"].items()}
    for key, fn, x, cot in (("apply", ffn.moe_apply, t["x"], seq_cat(t["cot"]["apply"])),
                            ("decode", ffn.moe_decode, t["xdec"],
                             rows_sum(t["cot"]["decode"]) if t["xdec"] is not None else None)):
        if x is None:
            continue
        p = params_from_numpy(p1, "cpu")
        (y, aux), dp, dx = _torch_ranks._vjp(lambda pp, xx: fn(pp, xx, ctx, cfg, 1), p,
                                             torch.from_numpy(x), (cot, world * COT_AUX))
        out[key] = {"y": y, "aux": float(aux), "dp": dp, "dx": dx}
    if "mla" in t["params"]:
        p = params_from_numpy(t["params"]["mla"], "cpu")

        def mla(pp, xx):
            o, (c, kr) = attention.mla_apply(pp, xx, ctx, cfg, return_latent=True)
            return o, c, kr

        (o, c, kr), dp, dx = _torch_ranks._vjp(mla, p, torch.from_numpy(t["x"]), (
            seq_cat(t["cot"]["mla"]), rows_sum(t["cot"]["c_kv"]), rows_sum(t["cot"]["k_rope"])))
        out["mla"] = {"y": o, "c_kv": c, "k_rope": kr, "dp": dp, "dx": dx}
        with torch.no_grad():
            _, (c, kr) = attention.mla_apply(p, torch.from_numpy(t["x"]), ctx, cfg,
                                             return_latent=True)
            cache = attention.mla_fill_cache(
                attention.mla_init_cache(cfg, ctx, B, MAX_LEN), c, kr, ctx)
            ys = []
            for xd in t["xsteps"]:
                o, cache = attention.mla_decode(p, torch.from_numpy(xd), cache, ctx, cfg)
                ys.append(o.numpy())
        out["mla_decode"] = {"y": ys, "c_kv": cache["c_kv"].float().numpy(),
                             "k_rope": cache["k_rope"].float().numpy()}
    del moe
    return out


def rank_block(a, mesh, r, spec):
    d, m = mesh
    at = {"data": r // m, "model": r % m}
    idx = []
    for dim, ax in zip(a.shape, spec):
        n = {"data": d, "model": m}.get(ax, 1)
        i = at.get(ax, 0)
        idx.append(slice(i * (dim // n), (i + 1) * (dim // n)))
    return a[tuple(idx)]


@pytest.mark.parametrize("name", LAYER_NAMES)
def test_layers_match_one_rank(runs, name):
    """Every rank's MoE and MLA outputs are its block of the one-rank
    outputs, its aux loss the one-rank one; the gradients summed over
    ranks into the global shapes are the one-rank gradients."""
    per, t = per_rank(runs, "layers", name)
    one = one_rank_layers(t)
    mesh = t["mesh"]
    seq, rows = ("data", "model", None), ("data", None, None)
    cfg = cfg_of(t["arch"], t["scale"])
    for key, spec in (("apply", seq), ("decode", rows)):
        for r, res in enumerate(per):
            assert_close(res[key]["y"], rank_block(one[key]["y"], mesh, r, spec), 1e-5,
                         f"{name} {key} y {r}")
            assert abs(res[key]["aux"] - one[key]["aux"]) <= 1e-5 * one[key]["aux"]
        # a decode row is replicated over 'model': its gradient is the sum of
        # the 'model' ranks' partial ones (the shared experts' columns)
        dx = sum_blocks([res[key]["dx"] for res in per], one[key]["dx"].shape, spec, mesh)
        assert_close(dx, one[key]["dx"], 1e-4, f"{name} {key} dx")
        for leaf, p in moe_spec_of(t).items():
            g = summed_global([res[key]["dp"][f"/{leaf}"] for res in per], p, mesh)
            assert_close(g[:cfg.n_experts] if leaf in EXPERTS else g, one[key]["dp"][f"/{leaf}"],
                         1e-4, f"{name} {key} d{leaf}")
    mspec = attention.mla_spec(cfg, ctx_of(*mesh))
    for r, res in enumerate(per):
        for k, spec in (("y", seq), ("c_kv", rows), ("k_rope", rows), ("dx", seq)):
            assert_close(res["mla"][k], rank_block(one["mla"][k], mesh, r, spec),
                         1e-4 if k == "dx" else 1e-5, f"{name} mla {k} {r}")
        for i, y in enumerate(res["mla_decode"]["y"]):
            np.testing.assert_allclose(y, rank_block(one["mla_decode"]["y"][i], mesh, r, rows),
                                       rtol=1 / 128, atol=1 / 128)
        for k in ("c_kv", "k_rope"):
            np.testing.assert_allclose(
                res["mla_decode"][k], rank_block(one["mla_decode"][k], mesh, r,
                                                 ("data", "model", None)),
                rtol=1 / 128, atol=1 / 128)
    for leaf, p in mspec.items():
        g = summed_global([res["mla"]["dp"][f"/{leaf}"] for res in per], p, mesh)
        assert_close(g, one["mla"]["dp"][f"/{leaf}"], 1e-4, f"{name} mla d{leaf}")


# ---------------------------------------------------------------------------
# capacity drops, and the reference's expert placement (Queue C)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,key", [("drop-12", "apply"), ("drop-22", "apply"),
                                      ("drop-22", "decode")])
def test_forced_drops_match_reference(runs, name, key):
    """Every token's top-2 experts in one destination under both
    placements, more pairs than ``cap`` there: the port drops exactly the
    reference's pairs (the same count on every rank, the same outputs —
    zero for a dropped pair — and gradients); ``moe_decode``'s round-robin
    ownership counts only the owned rows' pairs."""
    per = check_moe_against_ref(runs, name, key)
    drops = [res[key]["dispatch"]["dropped"] for res in per]
    assert all(n > 0 for n in drops), drops
    t = runs["layers"][name]
    d, m = t["mesh"]
    if key == "decode":      # owned rows only: B/d rows a data rank, 1/m of them owned
        assert all(res[key]["dispatch"]["pairs"] == 32 // d // m * 2 for res in per)


def test_expert_placement_where_the_reference_permutes_experts(runs):
    """Queue C, reference ``src/repro/models/ffn.py:81-83`` against ``:126``,
    ``:145``: ``moe_spec`` shards the experts over ('data', 'model') in
    contiguous blocks, but ``_moe_core`` runs expert ``e`` on rank ``e %
    world`` as local expert ``e // world``.  Given one set of global
    weights, the reference's (1, 2) ``moe_apply`` departs from its own one
    device (expert ``e`` computes with another expert's row), while the
    port's (1, 2), which runs expert ``e`` where its row lies, equals the
    port's one rank.  On a (2, 2) mesh with 6 experts padded to 8 the
    reference runs expert 3 through pad row 6 (zero): its output is its
    one device's on the rows it reads, expert ``e`` on row ``(e % 4) · 2 +
    e // 4``; the port's pad rows get no token (zero gradient) and its
    output equals one rank's."""
    ref = runs["ref"]
    # (1, 2): the reference against its own one device
    y12 = np.concatenate(list(ref["qc-12/apply/out0"]), 1)       # (B, T, d)
    y11 = ref["qc-11/apply/out0"][0]
    scale = float(np.abs(y11).max())
    assert float(np.abs(y12 - y11).max()) > 0.1 * scale
    # the port's (1, 2) equals the port's one rank
    per, t = per_rank(runs, "layers", "qc-12")
    one = one_rank_layers(dict(t, xdec=None, params={"moe": t["params"]["moe"]}))
    for r, res in enumerate(per):
        assert_close(res["apply"]["y"], rank_block(one["apply"]["y"], (1, 2), r,
                                                   ("data", "model", None)), 1e-5, f"rank {r}")
    # and the reference's one device equals the port's one rank
    assert_close(one["apply"]["y"], y11, 1e-5, "one device")
    # (2, 2), 6 experts padded to 8
    got = ref["qc-22pad/apply/out0"]                 # (4, B/2, T/2, d)
    y22 = np.concatenate([np.concatenate(list(got[2 * i:2 * i + 2]), 1) for i in range(2)], 0)
    seen, true = ref["qc-11seen/apply/out0"][0], ref["qc-11pad/apply/out0"][0]
    assert_close(y22, seen, 1e-5, "the reference runs expert e on row (e % 4) * 2 + e // 4")
    assert float(np.abs(y22 - true).max()) > 0.1 * float(np.abs(true).max())
    assert ref_rows(8, 4)[3] == 6                    # expert 3 on a pad row
    per, t = per_rank(runs, "layers", "qc-22pad")
    one = one_rank_layers(dict(t, xdec=None, params={"moe": t["params"]["moe"]}))
    for r, res in enumerate(per):
        assert_close(res["apply"]["y"], rank_block(one["apply"]["y"], (2, 2), r,
                                                   ("data", "model", None)), 1e-5, f"rank {r}")
    spec = moe_spec_of(t)
    for leaf in EXPERTS:
        g = expert_global([res["apply"]["dp"][f"/{leaf}"] for res in per], spec[leaf], (2, 2))
        assert not g[6:].any() and g[:6].any()


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------

REF_STEPS = [n for n, t in STEP_TASKS.items() if t[4]]


def port_step(runs, name):
    per, _ = per_rank(runs, "steps", name)
    return per[0]


def _one_rank(name, params, opt):
    arch, (d, m), zero1, scale, _ = STEP_TASKS[name]
    ocfg = OptConfig(warmup=2, total_steps=20, zero1=zero1)
    return to_one_rank(params, opt, cfg_of(arch, scale), ocfg, sizes(d, m))


def assert_state_close(got, want, label):
    (gp, go), (wp, wo) = got, want
    fg, fw = flat(gp, "", {}), flat(wp, "", {})
    assert sorted(fg) == sorted(fw)
    for path, w in fw.items():
        assert np.abs(fg[path] - w).max() <= 1e-6, (label, path, np.abs(fg[path] - w).max())
    assert int(go["step"]) == int(wo["step"]) == 11
    gl, wl = flat(go["leaves"], "", {}), flat(wo["leaves"], "", {})
    assert sorted(gl) == sorted(wl)
    for path, w in wl.items():
        if path.endswith("/master"):
            assert np.abs(gl[path] - w).max() <= 1e-6, (label, path)
        else:
            assert_close(gl[path], w, 1e-4, f"{label} {path}")


@pytest.mark.parametrize("name", REF_STEPS)
def test_step_matches_reference(runs, name):
    """Loss, the synced gradients, metrics, and the parameters and state
    after one step, against the reference's step on the same mesh (its
    expert rows moved back to the port's placement)."""
    got, ref = port_step(runs, name), runs["ref"]
    arch, (d, m), zero1, scale, _ = STEP_TASKS[name]
    want = float(ref[f"{name}/loss"])
    assert abs(got["loss"] - want) <= 1e-5 * abs(want), (got["loss"], want)
    want_g = from_ref(unflat(ref, f"{name}/grads"), d * m)
    fg = flat(got["grads"], "", {})
    for path, w in flat(want_g, "", {}).items():
        assert_close(fg[path], w, 1e-4, f"{name} {path}")
    for k in ("grad_norm", "loss", "aux"):
        w = float(ref[f"{name}/metrics/{k}"])
        assert abs(got["metrics"][k] - w) <= 1e-5 * abs(w), (k, got["metrics"][k], w)
    cfg = cfg_of(arch, scale)
    ocfg = OptConfig(warmup=2, total_steps=20, zero1=zero1)
    ref_p = from_ref(unflat(ref, f"{name}/after/params"), d * m)
    ref_o = unflat(ref, f"{name}/after/opt")
    ref_o = opt_to_ref(dict(ref_o, step=ref_o["step"]), cfg, ocfg, d, m, back=True)
    assert_state_close(_one_rank(name, got["params"], got["opt"]),
                       _one_rank(name, ref_p, ref_o), name)


@pytest.fixture(scope="module")
def one_rank_steps(runs):
    out = {}
    for key, (params1, opt1) in runs["one"].items():
        arch, scale = json.loads(key)
        cfg = cfg_of(arch, scale)
        bundle = make_train_step(cfg, make_local_mesh(device="cpu"),
                                 OptConfig(warmup=2, total_steps=20), batch=B)
        p = params_from_numpy(params1, "cpu")
        opt = {"step": opt1["step"].clone(), "leaves": _clone(opt1["leaves"])}
        grads, ce, aux = bundle.grads(p, runs["batch"])
        synced = _map_plan(lambda g, pl: sync_gradient(g, pl), grads, bundle.plan)
        p, opt, met = bundle.update(p, opt, grads, ce, aux)
        out[key] = {"grads": synced, "params": p, "opt": opt,
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
    """Every mesh's step (a padded (2, 2) of 6 experts too) against the
    port's one-rank step from the same state, in the one-rank layout; the
    aux loss is the same on every rank and enters the loss as ce does."""
    got = port_step(runs, name)
    arch, (d, m), _, scale, _ = STEP_TASKS[name]
    one = one_rank_steps[json.dumps([arch, scale])]
    per, _ = per_rank(runs, "steps", name)
    assert all(r["dispatch"]["dropped"] == 0 and r["dispatch"]["calls"] for r in per)
    for k in ("loss", "grad_norm", "aux"):
        assert abs(got["metrics"][k] - one["metrics"][k]) <= 1e-5 * abs(one["metrics"][k]), k
    g1, _ = to_one_rank(got["grads"], None, cfg_of(arch, scale), OptConfig(), sizes(d, m))
    fg = flat(g1, "", {})
    for path, w in flat(one["grads"], "", {}).items():
        assert_close(fg[path], w, 1e-4, f"{name} {path}")
    assert_state_close(_one_rank(name, got["params"], got["opt"]),
                       (one["params"], one["opt"]), name)
    if "n_experts" in scale:        # the pad rows stay zero: no token reaches them
        e = cfg_of(arch, scale).n_experts
        for leaf in EXPERTS:
            assert not got["params"]["g1"]["moe"][leaf][:, e:].any()


def test_step_collectives_include_the_all_to_all(runs):
    for r in range(4):
        led = runs["port"][4][r]["steps"]["st-v2-22"]["ledger"]
        assert {"all_gather", "reduce_scatter", "all_reduce", "all_to_all"} <= set(led), led
        # forward, remat recompute and backward: 3 + 3 + 2 a MoE layer
        assert led["all_to_all"]["calls"] == 8, led["all_to_all"]


# ---------------------------------------------------------------------------
# the optimizer state across layouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_experts", [8, 6])
def test_moe_state_carries_across_layouts(n_experts):
    """A (2, 2) MoE training state, parameters and float optimizer states
    (ZeRO-1 too), goes to one rank and back exactly; with 6 experts on an
    expert-parallel world of 4 the mesh layout pads them to 8, its pad rows
    zero, dropped on the way to one rank."""
    cfg = cfg_of(V2, {"n_experts": n_experts})
    rng = np.random.default_rng(3)
    params1 = draw_tree(backbone.model_spec(cfg, MeshCtx()), rng)
    opt1 = carried_state(params1, cfg, rng)
    for zero1 in (False, True):
        ocfg = OptConfig(warmup=2, total_steps=20, zero1=zero1)
        pm, om = from_one_rank(params1, opt1, cfg, ocfg, sizes(2, 2))
        assert pm["g1"]["moe"]["we_gate"].shape[1] == 8
        assert not pm["g1"]["moe"]["we_gate"][:, n_experts:].any()
        p1, o1 = to_one_rank(pm, om, cfg, ocfg, sizes(2, 2))
        for path, w in flat(params1, "", {}).items():
            assert np.array_equal(flat(p1, "", {})[path], w), path
        for path, w in flat(opt1["leaves"], "", {}).items():
            assert np.array_equal(flat(o1["leaves"], "", {})[path], w), path
        pm2, om2 = from_one_rank(p1, o1, cfg, ocfg, sizes(2, 2))
        for a, b in ((pm, pm2), (om["leaves"], om2["leaves"])):
            for path, w in flat(a, "", {}).items():
                assert np.array_equal(flat(b, "", {})[path], w), path


def test_one_seed_draws_one_model_on_every_mesh():
    """The padded experts are drawn at ``n_experts`` rows and zero-padded
    (``logical``): a (2, 2) mesh's global weights from one seed are the
    one-rank weights from that seed, pad rows zero."""
    cfg = cfg_of(V2, {"n_experts": 6})
    g = lambda: torch.Generator().manual_seed(4)    # noqa: E731
    one = init_params(backbone.model_spec(cfg, MeshCtx()), g(), "cpu")
    mesh = init_params(backbone.model_spec(cfg, ctx_of(2, 2)), g(), "cpu")
    assert mesh["g1"]["moe"]["we_up"].shape[1] == 8 and not mesh["g1"]["moe"]["we_up"][:, 6:].any()
    back, _ = to_one_rank(mesh, None, cfg, OptConfig(), sizes(2, 2))
    for path, w in flat(one, "", {}).items():
        assert np.array_equal(flat(back, "", {})[path], w), path


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def ref_completions(runs, name):
    ref, t = runs["ref"], runs["serves"][name]
    return ({rid: (ref[f"{name}/tokens/{rid}"].tolist(), bool(ref[f"{name}/finished/{rid}"]))
             for rid, _, _ in t["requests"]},
            tuple(int(x) for x in ref[f"{name}/stats"]))


@pytest.mark.parametrize("name", list(SERVE_TASKS))
def test_every_rank_serves_the_reference_and_one_rank_tokens(runs, name):
    per, t = per_rank(runs, "serve", name)
    ref = ref_completions(runs, name)
    want = runs["serve_want"][t["arch"]]
    for r, res in enumerate(per):
        got = (res["completions"], res["stats"])
        assert got == ref, (name, r, got, ref)
        assert got == want, (name, r)
        assert res["dispatch"]["dropped"] == 0 and res["dispatch"]["calls"] > 0


@pytest.mark.parametrize("name", list(SERVE_TASKS))
def test_prefill_latent_caches_are_the_reference_blocks(runs, name):
    """Each rank's latent caches after the 20-token bucket's prefill (which
    crosses the chunk boundary) are its block of the reference's global
    caches by ``cache_spec``; positions past the prompt hold zeros."""
    per, t = per_rank(runs, "serve", name)
    d, m = t["mesh"]
    cfg = cfg_of(t["arch"], t["scale"])
    spec = cache_spec(cfg, LocalMesh(("data", "model"), sizes(d, m), torch.device("cpu")), B,
                      SERVE_MAX_LEN)
    ref = runs["ref"]
    for r, res in enumerate(per):
        at = {"data": r // m, "model": r % m}
        for g in spec:
            assert res["caches"][g]["len"] == CROSS
            for key in ("c_kv", "k_rope"):
                p = spec[g][key]
                want = ref[f"{name}/caches/{g}/{key}"][dim_blocks(p.shape, p.axes, sizes(d, m),
                                                                  at)]
                got = res["caches"][g][key]
                assert got.shape == want.shape, (name, r, g, key)
                np.testing.assert_allclose(got, want, rtol=1 / 128, atol=1 / 128)
                tc = SERVE_MAX_LEN // m
                tail = max(0, min(tc, CROSS - (r % m) * tc))
                assert not got[..., tail:, :].any()
        np.testing.assert_array_equal(res["prefill_token"], ref[f"{name}/prefill_token"])
        np.testing.assert_array_equal(res["decode_token"], per[0]["decode_token"])


@pytest.mark.parametrize("name", list(SERVE_TASKS))
def test_decode_step_collectives(runs, name):
    """One decode step's collectives, a rank.  Over 'model': per MLA layer
    the two query all-gathers, ``combine_partials``' three all-reduces and
    the ``wo`` psum; the dense MLP's psum; per MoE layer the owned rows'
    and the shared experts' psums; the embedding's psum and the argmax's
    all-gather.  Per MoE layer over the whole world: the aux terms' one
    all-reduce and three all-to-alls (tokens, expert ids, outputs).  The
    token's all-gather over 'data'."""
    per, t = per_rank(runs, "serve", name)
    d, m = t["mesh"]
    cfg = cfg_of(t["arch"], t["scale"])
    n_moe, n_dense = cfg.n_layers - cfg.n_dense_layers, cfg.n_dense_layers
    want = {"all_to_all": 3 * n_moe, "all_reduce": n_moe}
    if m > 1:
        want["all_gather"] = 2 * cfg.n_layers + 1
        want["all_reduce"] += (1 + 4 * cfg.n_layers + n_dense
                               + n_moe * (1 + bool(cfg.n_shared_experts)))
    if d > 1:
        want["all_gather"] = want.get("all_gather", 0) + 1
    for r, res in enumerate(per):
        assert res["decode_ledger"] == want, (name, r, res["decode_ledger"])
