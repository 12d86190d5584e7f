"""The recurrent families across ranks — the RG-LRU's sequence-parallel
scan with its gathered conv halo (``rglru.rglru_apply``), local attention
with its replicated ring (``gqa_apply(window=)``, ``local_decode``), the
SSD's head-sharded apply, norm and decode (``ssm.ssm_*``), the
recurrentgemma and mamba2 training steps and ``BatchScheduler`` — the
port's ranks as gloo processes on the CPU
(``repro_torch.launch.ranks.run_ranks``, one group of 2 and one of 4 ranks
for the module, ``tests/_torch_ranks.py``) against the reference's
``shard_map`` bodies on fake CPU devices (``tests/_jax_mesh_ref.py``, three
subprocesses beside the ranks), and against the port's own one-rank result.

Meshes: (1, 2), (2, 1), (2, 2) and (1, 4).  Configs: the smoke configs of
recurrentgemma-2b (6 layers: two periods of rglru, rglru, attn; window 64,
16 in the layer tasks so that a 32-token prefill rolls the ring and its
decode wraps it) and mamba2-780m (2 layers, 8 heads, one B/C group).
Inputs come from numpy seeds; everything is float32 but the KV rings and
the RG-LRU's conv tail, which are bfloat16 in both packages.

Where the reference is not the target:

* the RG-LRU's decode cache holds the **pre-conv** tail (the reference's
  holds the conv output, ROADMAP Queue C): the port's is held against the
  reference's raw ``_branch_in`` tail of the whole sequence, its decode is
  run from one given cache in both packages, and recurrentgemma's served
  tokens are held against the reference's no-cache ``forward`` on the
  mesh, never its decode;
* chunks shorter than the conv's 3-row halo: the reference's ``ppermute``
  of ``rec[:, -3:]`` is as short as the chunk, and it raises or misaligns
  (``test_short_chunks_where_the_reference_fails``);
* the SSD's B/C group of a local head: the reference reads it from the
  local head count (``test_ssd_groups_where_the_reference_maps_local_heads``).

Tolerances, stated before the first run:

* each rank's block outputs and states (RG-LRU ``h``, the SSD's ``ssd``
  state and conv rings, the attention's K/V) within 2e-5 absolute plus
  2e-5 relative, those of ``tests/test_torch_recurrent.py`` (the doubling
  scan and ``lax.associative_scan``, and the chunk composition, round in
  other orders); every gradient leaf (parameters and input) within 1e-4
  of its largest magnitude;
* against a bfloat16 ring or tail (the KV rings, ``local_decode``'s
  outputs, the RG-LRU's ``conv``): one bfloat16 step, 1/128 relative and
  absolute;
* the step: as in ``tests/test_torch_mesh_train.py`` (loss 1e-5 relative,
  synced gradient leaves 1e-4 of their largest, parameters and master
  1e-6 absolute, m and v 1e-4 of their largest);
* served tokens, ``finished`` flags and counts: exactly equal to one
  rank's; mamba2's exactly equal to the reference's ``BatchScheduler`` on
  the mesh; recurrentgemma's equal to the argmax of the reference's
  no-cache ``forward`` on the mesh wherever its top-2 margin exceeds 0.01
  (``test_torch_recurrent.MARGIN``, float32: the decode reads bfloat16
  rings), at half the positions or more; prefill caches within 2e-5
  (float32 leaves) or one bfloat16 step.
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
from test_torch_moe_multirank import (
    _clone,
    _map_plan,
    _np,
    assert_close,
    assert_state_close,
    carried_state,
    flat,
    rank_block,
    sum_blocks,
    unflat,
)
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import LocalMesh, make_local_mesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import attention, backbone, rglru, ssm
from repro_torch.models.layers import MeshCtx
from repro_torch.models.spec import dim_blocks, params_from_numpy, tree_map
from repro_torch.optim import OptConfig, sync_gradient
from repro_torch.serve.engine import cache_spec
from repro_torch.serve.scheduler import BatchScheduler, Request
from repro_torch.train import make_train_step
from repro_torch.train.layout import from_one_rank, to_one_rank

ROOT = Path(__file__).resolve().parents[1]
RG, MB = "recurrentgemma-2b", "mamba2-780m"
MESHES = {"12": (1, 2), "21": (2, 1), "22": (2, 2), "14": (1, 4)}
B, T, STEPS = 4, 32, 3
F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=1 / 128, rtol=1 / 128)
WINDOW16 = {"window": 16}
SPECS = {"rglru": rglru.rglru_spec, "attn": attention.gqa_spec, "ssm": ssm.ssm_spec}
SEQ, ROWS = ("data", "model", None), ("data", None, None)
TIMEOUT = 240


def cfg_of(arch, scale=None):
    return get_smoke_config(arch).scaled(**(scale or {}))


def ctx_of(d, m):
    return MeshCtx(model_size=m, data_size=d)


def sizes(d, m):
    return {"data": d, "model": m}


def f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def bf16_values(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


# ---------------------------------------------------------------------------
# tasks
# ---------------------------------------------------------------------------


def layer_task(name, arch, mesh, rng, parts, scale=None, *, seq=T, steps=STEPS, port=True,
               same_as=None):
    """A layer task: global float32 weights of ``parts``, inputs and
    cotangents (``same_as``: another task's weights and x)."""
    d, m = mesh
    cfg = cfg_of(arch, scale)
    ctx = ctx_of(d, m)
    params = same_as["params"] if same_as else {k: draw_tree(SPECS[k](cfg, ctx), rng)
                                                 for k in parts}
    x = same_as["x"] if same_as else f32(rng, B, seq, cfg.d_model)
    t = {"name": name, "arch": arch, "scale": scale, "mesh": mesh, "parts": parts,
         "params": params, "x": x, "port": port,
         "cot": {k: f32(rng, d * m, B // d, seq // m, cfg.d_model) for k in parts}}
    if steps:
        t["xsteps"] = [f32(rng, B, 1, cfg.d_model) for _ in range(steps)]
        if "rglru" in parts:
            t["h0"] = f32(rng, B, cfg.lru_width)
            t["conv0"] = bf16_values(f32(rng, B, 3, cfg.lru_width))
    return t


def layer_tasks(rng):
    tasks = {}
    for mname, mesh in MESHES.items():
        tasks[f"rg-{mname}"] = layer_task(f"rg-{mname}", RG, mesh, rng, ("rglru", "attn"),
                                          WINDOW16)
        tasks[f"mb-{mname}"] = layer_task(f"mb-{mname}", MB, mesh, rng, ("ssm",))
    # 6 heads padded to 8 on a 'model' of 4: rank 3 holds two pad heads
    tasks["rg-14pad"] = layer_task("rg-14pad", RG, (1, 4), rng, ("attn",),
                                   dict(WINDOW16, n_heads=6))
    # chunks of 1 and 2 rows, and the reference's one device on the same inputs
    for n in (4, 8):
        short = layer_task(f"short-14-{n}", RG, (1, 4), rng, ("rglru",), seq=n, steps=0)
        tasks[short["name"]] = short
        tasks[f"short-11-{n}"] = layer_task(f"short-11-{n}", RG, (1, 1), rng, ("rglru",),
                                            seq=n, steps=0, port=False, same_as=short)
    # two B/C groups over 8 heads: on (1, 2) the reference's local map departs
    grp = layer_task("grp-12", MB, (1, 2), rng, ("ssm",), {"ssm_ngroups": 2})
    tasks["grp-12"] = grp
    tasks["grp-11"] = dict(layer_task("grp-11", MB, (1, 1), rng, ("ssm",), {"ssm_ngroups": 2},
                                      port=False, same_as=grp), xsteps=grp["xsteps"])
    return tasks


# name: (arch, mesh, zero1, in the reference, rank 1's chunk all padding)
STEP_TASKS = {
    "st-rg-12": (RG, (1, 2), False, True, False),
    "st-rg-21z": (RG, (2, 1), True, True, False),
    "st-rg-22": (RG, (2, 2), False, True, False),
    "st-rg-14": (RG, (1, 4), False, False, False),
    "st-mb-12": (MB, (1, 2), False, True, False),
    "st-mb-21z": (MB, (2, 1), True, True, False),
    "st-mb-22": (MB, (2, 2), False, True, False),
    "st-mb-14": (MB, (1, 4), False, False, False),
    "st-rg-12pad": (RG, (1, 2), False, False, True),
}


def step_tasks(rng):
    one, tasks = {}, {}
    toks = rng.integers(0, 256, (B, T)).astype(np.int32)
    labels = rng.integers(0, 256, (B, T)).astype(np.int32)
    labels[:, :3] = -1
    batches = {False: {"tokens": toks, "labels": labels},
               True: {"tokens": np.where(np.arange(T) < T // 2, toks, 0).astype(np.int32),
                      "labels": np.where(np.arange(T) < T // 2, labels, -1).astype(np.int32)}}
    for name, (arch, (d, m), zero1, in_ref, pad) in STEP_TASKS.items():
        cfg = cfg_of(arch)
        if arch not in one:
            params1 = draw_tree(backbone.model_spec(cfg, MeshCtx()), rng)
            one[arch] = (params1, carried_state(params1, cfg, rng))
        params1, opt1 = one[arch]
        ocfg = OptConfig(warmup=2, total_steps=20, zero1=zero1)
        pm, om = from_one_rank(params1, opt1, cfg, ocfg, sizes(d, m))
        tasks[name] = {"name": name, "arch": arch, "scale": None, "mesh": (d, m),
                       "zero1": zero1, "params": _np(pm), "opt": _np(om),
                       "batch": batches[pad], "pad": pad, "ref": in_ref}
    return one, batches, tasks


# serving: prompts of 4 and 8 tokens (chunks of 1 and 2 rows on (1, 4), of 2
# on (1, 2)) and of 72, past the smoke window of 64: the ring rolls at the
# fill and wraps while decoding
SERVE_MAX_LEN, CACHED = 96, 8
LENS, MAX_NEW = (4, 8, 8, 72, 72, 4), (5, 3, 6, 4, 6, 5)
MARGIN, CHECKED = 0.01, 0.5


def serve_tasks(rng):
    one, tasks, want = {}, {}, {}
    reqs = {}
    for arch in (RG, MB):
        cfg = cfg_of(arch)
        reqs[arch] = [[i, [int(x) for x in rng.integers(0, cfg.vocab, n)], k]
                      for i, (n, k) in enumerate(zip(LENS, MAX_NEW))]
        one[arch] = draw_tree(backbone.model_spec(cfg, MeshCtx()), rng)
        sched = BatchScheduler(cfg, make_local_mesh(device="cpu"), batch=B,
                               max_len=SERVE_MAX_LEN, eos_id=-1)
        p1 = params_from_numpy(one[arch], "cpu")
        with torch.no_grad():
            done, st = sched.run(p1, [Request(*r) for r in reqs[arch]])
            prompts = [p for _, p, _ in reqs[arch] if len(p) == CACHED][:B]
            prompts += [prompts[0]] * (B - len(prompts))
            caches, _ = sched._engine.prefill(p1, {"tokens": torch.tensor(prompts)})
        want[arch] = ({rid: (c.tokens, c.finished) for rid, c in done.items()},
                      (st.requests, st.prefill_tokens, st.decode_steps, st.batches),
                      tree_map(lambda x: x if isinstance(x, int) else x.float().numpy(),
                               caches))
        for mname, (d, m) in MESHES.items():
            name = f"sv-{'rg' if arch == RG else 'mb'}-{mname}"
            pm, _ = from_one_rank(one[arch], None, cfg, OptConfig(), sizes(d, m))
            tasks[name] = {"name": name, "arch": arch, "scale": None, "mesh": (d, m),
                           "batch": B, "max_len": SERVE_MAX_LEN, "eos_id": -1,
                           "requests": reqs[arch], "prefill": CACHED, "params": _np(pm)}
    return tasks, want


def forward_rows(reqs, completions):
    """recurrentgemma's checked sequences, prompt + served tokens but the
    last, one row a request (padded with a copy to an even count), padded
    at the end (causal) to a length that 4 divides; and where each row's
    served tokens sit."""
    seqs = [p + completions[rid][0][:-1] for rid, p, _ in reqs]
    n = -(-max(map(len, seqs)) // 4) * 4
    rows = np.zeros((len(seqs) + len(seqs) % 2, n), np.int32)
    for i, s in enumerate(seqs):
        rows[i, :len(s)] = s
    rows[len(seqs):] = rows[0]
    return rows, [(len(p) - 1, k) for _, p, k in reqs]


# ---------------------------------------------------------------------------
# the runs
# ---------------------------------------------------------------------------


def reference_job(layers, steps, serves, forwards, path):
    job, arrays = [], {}
    for t in layers:
        job.append({"kind": "recurrent_layers", "name": t["name"], "arch": t["arch"],
                    "scale": t["scale"] or {}, "mesh": t["mesh"], "parts": list(t["parts"]),
                    "n_steps": len(t.get("xsteps", ()))})
        flat(t["params"], f"{t['name']}/params", arrays)
        flat(t["cot"], f"{t['name']}/cot", arrays)
        arrays[f"{t['name']}/x"] = t["x"]
        for i, xs in enumerate(t.get("xsteps", ())):
            arrays[f"{t['name']}/xstep{i}"] = xs
        for k in ("h0", "conv0"):
            if k in t:
                arrays[f"{t['name']}/{k}"] = t[k]
    for t in steps:
        job.append({"kind": "step", "name": t["name"], "arch": t["arch"], "mesh": t["mesh"],
                    "scale": {}, "zero1": t["zero1"]})
        flat(t["params"], f"{t['name']}/params", arrays)
        flat(t["opt"], f"{t['name']}/opt", arrays)
        flat(t["batch"], f"{t['name']}/batch", arrays)
    for t in serves:
        job.append({k: t[k] for k in ("name", "mesh", "batch", "max_len", "eos_id",
                                      "requests", "prefill")}
                   | {"kind": "serve", "arch": t["arch"], "scale": {}})
        flat(t["params"], f"{t['name']}/params", arrays)
    for t in forwards:
        job.append({"kind": "forward", "name": t["name"], "arch": t["arch"], "scale": {},
                    "mesh": t["mesh"]})
        flat(t["params"], f"{t['name']}/params", arrays)
        arrays[f"{t['name']}/tokens"] = t["tokens"]
    np.savez(path, job=json.dumps(job), **arrays)


def ranks_body(dev, layers, steps, serves):
    """Layers, then steps, then serving, in one group of ranks."""
    return {"layers": _torch_ranks.recurrent_layers(dev, layers),
            "steps": _torch_ranks.train_steps(dev, steps),
            "serve": _torch_ranks.serve(dev, serves)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("recurrent_multirank")
    rng = np.random.default_rng(28)
    layers = layer_tasks(rng)
    one, batches, steps = step_tasks(rng)
    serves, serve_want = serve_tasks(rng)
    rows, spans = forward_rows(serves["sv-rg-12"]["requests"], serve_want[RG][0])
    forwards = [{"name": f"fw-{n[3:]}", "arch": RG, "mesh": t["mesh"], "params": t["params"],
                 "tokens": rows} for n, t in serves.items() if t["arch"] == RG]
    # three reference subprocesses, the work split about evenly
    ref_l = list(layers.values())
    ref_s = [t for t in steps.values() if t["ref"]]
    ref_v = [t for t in serves.values() if t["arch"] == MB]
    parts = [(ref_l[i::3], ref_s[i::3], ref_v[i::3], forwards[i::3]) for i in range(3)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    refs = []
    for i, (lt, st, sv, fw) in enumerate(parts):
        reference_job(lt, st, sv, fw, tmp / f"in{i}.npz")
        refs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_jax_mesh_ref.py"), str(tmp / f"in{i}.npz"),
             str(tmp / f"out{i}.npz"), "4"], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))

    def port_tasks(world):
        lt = [t for t in layers.values() if t["port"] and np.prod(t["mesh"]) == world]
        st = [t for t in steps.values() if np.prod(t["mesh"]) == world]
        sv = [t for t in serves.values() if np.prod(t["mesh"]) == world]
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
    for i in range(3):
        ref.update(np.load(tmp / f"out{i}.npz"))
    return {"ref": ref, "port": port, "layers": layers, "steps": steps, "one": one,
            "batches": batches, "serves": serves, "serve_want": serve_want,
            "forward_rows": rows, "forward_spans": spans}


def per_rank(runs, group, name):
    t = {"layers": runs["layers"], "steps": runs["steps"], "serve": runs["serves"]}[group][name]
    world = int(np.prod(t["mesh"]))
    return [r[group][name] for r in runs["port"][world]], t


def close(got, want, tol, label):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    np.testing.assert_allclose(got, want, **tol, err_msg=label)


# where each state leaf of a block lies on a mesh: (rows, ...) axes
STATE_AXES = {"rglru": {"h": ("data", None), "conv": ROWS},
              "attn": {"k": ("data", None, None, None), "v": ("data", None, None, None)},
              "ssm": {"ssd": ("data", "model", None, None),
                      "conv": {"x": ("data", None, "model"), "bc": ROWS}}}
BF16_STATE = {("rglru", "conv"), ("attn", "k"), ("attn", "v")}


def state_leaves(key, st, prefix=""):
    """(path, leaf, axes, tolerance) of a block's state dict."""
    axes = STATE_AXES[key]
    for k, v in st.items():
        if k == "len":
            continue
        if isinstance(v, dict):
            for kk, vv in v.items():
                yield f"{k}/{kk}", vv, axes[k][kk], F32
        else:
            yield k, v, axes[k], BF16 if (key, k) in BF16_STATE else F32


# ---------------------------------------------------------------------------
# the layers against the reference, rank by rank
# ---------------------------------------------------------------------------

RG_LAYERS = [f"rg-{m}" for m in MESHES]
MB_LAYERS = [f"mb-{m}" for m in MESHES]
LAYER_CASES = [(n, "rglru") for n in RG_LAYERS] + [(n, "attn") for n in RG_LAYERS] + [
    (n, "ssm") for n in MB_LAYERS] + [("rg-14pad", "attn")]


@pytest.mark.parametrize("name,key", LAYER_CASES)
def test_apply_per_rank_matches_reference(runs, name, key):
    """Each rank's output chunk, its state and its gradients (parameter
    leaves and input chunk) against the reference's ``shard_map`` body;
    the RG-LRU's conv tail against the reference's raw pre-conv tail (the
    reference's own state holds the conv output)."""
    per, t = per_rank(runs, "layers", name)
    ref = runs["ref"]
    d, m = t["mesh"]
    for r, res in enumerate(per):
        got = res[key]
        close(got["y"], ref[f"{name}/{key}/y"][r], F32, f"{name} {key} y {r}")
        for path, leaf, axes, tol in state_leaves(key, got["state"]):
            want = ref[f"{name}/{key}/state/{path}"][r]
            if (key, path) == ("rglru", "conv"):
                want = rank_block(bf16_values(ref[f"{name}/raw_tail"]), (d, m), r, axes)
            close(leaf, want, tol, f"{name} {key} {path} {r}")
        assert_close(got["dx"], ref[f"{name}/{key}/dx"][r], 1e-4, f"{name} {key} dx {r}")
        for path, g in got["dp"].items():
            assert_close(g, ref[f"{name}/{key}/dp{path}"][r], 1e-4, f"{name} {key} d{path} {r}")


@pytest.mark.parametrize("name,key", LAYER_CASES)
def test_decode_per_rank_matches_reference(runs, name, key):
    """The decode chains: ``rglru_decode`` from one given cache,
    ``local_fill_cache`` + ``local_decode`` (the ring rolled at the fill and
    wrapped by the steps: 32 prompt positions and 3 steps in 16 slots),
    ``ssm_apply`` + ``ssm_decode``: each step's output and the last cache,
    each rank's against the reference's."""
    per, t = per_rank(runs, "layers", name)
    ref = runs["ref"]
    tol = BF16 if key == "attn" else F32
    for r, res in enumerate(per):
        got = res[f"{key}_decode"]
        assert got["state"]["len"] == (STEPS if key == "rglru" else T + STEPS)
        for i, y in enumerate(got["y"]):
            close(y, ref[f"{name}/{key}_decode/y{i}"][r], tol, f"{name} step {i} rank {r}")
        for path, leaf, _, ltol in state_leaves(key, got["state"]):
            close(leaf, ref[f"{name}/{key}_decode/state/{path}"][r], ltol,
                  f"{name} {path} rank {r}")


# ---------------------------------------------------------------------------
# the layers against the port's one rank
# ---------------------------------------------------------------------------


def seq_cat(cot, d, m):
    """(world, B/d, T/m, …) per-rank chunks -> (B, T, …)."""
    c = cot.reshape((d, m) + cot.shape[1:])
    return np.concatenate([np.concatenate(list(c[i]), 1) for i in range(d)], 0)


def one_rank_layers(t):
    """The port's one-rank blocks on the task's global inputs: outputs,
    states and gradients of the objective every rank's sums to, and the
    decode chains."""
    d, m = t["mesh"]
    cfg = cfg_of(t["arch"], t["scale"])
    ctx = MeshCtx()
    out = {}
    for key in t["parts"]:
        p = params_from_numpy(t["params"][key], "cpu")
        leaves = [(k, v.requires_grad_(True)) for k, v in _torch_ranks._leaves(p)]
        x = torch.from_numpy(t["x"]).requires_grad_(True)
        y, st = _torch_ranks._recurrent_apply(key, p, x, ctx, cfg)
        wrt = [v for _, v in leaves] + [x]
        gs = torch.autograd.grad(y, wrt, grad_outputs=torch.from_numpy(
            seq_cat(t["cot"][key], d, m)))
        out[key] = {"y": y.detach().numpy(), "state": _torch_ranks._state_np(st),
                    "dp": {k: g.numpy() for (k, _), g in zip(leaves, gs)}, "dx": gs[-1].numpy()}
        if t.get("xsteps"):
            cache0 = ({"h": torch.from_numpy(t["h0"]),
                       "conv": torch.from_numpy(t["conv0"]).to(torch.bfloat16)}
                      if key == "rglru" else None)
            p = params_from_numpy(t["params"][key], "cpu")
            with torch.no_grad():
                ys, cache = _torch_ranks._recurrent_chain(
                    key, p, torch.from_numpy(t["x"]), [torch.from_numpy(s) for s in t["xsteps"]],
                    ctx, cfg, cache0)
            out[f"{key}_decode"] = {"y": ys, "state": _torch_ranks._state_np(cache)}
    return out


ONE_RANK_CASES = [(n, k) for n, k in LAYER_CASES if n != "rg-14pad"] + [("grp-12", "ssm")]


@pytest.mark.parametrize("name,key", ONE_RANK_CASES)
def test_layers_match_one_rank(runs, name, key):
    """Every rank's output and state are its blocks of the one-rank ones;
    the gradients summed over ranks into the global shapes are the
    one-rank gradients; each decode step's output and the last cache are
    the one-rank chain's blocks."""
    per, t = per_rank(runs, "layers", name)
    one = one_rank_layers(t)
    mesh = t["mesh"]
    spec = SPECS[key](cfg_of(t["arch"], t["scale"]), ctx_of(*mesh))
    tol = BF16 if key == "attn" else F32
    for r, res in enumerate(per):
        got, want = res[key], one[key]
        close(got["y"], rank_block(want["y"], mesh, r, SEQ), F32, f"{name} y {r}")
        assert_close(got["dx"], rank_block(want["dx"], mesh, r, SEQ), 1e-4, f"{name} dx {r}")
        for (path, leaf, axes, ltol), (_, w, _, _) in zip(state_leaves(key, got["state"]),
                                                          state_leaves(key, want["state"])):
            close(leaf, rank_block(w, mesh, r, axes), ltol, f"{name} {path} {r}")
        dec, wdec = res[f"{key}_decode"], one[f"{key}_decode"]
        for i, y in enumerate(dec["y"]):
            close(y, rank_block(wdec["y"][i], mesh, r, ROWS), tol, f"{name} step {i} {r}")
        for (path, leaf, axes, ltol), (_, w, _, _) in zip(state_leaves(key, dec["state"]),
                                                          state_leaves(key, wdec["state"])):
            close(leaf, rank_block(w, mesh, r, axes), ltol, f"{name} decode {path} {r}")
    for leaf, p in spec.items():
        g = sum_blocks([res[key]["dp"][f"/{leaf}"] for res in per], p.shape, p.axes, mesh)
        assert_close(g, one[key]["dp"][f"/{leaf}"], 1e-4, f"{name} d{leaf}")


@pytest.mark.parametrize("name", RG_LAYERS)
def test_rglru_collectives(runs, name):
    """The RG-LRU's apply takes two all-gathers over 'model' (the tails and
    the summaries) and their two reduce-scatters in the backward, on every
    rank; its decode takes none.  The windowed attention's decode takes
    one all-reduce a step (the ``wo`` psum)."""
    per, t = per_rank(runs, "layers", name)
    m = t["mesh"][1]
    for res in per:
        want = {"all_gather": 2, "reduce_scatter": 2} if m > 1 else {}
        assert res["rglru"]["ledger"] == want, res["rglru"]["ledger"]
        assert res["rglru_decode"]["ledger"] == {}
        # the prefill's sequence gather and output reduce-scatter, then a step's psum
        assert res["attn_decode"]["ledger"] == ({"all_gather": 1, "reduce_scatter": 1,
                                                 "all_reduce": STEPS} if m > 1 else {})


@pytest.mark.parametrize("name", MB_LAYERS)
def test_ssd_collectives(runs, name):
    """The SSD's apply: the sequence's all-gather, the norm's psum and the
    output's reduce-scatter, transposed in the backward (a psum's transpose
    is a psum); its decode two all-reduces a step (the norm, the output)."""
    per, t = per_rank(runs, "layers", name)
    m = t["mesh"][1]
    for res in per:
        want = ({"all_gather": 2, "reduce_scatter": 2, "all_reduce": 2} if m > 1 else {})
        assert res["ssm"]["ledger"] == want, res["ssm"]["ledger"]
        assert res["ssm_decode"]["ledger"] == ({"all_gather": 1, "reduce_scatter": 1,
                                                "all_reduce": 1 + 2 * STEPS} if m > 1 else {})


def test_padded_heads_stay_inert(runs):
    """recurrentgemma's heads padded to the 'model' size (6 to 8 on (1, 4)):
    rank 3 holds heads 6 and 7, both pads — their ``wq`` columns and
    ``wo`` rows get zero gradients, and its decode contributes zero to the
    psum (the outputs equal the reference's on every rank)."""
    per, _ = per_rank(runs, "layers", "rg-14pad")
    dp = per[3]["attn"]["dp"]
    assert not np.any(dp["/wq"]) and not np.any(dp["/wo"])
    assert np.any(per[2]["attn"]["dp"]["/wq"])
    assert all(np.array_equal(per[0]["attn_decode"]["y"][i], res["attn_decode"]["y"][i])
               for res in per[1:] for i in range(STEPS))


# ---------------------------------------------------------------------------
# the reference's faults above one rank
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [4, 8])
def test_short_chunks_where_the_reference_fails(runs, n):
    """The RG-LRU on (1, 4) over T = 4 and 8: chunks of 1 and 2 rows,
    shorter than the conv's 3-row halo.  The reference ``ppermute``s
    ``rec[:, -3:]`` of the chunk, as short as the chunk: at 1 row it
    raises, at 2 its taps meet a 2-row halo and its output departs from its
    own one device (``src/repro/models/rglru.py:82-84``).  The port's
    gathered tails give each rank its 3 rows: every rank equals the port's
    one rank and the reference's one device."""
    ref = runs["ref"]
    name = f"short-14-{n}"
    one11 = ref[f"short-11-{n}/rglru/y"][0]
    if f"{name}/rglru/error" not in ref:       # it ran: its output departs
        y14 = np.concatenate(list(ref[f"{name}/rglru/y"]), 1)
        assert y14.shape != one11.shape or np.abs(y14 - one11).max() > 1e-3
    per, t = per_rank(runs, "layers", name)
    one = one_rank_layers(t)
    close(one["rglru"]["y"], one11, F32, "one rank, one device")
    for r, res in enumerate(per):
        close(res["rglru"]["y"], rank_block(one["rglru"]["y"], (1, 4), r, SEQ), F32, f"{r}")
        close(res["rglru"]["state"]["h"], one["rglru"]["state"]["h"], F32, f"h {r}")
        close(res["rglru"]["state"]["conv"], one["rglru"]["state"]["conv"], BF16, f"conv {r}")
    dx = np.concatenate([res["rglru"]["dx"] for res in per], 1)
    assert_close(dx, one["rglru"]["dx"], 1e-4, "dx")


def test_ssd_groups_where_the_reference_maps_local_heads(runs):
    """mamba2 at two B/C groups over 8 heads on (1, 2).  The reference's
    ``_ssd_chunked`` and ``ssm_decode`` take the group map from the local
    head count (``src/repro/models/ssm.py:71,85-86,201-205``): rank 0's
    heads 0-3 read groups 0, 0, 1, 1 where one device reads 0, 0, 0, 0,
    so its mesh departs from its own one device.  The port reads each
    head's global group: its mesh equals its one rank and the reference's
    one device, apply and decode."""
    ref = runs["ref"]
    y12 = np.concatenate(list(ref["grp-12/ssm/y"]), 1)
    y11 = ref["grp-11/ssm/y"][0]
    assert np.abs(y12 - y11).max() > 0.1 * np.abs(y11).max()
    per, t = per_rank(runs, "layers", "grp-12")
    one = one_rank_layers(t)
    close(one["ssm"]["y"], y11, F32, "one rank, one device")
    for i in range(STEPS):
        close(one["ssm_decode"]["y"][i], ref[f"grp-11/ssm_decode/y{i}"][0], F32, f"step {i}")
    for r, res in enumerate(per):
        close(res["ssm"]["y"], rank_block(y11, (1, 2), r, SEQ), F32, f"rank {r}")
        for i in range(STEPS):
            close(res["ssm_decode"]["y"][i], ref[f"grp-11/ssm_decode/y{i}"][0], F32,
                  f"rank {r} step {i}")


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------

REF_STEPS = [n for n, t in STEP_TASKS.items() if t[3]]


def _one_rank(name, params, opt):
    arch, (d, m), zero1, _, _ = STEP_TASKS[name]
    ocfg = OptConfig(warmup=2, total_steps=20, zero1=zero1)
    return to_one_rank(params, opt, cfg_of(arch), ocfg, sizes(d, m))


@pytest.mark.parametrize("name", REF_STEPS)
def test_step_matches_reference(runs, name):
    """Loss, the synced gradients, metrics, and the parameters and state
    after one step, against the reference's step on the same mesh."""
    got = per_rank(runs, "steps", name)[0][0]
    ref = runs["ref"]
    want = float(ref[f"{name}/loss"])
    assert abs(got["loss"] - want) <= 1e-5 * abs(want), (got["loss"], want)
    fg = flat(got["grads"], "", {})
    want_g = flat(unflat(ref, f"{name}/grads"), "", {})
    assert sorted(fg) == sorted(want_g)
    for path, w in want_g.items():
        assert_close(fg[path], w, 1e-4, f"{name} {path}")
    for k in ("grad_norm", "loss"):
        w = float(ref[f"{name}/metrics/{k}"])
        assert abs(got["metrics"][k] - w) <= 1e-5 * abs(w), (k, got["metrics"][k], w)
    ref_o = unflat(ref, f"{name}/after/opt")
    assert_state_close(_one_rank(name, got["params"], got["opt"]),
                       _one_rank(name, unflat(ref, f"{name}/after/params"), ref_o), name)


@pytest.fixture(scope="module")
def one_rank_steps(runs):
    out = {}
    for arch, (params1, opt1) in runs["one"].items():
        for pad, batch in runs["batches"].items():
            bundle = make_train_step(cfg_of(arch), make_local_mesh(device="cpu"),
                                     OptConfig(warmup=2, total_steps=20), batch=B)
            p = params_from_numpy(params1, "cpu")
            opt = {"step": opt1["step"].clone(), "leaves": _clone(opt1["leaves"])}
            grads, ce, aux = bundle.grads(p, batch)
            synced = _map_plan(lambda g, pl: sync_gradient(g, pl), grads, bundle.plan)
            p, opt, met = bundle.update(p, opt, grads, ce, aux)
            out[arch, pad] = {"grads": synced, "params": p, "opt": opt,
                              "metrics": {k: float(v) for k, v in met.items()}}
    return out


@pytest.mark.parametrize("name", list(STEP_TASKS))
def test_step_matches_one_rank_step(runs, one_rank_steps, name):
    """Every mesh's step against the port's one-rank step from the same
    state, in the one-rank layout; ``st-rg-12pad``'s rank 1 holds a chunk of
    padding only (token 0, label -1): it still takes part in every
    collective of the backward, and the step ends and equals one rank's."""
    got = per_rank(runs, "steps", name)[0][0]
    arch, (d, m), _, _, pad = STEP_TASKS[name]
    one = one_rank_steps[arch, pad]
    for k in ("loss", "grad_norm"):
        assert abs(got["metrics"][k] - one["metrics"][k]) <= 1e-5 * abs(one["metrics"][k]), k
    g1, _ = to_one_rank(got["grads"], None, cfg_of(arch), OptConfig(), sizes(d, m))
    fg = flat(g1, "", {})
    for path, w in flat(one["grads"], "", {}).items():
        assert_close(fg[path], w, 1e-4, f"{name} {path}")
    assert_state_close(_one_rank(name, got["params"], got["opt"]),
                       (one["params"], one["opt"]), name)


def test_padding_chunk_step_runs_every_collective(runs):
    """On ``st-rg-12pad`` both ranks ran the same collectives, the RG-LRU's
    gathers and their transposes among them."""
    ledgers = [r["steps"]["st-rg-12pad"]["ledger"] for r in runs["port"][2]]
    assert ledgers[0].keys() == ledgers[1].keys()
    assert all(ledgers[0][k]["calls"] == ledgers[1][k]["calls"] for k in ledgers[0])
    # 4 RG-LRU layers: 2 gathers each in the forward, the remat recompute, and
    # 2 reduce-scatters in the backward, beside the other blocks' own
    assert ledgers[0]["reduce_scatter"]["calls"] >= 8


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

SERVES = [f"sv-{a}-{m}" for a in ("rg", "mb") for m in MESHES]


def ref_completions(runs, name):
    ref, t = runs["ref"], runs["serves"][name]
    return ({rid: (ref[f"{name}/tokens/{rid}"].tolist(), bool(ref[f"{name}/finished/{rid}"]))
             for rid, _, _ in t["requests"]},
            tuple(int(x) for x in ref[f"{name}/stats"]))


def forward_logits(x, tok, cfg):
    """The reference forward's float32 logits (its ``greedy_token``'s) from
    its final-norm states and the tied embedding."""
    logits = x @ tok[:cfg.vocab].T
    return cfg.logit_softcap * np.tanh(logits / cfg.logit_softcap)


@pytest.mark.parametrize("name", SERVES)
def test_every_rank_serves_one_rank_tokens(runs, name):
    """Every rank's completions and counts equal one rank's; mamba2's equal
    the reference's ``BatchScheduler`` on the mesh; recurrentgemma's equal
    the argmax of the reference's no-cache ``forward`` on the mesh where
    its margin exceeds ``MARGIN``, at half the positions or more."""
    per, t = per_rank(runs, "serve", name)
    want = runs["serve_want"][t["arch"]][:2]
    for r, res in enumerate(per):
        assert (res["completions"], res["stats"]) == want, (name, r)
    if t["arch"] == MB:
        assert ref_completions(runs, name) == want
        return
    cfg = cfg_of(RG)
    x = runs["ref"][f"fw-{name[3:]}/x"]
    logits = forward_logits(x, t["params"]["embed"]["tok"], cfg)
    got, lg = [], []
    for i, ((rid, _, _), (start, k)) in enumerate(zip(t["requests"], runs["forward_spans"])):
        got += per[0]["completions"][rid][0]
        lg.append(logits[i, start:start + k])
    lg = np.concatenate(lg)
    top2 = np.sort(lg, -1)[:, -2:]
    ok = top2[:, 1] - top2[:, 0] > MARGIN
    assert ok.mean() >= CHECKED, ok.mean()
    np.testing.assert_array_equal(np.asarray(got)[ok], lg.argmax(-1)[ok])


@pytest.mark.parametrize("name", SERVES)
def test_prefill_caches_are_one_rank_blocks(runs, name):
    """Each rank's caches after the 8-token bucket's prefill are its blocks
    of the one-rank caches by ``cache_spec`` (the RG-LRU state and conv tail
    and the rings replicated over 'model', the SSD's state and ``x`` ring
    split by heads); mamba2's are also the reference's blocks."""
    per, t = per_rank(runs, "serve", name)
    d, m = t["mesh"]
    cfg = cfg_of(t["arch"])
    spec = cache_spec(cfg, LocalMesh(("data", "model"), sizes(d, m), torch.device("cpu")), B,
                      SERVE_MAX_LEN)
    one = runs["serve_want"][t["arch"]][2]
    ref = runs["ref"]
    for r, res in enumerate(per):
        at = {"data": r // m, "model": r % m}
        for path, p in flat_specs(spec):
            got = walk(res["caches"], path)
            tol = BF16 if p.dtype == torch.bfloat16 else F32
            if path[-1] == "len":
                assert got == walk(one, path) == CACHED
                continue
            blk = dim_blocks(p.shape, p.axes, sizes(d, m), at)
            close(got, walk(one, path)[blk], tol, f"{name} {path} {r}")
            if t["arch"] == MB:
                close(got, ref[f"{name}/caches/{'/'.join(path)}"][blk], tol, f"{name} {path}")
        np.testing.assert_array_equal(res["decode_token"], per[0]["decode_token"])
    if t["arch"] == MB:
        np.testing.assert_array_equal(per[0]["prefill_token"], ref[f"{name}/prefill_token"])


def flat_specs(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat_specs(v, path + (k,))
        else:
            yield path + (k,), v


def walk(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("name", SERVES)
def test_decode_step_collectives(runs, name):
    """One decode step's collectives, a rank.  Over 'model': an RG-LRU block
    none of its own, a local attention block one all-reduce (``wo``), an
    SSD block two (the norm, the output), the MLP's psum, the embedding's
    psum and the argmax's all-gather.  The token's all-gather over
    'data'."""
    per, t = per_rank(runs, "serve", name)
    d, m = t["mesh"]
    cfg = cfg_of(t["arch"])
    if t["arch"] == RG:
        n_attn = sum(k == "attn" for k in cfg.pattern) * (cfg.n_layers // len(cfg.pattern))
        n_rec = cfg.n_layers - n_attn
        reduces = n_rec + 2 * n_attn + 1
    else:
        reduces = 2 * cfg.n_layers + 1
    want = {"all_gather": 1, "all_reduce": reduces} if m > 1 else {}
    if d > 1:
        want["all_gather"] = want.get("all_gather", 0) + 1
    for r, res in enumerate(per):
        assert res["decode_ledger"] == want, (name, r, res["decode_ledger"])
