"""The encoder-decoder family and the patch frontend across ranks — the
encoder over each rank's chunk of the frames with its memory gathered
whole (``backbone.encode``), cross attention over that memory
(``gqa_apply(memory=)``), the sequence-sharded cross cache
(``cross_fill_cache``) and its LSE-combined decode (``cross_decode``), the
no-cache ``forward`` with frames or patch rows, the whisper-tiny and
pixtral-12b training steps and ``BatchScheduler.run(extras=)`` — the port's
ranks as gloo processes on the CPU (``repro_torch.launch.ranks.run_ranks``,
one group of 2 and one of 4 ranks for the module, ``tests/_torch_ranks.py``)
against the reference's ``shard_map`` bodies on fake CPU devices
(``tests/_jax_mesh_ref.py``, three subprocesses beside the ranks), and
against the port's own one-rank result.

Meshes: (1, 2), (2, 1), (2, 2) and (1, 4).  Configs: the smoke configs of
whisper-tiny (2 encoder and 2 decoder layers, 2 heads, so (1, 4) pads its
heads to 4) and pixtral-12b (2 layers; 8 patch positions lead its 12- and
20-token prompts, so the patches straddle a chunk boundary on (1, 2) and on
(1, 4); its training batch holds 20 patch positions of 32).  The weights
are drawn once an architecture at the one-rank shapes and carried to each
mesh's layout (``train.layout.from_one_rank``: pad heads zero).  Inputs
come from numpy seeds; everything is float32 but the self and cross
caches, which are bfloat16 in both packages.

Tolerances, stated before the first run:

* outputs (the gathered memory, cross attention, ``forward``'s states):
  2e-5 absolute plus 2e-5 relative;
* gradient leaves (and the gradients of the frames, the stream and the
  memory): within 1e-4 of their largest magnitude;
* against a bfloat16 cache (the cross cache's chunks, ``cross_decode``'s
  outputs, which read one and LSE-combine to bfloat16, and the prefill's
  self and cross caches): one bfloat16 step, 1/128 relative and absolute;
* the step: as in ``tests/test_torch_mesh_train.py`` (loss and
  ``grad_norm`` 1e-5 relative, synced gradient leaves 1e-4 of their
  largest, parameters and master 1e-6 absolute, m and v 1e-4 of their
  largest);
* served ``finished`` flags and counts: exactly equal to one rank's, and
  to the reference's ``BatchScheduler`` on the mesh, pixtral's text-only
  run included (the reference's prefill requires a ``"frontend"``: it
  gets zero rows, which no text position reads); served tokens as below.

Served tokens can part at near ties of the port's one-rank no-cache
forward: pixtral's text-only request 5 at its fifth token has its top two
logits 5.6e-4 apart (0.6071 and 0.6066) — the reference's (2, 1) picks the
second, its (1, 2) the first, and the port's one rank either from one run
to the next — and request 1 parts at its third token on the port's
(1, 4).  Every path decodes over bfloat16 self caches and combines to
bfloat16: a float32 difference in summation order can round an entry to
the neighbouring bfloat16 value, and the packages round in other places,
so a tie that close falls either way.  The flags and counts are held
exactly; the tokens equal up to the first position where they part,
which must be a near tie of the port's one-rank no-cache forward, a top-2
margin of at most 1/128 against one rank (``chip_smoke.py``'s
``MR_SERVE_F32_MARGIN``, for the same summation-order rounding) and at most
1/32 against the reference (``tests/test_torch_frontends.py``'s float32
margin: the packages' logits part by up to 0.0062 there), with half the
positions or more compared.
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
from repro_torch.models import attention, backbone
from repro_torch.models.layers import MeshCtx
from repro_torch.models.spec import dim_blocks, params_from_numpy, tree_map
from repro_torch.optim import OptConfig, sync_gradient
from repro_torch.serve.engine import cache_spec, make_serve_fns
from repro_torch.serve.scheduler import BatchScheduler, Request
from repro_torch.train import make_train_step
from repro_torch.train.layout import from_one_rank, to_one_rank

ROOT = Path(__file__).resolve().parents[1]
WH, PX = "whisper-tiny", "pixtral-12b"
MESHES = {"12": (1, 2), "21": (2, 1), "22": (2, 2), "14": (1, 4)}
B, T, TE, STEPS = 4, 16, 16, 3
PX_T = 12                  # pixtral's forward: 8 patches, then 4 text positions
F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=1 / 128, rtol=1 / 128)
SEQ, ROWS = ("data", "model", None), ("data", None, None)
CACHE_AXES = ("data", None, "model", None)
TIMEOUT = 240


def cfg_of(arch):
    return get_smoke_config(arch)


def ctx_of(d, m):
    return MeshCtx(model_size=m, data_size=d)


def sizes(d, m):
    return {"data": d, "model": m}


def f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def bf16_values(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def on_mesh(params1, arch, mesh):
    """One-rank parameters in the global layout of ``mesh`` (numpy)."""
    pm, _ = from_one_rank(params1, None, cfg_of(arch), OptConfig(), sizes(*mesh))
    return _np(pm)


def layer0(tree):
    """Layer 0's tree of a stacked group."""
    return {k: layer0(v) if isinstance(v, dict) else v[0] for k, v in tree.items()}


def image_prompt(rng, cfg, n):
    """``n`` tokens led by ``n_frontend_tokens`` patch positions (-1)."""
    toks = [int(x) for x in rng.integers(0, cfg.vocab, n)]
    toks[:cfg.n_frontend_tokens] = [-1] * cfg.n_frontend_tokens
    return toks


# ---------------------------------------------------------------------------
# tasks
# ---------------------------------------------------------------------------


def model_weights(rng):
    return {a: draw_tree(backbone.model_spec(cfg_of(a), MeshCtx()), rng) for a in (WH, PX)}


def layer_tasks(rng, weights):
    """Per mesh: whisper's encode, cross attention, cross cache and decode,
    and forward over frames; pixtral's forward over patch rows."""
    wh, px = cfg_of(WH), cfg_of(PX)
    shared = {
        "frames": f32(rng, B, TE, wh.d_model), "x": f32(rng, B, T, wh.d_model),
        "memory": f32(rng, B, TE, wh.d_model),
        "cache_k": bf16_values(f32(rng, B, wh.n_kv_heads, TE, wh.resolved_head_dim)),
        "cache_v": bf16_values(f32(rng, B, wh.n_kv_heads, TE, wh.resolved_head_dim)),
        "xsteps": [f32(rng, B, 1, wh.d_model) for _ in range(STEPS)],
        "tokens": rng.integers(0, wh.vocab, (B, T)).astype(np.int32)}
    px_toks = np.stack([image_prompt(rng, px, PX_T) for _ in range(B)]).astype(np.int32)
    px_front = (0.02 * f32(rng, B, PX_T, px.d_model)).astype(np.float32)
    tasks = {}
    for mname, (d, m) in MESHES.items():
        pm = on_mesh(weights[WH], WH, (d, m))
        w = d * m
        tasks[f"wh-{mname}"] = dict(
            shared, name=f"wh-{mname}", arch=WH, mesh=(d, m),
            parts=("encode", "cross", "forward"),
            params={"enc": pm["enc"], "cross": layer0(pm["g0"]["cross"]), "model": pm},
            cot={"encode": f32(rng, w, B // d, TE, wh.d_model),
                 "cross": f32(rng, w, B // d, T // m, wh.d_model)})
        tasks[f"px-{mname}"] = dict(
            name=f"px-{mname}", arch=PX, mesh=(d, m), parts=("forward",),
            params={"model": on_mesh(weights[PX], PX, (d, m))}, tokens=px_toks,
            frontend=px_front)
    return tasks


# name: (arch, mesh, zero1, in the reference)
STEP_TASKS = {
    "st-wh-12": (WH, (1, 2), False, True),
    "st-wh-21z": (WH, (2, 1), True, True),
    "st-wh-22": (WH, (2, 2), False, True),
    "st-wh-14": (WH, (1, 4), False, False),
    "st-px-12": (PX, (1, 2), False, True),
    "st-px-21z": (PX, (2, 1), True, True),
    "st-px-22": (PX, (2, 2), False, True),
    "st-px-14": (PX, (1, 4), False, False),
}
STEP_T, PX_PATCHES = 32, 20        # 20 patch positions straddle (1, 2)'s and (1, 4)'s chunks


def step_tasks(rng):
    one, batches, tasks = {}, {}, {}
    for arch in (WH, PX):
        cfg = cfg_of(arch)
        params1 = draw_tree(backbone.model_spec(cfg, MeshCtx()), rng)
        one[arch] = (params1, carried_state(params1, cfg, rng))
        toks = rng.integers(0, cfg.vocab, (B, STEP_T)).astype(np.int32)
        labels = rng.integers(0, cfg.vocab, (B, STEP_T)).astype(np.int32)
        labels[:, :3] = -1
        if arch == WH:
            batches[arch] = {"tokens": toks, "labels": labels,
                             "enc": f32(rng, B, TE, cfg.d_model)}
        else:
            toks[:, :PX_PATCHES] = -1
            labels[:, :PX_PATCHES] = -1
            batches[arch] = {"tokens": toks, "labels": labels,
                             "frontend": 0.02 * f32(rng, B, STEP_T, cfg.d_model)}
    for name, (arch, (d, m), zero1, in_ref) in STEP_TASKS.items():
        params1, opt1 = one[arch]
        ocfg = OptConfig(warmup=2, total_steps=20, zero1=zero1)
        pm, om = from_one_rank(params1, opt1, cfg_of(arch), ocfg, sizes(d, m))
        tasks[name] = {"name": name, "arch": arch, "scale": None, "mesh": (d, m),
                       "zero1": zero1, "params": _np(pm), "opt": _np(om),
                       "batch": batches[arch], "ref": in_ref}
    return one, batches, tasks


# serving: whisper one run of three prompt lengths under one set of frames;
# pixtral one run an image prompt length (12: the patches straddle (1, 2)'s
# and (1, 4)'s chunks; 20: (1, 4)'s) and a text-only run
SERVE_MAX_LEN, ENC_LEN = 32, 16
WH_LENS, WH_NEW = (4, 8, 8, 12, 4), (5, 3, 6, 4, 6)
TEXT_LEN = 16             # pixtral's text-only prompts
PX_RUNS = ((12, (5, 3, 6)), (20, (4, 6)), (TEXT_LEN, (5, 3, 4)))
PREFILL = {WH: 8, PX: 12}


def serve_inputs(rng):
    """Per architecture: its requests and its runs (request indices, the
    port's extras, the reference's extras)."""
    wh, px = cfg_of(WH), cfg_of(PX)
    reqs = {WH: [[i, [int(x) for x in rng.integers(0, wh.vocab, n)], k]
                 for i, (n, k) in enumerate(zip(WH_LENS, WH_NEW))]}
    frames = {"enc": f32(rng, B, ENC_LEN, wh.d_model)}
    runs = {WH: [(list(range(len(WH_LENS))), frames, frames)]}
    reqs[PX], runs[PX] = [], []
    for plen, news in PX_RUNS:
        idx = []
        for k in news:
            idx.append(len(reqs[PX]))
            prompt = (image_prompt(rng, px, plen) if plen != TEXT_LEN
                      else [int(x) for x in rng.integers(0, px.vocab, plen)])
            reqs[PX].append([len(reqs[PX]), prompt, k])
        if plen != TEXT_LEN:
            fe = {"frontend": (0.02 * f32(rng, B, plen, px.d_model)).astype(np.float32)}
            runs[PX].append((idx, fe, fe))
        else:               # text only: no frontend; the reference's prefill needs one
            runs[PX].append((idx, None,
                             {"frontend": np.zeros((B, plen, px.d_model), np.float32)}))
    return reqs, runs


def one_rank_serve(arch, params1, reqs, runs):
    """The port's one rank over the same runs: completions, summed counts
    and the prefill bucket's caches."""
    cfg = cfg_of(arch)
    sched = BatchScheduler(cfg, make_local_mesh(device="cpu"), batch=B, max_len=SERVE_MAX_LEN,
                           eos_id=-1, enc_len=ENC_LEN)
    p1 = params_from_numpy(params1, "cpu")
    done, counts = {}, np.zeros(4, np.int64)
    with torch.no_grad():
        for idx, extras, _ in runs:
            got, st = sched.run(p1, [Request(*reqs[i]) for i in idx], extras=extras)
            done.update(got)
            counts += (st.requests, st.prefill_tokens, st.decode_steps, st.batches)
        plen = PREFILL[arch]
        prompts = [p for _, p, _ in reqs if len(p) == plen][:B]
        prompts += [prompts[0]] * (B - len(prompts))
        extras = next(e for idx, e, _ in runs
                      if any(len(reqs[i][1]) == plen for i in idx)) or {}
        caches, _ = sched._engine.prefill(p1, {"tokens": torch.tensor(prompts),
                                               **{k: torch.from_numpy(v)
                                                  for k, v in extras.items()}})
    return ({rid: (c.tokens, c.finished) for rid, c in done.items()},
            tuple(int(c) for c in counts),
            tree_map(lambda x: x if isinstance(x, int) else x.float().numpy(), caches))


def serve_tasks(rng, weights):
    reqs, runs = serve_inputs(rng)
    want, tasks = {}, {}
    for arch in (WH, PX):
        want[arch] = one_rank_serve(arch, weights[arch], reqs[arch], runs[arch])
        for mname, (d, m) in MESHES.items():
            name = f"sv-{'wh' if arch == WH else 'px'}-{mname}"
            tasks[name] = {"name": name, "arch": arch, "scale": None, "mesh": (d, m),
                           "batch": B, "max_len": SERVE_MAX_LEN, "eos_id": -1,
                           "enc_len": ENC_LEN, "requests": reqs[arch],
                           "prefill": PREFILL[arch], "params": on_mesh(weights[arch], arch,
                                                                       (d, m)),
                           "runs": [(idx, port) for idx, port, _ in runs[arch]],
                           "ref_runs": [(idx, ref) for idx, _, ref in runs[arch]]}
    return tasks, want


# ---------------------------------------------------------------------------
# the runs
# ---------------------------------------------------------------------------


def reference_job(layers, steps, serves, path):
    job, arrays = [], {}
    for t in layers:
        n = t["name"]
        if "encode" in t["parts"]:
            job.append({"kind": "frontend_layers", "name": n, "arch": t["arch"], "scale": {},
                        "mesh": t["mesh"], "parts": ["encode", "cross"],
                        "n_steps": len(t["xsteps"]), "cache_len": TE})
            flat({"enc": t["params"]["enc"], "cross": t["params"]["cross"]},
                 f"{n}/params", arrays)
            flat(t["cot"], f"{n}/cot", arrays)
            for k in ("frames", "x", "memory", "cache_k", "cache_v"):
                arrays[f"{n}/{k}"] = t[k]
            for i, xs in enumerate(t["xsteps"]):
                arrays[f"{n}/xstep{i}"] = xs
        fw = f"fw-{n}"
        job.append({"kind": "forward", "name": fw, "arch": t["arch"], "scale": {},
                    "mesh": t["mesh"]})
        flat(t["params"]["model"], f"{fw}/params", arrays)
        arrays[f"{fw}/tokens"] = t["tokens"]
        if "frames" in t:
            arrays[f"{fw}/enc"] = t["frames"]
        if "frontend" in t:
            arrays[f"{fw}/frontend"] = t["frontend"]
    for t in steps:
        job.append({"kind": "step", "name": t["name"], "arch": t["arch"], "mesh": t["mesh"],
                    "scale": {}, "zero1": t["zero1"]})
        flat(t["params"], f"{t['name']}/params", arrays)
        flat(t["opt"], f"{t['name']}/opt", arrays)
        flat(t["batch"], f"{t['name']}/batch", arrays)
    for t in serves:
        n = t["name"]
        job.append({k: t[k] for k in ("name", "mesh", "batch", "max_len", "eos_id",
                                      "requests", "prefill", "enc_len")}
                   | {"kind": "serve", "arch": t["arch"], "scale": {},
                      "runs": [idx for idx, _ in t["ref_runs"]]})
        flat(t["params"], f"{n}/params", arrays)
        for i, (_, ex) in enumerate(t["ref_runs"]):
            for k, v in ex.items():
                arrays[f"{n}/extras{i}/{k}"] = v
    np.savez(path, job=json.dumps(job), **arrays)


def ranks_body(dev, layers, steps, serves):
    """Layers, then steps, then serving, in one group of ranks."""
    return {"layers": _torch_ranks.frontend_layers(dev, layers),
            "steps": _torch_ranks.train_steps(dev, steps),
            "serve": _torch_ranks.serve(dev, serves)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("frontends_multirank")
    rng = np.random.default_rng(29)
    weights = model_weights(rng)
    layers = layer_tasks(rng, weights)
    one, batches, steps = step_tasks(rng)
    serves, serve_want = serve_tasks(rng, weights)
    # three reference subprocesses, the work split about evenly
    ref_l = list(layers.values())
    ref_s = [t for t in steps.values() if t["ref"]]
    ref_v = list(serves.values())
    parts = [(ref_l[i::3], ref_s[i::3], ref_v[i::3]) for i in range(3)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    refs = []
    for i, (lt, st, sv) in enumerate(parts):
        reference_job(lt, st, sv, tmp / f"in{i}.npz")
        refs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_jax_mesh_ref.py"), str(tmp / f"in{i}.npz"),
             str(tmp / f"out{i}.npz"), "4"], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))

    def port_tasks(world):
        lt = [t for t in layers.values() if np.prod(t["mesh"]) == world]
        st = [t for t in steps.values() if np.prod(t["mesh"]) == world]
        sv = [{k: v for k, v in t.items() if k != "ref_runs"} for t in serves.values()
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
    for i in range(3):
        ref.update(np.load(tmp / f"out{i}.npz"))
    return {"ref": ref, "port": port, "layers": layers, "steps": steps, "one": one,
            "batches": batches, "serves": serves, "serve_want": serve_want,
            "weights": weights}


def per_rank(runs, group, name):
    t = {"layers": runs["layers"], "steps": runs["steps"], "serve": runs["serves"]}[group][name]
    world = int(np.prod(t["mesh"]))
    return [r[group][name] for r in runs["port"][world]], t


def close(got, want, tol, label):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    np.testing.assert_allclose(got, want, **tol, err_msg=label)


def logical(g, p):
    """A gradient of a padded leaf cut to its one-rank (logical) shape."""
    return g[tuple(slice(0, n) for n in (p.logical or p.shape))]


# ---------------------------------------------------------------------------
# the layers against the reference, rank by rank
# ---------------------------------------------------------------------------

WH_LAYERS = [f"wh-{m}" for m in MESHES]
FORWARDS = WH_LAYERS + [f"px-{m}" for m in MESHES]


@pytest.mark.parametrize("name", WH_LAYERS)
def test_encode_per_rank_matches_reference(runs, name):
    """Each rank's gathered memory (its rows, every frame), the gradient of
    its frame chunk and of the encoder's leaves, against the reference's
    ``encode`` inside ``shard_map``."""
    per, _ = per_rank(runs, "layers", name)
    ref = runs["ref"]
    for r, res in enumerate(per):
        got = res["encode"]
        close(got["y"], ref[f"{name}/encode/y"][r], F32, f"{name} memory {r}")
        assert_close(got["dx"], ref[f"{name}/encode/dx"][r], 1e-4, f"{name} dx {r}")
        for path, g in got["dp"].items():
            assert_close(g, ref[f"{name}/encode/dp{path}"][r], 1e-4, f"{name} d{path} {r}")


@pytest.mark.parametrize("name", WH_LAYERS)
def test_cross_attention_per_rank_matches_reference(runs, name):
    """``gqa_apply(memory=)``: each rank's output chunk and its gradients of
    ``wq`` / ``wk`` / ``wv`` / ``wo``, of its stream chunk and of its rows
    of the memory (its query heads' part), against the reference's."""
    per, _ = per_rank(runs, "layers", name)
    ref = runs["ref"]
    for r, res in enumerate(per):
        got = res["cross"]
        close(got["y"], ref[f"{name}/cross/y"][r], F32, f"{name} y {r}")
        assert_close(got["dx"], ref[f"{name}/cross/dx"][r], 1e-4, f"{name} dx {r}")
        assert_close(got["dmem"], ref[f"{name}/cross/dmem"][r], 1e-4, f"{name} dmem {r}")
        assert sorted(got["dp"]) == ["/wk", "/wo", "/wq", "/wv"]
        for path, g in got["dp"].items():
            assert_close(g, ref[f"{name}/cross/dp{path}"][r], 1e-4, f"{name} d{path} {r}")


@pytest.mark.parametrize("name", WH_LAYERS)
def test_cross_cache_and_decode_per_rank_match_reference(runs, name):
    """``cross_fill_cache``: each rank's chunk of the memory's K/V;
    ``cross_decode`` from one given cache, each rank its chunk: each step's
    output, against the reference's."""
    per, _ = per_rank(runs, "layers", name)
    ref = runs["ref"]
    for r, res in enumerate(per):
        for k in ("k", "v"):
            close(res["cross_cache"][k], ref[f"{name}/cross_cache/{k}"][r], BF16,
                  f"{name} {k} {r}")
        assert res["cross_cache"]["len"] == TE
        for i, y in enumerate(res["cross_decode"]["y"]):
            close(y, ref[f"{name}/cross_decode/y{i}"][r], BF16, f"{name} step {i} {r}")


@pytest.mark.parametrize("name", FORWARDS)
def test_forward_per_rank_matches_reference(runs, name):
    """The no-cache ``forward`` over each rank's tokens with its chunk of the
    frames (whisper) or of the patch rows (pixtral): its stream chunk
    against its block of the reference's."""
    per, t = per_rank(runs, "layers", name)
    x = runs["ref"][f"fw-{name}/x"]
    for r, res in enumerate(per):
        close(res["forward"]["x"], rank_block(x, t["mesh"], r, SEQ), F32, f"{name} {r}")


# ---------------------------------------------------------------------------
# the layers against the port's one rank
# ---------------------------------------------------------------------------


def seq_cat(cot, d, m):
    """(world, B/d, T/m, …) per-rank chunks -> (B, T, …)."""
    c = cot.reshape((d, m) + cot.shape[1:])
    return np.concatenate([np.concatenate(list(c[i]), 1) for i in range(d)], 0)


def model_sum(a, d, m):
    """(world, B/d, …) per-rank arrays, replicated over 'model' -> (B, …),
    each row block the sum over its 'model' ranks."""
    c = a.reshape((d, m) + a.shape[1:])
    return np.concatenate(list(c.sum(1)), 0)


@pytest.fixture(scope="module")
def one_rank_layers(runs):
    """Per whisper layer task: the port's one-rank encode, cross attention,
    cross cache and decode on the global inputs (the objective every rank's
    sums to); per task: the one-rank forward."""
    out = {}
    ctx = MeshCtx()
    for name, t in runs["layers"].items():
        d, m = t["mesh"]
        cfg = cfg_of(t["arch"])
        w = runs["weights"][t["arch"]]
        res = {}
        kw = {"enc_embeds": torch.from_numpy(t["frames"])} if "frames" in t else {
            "frontend": torch.from_numpy(t["frontend"])}
        with torch.no_grad():
            res["forward"] = backbone.forward(params_from_numpy(w, "cpu"),
                                              torch.from_numpy(t["tokens"]), ctx, cfg,
                                              remat=False, **kw).numpy()
        if "encode" in t["parts"]:
            (y,), dp, dx = _torch_ranks._vjp(
                lambda pp, xx: (backbone.encode({"enc": pp}, xx, ctx, cfg),),
                params_from_numpy(w["enc"], "cpu"), torch.from_numpy(t["frames"]),
                [model_sum(t["cot"]["encode"], d, m)])
            res["encode"] = (y, dp, dx)
            cross = params_from_numpy(layer0(w["g0"]["cross"]), "cpu")
            (y,), dp, dxs = _torch_ranks._vjp(
                lambda pp, xx, mm: (attention.gqa_apply(pp, xx, ctx, cfg, causal=False,
                                                        memory=mm),),
                cross, torch.from_numpy(t["x"]), [seq_cat(t["cot"]["cross"], d, m)],
                more=[torch.from_numpy(t["memory"])])
            res["cross"] = (y, dp, dxs)
            with torch.no_grad():
                cross = params_from_numpy(layer0(w["g0"]["cross"]), "cpu")
                c = attention.cross_fill_cache(cross, torch.from_numpy(t["memory"]), cfg, ctx)
                cache = {"k": torch.from_numpy(t["cache_k"]).to(torch.bfloat16),
                         "v": torch.from_numpy(t["cache_v"]).to(torch.bfloat16), "len": TE}
                res["cross_cache"] = {k: c[k].float().numpy() for k in ("k", "v")}
                res["cross_decode"] = [
                    attention.cross_decode(cross, torch.from_numpy(xd), cache, ctx, cfg).numpy()
                    for xd in t["xsteps"]]
        out[name] = res
    return out


@pytest.mark.parametrize("name", WH_LAYERS)
def test_encode_and_cross_attention_match_one_rank(runs, one_rank_layers, name):
    """Every rank's memory is its rows of the one-rank memory, whole; its
    frame gradient its block of the one-rank one; the encoder's and the
    cross block's leaf gradients summed over ranks (cut to the one-rank
    shapes where heads are padded) and the memory's gradient summed over
    'model' are the one-rank gradients; cross attention's output and
    stream gradient are the one-rank blocks."""
    per, t = per_rank(runs, "layers", name)
    mesh = t["mesh"]
    d, m = mesh
    one = one_rank_layers[name]
    cfg, ctx = cfg_of(WH), ctx_of(d, m)
    y1, dp1, dx1 = one["encode"]
    yc, dpc, (dxc, dmc) = one["cross"]
    for r, res in enumerate(per):
        close(res["encode"]["y"], rank_block(y1, mesh, r, ROWS), F32, f"{name} memory {r}")
        assert_close(res["encode"]["dx"], rank_block(dx1, mesh, r, SEQ), 1e-4, f"dx {r}")
        close(res["cross"]["y"], rank_block(yc, mesh, r, SEQ), F32, f"{name} cross y {r}")
        assert_close(res["cross"]["dx"], rank_block(dxc, mesh, r, SEQ), 1e-4, f"cross dx {r}")
    dmem = model_sum(np.stack([res["cross"]["dmem"] for res in per]), d, m)
    assert_close(dmem, dmc, 1e-4, f"{name} dmem")
    enc_spec = backbone.model_spec(cfg, ctx)["enc"]
    for path, p in flat_specs(enc_spec):
        key = "/" + "/".join(path)
        g = sum_blocks([res["encode"]["dp"][key] for res in per], p.shape, p.axes, mesh)
        assert_close(logical(g, p), dp1[key], 1e-4, f"{name} enc d{key}")
    for leaf, p in attention.gqa_spec(cfg, ctx).items():
        g = sum_blocks([res["cross"]["dp"][f"/{leaf}"] for res in per], p.shape, p.axes, mesh)
        assert_close(logical(g, p), dpc[f"/{leaf}"], 1e-4, f"{name} cross d{leaf}")


@pytest.mark.parametrize("name", WH_LAYERS)
def test_cross_cache_and_decode_match_one_rank(runs, one_rank_layers, name):
    """Each rank's cross cache is its chunk of the one-rank cache; every
    rank's decode output is its rows of the one-rank decode's."""
    per, t = per_rank(runs, "layers", name)
    one = one_rank_layers[name]
    for r, res in enumerate(per):
        for k in ("k", "v"):
            close(res["cross_cache"][k], rank_block(one["cross_cache"][k], t["mesh"], r,
                                                    CACHE_AXES), BF16, f"{name} {k} {r}")
        for i, y in enumerate(res["cross_decode"]["y"]):
            close(y, rank_block(one["cross_decode"][i], t["mesh"], r, ROWS), BF16,
                  f"{name} step {i} {r}")


@pytest.mark.parametrize("name", FORWARDS)
def test_forward_matches_one_rank(runs, one_rank_layers, name):
    """Every rank's stream chunk is its block of the one-rank forward's,
    with frames (whisper) or with patch rows straddling its chunk
    boundary (pixtral)."""
    per, t = per_rank(runs, "layers", name)
    for r, res in enumerate(per):
        close(res["forward"]["x"], rank_block(one_rank_layers[name]["forward"], t["mesh"], r,
                                              SEQ), F32, f"{name} {r}")


@pytest.mark.parametrize("name", WH_LAYERS)
def test_cross_decode_collectives(runs, name):
    """A cross decode step takes, over 'model', q's all-gather, the combine's
    three all-reduces and the ``wo`` psum; on one 'model' rank none."""
    per, t = per_rank(runs, "layers", name)
    m = t["mesh"][1]
    want = {"all_gather": STEPS, "all_reduce": 4 * STEPS} if m > 1 else {}
    for res in per:
        assert res["cross_decode"]["ledger"] == want, res["cross_decode"]["ledger"]


def test_padded_heads_stay_inert(runs):
    """whisper's 2 heads padded to 4 on (1, 4): ranks 2 and 3 hold pads only
    — their cross ``wq`` columns and ``wo`` rows get zero gradients, and
    every rank's decode output is the same."""
    per, _ = per_rank(runs, "layers", "wh-14")
    for r in (2, 3):
        dp = per[r]["cross"]["dp"]
        assert not np.any(dp["/wq"]) and not np.any(dp["/wo"])
    assert np.any(per[1]["cross"]["dp"]["/wq"])
    assert all(np.array_equal(per[0]["cross_decode"]["y"][i], res["cross_decode"]["y"][i])
               for res in per[1:] for i in range(STEPS))


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------

REF_STEPS = [n for n, t in STEP_TASKS.items() if t[3]]


def _one_rank(name, params, opt):
    arch, (d, m), zero1, _ = STEP_TASKS[name]
    ocfg = OptConfig(warmup=2, total_steps=20, zero1=zero1)
    return to_one_rank(params, opt, cfg_of(arch), ocfg, sizes(d, m))


@pytest.mark.parametrize("name", REF_STEPS)
def test_step_matches_reference(runs, name):
    """Loss, the synced gradients, metrics, and the parameters and state
    after one step, against the reference's step on the same mesh, the
    frames or patch rows in its batch."""
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
    assert_state_close(_one_rank(name, got["params"], got["opt"]),
                       _one_rank(name, unflat(ref, f"{name}/after/params"),
                                 unflat(ref, f"{name}/after/opt")), name)


@pytest.fixture(scope="module")
def one_rank_steps(runs):
    out = {}
    for arch, (params1, opt1) in runs["one"].items():
        bundle = make_train_step(cfg_of(arch), make_local_mesh(device="cpu"),
                                 OptConfig(warmup=2, total_steps=20), batch=B)
        p = params_from_numpy(params1, "cpu")
        opt = {"step": opt1["step"].clone(), "leaves": _clone(opt1["leaves"])}
        grads, ce, aux = bundle.grads(p, runs["batches"][arch])
        synced = _map_plan(lambda g, pl: sync_gradient(g, pl), grads, bundle.plan)
        p, opt, met = bundle.update(p, opt, grads, ce, aux)
        out[arch] = {"grads": synced, "params": p, "opt": opt,
                     "metrics": {k: float(v) for k, v in met.items()}}
    return out


@pytest.mark.parametrize("name", list(STEP_TASKS))
def test_step_matches_one_rank_step(runs, one_rank_steps, name):
    """Every mesh's step against the port's one-rank step from the same
    state, in the one-rank layout: whisper's encoder gradients reach every
    rank's frames through the memory's gather (its backward a
    reduce-scatter), pixtral's patch rows straddle the chunks."""
    got = per_rank(runs, "steps", name)[0][0]
    arch, (d, m), _, _ = STEP_TASKS[name]
    one = one_rank_steps[arch]
    for k in ("loss", "grad_norm"):
        assert abs(got["metrics"][k] - one["metrics"][k]) <= 1e-5 * abs(one["metrics"][k]), k
    g1, _ = to_one_rank(got["grads"], None, cfg_of(arch), OptConfig(), sizes(d, m))
    fg = flat(g1, "", {})
    for path, w in flat(one["grads"], "", {}).items():
        assert_close(fg[path], w, 1e-4, f"{name} {path}")
    assert_state_close(_one_rank(name, got["params"], got["opt"]),
                       (one["params"], one["opt"]), name)


@pytest.mark.parametrize("name", ["st-wh-12", "st-wh-22", "st-px-14"])
def test_every_rank_runs_the_same_step_collectives(runs, name):
    """Every rank of a mesh records the same collectives in a step (the
    encoder's gather and its reduce-scatter among them), or the backward
    would deadlock."""
    per, _ = per_rank(runs, "steps", name)
    calls = [{k: v["calls"] for k, v in res["ledger"].items()} for res in per]
    assert all(c == calls[0] for c in calls[1:]), calls


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

SERVES = [f"sv-{a}-{m}" for a in ("wh", "px") for m in MESHES]


def ref_completions(runs, name):
    ref, t = runs["ref"], runs["serves"][name]
    return ({rid: (ref[f"{name}/tokens/{rid}"].tolist(), bool(ref[f"{name}/finished/{rid}"]))
             for rid, _, _ in t["requests"]},
            tuple(int(x) for x in ref[f"{name}/stats"]))


ONE_RANK_TIE, REF_TIE = 1 / 128, 1 / 32


def forward_margin(runs, t, rid, tokens):
    """The top-2 margin of the port's one-rank no-cache forward after the
    request's prompt and ``tokens``, with its run's extras (its row's)."""
    arch = t["arch"]
    cfg = cfg_of(arch)
    idx, extras = next((idx, e) for idx, e in t["runs"] if rid in idx)
    row = idx.index(rid) % B
    prompt = t["requests"][rid][1]
    seq = torch.tensor([prompt + tokens], dtype=torch.int32)
    kw = {}
    if extras and "enc" in extras:
        kw["enc_embeds"] = torch.from_numpy(extras["enc"][row:row + 1])
    elif extras:
        fe = torch.from_numpy(extras["frontend"][row:row + 1])
        kw["frontend"] = torch.nn.functional.pad(fe, (0, 0, 0, seq.shape[1] - fe.shape[1]))
    p = params_from_numpy(runs["weights"][arch], "cpu")
    with torch.no_grad():
        x = backbone.forward(p, seq, MeshCtx(), cfg, remat=False, **kw)[:, -1:]
        top2 = backbone.vocab_logits(p["embed"], x, MeshCtx(), cfg).topk(2, dim=-1).values
    return float(top2[0, 0, 0] - top2[0, 0, 1])


def held_to_near_ties(runs, t, got, want, tie):
    """Each request's ``got`` tokens equal ``want``'s up to the first
    position where they part, a near tie (the one-rank forward's top-2
    margin at most ``tie``); ``finished`` equal.  Returns the positions
    compared and the ties met."""
    compared, ties = 0, []
    for rid, (toks, finished) in want.items():
        g, fin = got[rid]
        assert fin == finished and len(g) == len(toks), (rid, got[rid], toks)
        n = next((i for i, (a, b) in enumerate(zip(g, toks)) if a != b), None)
        if n is None:
            compared += len(toks)
            continue
        compared += n
        margin = forward_margin(runs, t, rid, toks[:n])
        assert margin <= tie, (t["name"], rid, n, margin)
        ties.append((rid, n, margin))
    assert compared * 2 >= sum(len(toks) for toks, _ in want.values()), compared
    return compared, ties


@pytest.mark.parametrize("name", SERVES)
def test_every_rank_serves_one_rank_and_reference_tokens(runs, name):
    """Every rank's completions (tokens, ``finished``) and summed counts
    against one rank's and the reference's ``BatchScheduler`` on the mesh:
    the flags and counts equal, the tokens equal up to a near tie (see the
    module docstring), every rank's the same: whisper's one run under one
    set of frames, pixtral's two image runs (patches across a chunk
    boundary) and its text-only run."""
    per, t = per_rank(runs, "serve", name)
    want, counts = runs["serve_want"][t["arch"]][:2]
    assert len(want) == len(t["requests"])
    for r, res in enumerate(per):
        assert res["stats"] == counts and res["completions"] == per[0]["completions"], r
    held_to_near_ties(runs, t, per[0]["completions"], want, ONE_RANK_TIE)
    ref, ref_counts = ref_completions(runs, name)
    assert ref_counts == counts
    held_to_near_ties(runs, t, ref, want, REF_TIE)


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
def test_prefill_caches_are_one_rank_and_reference_blocks(runs, name):
    """Each rank's caches after the prefill bucket (with its run's extras)
    are its blocks by ``cache_spec`` of the one-rank caches and of the
    reference's: whisper's self and cross caches both sequence-sharded over
    'model'; the prefill token is the reference's, and every rank's next
    token the same."""
    per, t = per_rank(runs, "serve", name)
    d, m = t["mesh"]
    cfg = cfg_of(t["arch"])
    spec = cache_spec(cfg, LocalMesh(("data", "model"), sizes(d, m), torch.device("cpu")), B,
                      SERVE_MAX_LEN, ENC_LEN)
    one = runs["serve_want"][t["arch"]][2]
    ref = runs["ref"]
    paths = [path for path, _ in flat_specs(spec)]
    assert (t["arch"] == WH) == any("cross" in path for path in paths)
    for r, res in enumerate(per):
        at = {"data": r // m, "model": r % m}
        for path, p in flat_specs(spec):
            got = walk(res["caches"], path)
            if path[-1] == "len":
                assert got == walk(one, path) == (ENC_LEN if "cross" in path
                                                  else PREFILL[t["arch"]])
                continue
            if "cross" in path:
                assert p.axes[3] == "model"
            blk = dim_blocks(p.shape, p.axes, sizes(d, m), at)
            close(got, walk(one, path)[blk], BF16, f"{name} {path} {r}")
            close(got, ref[f"{name}/caches/{'/'.join(path)}"][blk], BF16, f"{name} {path}")
        np.testing.assert_array_equal(res["prefill_token"], ref[f"{name}/prefill_token"])
        np.testing.assert_array_equal(res["decode_token"], per[0]["decode_token"])


@pytest.mark.parametrize("name", SERVES)
def test_decode_step_collectives(runs, name):
    """One decode step's collectives, a rank.  Over 'model', a ``dec`` layer:
    its self attention's and its cross attention's q all-gather, three
    combine all-reduces and ``wo`` psum each, and the MLP's psum; an
    ``attn`` layer the self half of that; the embedding's psum and the
    argmax's all-gather.  The token's all-gather over 'data'."""
    per, t = per_rank(runs, "serve", name)
    d, m = t["mesh"]
    n = cfg_of(t["arch"]).n_layers
    halves = 2 if t["arch"] == WH else 1
    want = {"all_gather": halves * n + 1, "all_reduce": (4 * halves + 1) * n + 1} if m > 1 else {}
    if d > 1:
        want["all_gather"] = want.get("all_gather", 0) + 1
    for r, res in enumerate(per):
        assert res["decode_ledger"] == want, (name, r, res["decode_ledger"])


# ---------------------------------------------------------------------------
# what the engine refuses above one rank
# ---------------------------------------------------------------------------


def test_enc_len_not_divisible_by_model_is_refused():
    """An encoder-decoder's ``enc_len`` that the 'model' size does not divide
    is refused, naming both numbers (the reference's ``shard_map`` cannot
    split such frames); a family without an encoder ignores it, and
    ``enc_len`` 16 builds on the same mesh."""
    mesh = LocalMesh(("data", "model"), {"data": 1, "model": 4}, torch.device("cpu"))
    with pytest.raises(ValueError, match="enc_len 18 .* 4 ranks"):
        make_serve_fns(cfg_of(WH), mesh, batch=2, max_len=16, enc_len=18)
    with pytest.raises(ValueError, match="enc_len 18"):
        BatchScheduler(cfg_of(WH), mesh, batch=2, max_len=16, enc_len=18)
    make_serve_fns(cfg_of(PX), mesh, batch=2, max_len=16, enc_len=18)
    assert make_serve_fns(cfg_of(WH), mesh, batch=2, max_len=16, enc_len=16).ctx.model_size == 4


@pytest.mark.parametrize("case", ["enc", "frontend"])
def test_prefill_refuses_global_inputs_of_another_shape(case):
    """Above one rank prefill checks ``"enc"`` against (B, enc_len) and
    ``"frontend"`` against the global tokens before any rank keeps its part,
    so the message names the global shapes."""
    arch = WH if case == "enc" else PX
    cfg = cfg_of(arch)
    mesh = LocalMesh(("data", "model"), {"data": 1, "model": 2}, torch.device("cpu"))
    sv = make_serve_fns(cfg, mesh, batch=2, max_len=16, enc_len=8)
    tokens = torch.zeros((2, 8), dtype=torch.int32)
    if case == "enc":
        inputs = {"tokens": tokens, "enc": torch.zeros((2, 6, cfg.d_model))}
        match = r"enc of shape \(2, 6, 64\): expected \(2, 8, d\)"
    else:
        inputs = {"tokens": tokens, "frontend": torch.zeros((2, 4, cfg.d_model))}
        match = r"frontend of shape \(2, 4, 128\) for tokens of shape \(2, 8\)"
    with pytest.raises(ValueError, match=match):
        sv.prefill({}, inputs)
