"""Serving the dense family across ranks: the port's ranks as gloo processes
on the CPU (``repro_torch.launch.ranks.run_ranks``, one group of 2 and one
of 4 ranks for the module, each rank running ``BatchScheduler`` over its
parameter shards, ``tests/_torch_ranks.py::serve``) against the reference's
``BatchScheduler`` / ``make_serve_fns`` under ``shard_map`` on fake CPU
devices (``tests/_jax_mesh_ref.py``, two subprocesses beside the ranks),
and against the port's own one-rank scheduler.

Meshes: (1, 2), (2, 1), (2, 2), and (1, 4) at 6 query heads (``head_dim``
32), padded to 8, so the last rank holds only pad heads.  Configs: the
smoke configs of qwen2-1.5b (tied, QKV bias) and qwen3-14b (untied,
qk-norm).  Parameters are float32 (the KV caches bfloat16, as in the
reference): with bfloat16 parameters the meshes' other summation orders
can flip near ties of the greedy token, even in the reference against
its own one device, where float32 leaves them far below every margin
these weights give.  Traffic: batch
4, ``max_len`` 32, prompts of 8 tokens (a full batch, inside rank 0's
chunk on (1, 2)) and of 20 (an underfull batch padded with copies, whose
prompt crosses the chunk boundary on every 'model' axis and whose decode
writes on another rank than rank 0).

Tolerances, stated before the first run:

* each rank's prefill caches against the block of the reference's global
  caches that ``cache_spec`` gives the rank: within one bfloat16 step
  (1/128 relative, 1/128 absolute), the prefill tolerance of
  ``tests/test_torch_serve.py`` at float32 parameters;
* every token, ``finished`` flag and ``ServeStats`` count: exactly equal
  to the reference's on the same mesh and to the port's one-rank run;
* the distributed argmax: an unembedding whose columns 5 and 300 (on
  different ranks) are equal and all others zero ties exactly; every token
  must be 5 (the lower id of the tie) or 0 (the first of the zeros), both
  must occur, and they must equal the reference's and one rank's;
* whole-vocab logits on every rank (``vocab_logits``) are held in
  ``tests/test_torch_collectives.py``.

On the card ``chip_smoke.py``'s phase ``multirank`` serves the same path
at qwen2-1.5b's full width with two tolerances, stated there with their
reasons: bfloat16 tokens against the one-rank no-cache forward where its
top-2 margin exceeds 0.0625 (qwen2's ``model_serve`` margin, 4 bfloat16
ulps of its top logits), and a float32 2-layer model's tokens against the
one-rank run's up to a near tie of margin at most 1/128 (a K/V entry
rounding to the other bfloat16 neighbour moves a logit by less).
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
from repro_torch.models import backbone
from repro_torch.models.layers import MeshCtx
from repro_torch.models.spec import dim_blocks, params_from_numpy
from repro_torch.serve.engine import cache_spec, make_serve_fns
from repro_torch.serve.scheduler import BatchScheduler, Request

ROOT = Path(__file__).resolve().parents[1]
ARCHS = {"q2": "qwen2-1.5b", "q3": "qwen3-14b"}
PAD = {"n_heads": 6, "head_dim": 32}      # 6 heads over 4 ranks: padded to 8
MESHES = {"12": ((1, 2), None), "21": ((2, 1), None), "22": ((2, 2), None),
          "14pad": ((1, 4), PAD)}
B, MAX_LEN, CROSS = 4, 32, 20
LENS, MAX_NEW = (8, 8, 8, 8, CROSS, CROSS), (6, 4, 6, 5, 6, 3)
TIE = (5, 300)                 # equal unembedding columns: rank 0 and rank 1 of (1, 2)
TIMEOUT = 150


def cfg_of(arch, scale=None):
    return get_smoke_config(arch).scaled(**(scale or {}))


def padded(params1, cfg, d, m):
    """One-rank parameters at a (d, m) mesh's global shapes: padding query
    heads appended as zeros, as the reference's init pads them."""
    return _pad(params1, backbone.model_spec(cfg, MeshCtx(model_size=m, data_size=d)))


def _pad(tree, spec):
    if isinstance(spec, dict):
        return {k: _pad(tree[k], spec[k]) for k in spec}
    return np.pad(tree, [(0, w - h) for h, w in zip(tree.shape, spec.shape)])


def requests(rng, vocab, lens=LENS, max_new=MAX_NEW):
    return [[i, [int(x) for x in rng.integers(0, vocab, n)], k]
            for i, (n, k) in enumerate(zip(lens, max_new))]


def one_rank(arch, scale, params1, reqs, *, batch=B, max_len=MAX_LEN, eos_id=-1):
    """The port's one-rank run: {rid: (tokens, finished)} and the counts."""
    sched = BatchScheduler(cfg_of(arch, scale), make_local_mesh(device="cpu"), batch=batch,
                           max_len=max_len, eos_id=eos_id)
    with torch.no_grad():
        done, st = sched.run(params_from_numpy(params1, "cpu"),
                             [Request(*r) for r in reqs])
    return ({rid: (c.tokens, c.finished) for rid, c in done.items()},
            (st.requests, st.prefill_tokens, st.decode_steps, st.batches))


def pick_eos(done):
    """An id that stops request 0 or 1 (data rank 0's rows of the first
    batch on (2, 1)) early and never occurs in requests 2 and 3 (data
    rank 1's): (eos id, the request it stops, its stopped length)."""
    other = set(done[2][0]) | set(done[3][0])
    for rid in (0, 1):
        toks = done[rid][0]
        for i in range(1, len(toks) - 1):
            if toks[i] not in toks[:i] and toks[i] not in other:
                return toks[i], rid, i + 1
    raise AssertionError(f"no early eos in {done}")


def build(rng):
    """The tasks of both packages and the port's one-rank results."""
    one = {}                                    # (arch, scale) -> one-rank float32 params
    for a, arch in ARCHS.items():
        for scale in (None, PAD):
            cfg = cfg_of(arch, scale)
            one[(a, json.dumps(scale))] = draw_tree(backbone.model_spec(cfg, MeshCtx()), rng)
    reqs = requests(rng, 512)
    tasks, want = [], {}

    def task(name, a, mesh, scale, params1, reqs_, batch=B, max_len=MAX_LEN, eos_id=-1,
             prefill=None, port=True, ref=True):
        arch = ARCHS[a]
        cfg = cfg_of(arch, scale)
        tasks.append({"name": name, "arch": arch, "scale": scale, "mesh": mesh,
                      "batch": batch, "max_len": max_len, "eos_id": eos_id,
                      "requests": reqs_, "prefill": prefill, "port": port, "ref": ref,
                      "params": padded(params1, cfg, *mesh)})
        want[name] = one_rank(arch, scale, params1, reqs_, batch=batch, max_len=max_len,
                              eos_id=eos_id) if port else None

    for a in ARCHS:
        for mname, (mesh, scale) in MESHES.items():
            task(f"{a}-{mname}", a, mesh, scale, one[(a, json.dumps(scale))], reqs,
                 prefill=CROSS)
    # the distributed argmax's tie: qwen3 (untied), unembedding zero but for
    # two equal columns holding one unit each, so their logits are exactly
    # one hidden coordinate, and every other logit exactly 0
    tie = dict(one[("q3", "null")])
    un = np.zeros_like(tie["embed"]["unembed"])
    un[0, list(TIE)] = 1.0
    tie["embed"] = dict(tie["embed"], unembed=un)
    task("tie-12", "q3", (1, 2), None, tie, reqs)
    # early eos on data rank 0's rows of (2, 1)
    eos, stopped, n_stopped = pick_eos(want["q2-21"][0])
    task("eos-21", "q2", (2, 1), None, one[("q2", "null")], reqs, eos_id=eos)
    # batch 3 on (2, 1): no batch axis divides it, every data rank serves every row
    reqs3 = requests(rng, 512, (8, 8, 8, CROSS, CROSS), (5, 6, 4, 6, 3))
    task("b3-21", "q2", (2, 1), None, one[("q2", "null")], reqs3, batch=3)
    # the reference's dropped positions: (1, 4), 8 prompt + 6 decoded positions
    qc = requests(rng, 512, (8,) * 4, (7,) * 4)
    task("qc-14-16", "q2", (1, 4), None, one[("q2", "null")], qc, max_len=16)
    task("qc-14-14", "q2", (1, 4), None, one[("q2", "null")], qc, max_len=14, port=False)
    task("qc-11-14", "q2", (1, 1), None, one[("q2", "null")], qc, max_len=14, port=False)
    return tasks, want, {"eos": eos, "stopped": stopped, "n_stopped": n_stopped,
                         "tie": tie}


def flat(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat(v, f"{prefix}/{k}", out)
    else:
        out[prefix] = np.asarray(tree)
    return out


def reference(tasks, tmp, part):
    """Start the reference's script on ``tasks`` (a Popen)."""
    job, arrays = [], {}
    for t in tasks:
        job.append({k: t[k] for k in ("name", "mesh", "batch", "max_len", "eos_id",
                                      "requests", "prefill")}
                   | {"kind": "serve", "arch": t["arch"], "scale": t["scale"] or {}})
        flat(t["params"], f"{t['name']}/params", arrays)
    np.savez(tmp / f"in{part}.npz", job=json.dumps(job), **arrays)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, str(ROOT / "tests" / "_jax_mesh_ref.py"),
                             str(tmp / f"in{part}.npz"), str(tmp / f"out{part}.npz"), "4"],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_multirank")
    tasks, want, extra = build(np.random.default_rng(31))
    ref_tasks = [t for t in tasks if t["ref"]]
    refs = [reference(ref_tasks[i::2], tmp, i) for i in range(2)]

    def ranks(world):
        mine = [t for t in tasks if t["port"] and np.prod(t["mesh"]) == world]
        return run_ranks(_torch_ranks.serve, world, tmp / f"rdv{world}", device="cpu",
                         args=(mine,), timeout=TIMEOUT)

    try:
        with ThreadPoolExecutor(2) as pool:       # both groups at once
            port = dict(zip((2, 4), pool.map(ranks, (2, 4))))
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
    return {"ref": ref, "port": port, "want": want, "tasks": {t["name"]: t for t in tasks},
            **extra}


def port_ranks(runs, name):
    t = runs["tasks"][name]
    world = int(np.prod(t["mesh"]))
    return [r[name] for r in runs["port"][world]], t


def ref_completions(runs, name):
    ref, t = runs["ref"], runs["tasks"][name]
    return ({rid: (ref[f"{name}/tokens/{rid}"].tolist(), bool(ref[f"{name}/finished/{rid}"]))
             for rid, _, _ in t["requests"]},
            tuple(int(x) for x in ref[f"{name}/stats"]))


MAIN = [f"{a}-{m}" for a in ARCHS for m in MESHES]
SERVED = MAIN + ["tie-12", "eos-21", "b3-21", "qc-14-16"]


@pytest.mark.parametrize("name", SERVED)
def test_every_rank_serves_the_reference_and_one_rank_tokens(runs, name):
    """Every rank returns the same completions and counts, equal to the
    reference's on the same mesh and to the port's one-rank run."""
    per_rank, _ = port_ranks(runs, name)
    ref = ref_completions(runs, name)
    for r, res in enumerate(per_rank):
        got = (res["completions"], res["stats"])
        assert got == ref, (name, r, got, ref)
        assert got == runs["want"][name], (name, r)


@pytest.mark.parametrize("name", MAIN)
def test_prefill_caches_are_the_reference_blocks(runs, name):
    """Each rank's prefill caches (the 20-token bucket's prompts, which
    cross the chunk boundary) are its block of the reference's global
    caches by ``cache_spec``; the prefill and next decode tokens are
    global and equal on every rank."""
    per_rank, t = port_ranks(runs, name)
    d, m = t["mesh"]
    cfg = cfg_of(t["arch"], t["scale"])
    spec = cache_spec(cfg, LocalMesh(("data", "model"), {"data": d, "model": m},
                                     torch.device("cpu")), B, MAX_LEN)
    ref = runs["ref"]
    for r, res in enumerate(per_rank):
        at = {"data": r // m, "model": r % m}
        assert res["caches"]["g0"]["len"] == CROSS
        for key in ("k", "v"):
            p = spec["g0"][key]
            want = ref[f"{name}/caches/g0/{key}"][dim_blocks(p.shape, p.axes,
                                                             {"data": d, "model": m}, at)]
            got = res["caches"]["g0"][key]
            assert got.shape == want.shape, (name, r, key, got.shape, want.shape)
            np.testing.assert_allclose(got, want, rtol=1 / 128, atol=1 / 128,
                                       err_msg=f"{name} rank {r} {key}")
        # a chunk past the prompt holds zeros, never garbage
        tc = MAX_LEN // m
        lo = (r % m) * tc
        tail = max(0, min(tc, CROSS - lo))
        assert not res["caches"]["g0"]["k"][:, :, :, tail:].any()
        np.testing.assert_array_equal(res["prefill_token"], ref[f"{name}/prefill_token"])
        np.testing.assert_array_equal(res["prefill_token"], per_rank[0]["prefill_token"])
        np.testing.assert_array_equal(res["decode_token"], per_rank[0]["decode_token"])


@pytest.mark.parametrize("name", MAIN)
def test_decode_step_collectives(runs, name):
    """One decode step's collectives, a rank: per layer the q all-gather,
    ``combine_partials``' three all-reduces and the ``wo`` and MLP psums
    over 'model'; the embedding's psum and the argmax's one all-gather;
    the token's all-gather over 'data'."""
    per_rank, t = port_ranks(runs, name)
    d, m = t["mesh"]
    n_layers = cfg_of(t["arch"], t["scale"]).n_layers
    want = {}
    if m > 1:
        want = {"all_gather": n_layers + 1, "all_reduce": 5 * n_layers + 1}
    if d > 1:
        want["all_gather"] = want.get("all_gather", 0) + 1
    for r, res in enumerate(per_rank):
        assert res["decode_ledger"] == want, (name, r, res["decode_ledger"])


def test_argmax_tie_goes_to_the_lower_id(runs):
    per_rank, _ = port_ranks(runs, "tie-12")
    toks = [x for toks, _ in per_rank[0]["completions"].values() for x in toks]
    assert set(toks) <= {0, TIE[0]}, toks
    assert TIE[0] in toks and 0 in toks, toks      # both ties decided, each way
    # the two tied ids lie on different ranks of (1, 2)
    vl = backbone.vocab_pad(cfg_of(ARCHS["q3"])) // 2
    assert TIE[0] // vl == 0 and TIE[1] // vl == 1


def test_early_eos_on_one_data_rank_does_not_stall_the_others(runs):
    """On (2, 1) data rank 0's request stops at ``eos_id`` while data rank
    1's rows run on: both ranks keep stepping together (a rank breaking
    alone would leave the other in a collective until the join limit)."""
    per_rank, t = port_ranks(runs, "eos-21")
    done = per_rank[0]["completions"]
    rid, n = runs["stopped"], runs["n_stopped"]
    max_new = {r[0]: r[2] for r in t["requests"]}
    assert len(done[rid][0]) == n < max_new[rid] and done[rid][0][-1] == runs["eos"]
    assert done[rid][1]
    for other in (2, 3):
        assert len(done[other][0]) == max_new[other]


def test_replicated_rows_when_no_batch_axis_divides(runs):
    per_rank, t = port_ranks(runs, "b3-21")
    mesh = LocalMesh(("data", "model"), {"data": 2, "model": 1}, torch.device("cpu"))
    assert make_serve_fns(cfg_of(ARCHS["q2"]), mesh, batch=3, max_len=MAX_LEN).batch_ax is None
    assert per_rank[0]["completions"] == per_rank[1]["completions"]
    assert per_rank[0]["stats"][3] == 2          # one batch of 8-token prompts, one of 20


def test_max_len_not_divisible_by_model_where_the_reference_drops_positions(runs):
    """On (1, 4) with ``max_len`` 14 the reference gives each rank 3
    positions, 12 in all: the decode's writes of positions 12 and 13 (8
    prompt + 6 decoded positions fill 14 on one device) have no owner and
    are lost, so the tokens they feed, the last two, depart from one
    device's.  The port refuses that ``max_len``, naming both numbers; at
    16 its tokens equal one device's (and the reference's)."""
    ref14, _ = ref_completions(runs, "qc-14-14")
    one14, _ = ref_completions(runs, "qc-11-14")
    for rid in ref14:      # equal while every position had an owner
        assert ref14[rid][0][:5] == one14[rid][0][:5]
    assert any(ref14[rid][0][5:] != one14[rid][0][5:] for rid in ref14), (ref14, one14)
    cfg = cfg_of(ARCHS["q2"])
    mesh = LocalMesh(("data", "model"), {"data": 1, "model": 4}, torch.device("cpu"))
    with pytest.raises(ValueError, match="max_len 14 .* 4 ranks"):
        make_serve_fns(cfg, mesh, batch=2, max_len=14)
    with pytest.raises(ValueError, match="max_len 14"):
        BatchScheduler(cfg, mesh, batch=2, max_len=14)
    per_rank, _ = port_ranks(runs, "qc-14-16")
    assert per_rank[0]["completions"] == one14 == runs["want"]["qc-14-16"][0]


def test_every_family_builds_its_steps_above_one_rank():
    """Every family's steps build on a 'model' axis of 2: since 6c.i the
    MoE family's (``tests/test_torch_moe_multirank.py`` serves it), its
    latent cache split over 'model'; since 6c.ii the recurrent families'
    (``tests/test_torch_recurrent_multirank.py``): the RG-LRU state and the
    rings replicated over 'model', the SSD's state split by heads; since
    6c.iii the encoder-decoder's, its cross cache split over 'model' as its
    self cache is, and the patch frontend's
    (``tests/test_torch_frontends_multirank.py`` serves both), whose rows
    on 'data' 2 (no collective) embed as one rank's."""
    mesh = LocalMesh(("data", "model"), {"data": 1, "model": 2}, torch.device("cpu"))
    wh = make_serve_fns(get_smoke_config("whisper-tiny"), mesh, batch=2, max_len=16,
                        enc_len=24)
    assert wh.ctx.model_size == 2
    for leaf in ("k", "v"):
        assert wh.cache_pspec["g0"]["cross"][leaf].axes == (None, ("data",), None, "model",
                                                            None)
        assert wh.cache_pspec["g0"]["self"][leaf].axes == (None, ("data",), None, "model",
                                                           None)
    sv = make_serve_fns(get_smoke_config("deepseek-v2-236b"), mesh, batch=2, max_len=16)
    assert sv.ctx.model_size == 2
    assert sv.cache_pspec["g1"]["c_kv"].axes == (None, ("data",), "model", None)
    rg = make_serve_fns(get_smoke_config("recurrentgemma-2b"), mesh, batch=2, max_len=16)
    assert rg.cache_pspec["g0"]["b0"]["h"].axes == (None, ("data",), None)
    assert rg.cache_pspec["g0"]["b2"]["k"].axes == (None, ("data",), None, None, None)
    mb = make_serve_fns(get_smoke_config("mamba2-780m"), mesh, batch=2, max_len=16)
    assert mb.cache_pspec["g0"]["ssd"].axes == (None, ("data",), "model", None, None)
    assert mb.cache_pspec["g0"]["conv"]["x"].axes == (None, ("data",), None, "model")
    cfg = get_smoke_config("pixtral-12b")
    assert make_serve_fns(cfg, mesh, batch=2, max_len=16).ctx.model_size == 2
    rng = np.random.default_rng(9)
    p = {"tok": torch.from_numpy((0.02 * rng.standard_normal((cfg.vocab, cfg.d_model)))
                                 .astype(np.float32))}
    toks = torch.tensor([[-1, -1, 3, 4], [-1, -1, 5, 6]], dtype=torch.int32)
    fe = torch.from_numpy(rng.standard_normal((2, 4, cfg.d_model)).astype(np.float32))
    got = backbone.embed_inputs(p, toks, MeshCtx(data_size=2), cfg, frontend=fe)
    assert torch.equal(got, backbone.embed_inputs(p, toks, MeshCtx(), cfg, frontend=fe))
    assert torch.equal(got[:, :2], fe[:, :2])
