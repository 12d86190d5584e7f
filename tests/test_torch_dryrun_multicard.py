"""The dry run across cards: meta meshes whose collectives ledger ring
bytes (``launch.mesh``), the collective term (``roofline.analyze_step``),
the MoE dispatch on meta tensors above one rank (``models.ffn``) and the
production meshes (``launch.dryrun``), held against real ranks, the
reference's compiled cells and hand counts.

Tolerances, stated before the first run:

* **Meta against real ranks** — exact.  A smoke qwen2-1.5b training step,
  prefill and decode and a smoke deepseek-v3-671b training step run on
  gloo ranks of (2, 2) and (1, 4) (``_torch_ranks.dryrun_ledgers``); the
  same cells counted on meta meshes of the same shape, rank by rank, give
  each rank's ledger op for op: calls, bytes in, result bytes, ring bytes
  and their link.  The MoE all-to-all's buffers do not depend on routes,
  so they match too.
* **Against the reference's compiled HLO** (``tests/_jax_mesh_ref.py``'s
  ``dryrun`` task, ``analyze_hlo`` of the reference's cell on fake CPU
  devices) — exact after named items, each pinned to the unit by a
  formula: per-device flops, and ring bytes and tensors by op and element
  type.  The reference's CPU compile carries every bfloat16 collective in
  float32 (XLA's CPU backend promotes them: ``convert`` fusions around
  ``*_promoted`` reductions), so the port's bfloat16 calls are compared at
  float32 size.  A tuple-shaped (combined) collective counts one tensor an
  element, so XLA's combining of all-reduces changes no count.  The items:
  - ``greedy_token``: the port gathers each rank's maximum and index as one
    float64 (M, 2, B) all-gather; the reference gathers them as float32 and
    int32 (M, B);
  - the served token: the port all-gathers the global token (B,) int32 over
    the batch axes; the reference's jit returns a sharded array;
  - ``ce_loss``'s recompute (training): the port recomputes each chunk's
    logits in the backward, one (B·T × d)·(d × V/M) product more and the
    forward's three (B, T) float32 all-reduces over 'model' again;
  - the metrics: the port sums ``[ce, aux]`` in one all-reduce, the
    reference in two;
  - the MoE aux loss: the port sums ``[n_owned, load, pbar]`` (1 + 2E
    floats) in one all-reduce in the forward, its recompute and its
    backward (3 a layer); the reference's compiled step keeps 4 psums of E
    floats a layer and one of ``n_owned``, the same in every layer;
  - the MoE all-to-all: XLA's CPU all-to-all carries one tuple element a
    destination, the port one tensor a call;
  - the experts' compute: the reference runs each local expert over all
    ``world · cap`` slots (masked), the port over its received rows
    (``ffn.meta_dispatch_counts``), 3 products a layer, 4 times in a
    training step (forward, recompute, two in the backward);
  - whisper's prefill: the port's ``cross_fill_cache`` projects this
    rank's chunk of the memory's K and V again, where the reference's
    compiled prefill reuses its cross attention's projection.
* **Uniform SPMD** — exact after named items: every rank of a (2, 2) and a
  (2, 2, 2) meta mesh counts rank 0's flops, bytes, argument bytes, peak
  and collectives, but for (a) the decode position's owner, the last
  'model' rank, which writes the position's K / V (latent) rows: 2 × their
  bytes, as every in-place window write is charged; and (b) an MoE
  decode's few pairs, whose balanced routes reach the first experts only:
  its flops differ by the received rows' products, and with every rank
  given rank 0's received rows all else is equal.
* **Production cells** at full width through ``run_cell``: structural
  (``chips``, every op kind with ring bytes, the 'pod' all-reduce, the
  collective term at the NIC's rate, ``fits_h100``), deepseek-v2-236b's
  prefill dropping 279 424 of 1 449 984 pairs (19.27 %: 160 experts on 256
  ranks overflow ``cap`` by 1.28×) and its decode none.
* **One dense layer by hand** — exact: its forward and backward on (1, 4)
  move 8 sequence collectives of S · 3/4 ring bytes each, S the gathered
  activation's bytes.
"""
import json
import math
import os
import subprocess
import sys
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_ranks
from repro_torch.configs import get_smoke_config
from repro_torch.launch import cells, dryrun
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch.mesh import make_local_mesh, meta_mesh, ring_bytes
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import backbone, ffn
from repro_torch.models.layers import pad_to
from repro_torch.models.spec import abstract_shards
from repro_torch.roofline import NIC_BYTES_PER_S, analyze_step
from repro_torch.serve.engine import cache_spec
from repro_torch.train.step import batch_axes, mesh_ctx

ROOT = Path(__file__).resolve().parents[1]
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}

# ---------------------------------------------------------------------------
# the runs: gloo ranks and the reference's compiled cells, at once
# ---------------------------------------------------------------------------

RANK_MESHES = ((2, 2), (1, 4))
RB, RT = 4, 64                        # the ranks' batch and sequence
RANK_STEPS = [("qwen2-1.5b", "train"), ("qwen2-1.5b", "prefill"), ("qwen2-1.5b", "decode"),
              ("deepseek-v3-671b", "train")]
SHAPE_OF = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}

HB, HT = 8, 64                        # the reference cases' batch and sequence
HLO_CASES = [("qwen2-1.5b", s, dims) for dims in ((2, 2), (2, 2, 2))
             for s in ("train_4k", "prefill_32k", "decode_32k")]
HLO_CASES += [("deepseek-v3-671b", "train_4k", (2, 2)), ("whisper-tiny", "prefill_32k", (1, 2))]


def _hlo_id(case):
    return f"{case[0]}-{case[1]}-{'x'.join(map(str, case[2]))}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_multicard")
    job = [{"kind": "dryrun", "name": _hlo_id(c), "arch": c[0], "shape": c[1],
            "mesh": list(c[2]), "axes": list(AXES[len(c[2])]), "batch": HB, "seq": HT}
           for c in HLO_CASES]
    np.savez(tmp / "in.npz", job=json.dumps(job))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, str(ROOT / "tests" / "_jax_mesh_ref.py"),
                            str(tmp / "in.npz"), str(tmp / "out.npz"), "8"],
                           env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def ranks(dims):
        d, m = dims
        tasks = [{"name": arch, "mesh": [d, m], "arch": arch, "kind": kind,
                  "batch": RB, "seq": RT}
                 for arch, kind in RANK_STEPS if kind != "decode"]
        return run_ranks(_torch_ranks.dryrun_ledgers, d * m, tmp / f"rdv{d}{m}",
                         device="cpu", args=(tasks,), timeout=150)

    try:
        with ThreadPoolExecutor(len(RANK_MESHES)) as pool:
            port = dict(zip(RANK_MESHES, pool.map(ranks, RANK_MESHES)))
        _, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err[-3000:]
    return {"ref": dict(np.load(tmp / "out.npz")), "ranks": port}


@contextmanager
def recorded_calls():
    """Every collective a ``LocalMesh`` runs meanwhile: (op, dtype, result
    bytes, group size, axes)."""
    calls = []
    run = port_mesh.LocalMesh._run

    def rec(self, name, fn, x, out_shape, axes):
        out = run(self, name, fn, x, out_shape, axes)
        calls.append((name, x.dtype, out.numel() * out.element_size(), self.size(axes),
                      self._axes(axes)))
        return out

    port_mesh.LocalMesh._run = rec
    try:
        yield calls
    finally:
        port_mesh.LocalMesh._run = run


def count(arch, shape, mesh, b, s, memo=None):
    cell = cells.build_cell(arch, shape, mesh, cfg=get_smoke_config(arch), batch=b, seq=s)
    return analyze_step(cell.fn, cell.args, memo=memo, mesh=mesh, host=cell.host)


# ---------------------------------------------------------------------------
# meta against real ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,kind", RANK_STEPS, ids=[f"{a}-{k}" for a, k in RANK_STEPS])
@pytest.mark.parametrize("dims", RANK_MESHES, ids=["2x2", "1x4"])
def test_meta_ledger_equals_every_real_rank(runs, dims, arch, kind):
    d, m = dims
    got = []
    for r in range(d * m):
        mesh = make_local_mesh(d, m, device="meta", rank=r)
        count(arch, SHAPE_OF[kind], mesh, RB, RT)
        meta = {op: {k: led[k] for k in _torch_ranks.LEDGER_KEYS}
                for op, led in mesh.ledger.items()}
        real = runs["ranks"][dims][r][f"{arch}/{kind}"]
        assert meta == real, (r, meta, real)
        got.append(meta)
    ops = {"train": {"all_gather", "reduce_scatter", "all_reduce"},
           "prefill": {"all_gather", "reduce_scatter"},
           "decode": {"all_gather", "all_reduce"}}[kind]
    if arch.startswith("deepseek"):
        ops = ops | {"all_to_all"}
    assert set(got[0]) == ops
    # a (d, m) mesh of 4 cards lies in one node of 8: every ring on NVLink
    assert all(led["ring_bytes_nic"] == 0 and led["ring_bytes_nvlink"] == led["ring_bytes"] > 0
               for g in got for led in g.values())


# ---------------------------------------------------------------------------
# against the reference's compiled cells
# ---------------------------------------------------------------------------

_DT = {torch.bfloat16: "f32", torch.float32: "f32", torch.int32: "s32", torch.float64: "f64"}


def named_items(arch, shape, dims, b, s):
    """The port's count less the reference's, item by item (module
    docstring): flops, and ring bytes and tensors by ``op|dtype``."""
    cfg = get_smoke_config(arch)
    sizes = dict(zip(AXES[len(dims)], dims))
    M = sizes["model"]
    ba = batch_axes(meta_mesh(sizes), b) or ()
    nb = int(np.prod([sizes[a] for a in ba]))
    bl = b // nb
    kind = cells.SHAPES[shape]["kind"]
    flops, nbytes, tensors = 0, Counter(), Counter()
    if kind != "train" and M > 1:           # greedy_token's one float64 gather
        nbytes["all-gather|f64"] += ring_bytes("all_gather", 16 * M * bl, M)
        tensors["all-gather|f64"] += 1
        for dt in ("f32", "s32"):
            nbytes[f"all-gather|{dt}"] -= ring_bytes("all_gather", 4 * M * bl, M)
            tensors[f"all-gather|{dt}"] -= 1
    if kind != "train" and nb > 1:          # the served token, gathered
        nbytes["all-gather|s32"] += ring_bytes("all_gather", 4 * b, nb)
        tensors["all-gather|s32"] += 1
    if kind == "train":
        if M > 1:                           # ce_loss's recompute
            nbytes["all-reduce|f32"] += 3 * ring_bytes("all_reduce", 4 * bl * s, M)
            tensors["all-reduce|f32"] += 3
        flops += 2 * bl * s * cfg.d_model * backbone.vocab_pad(cfg) // M
        tensors["all-reduce|f32"] -= 1      # [ce, aux] in one all-reduce
    if cfg.n_experts and kind == "train":
        W, E, k = sizes["data"] * M, cfg.n_experts, cfg.moe_top_k
        L = cfg.n_layers - cfg.n_dense_layers
        ar = lambda n: ring_bytes("all_reduce", n, W)  # noqa: E731
        nbytes["all-reduce|f32"] += 3 * L * ar(4 * (1 + 2 * E)) - 4 * L * ar(4 * E) - ar(4)
        tensors["all-reduce|f32"] += 3 * L - (4 * L + 1)
        tensors["all-to-all|f32"] -= (W - 1) * 6 * L       # 6 buffer all-to-alls a layer
        tensors["all-to-all|s32"] -= (W - 1) * 2 * L       # 2 of expert ids
        nt = bl * s // M
        cap = math.ceil(nt * k / W * cfg.capacity_factor) + 4
        rows, _, _ = ffn.meta_dispatch_counts([nt] * M, k, E, pad_to(E, W) // W, W, cap, 0)
        flops -= 4 * L * 3 * 2 * cfg.d_model * cfg.moe_d_ff * sum(W * cap - r for r in rows)
    if cfg.family == "encdec" and kind == "prefill" and M > 1:
        kvd = cfg.n_kv_heads * cfg.resolved_head_dim
        flops += cfg.n_layers * 2 * 2 * bl * (cells.ENC_LEN // M) * cfg.d_model * kvd
    return flops, nbytes, tensors


@pytest.mark.parametrize("case", HLO_CASES, ids=[_hlo_id(c) for c in HLO_CASES])
def test_counts_equal_the_reference_compiled_cell_but_for_named_items(runs, case):
    arch, shape, dims = case
    ref = {k.split("/", 1)[1]: float(v) for k, v in runs["ref"].items()
           if k.startswith(_hlo_id(case) + "/")}
    mesh = meta_mesh(dict(zip(AXES[len(dims)], dims)))
    with recorded_calls() as calls:
        got = count(arch, shape, mesh, HB, HT)
    nbytes, tensors = Counter(), Counter()
    for op, dtype, out_bytes, n, _ in calls:
        key = f"{op.replace('_', '-')}|{_DT[dtype]}"
        # XLA's CPU backend carries a bfloat16 collective in float32
        nbytes[key] += ring_bytes(op, out_bytes * (2 if dtype == torch.bfloat16 else 1), n)
        tensors[key] += 1
    flops, dbytes, dtensors = named_items(arch, shape, dims, HB, HT)
    assert got["flops_per_device"] == ref["flops"] + flops
    assert got["unresolved_dots"] == ref["unresolved"] == 0
    keys = {k.split("/")[1] for k in ref if k.startswith("dtype/") and "tensors" not in k}
    for key in set(nbytes) | set(dbytes) | keys:
        assert nbytes[key] == ref.get(f"dtype/{key}", 0) + dbytes[key], key
        assert tensors[key] == ref.get(f"dtype/{key}|tensors", 0) + dtensors[key], key
    # ops: as many calls where XLA combines none (sequence collectives, all-to-alls)
    assert got["collective_op_counts"].get("all-to-all", 0) == ref.get("calls/all-to-all", 0)
    assert got["collective_op_counts"]["all-gather"] == ref["calls/all-gather"] + sum(
        v for k, v in dtensors.items() if k.startswith("all-gather"))
    if "calls/reduce-scatter" in ref:
        assert got["collective_op_counts"]["reduce-scatter"] == ref["calls/reduce-scatter"]


# ---------------------------------------------------------------------------
# uniform SPMD
# ---------------------------------------------------------------------------

UNIFORM = [("qwen2-1.5b", "train_4k"), ("qwen2-1.5b", "prefill_32k"),
           ("qwen2-1.5b", "decode_32k"), ("deepseek-v3-671b", "train_4k"),
           ("deepseek-v3-671b", "decode_32k"), ("whisper-tiny", "decode_32k")]
SAME = ("flops_per_device", "collective_per_device", "collective_by_op_per_device",
        "collective_op_counts", "collective_by_link_per_device", "argument_bytes_per_device",
        "peak_bytes_per_device")


def owner_write_bytes(arch, mesh, b, s):
    """What the decode position's owner writes: one position of every
    self cache sharded over 'model' (K, V or the latent; not the cross
    cache, which decode reads only), at 2 × its bytes."""
    cfg = get_smoke_config(arch)
    total = 0

    def walk(spec, shards, cross=False):
        nonlocal total
        if isinstance(spec, dict):
            for key in spec:
                walk(spec[key], shards[key], cross or key == "cross")
            return
        axes = list(spec.axes)
        if cross or "model" not in axes:
            return
        at = axes.index("model")
        total += 2 * shards.numel() // shards.shape[at] * shards.element_size()

    spec = cache_spec(cfg, mesh, b, s, enc_len=cells.ENC_LEN)
    walk(spec, abstract_shards(spec, mesh))
    return total


@pytest.mark.parametrize("arch,shape", UNIFORM, ids=[f"{a}-{s}" for a, s in UNIFORM])
@pytest.mark.parametrize("dims", [(2, 2), (2, 2, 2)], ids=["2x2", "2x2x2"])
def test_every_rank_counts_as_rank_0_but_for_named_items(dims, arch, shape, monkeypatch):
    sizes = dict(zip(AXES[len(dims)], dims))
    memo = {}
    world, M = int(np.prod(dims)), sizes["model"]
    base = [count(arch, shape, meta_mesh(sizes, r), HB, HT, memo) for r in range(world)]
    cfg = get_smoke_config(arch)
    moe_decode = bool(cfg.n_experts) and shape == "decode_32k"
    if moe_decode:
        # (b): the received rows' products, pinned; then every rank gets rank 0's rows
        W, k, E = sizes["data"] * M, cfg.moe_top_k, cfg.n_experts
        bl = HB // int(np.prod([sizes[a] for a in batch_axes(meta_mesh(sizes), HB)]))
        owned = [len(range(m, bl, M)) for m in range(M)]
        cap = math.ceil(bl * k / W * cfg.capacity_factor) + 4
        L = cfg.n_layers - cfg.n_dense_layers
        got_rows = [sum(ffn.meta_dispatch_counts(owned, k, E, pad_to(E, W) // W, W, cap,
                                                 r % W)[0]) for r in range(world)]
        for r in range(world):
            assert base[r]["flops_per_device"] - base[0]["flops_per_device"] == (
                L * 3 * 2 * cfg.d_model * cfg.moe_d_ff * (got_rows[r] - got_rows[0]))
        assert len(set(got_rows)) > 1                      # the item is real here
        counts0 = ffn.meta_dispatch_counts
        monkeypatch.setattr(ffn, "meta_dispatch_counts",
                            lambda *a: counts0(*a[:-1], 0)[:1] + counts0(*a)[1:])
        base = [count(arch, shape, meta_mesh(sizes, r), HB, HT, memo) for r in range(world)]
    owner = (owner_write_bytes(arch, meta_mesh(sizes), HB, HT)
             if shape == "decode_32k" else 0)
    for r in range(world):
        mesh = meta_mesh(sizes, r)
        for key in SAME + ("moe_dispatch",) * (not moe_decode):
            assert base[r][key] == base[0][key], (r, key)
        last = mesh.index("model") == M - 1
        assert base[r]["bytes_per_device"] - base[0]["bytes_per_device"] == owner * last, r
    assert owner == 0 or any(meta_mesh(sizes, r).index("model") == M - 1
                             for r in range(world))


# ---------------------------------------------------------------------------
# the production cells, at full width
# ---------------------------------------------------------------------------


def test_qwen2_train_on_the_pod_mesh(tmp_path):
    rec = dryrun.run_cell("qwen2-1.5b", "train_4k", multi_pod=False, out_dir=tmp_path,
                          opt_overrides={})
    assert (rec["status"], rec["mesh"], rec["chips"]) == ("ok", "pod", 256)
    hlo, ro = rec["hlo"], rec["roofline"]
    assert set(hlo["collective_by_op_per_device"]) == {"all-gather", "reduce-scatter",
                                                       "all-reduce"}
    assert all(v > 0 for v in hlo["collective_by_op_per_device"].values())
    # every group of the (16, 16) mesh spans nodes: the whole term at the NIC's rate
    assert set(hlo["collective_by_link_per_device"]) == {"nic"}
    assert ro["collective_s"] == pytest.approx(
        sum(hlo["collective_by_op_per_device"].values()) / NIC_BYTES_PER_S, rel=1e-12)
    assert ro["collective_s"] > 0 and rec["memory"]["fits_h100"] is True
    assert hlo["collective_global"] == pytest.approx(
        256 * sum(hlo["collective_by_op_per_device"].values()), rel=1e-12)


def test_deepseek_v3_train_on_the_multipod_mesh(tmp_path):
    """512 ranks: the gradients of leaves replicated over ('pod', 'data')
    are all-reduced across both pods; the experts' all-to-alls stay in a
    pod, over ('data', 'model')."""
    with recorded_calls() as calls:
        rec = dryrun.run_cell("deepseek-v3-671b", "train_4k", multi_pod=True,
                              out_dir=tmp_path, opt_overrides={})
    assert (rec["status"], rec["mesh"], rec["chips"]) == ("ok", "multipod", 512)
    by_op = rec["hlo"]["collective_by_op_per_device"]
    assert set(by_op) == {"all-gather", "reduce-scatter", "all-reduce", "all-to-all"}
    assert all(v > 0 for v in by_op.values()) and rec["roofline"]["collective_s"] > 0
    assert any(op == "all_reduce" and "pod" in axes for op, *_, axes in calls)
    assert {axes for op, *_, axes in calls if op == "all_to_all"} == {("data", "model")}
    assert rec["meta"]["moe_dispatch"]["dropped"] == 0          # 256 experts on 256 ranks
    # 671 B parameters' state over 512 cards still overfills one card's 80 GiB
    assert rec["memory"]["fits_h100"] is False


def test_deepseek_v2_prefill_drops_a_fifth_and_decode_none(tmp_path):
    """160 experts on 256 ranks: a balanced router sends each real expert
    N·k/160 pairs a sender against ``cap = ceil(N·k/256 · 1.25) + 4``,
    about 1.28× over, so about a fifth of the pairs drop; a decode step's
    few owned rows a rank drop none."""
    rec = dryrun.run_cell("deepseek-v2-236b", "prefill_32k", multi_pod=False, out_dir=tmp_path,
                          opt_overrides={})
    disp = rec["meta"]["moe_dispatch"]
    layers = 59                                        # 60 layers, the first dense
    nt = 32 // 16 * 32_768 // 16                       # a rank's rows: 2 × 2 048
    cap = math.ceil(nt * 6 / 256 * 1.25) + 4           # 124
    # a sender's 24 576 pairs over 160 experts: 154 to 96 of them, 153 to 64
    dropped = sum(max(0, n - cap) for n in ffn.balanced_routes(nt * 6, 160))
    assert (cap, dropped) == (124, 96 * 30 + 64 * 29)
    assert disp == {"calls": layers, "pairs": layers * nt * 6, "dropped": layers * dropped}
    assert 0.19 < disp["dropped"] / disp["pairs"] < 0.2
    dec = dryrun.run_cell("deepseek-v2-236b", "decode_32k", multi_pod=False, out_dir=tmp_path,
                          opt_overrides={})
    assert dec["meta"]["moe_dispatch"]["dropped"] == 0
    assert dec["meta"]["moe_dispatch"]["pairs"] == layers * 6     # one owned row on rank 0


# ---------------------------------------------------------------------------
# one dense layer by hand
# ---------------------------------------------------------------------------


def test_ring_bytes_of_one_dense_layer_by_hand():
    """qwen2-1.5b's smoke block (d 128) on rank 0 of a (1, 4) meta mesh,
    forward and backward over a (2, 16 / 4, d) bfloat16 chunk: the
    attention's and the MLP's all-gather of the sequence and
    reduce-scatter back (4), and in the backward their transposes (4).
    S = 2 · 16 · 128 · 2 = 8 192 bytes gathered: an all-gather moves
    S · 3/4, a reduce-scatter of S/4 moves S/4 · 3, 6 144 each."""
    cfg = get_smoke_config("qwen2-1.5b")
    mesh = make_local_mesh(1, 4, device="meta")
    ctx = mesh_ctx(mesh)
    p = abstract_shards(backbone.block_spec(cfg, ctx, "attn"), mesh)
    leaves = [t.requires_grad_() for t in _leaves(p)]
    x = torch.empty(2, 4, cfg.d_model, dtype=torch.bfloat16, device="meta", requires_grad=True)
    block = backbone.make_block_fn(cfg, ctx, "attn")

    def step(p, x):
        y = block(p, x)
        return torch.autograd.grad(y.float().sum(), leaves + [x])

    got = analyze_step(step, (p, x), mesh=mesh)
    S = 2 * 16 * cfg.d_model * 2
    assert got["collective_op_counts"] == {"all-gather": 4, "reduce-scatter": 4}
    assert got["collective_by_op_per_device"] == {"all-gather": 4 * S * 3 / 4,
                                                  "reduce-scatter": 4 * S / 4 * 3}
    assert got["collective_per_device"] == 8 * 6144
    assert got["collective_by_link_per_device"] == {"nvlink": 8 * 6144}
    assert got["collective_global"] == 4 * 8 * 6144


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]
