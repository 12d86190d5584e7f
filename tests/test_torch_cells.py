"""The dry-run grid, ported to ``repro_torch.launch.cells``, held against
the JAX package's ``repro.launch.cells``.

Everything here is shapes, dtypes and names, so every comparison is exact:
``SHAPES``, ``ENC_LEN``, ``cell_status``, ``default_opt_cfg``, and for every
runnable cell the meta arguments of ``build_cell`` against the reference's
``ShapeDtypeStruct``s on ``make_local_mesh(1, 1)``, leaf for leaf: the
parameters, the optimizer state, the batch and the caches.  The deliberate
differences are named and pinned:

* a decode cache's ``"len"`` is a host int (the cell's last position,
  ``seq - 1``; a cross cache's the encoder length), one a group, where the
  reference's is an int32 array (a scalar, or one entry a stacked layer);
* ``meta`` adds ``decode_position`` (decode cells) and ``moe_routes`` and
  ``capacity_factor`` (MoE cells), and its mesh is one card.

Also the repairs the cells needed: ``ServeBundle``'s ``param_spec``,
``cache_pspec`` and ``batch_ax``; ``TrainBundle.abstract_args``;
``BLOCK_SKIP_DEFAULT``; ``_moe_core`` on meta tensors, whose balanced
routes are held to an analytic count (exact, in operations).
"""
import dataclasses

import _torch_ranks

import jax
import numpy as np
import pytest
import torch

import repro.launch.cells as ref_cells
import repro.models.layers as ref_layers
from repro.launch.mesh import make_local_mesh as ref_mesh
from repro.serve.engine import make_serve_fns as ref_make_serve_fns
import repro_torch.launch.cells as cells
import repro_torch.models.layers as layers
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import ffn
from repro_torch.models.backbone import model_spec
from repro_torch.launch.ranks import run_ranks
from repro_torch.models.spec import abstract_shards
from repro_torch.roofline import StepCounter, analyze_step
from repro_torch.serve.engine import make_serve_fns
from repro_torch.train.step import make_train_step, mesh_ctx

META = make_local_mesh(device="meta")
RUNNABLE = [c for c in cells.all_cells() if cells.cell_status(*c)[0]]


def flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, path + (k,)))
        return out
    return {"/".join(path): tree}


def sig(x):
    """(shape, dtype name) of a meta tensor, a ShapeDtypeStruct or a P."""
    dt = x.dtype
    name = str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) else np.dtype(dt).name
    return tuple(x.shape), name


def test_grid_constants_equal_the_reference():
    assert cells.SHAPES == ref_cells.SHAPES
    assert cells.ENC_LEN == ref_cells.ENC_LEN
    assert list(cells.all_cells()) == list(ref_cells.all_cells())
    assert len(list(cells.all_cells())) == 40 and len(RUNNABLE) == 32


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_status_equals_the_reference(arch):
    for shape in cells.SHAPES:
        assert cells.cell_status(arch, shape) == ref_cells.cell_status(arch, shape)


def test_default_opt_cfg_equals_the_reference():
    for over in ({}, {"zero1": True, "master_fp32": False}, {"warmup": 7}):
        port = dataclasses.asdict(cells.default_opt_cfg("qwen2-1.5b", **over))
        ref = dataclasses.asdict(ref_cells.default_opt_cfg("qwen2-1.5b", **over))
        assert str(port.pop("state_dtype")).removeprefix("torch.") == \
            np.dtype(ref.pop("state_dtype")).name
        assert port == ref


def _len_paths(tree):
    return [k for k in flat(tree) if k.endswith("len")]


@pytest.mark.parametrize("arch,shape", RUNNABLE, ids=[f"{a}-{s}" for a, s in RUNNABLE])
def test_meta_arguments_equal_the_reference_leaf_for_leaf(arch, shape):
    port = cells.build_cell(arch, shape, META)
    ref = ref_cells.build_cell(arch, shape, ref_mesh(1, 1))
    assert (port.arch, port.shape, port.kind) == (ref.arch, ref.shape, ref.kind)
    assert len(port.args) == len(ref.args)
    seq = cells.SHAPES[shape]["seq"]
    for pa, ra in zip(port.args, ref.args):
        if not isinstance(ra, dict):                          # decode tokens
            assert pa.is_meta and sig(pa) == sig(ra)
            continue
        fp, fr = flat(pa), flat(ra)
        assert set(fp) == set(fr)
        for k in fr:
            if k.endswith("len"):                             # the pinned difference
                shape, dtype = sig(fr[k])             # a scalar, or one a stacked layer
                assert dtype == "int32" and len(shape) <= 1, k
                assert fp[k] == (cells.ENC_LEN if "cross" in k else seq - 1), k
                continue
            assert fp[k].is_meta and sig(fp[k]) == sig(fr[k]), k
    extra = {"decode_position": seq - 1} if port.kind == "decode" else {}
    cfg = cells.get_config(arch)
    if cfg.n_experts:
        extra.update(moe_routes="balanced", capacity_factor=cfg.capacity_factor)
    assert port.meta == {**ref.meta, "mesh": {"data": 1, "model": 1}, **extra}
    if port.kind == "decode":
        assert _len_paths(port.args[1])


def test_build_cell_takes_a_config_batch_and_sequence():
    cfg = get_smoke_config("qwen2-1.5b")
    cell = cells.build_cell("qwen2-1.5b", "decode_32k", META, cfg=cfg, batch=3, seq=40)
    params, caches, toks = cell.args
    assert tuple(toks.shape) == (3, 1) and cell.meta["decode_position"] == 39
    assert tuple(caches["g0"]["k"].shape) == (cfg.n_layers, 3, cfg.n_kv_heads, 40,
                                              cfg.resolved_head_dim)
    assert tuple(params["embed"]["tok"].shape)[1] == cfg.d_model


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "whisper-tiny", "deepseek-v2-236b",
                                  "recurrentgemma-2b"])
def test_serve_bundle_carries_the_reference_specs(arch):
    cfg = get_smoke_config(arch)
    import repro.configs as ref_configs
    ref = ref_make_serve_fns(ref_configs.get_smoke_config(arch), ref_mesh(1, 1), batch=2,
                             max_len=32, enc_len=24)
    port = make_serve_fns(cfg, make_local_mesh(device="cpu"), batch=2, max_len=32, enc_len=24)
    for name in ("param_spec", "cache_pspec"):
        fp, fr = flat(getattr(port, name)), flat(getattr(ref, name))
        assert set(fp) == set(fr)
        for k in fr:
            assert sig(fp[k]) == sig(fr[k]) and fp[k].axes == fr[k].axes, (name, k)
    assert port.batch_ax == ref.batch_ax == ("data",)
    assert flat(port.param_spec) == flat(model_spec(cfg, port.ctx))


def test_train_bundle_abstract_args_are_meta_and_allocate_nothing():
    cfg = get_smoke_config("qwen2-1.5b")
    ocfg = cells.default_opt_cfg("qwen2-1.5b")
    bundle = make_train_step(cfg, META, ocfg, batch=2)
    params, opt, batch = bundle.abstract_args({"tokens": ((2, 16), torch.int32),
                                               "labels": ((2, 16), torch.int32)})
    leaves = list(flat(params).values()) + list(flat(opt).values()) + list(batch.values())
    assert leaves and all(t.is_meta for t in leaves)
    assert sig(batch["tokens"]) == ((2, 16), "int32")
    assert set(flat(params)) == set(flat(bundle.param_spec))
    assert set(flat(opt)) == set(flat(bundle.opt_spec))


def test_block_skip_default_keeps_the_output_and_false_runs_the_dense_grid():
    assert layers.BLOCK_SKIP_DEFAULT == ref_layers.BLOCK_SKIP_DEFAULT == [True]
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 96, 8, generator=g) for _ in range(3))
    kvm = torch.tensor([0, 1])

    def run(**kw):
        return layers.blockwise_attention(q, k, v, kvm, causal=True, q_chunk=32, k_chunk=32,
                                          **kw)

    def flops(**kw):
        mode = StepCounter()
        with mode:
            run(**kw)
        return mode.flops

    pair = 2 * 2 * 32 * 32 * 8 * 2            # two products of one chunk pair
    assert torch.equal(run(), run(block_skip=True))
    assert flops() == flops(block_skip=True) == 6 * pair      # nq (nq + 1) / 2 pairs
    try:
        layers.BLOCK_SKIP_DEFAULT[0] = False
        dense = run()
        assert flops() == flops(block_skip=False) == 9 * pair  # the dense grid, nq · nk
    finally:
        layers.BLOCK_SKIP_DEFAULT[0] = True
    torch.testing.assert_close(dense, run(), rtol=1e-6, atol=1e-6)


def test_balanced_routes():
    assert ffn.balanced_routes(10, 4) == [3, 3, 2, 2]
    assert ffn.balanced_routes(8, 8) == [1] * 8
    assert ffn.balanced_routes(3, 5) == [1, 1, 1, 0, 0]


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "deepseek-v3-671b"])
def test_moe_on_meta_counts_the_balanced_routes(arch):
    """``moe_apply`` on meta tensors: each expert's three GEMMs take its
    balanced share of the N · k routed rows, so the matrix-product count is
    the router's 2 N d E, the experts' 6 N k d f and the shared experts'
    6 N d (s f), to the unit; the per-expert row counts are the split."""
    cfg = get_smoke_config(arch)
    ctx = mesh_ctx(META)
    from repro_torch.models.spec import abstract_params
    p = abstract_params(ffn.moe_spec(cfg, ctx))
    B, T = 3, 7                                   # N k = 42 rows over 8 experts: 6 or 5
    x = torch.empty(B, T, cfg.d_model, dtype=torch.bfloat16, device="meta")
    N, d, E, k, f = B * T, cfg.d_model, cfg.n_experts, cfg.moe_top_k, cfg.moe_d_ff
    rows = []

    class Rows(StepCounter):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.mm.default and args[1].shape == (d, f):
                rows.append(args[0].shape[0])
            return super().__torch_dispatch__(func, types, args, kwargs)

    mode = Rows()
    with mode:
        y, aux = ffn.moe_apply(p, x, ctx, cfg, 1)
    assert y.shape == x.shape and aux.shape == ()
    want = 2 * N * d * E + 6 * N * k * d * f + 6 * N * d * cfg.n_shared_experts * f
    assert mode.flops == want
    per_expert = ffn.balanced_routes(N * k, E)
    shared = [N, N] if cfg.n_shared_experts * f == f else []    # same weight shape
    assert rows == [n for n in per_expert for _ in (0, 1) if n] + shared  # gate, up


def test_moe_off_meta_still_routes_by_the_router_on_one_rank_and_above(tmp_path):
    """On a computing device the counts come from the router (bincount), not
    the balanced split: a skewed router sends every row to expert 0.  Above
    one rank too (gloo ranks of a (1, 2) mesh, deepseek-v2's 8 experts 4 a
    rank, the router's logits 2, 1, 0, …): each rank's 10 rows go to experts 0
    and 1, both on rank 0; a destination holds ``cap = ceil(10 · 2 / 2
    · 1.25) + 4 = 17`` of a sender's 20 pairs, the first 17 in (token,
    slot) order, 9 of expert 0's and 8 of expert 1's; so rank 0's expert 0
    takes 18 rows, its expert 1 16, rank 1's experts none, and 3 pairs a
    rank drop.  The meta branch on a (1, 2) meta mesh takes balanced routes
    instead: a sender's 20 pairs 3, 3, 3, 3, 2, 2, 2, 2 over the 8
    experts, so each of rank 0's 4 experts takes 2 · 3 rows, nothing
    dropped."""
    cfg = get_smoke_config("deepseek-v2-236b")
    ctx = mesh_ctx(make_local_mesh(device="cpu"))
    from repro_torch.models.spec import init_params
    p = init_params(ffn.moe_spec(cfg, ctx), torch.Generator().manual_seed(0), "cpu")
    p["router"].zero_()
    p["router"][:, 0] = 10.0
    x = torch.ones(2, 5, cfg.d_model)
    rows = []

    class Rows(StepCounter):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.mm.default and args[1].shape == (cfg.d_model,
                                                                       cfg.moe_d_ff):
                rows.append(args[0].shape[0])
            return super().__torch_dispatch__(func, types, args, kwargs)

    with Rows():
        ffn.moe_apply(p, x, ctx, cfg, 1)
    # every token the same: all 10 go to expert 0 and to one other (top-2),
    # then the shared expert's 10; balanced routes would give 3 or 2 each
    assert rows == [10] * 6
    ranks = run_ranks(_torch_ranks.skewed_router, 2, tmp_path, device="cpu",
                      args=("deepseek-v2-236b",), timeout=120)
    assert ranks[0]["rows"] == [18, 18, 16, 16] and ranks[1]["rows"] == []
    assert [r["dispatch"] for r in ranks] == [{"calls": 1, "pairs": 20, "dropped": 3}] * 2
    mesh = make_local_mesh(1, 2, device="meta")
    mctx = mesh_ctx(mesh)
    meta_p = abstract_shards(ffn.moe_spec(cfg, mctx), mesh)
    rows.clear()
    with Rows():
        ffn.moe_apply(meta_p, torch.empty(2, 5, cfg.d_model, device="meta"), mctx, cfg, 1)
    assert rows == [6] * 8 and mesh.dispatch == {"calls": 1, "pairs": 20, "dropped": 0}


def test_capacity_factor_is_recorded_and_changes_no_count():
    cfg = get_smoke_config("deepseek-v2-236b")
    counts = []
    for cf in (None, 0.5, 4.0):
        cell = cells.build_cell("deepseek-v2-236b", "prefill_32k", META, cfg=cfg, batch=2,
                                seq=32, capacity_factor=cf)
        assert cell.meta["capacity_factor"] == (cf or cfg.capacity_factor)
        r = analyze_step(cell.fn, cell.args)
        counts.append((r["flops_per_device"], r["bytes_per_device"],
                       r["peak_bytes_per_device"]))
    assert counts[0] == counts[1] == counts[2]
