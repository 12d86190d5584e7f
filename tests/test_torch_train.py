"""The training path, ported to ``repro_torch`` (``models.backbone.ce_loss``
and ``forward(with_aux=True)``, ``train.step``, ``optim``), held against the
JAX package on the same inputs and the same carried-over state.

The port runs on ``device="cpu"`` in float32 at smoke width; the
reference's functions run jitted inside a 1x1 ``jax.shard_map``
(``_torch_models.on_mesh``) and its ``make_train_step`` on a 1x1 mesh.
Tolerances, stated before the first run:

* loss, aux and the gradient norm: relative 1e-5 (float32 sums in other
  orders);
* every gradient leaf: ``max |g_port - g_ref| <= 1e-4 * max |g_ref|`` over
  the leaf (float32 matmuls in other orders, through a few layers and
  their backward);
* three ``bundle.step``s from one carried state (``carried_state``: step 10,
  random m, v well above the squared gradients so the Adam update is a
  smooth function of the gradient): parameters and master within 1e-6
  absolute, m and v within 1e-4 of the leaf's largest entry, metrics as
  above, the learning rate within 1e-6 relative;
* int8 states: ``log10`` in XLA and in torch may part by an ulp, so a code
  may part by one where its pre-round value lies at a .5 boundary
  (``test_torch_optim.py`` holds that rule on one quantization).  Across
  steps such a flip carries on: the next moment ``0.9 m + 0.1 g`` may
  nearly cancel, and then the entry's code parts by more than one (the
  first run of this test: 11 codes of 723 968 after one step, all by one;
  22 after three, by up to 2-3).  So after three steps at most 1e-4 of the
  codes differ, a scale (its block's absmax) within 1e-5 relative except
  at most 1e-3 of them, which are within 15 % (one level of m), and the
  parameters and master are within 1e-6 except at most 1e-4 of the
  entries, which are within 3 learning rates (three steps' whole update);
* compression: the selected sets equal (nothing at the smoke leaves ties
  near the k-th magnitude within float32 noise), so the error buffers are
  held as m and v are.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_models import draw_tree, leaves, on_mesh, t, to_np

import repro.configs as ref_configs
import repro.models.backbone as ref_bb
import repro.optim as ref_optim
import repro.optim.compression as ref_comp
from repro.launch.mesh import make_local_mesh as ref_mesh
from repro.train import make_train_step as ref_make_train_step
from repro.train.step import batch_pspec_tree as ref_batch_pspec_tree
from repro.train.step import batch_shapes as ref_batch_shapes
from repro.train.step import mesh_ctx as ref_mesh_ctx
import repro_torch.configs as port_configs
import repro_torch.models.backbone as port_bb
import repro_torch.models.layers as port_layers
import repro_torch.optim as port_optim
import repro_torch.optim.compression as port_comp
from repro_torch.launch.mesh import make_local_mesh as port_mesh
from repro_torch.models.spec import params_from_numpy
from repro_torch.train import batch_pspec_tree, batch_shapes
from repro_torch.train import make_train_step as port_make_train_step

PCTX = port_layers.MeshCtx()
AUX_COEF = 1e-3
ARCHS = ref_configs.ARCH_IDS


@pytest.fixture(scope="module")
def jmesh():
    mesh = ref_mesh(1, 1)
    return mesh, ref_mesh_ctx(mesh)


def smoke(arch):
    """Both packages' smoke config; recurrentgemma at 8 layers so its
    unscanned groups run."""
    r, p = ref_configs.get_smoke_config(arch), port_configs.get_smoke_config(arch)
    if arch == "recurrentgemma-2b":
        r, p = r.scaled(n_layers=8), p.scaled(n_layers=8)
    return r, p


def draw_batch(cfg, rng, B=2, T=48, enc_len=24):
    """tokens and labels (a few labels -1, not counted), with the frames of
    an encoder-decoder and the patch embeddings of a patch frontend (its
    first positions -1)."""
    toks = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    labels[:, :3] = -1
    batch = {"tokens": toks, "labels": labels}
    if cfg.family == "encdec":
        batch["enc"] = rng.standard_normal((B, enc_len, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "patch_stub":
        toks[:, :cfg.n_frontend_tokens] = -1
        batch["frontend"] = (0.02 * rng.standard_normal((B, T, cfg.d_model))).astype(np.float32)
    return batch


def ref_value_and_grad(jmesh, rcfg, arrays, batch):
    mesh, ctx = jmesh

    def objective(params, b):
        x, aux = ref_bb.forward(params, b["tokens"], ctx, rcfg, ep_data_size=1,
                                frontend_sp=b.get("frontend"), enc_embeds_sp=b.get("enc"))
        ce = ref_bb.ce_loss(params["embed"], x, b["labels"], ctx, rcfg)
        return ce + AUX_COEF * aux, (ce, aux)

    fn = lambda p, b: jax.value_and_grad(objective, has_aux=True)(p, b)  # noqa: E731
    jparams = jax.tree.map(jnp.asarray, arrays)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (_, (ce, aux)), grads = on_mesh(jmesh, fn, jparams, jbatch)
    return float(ce), float(aux), grads


def port_value_and_grad(pcfg, arrays, batch, remat=True):
    params = params_from_numpy(arrays, "cpu")
    flat = [v for _, v in leaves(params)]
    for x in flat:
        x.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    x, aux = port_bb.forward(params, tb["tokens"], PCTX, pcfg, frontend=tb.get("frontend"),
                             enc_embeds=tb.get("enc"), remat=remat, with_aux=True)
    ce = port_bb.ce_loss(params["embed"], x, tb["labels"], PCTX, pcfg)
    gs = torch.autograd.grad(ce + AUX_COEF * aux, flat, allow_unused=True)
    grads = {path: (torch.zeros_like(v) if g is None else g)
             for (path, v), g in zip(leaves(params), gs)}
    return float(ce.detach()), float(aux.detach()), grads


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def assert_leaf_close(got, want, rel, name):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= rel * scale + 1e-12, (name, err, scale)


# ---------------------------------------------------------------------------
# the objective: loss, aux and every gradient leaf, all ten configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_aux_and_every_gradient_match_reference(jmesh, arch):
    rcfg, pcfg = smoke(arch)
    rng = np.random.default_rng(7)
    arrays = draw_tree(ref_bb.model_spec(rcfg, jmesh[1]), rng)
    batch = draw_batch(rcfg, rng)
    ce_r, aux_r, g_r = ref_value_and_grad(jmesh, rcfg, arrays, batch)
    ce_p, aux_p, g_p = port_value_and_grad(pcfg, arrays, batch)
    assert np.isfinite(ce_p) and abs(ce_p - ce_r) <= 1e-5 * abs(ce_r), (ce_p, ce_r)
    assert abs(aux_p - aux_r) <= 1e-5 * max(abs(aux_r), 1e-30), (aux_p, aux_r)
    if rcfg.n_experts:
        assert aux_r > 0
    ref_paths = [p for p, _ in leaves(arrays)]
    assert sorted(ref_paths) == sorted(g_p)
    for path in ref_paths:
        assert_leaf_close(g_p[path], _get(g_r, path), 1e-4, "/".join(path))


# the reference's (pod, data, model) meshes by their axes alone: both
# packages' batch_axes read only ``axis_names`` and ``shape``
BATCH_MESHES = [
    (("data", "model"), {"data": 1, "model": 1}, 2),
    (("pod", "data", "model"), {"pod": 2, "data": 4, "model": 8}, 16),
    (("pod", "data", "model"), {"pod": 2, "data": 4, "model": 8}, 4),
    (("pod", "data", "model"), {"pod": 2, "data": 4, "model": 8}, 1),
]


def _spec(entries):
    """A spec's entries with a one-axis tuple read as its axis, as
    ``PartitionSpec`` reads it."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries)


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_and_shapes_match_reference(arch):
    rcfg, pcfg = ref_configs.get_config(arch), port_configs.get_config(arch)
    for names, shape, batch in BATCH_MESHES:
        mesh = types.SimpleNamespace(axis_names=names, shape=shape)
        ref = ref_batch_pspec_tree(rcfg, mesh, batch)
        port = batch_pspec_tree(pcfg, mesh, batch)
        assert {k: _spec(v) for k, v in port.items()} == {k: _spec(v) for k, v in ref.items()}
    ref = ref_batch_shapes(rcfg, 4, 4096, enc_len=1500)
    port = batch_shapes(pcfg, 4, 4096, enc_len=1500)
    assert {k: (s, jnp.dtype(d).name) for k, (s, d) in ref.items()} == {
        k: (s, str(d).removeprefix("torch.")) for k, (s, d) in port.items()}


def test_remat_on_and_off_give_equal_gradients():
    _, pcfg = smoke("deepseek-v2-236b")
    rng = np.random.default_rng(3)
    arrays = draw_tree(ref_bb.model_spec(ref_configs.get_smoke_config("deepseek-v2-236b"),
                                         ref_mesh_ctx(ref_mesh(1, 1))), rng)
    batch = draw_batch(pcfg, rng)
    on = port_value_and_grad(pcfg, arrays, batch, remat=True)
    off = port_value_and_grad(pcfg, arrays, batch, remat=False)
    assert on[:2] == off[:2]
    for path, g in on[2].items():
        torch.testing.assert_close(g, off[2][path], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# ce_loss: the reference leaves a sequence's tail out; the port counts it
# ---------------------------------------------------------------------------


def _plain_ce(params, x, labels, cfg):
    """Mean token cross-entropy over every valid position, in one piece."""
    logits = port_bb.vocab_logits(params["embed"], x, PCTX, cfg)
    lp = torch.log_softmax(logits.double(), -1)
    valid = labels >= 0
    nll = -torch.gather(lp, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    return float(nll[valid].mean())


def test_ce_loss_counts_the_tail_the_reference_drops(jmesh):
    """T = 600 with chunks of 512: the reference scans one whole chunk and
    leaves positions 512-599 out of its mean (ROADMAP Queue C); the port
    takes a last partial chunk.  Both numbers side by side: the port's
    equals the plain mean over all 600 positions, the reference's the
    plain mean over the first 512, and the two differ."""
    rcfg, pcfg = smoke("qwen2-1.5b")
    rng = np.random.default_rng(11)
    arrays = draw_tree(ref_bb.model_spec(rcfg, jmesh[1]), rng)
    T = 600
    x = rng.standard_normal((2, T, rcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, rcfg.vocab, (2, T)).astype(np.int32)
    labels[0, 550:] = -1
    ref = float(on_mesh(jmesh, lambda p, xx, yy: ref_bb.ce_loss(p, xx, yy, jmesh[1], rcfg),
                        jax.tree.map(jnp.asarray, arrays["embed"]), jnp.asarray(x),
                        jnp.asarray(labels)))
    params = params_from_numpy(arrays, "cpu")
    port = float(port_bb.ce_loss(params["embed"], t(x), torch.from_numpy(labels), PCTX, pcfg))
    whole = _plain_ce(params, t(x), torch.from_numpy(labels), pcfg)
    head = _plain_ce(params, t(x)[:, :512], torch.from_numpy(labels)[:, :512], pcfg)
    assert abs(port - whole) <= 1e-5 * whole, (port, whole)
    assert abs(ref - head) <= 1e-5 * head, (ref, head)
    assert abs(port - ref) > 1e-3, (port, ref)


def test_ce_loss_backward_recomputes_chunks_and_matches_plain():
    """The chunked loss's gradient (each chunk recomputed in the backward)
    equals the plain loss's to float32 precision, softcap included."""
    _, pcfg = smoke("qwen2-1.5b")
    pcfg = dataclasses.replace(pcfg, logit_softcap=30.0)
    rng = np.random.default_rng(5)
    arrays = draw_tree(ref_bb.model_spec(ref_configs.get_smoke_config("qwen2-1.5b"),
                                         ref_mesh_ctx(ref_mesh(1, 1))), rng)
    params = params_from_numpy(arrays["embed"], "cpu")
    x = t(rng.standard_normal((2, 70, pcfg.d_model)).astype(np.float32)).requires_grad_(True)
    labels = torch.from_numpy(rng.integers(-1, pcfg.vocab, (2, 70)).astype(np.int32))
    got = torch.autograd.grad(port_bb.ce_loss(params, x, labels, PCTX, pcfg, t_chunk=32), x)[0]
    logits = port_bb.vocab_logits(params, x, PCTX, pcfg)
    lp = torch.log_softmax(logits, -1)
    valid = labels >= 0
    nll = -torch.gather(lp, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    want = torch.autograd.grad(nll[valid].mean(), x)[0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# three bundle.steps, both packages, from one carried state
# ---------------------------------------------------------------------------


def carried_state(rng, ref_params, plan, ocfg):
    """A numpy optimizer state in the reference's layout at step 10: m
    ~ N(0, 1e-3), v in [1e-4, 2e-4) (int8: random codes of such values), the
    master the parameters' float32 copy."""
    st = jax.tree.map(np.asarray, ref_optim.init_opt_state(ref_params, plan, ocfg))
    st["step"] = np.asarray(10, np.int32)

    def fill(node):
        for k, v in list(node.items()):
            if isinstance(v, dict):
                fill(v)
            elif k == "m":
                node[k] = (1e-3 * rng.standard_normal(v.shape)).astype(np.float32)
            elif k == "v":
                node[k] = (1e-4 * (1 + rng.random(v.shape))).astype(np.float32)
            elif k == "m_q":
                node[k] = (rng.integers(60, 128, v.shape) * rng.choice([-1, 1], v.shape)
                           ).astype(np.int8)
            elif k == "v_q":
                node[k] = rng.integers(200, 256, v.shape).astype(np.uint8)
            elif k == "m_s":
                node[k] = np.full(v.shape, 3e-3, np.float32)
            elif k == "v_s":
                node[k] = np.full(v.shape, 2e-4, np.float32)

    fill(st["leaves"])
    return st


STEP_CASES = {
    "f32": dict(arch="qwen2-1.5b", microbatch=1),
    "f32-microbatch2": dict(arch="qwen2-1.5b", microbatch=2),
    "int8-microbatch2": dict(arch="qwen2-1.5b", microbatch=2, int8=True),
    "compression": dict(arch="qwen2-1.5b", microbatch=1, compression=True),
    "moe-microbatch2": dict(arch="deepseek-v2-236b", microbatch=2),
}


def _run_both(case, jmesh, steps=3):
    rcfg, pcfg = smoke(case["arch"])
    kw = {"state_dtype": "int8"} if case.get("int8") else {}
    rocfg = ref_optim.OptConfig(warmup=2, total_steps=20, **kw)
    pocfg = port_optim.OptConfig(warmup=2, total_steps=20, **kw)
    rc = (ref_comp.CompressionConfig(ratio=0.01, min_leaf_size=60_000, enabled=True)
          if case.get("compression") else None)
    pc = (port_comp.CompressionConfig(ratio=0.01, min_leaf_size=60_000, enabled=True)
          if case.get("compression") else None)
    mesh = jmesh[0]
    rng = np.random.default_rng(21)
    B = 4
    rb = ref_make_train_step(rcfg, mesh, rocfg, batch=B, microbatch=case["microbatch"],
                             compression=rc)
    arrays = draw_tree(rb.param_spec, rng)
    plan = ref_optim.build_plan(rb.param_spec, mesh.axis_names,
                                {a: mesh.shape[a] for a in mesh.axis_names}, rocfg)
    state = carried_state(rng, jax.tree.map(jnp.asarray, arrays), plan, rocfg)
    if rc:
        state["err"] = jax.tree.map(np.asarray, ref_comp.init_error_state(arrays, plan, rc))
    batch = draw_batch(rcfg, rng, B=B, T=32)

    pb = port_make_train_step(pcfg, port_mesh(device="cpu"), pocfg, batch=B,
                              microbatch=case["microbatch"], compression=pc)
    p_params = params_from_numpy(arrays, "cpu")
    p_opt = port_optim.opt_state_from_numpy(state, "cpu")
    r_params = jax.tree.map(jnp.asarray, arrays)
    r_opt = jax.tree.map(jnp.asarray, state)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rm, pm = [], []
    for _ in range(steps):
        r_params, r_opt, m = rb.step(r_params, r_opt, jb)
        rm.append({k: float(v) for k, v in m.items()})
        p_params, p_opt, m = pb.step(p_params, p_opt, batch)
        pm.append({k: float(v) for k, v in m.items()})
    return (rm, r_params, r_opt), (pm, p_params, p_opt), pocfg


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_three_bundle_steps_match_reference(jmesh, name):
    case = STEP_CASES[name]
    (rm, r_params, r_opt), (pm, p_params, p_opt), ocfg = _run_both(case, jmesh)
    for a, b in zip(pm, rm):
        for k in ("loss", "aux", "grad_norm"):
            assert abs(a[k] - b[k]) <= 1e-5 * max(abs(b[k]), 1e-30), (k, a[k], b[k])
        assert abs(a["lr"] - b["lr"]) <= 1e-6 * b["lr"]
    assert int(p_opt["step"]) == int(r_opt["step"]) == 13
    int8 = bool(case.get("int8"))
    lr3 = 3 * ocfg.lr_peak
    n_loose = n_total = 0

    def params_like(got, want, name):
        nonlocal n_loose, n_total
        got, want = to_np(got), to_np(want)
        err = np.abs(got - want)
        n_total += err.size
        if int8:
            assert err.max() <= lr3, (name, err.max())
            n_loose += int((err > 1e-6).sum())
        else:
            assert err.max() <= 1e-6, (name, err.max())

    for path, want in leaves(jax.tree.map(np.asarray, r_params)):
        params_like(_get(p_params, path), want, "/".join(path))
    codes = code_diffs = 0
    for path, want in leaves(jax.tree.map(np.asarray, r_opt["leaves"])):
        got = _get(p_opt["leaves"], path)
        name = "/".join(path)
        if path[-1] == "master":
            params_like(got, want, name)
        elif path[-1] in ("m_q", "v_q"):
            d = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
            codes += d.size
            code_diffs += int((d > 0).sum())
        elif path[-1] in ("m_s", "v_s") and int8:
            # a scale is its block's absmax: a code flipped in an earlier
            # step moves that entry, and where it is the block's max, the scale
            rel = np.abs(got.numpy() - want) / want
            assert np.mean(rel > 1e-5) <= 1e-3 and rel.max() <= 0.15, (name, rel.max())
        else:
            assert_leaf_close(got, want, 1e-4, name)
    if int8:
        assert code_diffs <= 1e-4 * codes, (code_diffs, codes)
        assert n_loose <= 1e-4 * n_total, (n_loose, n_total)
    if case.get("compression"):
        eligible = 0
        for path, want in leaves(jax.tree.map(np.asarray, r_opt["err"])):
            got = _get(p_opt["err"], path)
            assert_leaf_close(got, want, 1e-4, "err/" + "/".join(path))
            eligible += want.size > 1 and np.abs(want).sum() > 0
        assert eligible >= 1
