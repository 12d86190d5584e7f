"""The MoE family's serving path — MLA (``repro_torch.models.attention``'s
``mla_*``), routed experts (``repro_torch.models.ffn``'s ``moe_*``) and the
``moe`` plan of ``backbone`` and ``serve`` — held against the JAX package's
on the same inputs and weights (drawn in float32 with a numpy seed by
``draw_tree`` over the reference's spec, carried to the port with
``params_from_numpy``).  The port runs on ``device="cpu"``; the reference's
functions run jitted inside a 1x1 ``jax.shard_map`` (its MoE core reads the
expert-parallel axis index).

Configs: deepseek-v2-236b and deepseek-v3-671b at their smoke widths, and
two scaled copies of deepseek-v2's so that every spec branch runs:
``q_lora=0`` (one query projection ``wq``) and ``n_shared_experts=0`` (no
shared experts).  Everything runs in float32.  Tolerances:

* 2e-5 (``F32_TOL``, the default of ``tests/test_torch_recurrent.py``) on
  a block's float32 output (MLA's einsums and the expert GEMMs contract in
  other orders; the router's top-k indices are held equal exactly);
* the latent caches are bfloat16 in both packages: a prefill's cache
  within one bfloat16 ulp (1/128 relative).  A decode step reads them and
  rounds its attended latent to bfloat16 (``combine_partials``), and
  jitted, XLA's CPU fusion rounds elsewhere than the ops do
  (``tests/test_torch_models.py``): 1/128 on decode outputs, on the rows
  the decode steps add, and on served logits;
* ``forward``'s final-norm states: 1e-4 (two layers of blocks at 2e-5);
* tokens: equal wherever the top-2 logit margin exceeds ``MARGIN`` (1/64:
  each package's served logits lie within 1/128 of the forward's, so two
  argmaxes can part only below twice that), at least half the positions
  checked.  ``BatchScheduler``: every ``ServeStats`` count equal; each
  completion's tokens equal up to the first position where the two part,
  which must be a near tie (as ``tests/test_torch_serve.py``), and at
  least half of all generated positions compared.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_models import draw_tree, j, leaves, on_mesh, t, to_np
from torch.utils.flop_counter import FlopCounterMode

import repro.configs as ref_configs
import repro.models.attention as ref_attn
import repro.models.backbone as ref_bb
import repro.models.config as ref_config
import repro.models.ffn as ref_ffn
import repro.models.spec as ref_spec
import repro.serve.engine as ref_engine
from repro.launch.mesh import make_local_mesh as ref_mesh
from repro.serve.scheduler import BatchScheduler as RefScheduler
from repro.serve.scheduler import Request as RefRequest
from repro.train.step import mesh_ctx as ref_mesh_ctx
import repro_torch.configs as port_configs
import repro_torch.models.attention as port_attn
import repro_torch.models.backbone as port_bb
import repro_torch.models.config as port_config
import repro_torch.models.ffn as port_ffn
import repro_torch.models.spec as port_spec
import repro_torch.serve.engine as port_engine
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.layers import MeshCtx
from repro_torch.models.spec import params_from_numpy
from repro_torch.serve.scheduler import BatchScheduler, Request

PCTX = MeshCtx()
V2, V3 = "deepseek-v2-236b", "deepseek-v3-671b"
ARCHS = [V2, V3]
VARIANTS = ["v2", "v3", "v2-no-q-lora", "v2-no-shared"]
F32_TOL = dict(atol=2e-5, rtol=2e-5)
CACHE_TOL = dict(atol=1 / 128, rtol=1 / 128)
MARGIN = 1 / 64


@pytest.fixture(scope="module")
def jmesh():
    mesh = ref_mesh(1, 1)
    return mesh, ref_mesh_ctx(mesh)


@pytest.fixture(scope="module")
def cpu_mesh():
    return make_local_mesh(device="cpu")


def configs(variant: str):
    """(reference, port) smoke configs of a variant."""
    arch = V3 if variant == "v3" else V2
    kw = {"v2-no-q-lora": {"q_lora": 0}, "v2-no-shared": {"n_shared_experts": 0}}.get(variant, {})
    return (ref_configs.get_smoke_config(arch).scaled(**kw),
            port_configs.get_smoke_config(arch).scaled(**kw))


def both(arrays):
    """A float32 numpy tree as (JAX, port) trees."""
    return jax.tree.map(j, arrays), params_from_numpy(arrays, "cpu")


def normal(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def close(got, exp, **kw):
    assert tuple(got.shape) == tuple(exp.shape), (got.shape, exp.shape)
    np.testing.assert_allclose(to_np(got), to_np(exp), **kw)


def flat_specs(tree, tmap):
    out = []
    tmap(out.append, tree)
    return out


def same_spec_trees(got, ref):
    """Keys, shapes, axes, init laws, scales, logical shapes and dtypes."""
    assert jax.tree.structure(port_spec.tree_map_p(lambda _: 0, got)) == jax.tree.structure(
        ref_spec.tree_map_p(lambda _: 0, ref))
    flat_p, flat_r = flat_specs(got, port_spec.tree_map_p), flat_specs(ref, ref_spec.tree_map_p)
    assert len(flat_p) == len(flat_r)
    for a, b in zip(flat_p, flat_r):
        assert (a.shape, a.axes, a.init, a.scale, a.logical) == (b.shape, b.axes, b.init,
                                                                  b.scale, b.logical)
        assert str(a.dtype).split(".")[-1] == str(jnp.dtype(b.dtype))
    assert port_spec.count_params(got) == ref_spec.count_params(ref)


# ---------------------------------------------------------------------------
# specs and parameter counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", VARIANTS)
def test_block_specs_equal_the_reference(jmesh, variant):
    """``mla_spec`` (both ``q_lora`` branches) and ``moe_spec`` (with and
    without shared experts; the router float32)."""
    cfg, pcfg = configs(variant)
    same_spec_trees(port_attn.mla_spec(pcfg, PCTX), ref_attn.mla_spec(cfg, jmesh[1]))
    moe = port_ffn.moe_spec(pcfg, PCTX)
    same_spec_trees(moe, ref_ffn.moe_spec(cfg, jmesh[1]))
    assert moe["router"].dtype == torch.float32
    assert ("wq" in port_attn.mla_spec(pcfg, PCTX)) == (pcfg.q_lora == 0)
    assert ("ws_gate" in moe) == bool(pcfg.n_shared_experts)
    assert port_ffn.padded_experts(pcfg, PCTX) == ref_ffn.padded_experts(cfg, jmesh[1])
    assert port_ffn.ep_world(PCTX) == ref_ffn.ep_world(jmesh[1]) == 1


@pytest.mark.parametrize("variant", VARIANTS)
def test_model_spec_equals_the_reference(jmesh, variant):
    """The ``moe`` plan: an unscanned ``mla_dense`` group, then a stacked
    ``mla_moe`` group."""
    cfg, pcfg = configs(variant)
    assert port_bb.layer_plan(pcfg) == ref_bb.layer_plan(cfg) == [
        ("mla_dense", 1, False), ("mla_moe", cfg.n_layers - 1, True)]
    same_spec_trees(port_bb.model_spec(pcfg, PCTX), ref_bb.model_spec(cfg, jmesh[1]))


@pytest.mark.parametrize("arch,n_layers,n", [(V2, None, 235_741_434_880),
                                             (V2, 7, 25_219_261_440),
                                             (V3, None, 671_026_404_352)])
def test_model_spec_at_full_width(jmesh, arch, n_layers, n):
    """The full configs (and deepseek-v2 at the 7 layers ``chip_smoke.py``
    serves) on the ``meta`` device: the reference's tree and count."""
    kw = {"n_layers": n_layers} if n_layers else {}
    cfg, pcfg = ref_configs.get_config(arch).scaled(**kw), port_configs.get_config(arch).scaled(**kw)
    spec = port_bb.model_spec(pcfg, PCTX)
    same_spec_trees(spec, ref_bb.model_spec(cfg, jmesh[1]))
    assert port_spec.count_params(spec) == n
    metas = flat_specs(port_spec.abstract_params(spec), port_spec.tree_map)
    assert all(m.device.type == "meta" for m in metas)


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_formulas_equal_the_reference(arch):
    """``n_params_dense`` and ``n_active_params``, full and smoke configs."""
    for get in ("get_config", "get_smoke_config"):
        cfg, pcfg = getattr(ref_configs, get)(arch), getattr(port_configs, get)(arch)
        assert port_config.n_params_dense(pcfg) == ref_config.n_params_dense(cfg)
        assert port_config.n_active_params(pcfg) == ref_config.n_active_params(cfg)
        assert port_config.n_active_params(pcfg) < port_config.n_params_dense(pcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_spec_equals_the_reference(jmesh, cpu_mesh, arch):
    """At full width, batch 8, ``max_len`` 2048: every latent cache leaf has
    the reference's path, shape and dtype (576 values a position)."""
    cfg, pcfg = ref_configs.get_config(arch), port_configs.get_config(arch)
    got = dict(leaves(port_engine.abstract_cache(pcfg, cpu_mesh, 8, 2048)))
    ref = dict(leaves(ref_engine.abstract_cache(cfg, jmesh[0], 8, 2048)))
    assert got.keys() == ref.keys()
    for path, a in got.items():
        assert tuple(a.shape) == ref[path].shape and a.device.type == "meta", path
        assert str(a.dtype).split(".")[-1] == str(ref[path].dtype), path
    n_moe = cfg.n_layers - cfg.n_dense_layers
    assert tuple(got[("g1", "c_kv")].shape) == (n_moe, 8, 2048, 512)
    assert tuple(got[("g1", "k_rope")].shape) == (n_moe, 8, 2048, 64)
    dense = ("g0",) if cfg.n_dense_layers == 1 else ("g0", "l0")
    assert tuple(got[dense + ("c_kv",)].shape) == (8, 2048, 512)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


def _mla_params(jmesh, variant, seed=80):
    cfg, pcfg = configs(variant)
    return cfg, pcfg, both(draw_tree(ref_attn.mla_spec(cfg, jmesh[1]),
                                     np.random.default_rng(seed)))


@pytest.mark.parametrize("variant", ["v2", "v2-no-q-lora"])
def test_mla_projections(jmesh, variant):
    """``_mla_q`` (through ``wq_a``/``wq_b`` or ``wq``) and ``_mla_latent``
    at positions offset from 0."""
    cfg, pcfg, (jp, pp) = _mla_params(jmesh, variant)
    x = normal(81, 2, 9, cfg.d_model)
    pos = np.broadcast_to(np.arange(9) + 5, (2, 9)).astype(np.int32)
    ppos = torch.from_numpy(pos.copy())
    qn, qr = port_attn._mla_q(pp, t(x), pcfg, ppos)
    rqn, rqr = ref_attn._mla_q(jp, j(x), cfg, jnp.asarray(pos))
    close(qn, rqn, **F32_TOL)
    close(qr, rqr, **F32_TOL)
    c, kr = port_attn._mla_latent(pp, t(x), pcfg, ppos)
    rc, rkr = ref_attn._mla_latent(jp, j(x), cfg, jnp.asarray(pos))
    close(c, rc, **F32_TOL)
    close(kr, rkr, **F32_TOL)


@pytest.mark.parametrize("variant", ["v2", "v2-no-q-lora", "v3"])
def test_mla_apply_and_fill_cache(jmesh, variant):
    """``mla_apply(return_latent=True)`` over 37 positions (key width
    nope + rope differs from the value width), then ``mla_fill_cache``
    into a 48-position cache: the latents bfloat16, the tail zero."""
    cfg, pcfg, (jp, pp) = _mla_params(jmesh, variant, seed=82)
    x = normal(83, 2, 37, cfg.d_model)
    o, (c, kr) = port_attn.mla_apply(pp, t(x), PCTX, pcfg, return_latent=True)
    ro, (rc, rkr) = on_mesh(jmesh, lambda pa, xx: ref_attn.mla_apply(
        pa, xx, jmesh[1], cfg, return_latent=True), jp, j(x))
    close(o, ro, **F32_TOL)
    close(c, rc, **F32_TOL)
    close(kr, rkr, **F32_TOL)
    cache = port_attn.mla_fill_cache(port_attn.mla_init_cache(pcfg, PCTX, 2, 48), c, kr, PCTX)
    rcache = on_mesh(jmesh, lambda a, b: ref_attn.mla_fill_cache(
        ref_attn.mla_init_cache(cfg, jmesh[1], 2, 48), a, b, jmesh[1]), rc, rkr)
    for name in ("c_kv", "k_rope"):
        assert cache[name].dtype == torch.bfloat16
        close(cache[name], rcache[name], **CACHE_TOL)
        assert not cache[name][:, 37:].any()
    assert cache["len"] == int(rcache["len"]) == 37


def test_mla_apply_over_several_query_chunks(jmesh):
    """1 100 positions: the port's prefill takes queries in chunks of
    ``MLA_Q_CHUNK`` (512), the reference's in chunks of 1 024, over the same
    1 024-key chunks in the same order: the outputs agree within 2e-5."""
    cfg, pcfg, (jp, pp) = _mla_params(jmesh, "v2", seed=96)
    assert port_attn.MLA_Q_CHUNK == 512
    x = normal(97, 1, 1100, cfg.d_model)
    o = port_attn.mla_apply(pp, t(x), PCTX, pcfg)
    ro = on_mesh(jmesh, lambda pa, xx: ref_attn.mla_apply(pa, xx, jmesh[1], cfg), jp, j(x))
    close(o, ro, **F32_TOL)


@pytest.mark.parametrize("variant", ["v2", "v2-no-q-lora", "v3"])
def test_mla_decode(jmesh, variant):
    """Four absorbed decode steps from the same latent cache of 9
    positions: outputs and the whole caches agree, and the port wrote its
    cache in place."""
    cfg, pcfg, (jp, pp) = _mla_params(jmesh, variant, seed=84)
    c0, r0 = normal(85, 2, 16, cfg.kv_lora), normal(86, 2, 16, cfg.rope_head_dim)
    c0[:, 9:] = r0[:, 9:] = 0
    cache = {"c_kv": t(c0, torch.bfloat16), "k_rope": t(r0, torch.bfloat16), "len": 9}
    rcache = {"c_kv": j(c0, jnp.bfloat16), "k_rope": j(r0, jnp.bfloat16), "len": jnp.int32(9)}
    buf = cache["c_kv"]
    for step in range(4):
        x = normal(87 + step, 2, 1, cfg.d_model)
        o, cache = port_attn.mla_decode(pp, t(x), cache, PCTX, pcfg)
        ro, rcache = on_mesh(jmesh, lambda pa, c, xx: ref_attn.mla_decode(
            pa, xx, c, jmesh[1], cfg), jp, rcache, j(x))
        close(o, ro, **CACHE_TOL)
        assert cache["len"] == int(rcache["len"]) == 10 + step
    assert cache["c_kv"] is buf
    for name in ("c_kv", "k_rope"):
        close(cache[name], rcache[name], **CACHE_TOL)


def test_mla_decode_refuses_a_full_cache_where_the_reference_overwrites(jmesh):
    """A decode into a full latent cache of 8 slots at position 8: the
    reference writes at ``pos - (pos // tc) · tc`` = 0, overwriting the
    oldest position, while its mask still admits all 8 slots, so its
    output departs from a decode with room for the new position; the port
    raises."""
    cfg, pcfg, (jp, pp) = _mla_params(jmesh, "v2", seed=92)
    tc = 8
    c0, r0 = normal(93, 2, tc, cfg.kv_lora), normal(94, 2, tc, cfg.rope_head_dim)
    x = normal(95, 2, 1, cfg.d_model)

    def ref_step(cap):
        pad = ((0, 0), (0, cap - tc), (0, 0))
        c = {"c_kv": j(np.pad(c0, pad), jnp.bfloat16), "k_rope": j(np.pad(r0, pad), jnp.bfloat16),
             "len": jnp.int32(tc)}
        return on_mesh(jmesh, lambda pa, cc, xx: ref_attn.mla_decode(pa, xx, cc, jmesh[1], cfg),
                       jp, c, j(x))

    roomy, (clamped, ccache) = ref_step(tc + 1)[0], ref_step(tc)
    assert int(ccache["len"]) == tc + 1                          # claims 9 positions in 8 slots
    assert np.abs(to_np(ccache["c_kv"][:, 0]) - c0[:, 0]).max() > 0.1     # slot 0 overwritten
    close(ccache["c_kv"][:, 1:], j(c0[:, 1:], jnp.bfloat16), atol=0, rtol=0)
    assert np.abs(to_np(clamped) - to_np(roomy)).max() > 1e-3
    port_roomy, _ = port_attn.mla_decode(pp, t(x), {
        "c_kv": t(np.pad(c0, ((0, 0), (0, 1), (0, 0))), torch.bfloat16),
        "k_rope": t(np.pad(r0, ((0, 0), (0, 1), (0, 0))), torch.bfloat16), "len": tc},
        PCTX, pcfg)
    close(port_roomy, roomy, **CACHE_TOL)
    full = {"c_kv": t(c0, torch.bfloat16), "k_rope": t(r0, torch.bfloat16), "len": tc}
    with pytest.raises(ValueError, match="latent cache full"):
        port_attn.mla_decode(pp, t(x), full, PCTX, pcfg)
    assert torch.equal(full["c_kv"], t(c0, torch.bfloat16))     # nothing written


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _moe_params(jmesh, variant, seed=100):
    cfg, pcfg = configs(variant)
    return cfg, pcfg, both(draw_tree(ref_ffn.moe_spec(cfg, jmesh[1]),
                                     np.random.default_rng(seed)))


def _ref_topi(jp, x, cfg):
    logits = x.astype(jnp.float32) @ jp["router"]
    return np.asarray(jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.moe_top_k)[1])


@pytest.mark.parametrize("variant", VARIANTS)
def test_moe_apply(jmesh, variant):
    """``moe_apply`` over 2 x 37 tokens: the top-k indices equal, ``y``
    and the aux loss within 2e-5."""
    cfg, pcfg, (jp, pp) = _moe_params(jmesh, variant)
    x = normal(101, 2, 37, cfg.d_model)
    y, aux = port_ffn.moe_apply(pp, t(x), PCTX, pcfg, 1)
    ry, raux = on_mesh(jmesh, lambda pa, xx: ref_ffn.moe_apply(pa, xx, jmesh[1], cfg, 1),
                       jp, j(x))
    _, _, topi = port_ffn._route(pp, t(x).reshape(-1, cfg.d_model), pcfg)
    np.testing.assert_array_equal(topi.numpy(), _ref_topi(jp, j(x).reshape(-1, cfg.d_model), cfg))
    close(y, ry, **F32_TOL)
    close(aux, raux, **F32_TOL)
    assert float(aux) > 0


@pytest.mark.parametrize("variant", VARIANTS)
def test_moe_decode(jmesh, variant):
    """``moe_decode`` on a batch of 5 single tokens: the same checks."""
    cfg, pcfg, (jp, pp) = _moe_params(jmesh, variant, seed=102)
    x = normal(103, 5, 1, cfg.d_model)
    y, aux = port_ffn.moe_decode(pp, t(x), PCTX, pcfg, 1)
    ry, raux = on_mesh(jmesh, lambda pa, xx: ref_ffn.moe_decode(pa, xx, jmesh[1], cfg, 1),
                       jp, j(x))
    _, _, topi = port_ffn._route(pp, t(x)[:, 0], pcfg)
    np.testing.assert_array_equal(topi.numpy(), _ref_topi(jp, j(x)[:, 0], cfg))
    close(y, ry, **F32_TOL)
    close(aux, raux, **F32_TOL)


@pytest.mark.parametrize("variant", ["v2", "v3"])
def test_moe_gathers_each_experts_rows(variant):
    """The dispatch runs each expert's GEMMs on its routed rows only:
    ``moe_apply``'s counted flops stay within 5 % of the routed and shared
    experts' GEMMs plus the router's.  The reference's loop runs every
    expert over all ``ceil(1.25 · N · k) + 4`` slots, E / k · 1.25 times
    the routed work."""
    _, pcfg = configs(variant)
    spec = port_ffn.moe_spec(pcfg, PCTX)
    p = port_spec.init_params(spec, torch.Generator().manual_seed(7), "cpu")
    p = port_spec.tree_map(lambda a: a.float(), p)
    x = torch.randn(4, 37, pcfg.d_model, generator=torch.Generator().manual_seed(8))
    with FlopCounterMode(display=False) as counter:
        port_ffn.moe_apply(p, x, PCTX, pcfg, 1)
    d, ff, N, k = pcfg.d_model, pcfg.moe_d_ff, 4 * 37, pcfg.moe_top_k
    need = 2 * 3 * d * ff * N * (k + pcfg.n_shared_experts) + 2 * d * pcfg.n_experts * N
    assert need <= counter.get_total_flops() <= 1.05 * need, (counter.get_total_flops(), need)


# ---------------------------------------------------------------------------
# the model: forward, prefill / decode, the scheduler
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def model(request, jmesh):
    """(reference config, port config, JAX params, port params), float32."""
    cfg, pcfg = configs("v3" if request.param == V3 else "v2")
    return (cfg, pcfg, *both(draw_tree(ref_bb.model_spec(cfg, jmesh[1]),
                                       np.random.default_rng(110))))


def ref_forward_logits(jmesh, jp, cfg, tokens: np.ndarray) -> np.ndarray:
    """float32 logits at every position of the reference's no-cache forward."""
    def body(p, tk):
        x, _ = ref_bb.forward(p, tk, jmesh[1], cfg, ep_data_size=1, remat=False)
        return ref_bb._mask_vocab_pad((x @ ref_bb._unembed_weight(p["embed"], cfg)).astype(
            jnp.float32), 0, cfg)

    return np.asarray(on_mesh(jmesh, body, jp, jnp.asarray(tokens, jnp.int32)))


def port_forward_logits(pp, pcfg, tokens: np.ndarray) -> np.ndarray:
    x = port_bb.forward(pp, torch.from_numpy(tokens.astype(np.int32)), PCTX, pcfg)
    return port_bb.vocab_logits(pp["embed"], x, PCTX, pcfg).numpy()


def margins(logits: np.ndarray) -> np.ndarray:
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def check_tokens(got: np.ndarray, want: np.ndarray, logits: np.ndarray) -> int:
    ok = margins(logits) > MARGIN
    assert ok.mean() >= 0.5, margins(logits)
    np.testing.assert_array_equal(got[ok], want[ok])
    return int(ok.sum())


def test_forward_matches_the_reference(model, jmesh):
    """Final-norm states over 2 x 41 tokens (negative ids embed as 0)."""
    cfg, pcfg, jp, pp = model
    toks = np.random.default_rng(111).integers(-2, cfg.vocab, size=(2, 41)).astype(np.int32)
    ref = on_mesh(jmesh, lambda p, tk: ref_bb.forward(p, tk, jmesh[1], cfg, ep_data_size=1,
                                                      remat=False)[0], jp, jnp.asarray(toks))
    got = port_bb.forward(pp, torch.from_numpy(toks), PCTX, pcfg)
    close(got, ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(port_forward_logits(pp, pcfg, toks[:, :9].clip(0)),
                               ref_forward_logits(jmesh, jp, cfg, toks[:, :9].clip(0)),
                               atol=1e-4, rtol=1e-4)


def _record_logits(monkeypatch):
    """Patch the port engine's ``greedy_token`` to keep each step's logits."""
    recorded, greedy = [], port_engine.greedy_token

    def recording(p, x, ctx, cfg_):
        recorded.append(port_bb.vocab_logits(p, x[:, -1], ctx, cfg_).numpy())
        return greedy(p, x, ctx, cfg_)

    monkeypatch.setattr(port_engine, "greedy_token", recording)
    return recorded


def test_prefill_and_decode_match_the_reference(model, jmesh, cpu_mesh, monkeypatch):
    """Prefill 12 tokens, then 6 teacher-forced decode steps in both
    engines: latent caches leaf for leaf, the served logits within 1/128 of
    the reference's no-cache forward, tokens equal to the reference's
    decode where the margin allows, the port's caches written in place."""
    cfg, pcfg, jp, pp = model
    B, T, L, steps = 2, 12, 24, 6
    rng = np.random.default_rng(112)
    prompt = rng.integers(0, cfg.vocab, size=(B, T)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab, size=(B, steps)).astype(np.int32)
    seq = np.concatenate([prompt, forced], axis=1)
    recorded = _record_logits(monkeypatch)
    ref = ref_engine.make_serve_fns(cfg, jmesh[0], batch=B, max_len=L)
    port = port_engine.make_serve_fns(pcfg, cpu_mesh, batch=B, max_len=L)
    rcaches, rtok = ref.prefill(jp, {"tokens": jnp.asarray(prompt)})
    caches, tok = port.prefill(pp, {"tokens": torch.from_numpy(prompt)})
    paths = dict(leaves(caches))
    assert paths.keys() == {p for p, _ in leaves(rcaches)} == {
        (g, n) for g in ("g0", "g1") for n in ("c_kv", "k_rope", "len")}

    def held(tol):
        for path, got in dict(leaves(caches)).items():
            exp = rcaches[path[0]][path[1]]
            if path[-1] == "len":
                assert np.all(np.asarray(exp) == got)
            else:
                assert got.dtype == torch.bfloat16 and str(exp.dtype) == "bfloat16", path
                close(got, exp, **tol)

    held(CACHE_TOL)
    assert paths[("g1", "len")] == T
    buf = caches["g1"]["c_kv"]
    got, exp = [tok.numpy()], [np.asarray(rtok)]
    for s in range(steps):
        rtok, rcaches = ref.decode(jp, rcaches, jnp.asarray(forced[:, s:s + 1]))
        tok, caches = port.decode(pp, caches, torch.from_numpy(forced[:, s:s + 1]))
        got.append(tok.numpy())
        exp.append(np.asarray(rtok))
    assert caches["g1"]["c_kv"] is buf and caches["g0"]["len"] == caches["g1"]["len"] == T + steps
    held(CACHE_TOL)
    logits = ref_forward_logits(jmesh, jp, cfg, seq)[:, T - 1:]
    close(np.stack(recorded, 1), logits, atol=1 / 128, rtol=0)
    check_tokens(np.stack(got, 1), np.stack(exp, 1), logits)


def test_port_decode_equals_port_forward(model, cpu_mesh):
    """Within the port: greedy prefill + decode (no teacher forcing) equals
    the argmax of the port's no-cache forward over prompt + tokens."""
    _, pcfg, _, pp = model
    prompt = np.random.default_rng(113).integers(0, pcfg.vocab, size=(3, 7)).astype(np.int32)
    sv = port_engine.make_serve_fns(pcfg, cpu_mesh, batch=3, max_len=20)
    caches, tok = sv.prefill(pp, {"tokens": torch.from_numpy(prompt)})
    gen = [tok]
    for _ in range(8):
        tok, caches = sv.decode(pp, caches, tok[:, None])
        gen.append(tok)
    gen = torch.stack(gen, 1).numpy()
    logits = port_forward_logits(pp, pcfg, np.concatenate([prompt, gen[:, :-1]], 1))[:, 6:]
    check_tokens(gen, logits.argmax(-1), logits)


def _requests(cfg, cls):
    """Three buckets: 9 tokens (a full batch), 14 (a full batch and an
    underfull one), 5 (underfull)."""
    rng = np.random.default_rng(114)
    lens, max_new = [9, 9, 14, 14, 14, 5], [6, 4, 7, 5, 6, 3]
    return [cls(i, [int(x) for x in rng.integers(0, cfg.vocab, n)], m)
            for i, (n, m) in enumerate(zip(lens, max_new))]


def test_scheduler_matches_the_reference(model, jmesh, cpu_mesh):
    """``BatchScheduler.run`` on both packages: every ``ServeStats`` count
    equal (``wall_s`` aside), each completion equal up to a first
    divergence on a near tie of the port's forward."""
    cfg, pcfg, jp, pp = model
    ref_out, ref_stats = RefScheduler(cfg, jmesh[0], batch=2, max_len=32, eos_id=-1).run(
        jp, _requests(cfg, RefRequest))
    out, stats = BatchScheduler(pcfg, cpu_mesh, batch=2, max_len=32, eos_id=-1).run(
        pp, _requests(cfg, Request))
    reqs = {r.rid: r for r in _requests(cfg, Request)}
    assert out.keys() == ref_out.keys() == reqs.keys()
    compared = 0
    for rid, c in out.items():
        assert len(c.tokens) == len(ref_out[rid].tokens) == reqs[rid].max_new and c.finished
        n = next((i for i, (a, b) in enumerate(zip(c.tokens, ref_out[rid].tokens)) if a != b),
                 len(c.tokens))
        if n < len(c.tokens):
            seq = np.asarray([reqs[rid].prompt + c.tokens[:n]], np.int32)
            assert margins(port_forward_logits(pp, pcfg, seq)[0, -1]) <= MARGIN, (rid, n)
        compared += n
    assert compared * 2 >= sum(len(c.tokens) for c in out.values()), compared
    for f in ("requests", "prefill_tokens", "decode_steps", "batches"):
        assert getattr(stats, f) == getattr(ref_stats, f), f
    assert stats.batches == 4 and stats.decode_steps == sum(len(c.tokens) - 1
                                                            for c in out.values())


def test_max_len_guard_where_the_reference_clamps(jmesh, cpu_mesh):
    """8 prompt + 5 decoded positions need 13 latent cache slots.  With
    max_len=10 the reference's ``mla_decode`` writes positions 10-12 over
    slots 0-2, so it returns other tokens than with room to spare; the port
    refuses the request (and exactly full is allowed)."""
    cfg, pcfg = configs("v2")
    arrays = draw_tree(ref_bb.model_spec(cfg, jmesh[1]), np.random.default_rng(115))
    jp, pp = both(arrays)
    prompt = [int(x) for x in np.random.default_rng(116).integers(0, cfg.vocab, 8)]

    def ref_tokens(max_len):
        out, _ = RefScheduler(cfg, jmesh[0], batch=1, max_len=max_len, eos_id=-1).run(
            jp, [RefRequest(0, prompt, 6)])
        return out[0].tokens

    roomy, clamped = ref_tokens(32), ref_tokens(10)
    assert len(clamped) == len(roomy) == 6
    assert clamped != roomy                      # the reference's silent clamp
    assert clamped[:3] == roomy[:3]              # equal while the cache had room
    port = BatchScheduler(pcfg, cpu_mesh, batch=1, max_len=32, eos_id=-1)
    assert port.run(pp, [Request(0, prompt, 6)])[0][0].tokens == roomy
    with pytest.raises(ValueError, match="exceed the 10-position KV cache"):
        BatchScheduler(pcfg, cpu_mesh, batch=1, max_len=10, eos_id=-1).run(
            pp, [Request(0, prompt, 6)])
    assert len(BatchScheduler(pcfg, cpu_mesh, batch=1, max_len=10, eos_id=-1).run(
        pp, [Request(0, prompt, 3)])[0][0].tokens) == 3
