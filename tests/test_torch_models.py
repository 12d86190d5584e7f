"""The model scaffold's layers, ported to ``repro_torch.models``, held
against the JAX package's on the same inputs (drawn with a numpy seed).

The port runs on ``device="cpu"``.  Functions of the reference that read the
model-axis index (``local_kv_map`` calls ``axis_index``) run inside a 1x1
``jax.shard_map``.  Tolerances, each stated where it is used:

* ``blockwise_attention``: the reference test's own, 3e-5 on every
  ``tests/test_attention.py`` case and 5e-5 on its property sweep, against
  the dense softmax and against the JAX function alike;
* float32 parameters: 2e-5 (norms, rope), 1e-4 (blocks);
* decode against a bfloat16 cache: the reference rounds the attention
  weights, their weighted sum and the attention output to bfloat16.  Run op
  by op it equals the port to 1e-6 (``test_partial_attention_op_by_op``);
  jitted, XLA's CPU fusion rounds the weighted sum elsewhere, which moves a
  decode block's output by up to a bfloat16 ulp: 1/128 there;
* bfloat16 parameters: XLA's CPU backend computes bfloat16 elementwise
  work in float32 and may fuse ops before rounding, torch rounds after each
  op: one or two bfloat16 ulps of the values compared (1/128 relative).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st
from _torch_models import draw_tree, j, on_mesh, t, to_np
from jax.sharding import PartitionSpec as JP
from test_attention import CASES, ref_attn

import repro.configs as ref_configs
import repro.models.attention as ref_attn_mod
import repro.models.backbone as ref_bb
import repro.models.config as ref_config
import repro.models.ffn as ref_ffn
import repro.models.layers as ref_layers
import repro.models.spec as ref_spec
from repro.launch.mesh import make_local_mesh as ref_mesh
from repro.train.step import mesh_ctx as ref_mesh_ctx
import repro_torch.configs as port_configs
import repro_torch.models.attention as port_attn
import repro_torch.models.backbone as port_bb
import repro_torch.models.config as port_config
import repro_torch.models.ffn as port_ffn
import repro_torch.models.layers as port_layers
import repro_torch.models.spec as port_spec

CPU = torch.device("cpu")
PCTX = port_layers.MeshCtx()


@pytest.fixture(scope="module")
def jmesh():
    mesh = ref_mesh(1, 1)
    return mesh, ref_mesh_ctx(mesh)


# ---------------------------------------------------------------------------
# blockwise_attention: every case of tests/test_attention.py, both packages
# ---------------------------------------------------------------------------


def _attn_inputs(rng, B, H, Hkv, Tq, Tk, Dh, Dv):
    return (rng.normal(size=(B, H, Tq, Dh)).astype(np.float32),
            rng.normal(size=(B, Hkv, Tk, Dh)).astype(np.float32),
            rng.normal(size=(B, Hkv, Tk, Dv)).astype(np.float32))


def _check_attention(q, k, v, kvmap, atol, *, causal, window=None, kv_len=None, **kw):
    port = port_layers.blockwise_attention(
        t(q), t(k), t(v), torch.as_tensor(kvmap), causal=causal, window=window,
        kv_valid_len=kv_len, **kw)
    jk = None if kv_len is None else jnp.int32(kv_len)
    jref = ref_layers.blockwise_attention(
        j(q), j(k), j(v), jnp.asarray(kvmap, jnp.int32), causal=causal, window=window,
        kv_valid_len=jk, **kw)
    dense = ref_attn(j(q), j(k), j(v), jnp.asarray(kvmap, jnp.int32), causal, window,
                     kv_len=jk)
    assert port.shape == jref.shape and port.dtype == torch.float32
    np.testing.assert_allclose(port.numpy(), np.asarray(dense), atol=atol)
    np.testing.assert_allclose(port.numpy(), np.asarray(jref), atol=atol)


@pytest.mark.parametrize("Tq,Tk,qc,kc,causal,window,skip", CASES)
def test_blockwise_matches_reference(Tq, Tk, qc, kc, causal, window, skip):
    rng = np.random.default_rng(0)
    q, k, v = _attn_inputs(rng, 2, 4, 2, Tq, Tk, 8, 8)
    _check_attention(q, k, v, np.arange(4) // 2, 3e-5, causal=causal, window=window,
                     q_chunk=qc, k_chunk=kc, block_skip=skip)


def test_ragged_kv_len():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(1, 2, 32, 8)).astype(np.float32)
    k = rng.normal(size=(1, 2, 64, 8)).astype(np.float32)
    v = rng.normal(size=(1, 2, 64, 8)).astype(np.float32)
    _check_attention(q, k, v, np.arange(2), 3e-5, causal=False, q_chunk=16, k_chunk=16,
                     kv_len=40)


def test_block_skip_drops_pairs_not_results(monkeypatch):
    """Skipping changes the pair list only: skip on and off agree to 1e-6,
    and a causal 4x4 chunk grid runs 10 pairs, not 16."""
    rng = np.random.default_rng(3)
    q, k, v = _attn_inputs(rng, 1, 2, 2, 64, 64, 8, 8)
    outs = [port_layers.blockwise_attention(t(q), t(k), t(v), torch.arange(2), causal=True,
                                            q_chunk=16, k_chunk=16, block_skip=s)
            for s in (True, False)]
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), atol=1e-6)
    calls = []
    real = port_layers.einsum
    monkeypatch.setattr(port_layers, "einsum", lambda *a: calls.append(a[0]) or real(*a))
    port_layers.blockwise_attention(t(q), t(k), t(v), torch.arange(2), causal=True,
                                    q_chunk=16, k_chunk=16)
    assert len(calls) == 2 * 10           # two products a pair


@settings(max_examples=12, deadline=None)
@given(
    tq=st.integers(8, 96),
    causal=st.booleans(),
    qc=st.sampled_from([8, 16, 32]),
    kc=st.sampled_from([8, 16, 32]),
    seed=st.integers(0, 1000),
)
def test_blockwise_property(tq, causal, qc, kc, seed):
    rng = np.random.default_rng(seed)
    q, k, v = _attn_inputs(rng, 1, 2, 2, tq, tq, 4, 4)
    _check_attention(q, k, v, np.arange(2), 5e-5, causal=causal, q_chunk=qc, k_chunk=kc)



# ---------------------------------------------------------------------------
# norms, rope, activations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_norm(norm_type, dtype):
    rng = np.random.default_rng(4)
    cfg = ref_config.ModelConfig("n", "dense", 1, 64, 4, 2, 128, 512, norm_type=norm_type)
    pcfg = port_config.ModelConfig(**dataclasses.asdict(cfg))
    x = (3 * rng.normal(size=(2, 5, 64)) + 1).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.normal(size=64)).astype(np.float32),
         "bias": (0.1 * rng.normal(size=64)).astype(np.float32)}
    if norm_type == "rmsnorm":
        del p["bias"]
    tdt, jdt = (None, jnp.float32) if dtype == "float32" else (torch.bfloat16, jnp.bfloat16)
    port = port_layers.apply_norm(port_spec.params_from_numpy(p, CPU, tdt), t(x, tdt), pcfg)
    ref = ref_layers.apply_norm({k: j(v, jdt) for k, v in p.items()}, j(x, jdt), cfg)
    assert port.dtype == (torch.float32 if tdt is None else torch.bfloat16)
    if dtype == "float32":
        np.testing.assert_allclose(port.numpy(), to_np(ref), atol=2e-5, rtol=2e-5)
    else:   # one bfloat16 ulp of values of magnitude up to ~4
        np.testing.assert_allclose(to_np(port), to_np(ref), rtol=1 / 128, atol=1 / 64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_theta_1e6(dtype):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 3, 40, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(1000, 1040), (2, 1, 40)).astype(np.int32)
    tdt, jdt = (None, jnp.float32) if dtype == "float32" else (torch.bfloat16, jnp.bfloat16)
    port = port_layers.rope(t(x, tdt), torch.from_numpy(pos.copy()), 1e6)
    ref = ref_layers.rope(j(x, jdt), jnp.asarray(pos), 1e6)
    if dtype == "float32":
        np.testing.assert_allclose(port.numpy(), to_np(ref), atol=2e-5)
    else:
        np.testing.assert_allclose(to_np(port), to_np(ref), rtol=1 / 128, atol=1 / 64)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_act_fn(act):
    rng = np.random.default_rng(6)
    g, u = rng.normal(size=(2, 3, 16)).astype(np.float32), rng.normal(size=(2, 3, 16)).astype(np.float32)
    cfg = ref_config.ModelConfig("n", "dense", 1, 16, 2, 1, 32, 64, act=act)
    pcfg = port_config.ModelConfig(**dataclasses.asdict(cfg))
    np.testing.assert_allclose(port_layers.act_fn(pcfg, t(g), t(u)).numpy(),
                               to_np(ref_layers.act_fn(cfg, j(g), j(u))), atol=2e-6)


# ---------------------------------------------------------------------------
# GQA blocks and the dense FFN
# ---------------------------------------------------------------------------

BLOCK_ARCHS = ["qwen2-1.5b", "internlm2-1.8b", "qwen3-14b"]   # bias; untied; qk-norm


def _block_setup(jmesh, arch, seed):
    cfg = ref_configs.get_smoke_config(arch)
    pcfg = port_configs.get_smoke_config(arch)
    _, jctx = jmesh
    spec = ref_bb.block_spec(cfg, jctx, "attn")
    return cfg, pcfg, jctx, draw_tree(spec, np.random.default_rng(seed))


@pytest.mark.parametrize("arch", BLOCK_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_apply_and_mlp(jmesh, arch, dtype):
    cfg, pcfg, jctx, p = _block_setup(jmesh, arch, 8)
    x = np.random.default_rng(9).normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    tdt, jdt = (None, jnp.float32) if dtype == "float32" else (torch.bfloat16, jnp.bfloat16)
    pp = port_spec.params_from_numpy(p, CPU, tdt)
    jp = jax.tree.map(lambda a: j(a, jdt), p)
    o, (k, v) = port_attn.gqa_apply(pp["attn"], t(x, tdt), PCTX, pcfg, return_kv=True)
    ro, (rk, rv) = on_mesh(jmesh, lambda pa, xx: ref_attn_mod.gqa_apply(
        pa, xx, jctx, cfg, return_kv=True), jp["attn"], j(x, jdt))
    m = port_ffn.mlp_apply(pp["mlp"], t(x, tdt), PCTX, pcfg)
    rm = on_mesh(jmesh, lambda pm, xx: ref_ffn.mlp_apply(pm, xx, jctx, cfg), jp["mlp"], j(x, jdt))
    if dtype == "float32":
        tol = dict(atol=1e-4, rtol=1e-4)
    else:     # bfloat16 ulps of the projections, compounded through softmax / SwiGLU
        tol = dict(atol=0.05, rtol=0.02)
    for got, exp in ((o, ro), (k, rk), (v, rv), (m, rm)):
        assert tuple(got.shape) == exp.shape
        assert got.dtype == (torch.float32 if tdt is None else torch.bfloat16)
        np.testing.assert_allclose(to_np(got), to_np(exp), **tol)


@pytest.mark.parametrize("arch", BLOCK_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_decode_and_mlp_decode(jmesh, arch, dtype):
    """Fill a cache with a prefill's K/V, then decode three tokens in both
    packages: outputs and the whole cache agree, and the port's cache was
    written in place."""
    cfg, pcfg, jctx, p = _block_setup(jmesh, arch, 10)
    rng = np.random.default_rng(11)
    T, L = 9, 16
    tdt, jdt = (None, jnp.float32) if dtype == "float32" else (torch.bfloat16, jnp.bfloat16)
    x = rng.normal(size=(2, T, cfg.d_model)).astype(np.float32)
    pp = port_spec.params_from_numpy(p, CPU, tdt)
    jp = jax.tree.map(lambda a: j(a, jdt), p)
    _, (k, v) = port_attn.gqa_apply(pp["attn"], t(x, tdt), PCTX, pcfg, return_kv=True)
    cache = port_attn.gqa_fill_cache(port_attn.gqa_init_cache(pcfg, PCTX, 2, L), k, v, PCTX)

    def ref_fill(pa, xx):
        _, (rk, rv) = ref_attn_mod.gqa_apply(pa, xx, jctx, cfg, return_kv=True)
        return ref_attn_mod.gqa_fill_cache(ref_attn_mod.gqa_init_cache(cfg, jctx, 2, L),
                                           rk, rv, jctx)

    rcache = on_mesh(jmesh, ref_fill, jp["attn"], j(x, jdt))
    if dtype == "float32":
        o_tol, m_tol = dict(atol=1 / 128, rtol=1 / 128), dict(atol=1e-4, rtol=1e-4)
        c_tol = dict(atol=1 / 64, rtol=1 / 128)
    else:     # the bfloat16 tolerance of test_gqa_apply_and_mlp
        o_tol = m_tol = c_tol = dict(atol=0.05, rtol=0.02)
    k_buf = cache["k"]
    for step in range(3):
        xt = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        o, cache = port_attn.gqa_decode(pp["attn"], t(xt, tdt), cache, PCTX, pcfg)
        ro, rcache = on_mesh(jmesh, lambda pa, c, xx: ref_attn_mod.gqa_decode(
            pa, xx, c, jctx, cfg), jp["attn"], rcache, j(xt, jdt))
        assert str(o.dtype).split(".")[-1] == str(ro.dtype)
        np.testing.assert_allclose(to_np(o), to_np(ro), **o_tol)
        assert cache["len"] == int(rcache["len"]) == T + step + 1
        m = port_ffn.mlp_decode(pp["mlp"], t(xt, tdt), PCTX, pcfg)
        rm = on_mesh(jmesh, lambda pm, xx: ref_ffn.mlp_decode(pm, xx, jctx, cfg),
                     jp["mlp"], j(xt, jdt))
        np.testing.assert_allclose(to_np(m), to_np(rm), **m_tol)
    assert cache["k"] is k_buf and cache["k"].dtype == torch.bfloat16
    for name in ("k", "v"):
        np.testing.assert_allclose(to_np(cache[name]), to_np(rcache[name]), **c_tol)


def test_partial_attention_op_by_op():
    """The decode's attention over a bfloat16 cache, against the reference's
    ``attention_partial_lse`` + ``combine_partials`` run op by op (not
    jitted): equal to float32 rounding, bfloat16 roundings included."""
    rng = np.random.default_rng(14)
    q = rng.normal(size=(2, 4, 1, 32)).astype(np.float32)
    kc = rng.normal(size=(2, 2, 16, 32)).astype(np.float32)
    vc = rng.normal(size=(2, 2, 16, 32)).astype(np.float32)
    kvm = np.array([0, 0, 1, 1])
    num, m, l = port_layers.attention_partial_lse(
        t(q), t(kc, torch.bfloat16), t(vc, torch.bfloat16), torch.as_tensor(kvm), k_offset=0,
        kv_valid_len=10, q_pos=[9])
    rnum, rm, rl = ref_layers.attention_partial_lse(
        j(q), j(kc, jnp.bfloat16), j(vc, jnp.bfloat16), jnp.asarray(kvm, jnp.int32), k_offset=0,
        kv_valid_len=jnp.int32(10), q_pos=jnp.asarray([9]))
    for got, exp in ((num, rnum), (m, rm), (l, rl)):
        np.testing.assert_allclose(got.numpy(), to_np(exp), atol=1e-6, rtol=1e-6)
    out = port_layers.combine_partials(num, m, l, PCTX)
    rout = ref_layers.combine_partials(rnum, rm, rl, ref_layers.MeshCtx(model_size=1))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_np(out), to_np(rout))


def test_gqa_decode_refuses_a_full_cache():
    pcfg = port_configs.get_smoke_config("qwen2-1.5b")
    spec = port_attn.gqa_spec(pcfg, PCTX)
    p = port_spec.init_params(spec, torch.Generator().manual_seed(0), "cpu")
    cache = port_attn.gqa_init_cache(pcfg, PCTX, 1, 4)
    x = torch.zeros(1, 1, pcfg.d_model, dtype=torch.bfloat16)
    for _ in range(4):
        _, cache = port_attn.gqa_decode(p, x, cache, PCTX, pcfg)
    with pytest.raises(ValueError, match="KV cache full"):
        port_attn.gqa_decode(p, x, cache, PCTX, pcfg)


# ---------------------------------------------------------------------------
# embeddings, logits, greedy token
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "internlm2-1.8b"])   # tied; untied
def test_embed_and_greedy_token(jmesh, arch):
    cfg = ref_configs.get_smoke_config(arch)
    pcfg = port_configs.get_smoke_config(arch)
    _, jctx = jmesh
    p = draw_tree(ref_bb.embed_spec(cfg), np.random.default_rng(12))
    assert ("unembed" in p) == (not cfg.tie_embeddings)
    pp, jp = port_spec.params_from_numpy(p, CPU), jax.tree.map(j, p)
    # ids past the padded vocab and negative ids embed to zeros in both
    toks = np.array([[0, 5, cfg.vocab - 1, cfg.vocab + 100], [-3, 17, 511, 2]], np.int32)
    emb = port_bb.embed_tokens(pp, torch.from_numpy(toks), PCTX, pcfg)
    remb = on_mesh(jmesh, lambda pe, tk: ref_bb.embed_tokens(pe, tk, jctx, cfg), jp,
                   jnp.asarray(toks))
    np.testing.assert_array_equal(emb.numpy(), to_np(remb))
    assert not emb[0, 3].any() and not emb[1, 0].any()
    x = np.random.default_rng(13).normal(size=(6, 1, cfg.d_model)).astype(np.float32)
    tok = port_bb.greedy_token(pp, t(x), PCTX, pcfg)
    rtok = on_mesh(jmesh, lambda pe, xx: ref_bb.greedy_token(pe, xx, jctx, cfg), jp, j(x))
    assert tok.dtype == torch.int32
    np.testing.assert_array_equal(tok.numpy(), np.asarray(rtok))


def test_greedy_token_ties_go_to_the_first_maximum():
    pcfg = port_configs.get_smoke_config("internlm2-1.8b")
    d, v = pcfg.d_model, port_bb.vocab_pad(pcfg)
    unembed = torch.zeros(d, v)
    unembed[0, [7, 300, 9]] = 1.0                 # three columns tie for the maximum
    p = {"tok": torch.zeros(v, d), "unembed": unembed}
    x = torch.zeros(2, 1, d)
    x[:, 0, 0] = 1.0
    assert port_bb.greedy_token(p, x, PCTX, pcfg).tolist() == [7, 7]
    ref = ref_bb.greedy_token({"tok": jnp.zeros((v, d)), "unembed": jnp.asarray(unembed.numpy())},
                              jnp.asarray(x.numpy()), ref_layers.MeshCtx(model_size=1),
                              ref_configs.get_smoke_config("internlm2-1.8b"))
    assert np.asarray(ref).tolist() == [7, 7]


# ---------------------------------------------------------------------------
# specs, configs, parameter carry-over
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_configs_equal_the_reference(arch):
    assert port_configs.ARCH_IDS == ref_configs.ARCH_IDS
    for get_p, get_r in ((port_configs.get_config, ref_configs.get_config),
                         (port_configs.get_smoke_config, ref_configs.get_smoke_config)):
        pc, rc = get_p(arch), get_r(arch)
        assert dataclasses.asdict(pc) == dataclasses.asdict(rc)
        assert port_config.n_params_dense(pc) == ref_config.n_params_dense(rc)
        assert port_config.n_active_params(pc) == ref_config.n_active_params(rc)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "internlm2-1.8b", "qwen3-14b", "command-r-35b",
                                  "pixtral-12b", "recurrentgemma-2b", "mamba2-780m",
                                  "whisper-tiny"])
def test_model_spec_equals_the_reference_at_full_width(jmesh, arch):
    """The full configs' spec trees: the same keys, shapes, init laws and
    axes; nothing is allocated (meta tensors)."""
    _, jctx = jmesh
    pspec = port_bb.model_spec(port_configs.get_config(arch), PCTX)
    rspec = ref_bb.model_spec(ref_configs.get_config(arch), jctx)
    flat_p, flat_r = [], []
    port_spec.tree_map_p(flat_p.append, pspec)
    ref_spec.tree_map_p(flat_r.append, rspec)
    assert len(flat_p) == len(flat_r)
    for a, b in zip(flat_p, flat_r):
        assert (a.shape, a.axes, a.init, a.scale, a.logical) == (b.shape, b.axes, b.init,
                                                                  b.scale, b.logical)
        assert str(a.dtype).split(".")[-1] == str(jnp.dtype(b.dtype))
    assert port_spec.count_params(pspec) == ref_spec.count_params(rspec)
    metas = []
    port_spec.tree_map(metas.append, port_spec.abstract_params(pspec))
    assert len(metas) == len(flat_p) and all(m.device.type == "meta" for m in metas)


def test_mesh_ctx_is_one_card():
    """A MeshCtx above one rank sizes a spec, but runs no collective
    without the mesh of its process groups."""
    wide = port_layers.MeshCtx(model_size=16)
    with pytest.raises(ValueError, match="need its mesh"):
        port_layers.ag_seq(torch.zeros(1, 16, 4), wide)
    with pytest.raises(ValueError, match="need its mesh"):
        port_layers.rs_seq(torch.zeros(1, 16, 4), wide)
    assert PCTX.model_size == 1 and PCTX.midx() == 0


def test_init_params_law():
    """Zeros and ones where declared; normal leaves at scale/sqrt(fan_in),
    the head padding of a `logical` leaf zero; one generator, one model."""
    cfg = port_configs.get_smoke_config("qwen2-1.5b")
    spec = port_bb.model_spec(cfg, PCTX)
    a = port_spec.init_params(spec, torch.Generator().manual_seed(3), "cpu")
    b = port_spec.init_params(spec, torch.Generator().manual_seed(3), "cpu")
    assert torch.equal(a["g0"]["attn"]["wq"], b["g0"]["attn"]["wq"])
    assert a["g0"]["attn"]["wq"].dtype == torch.bfloat16
    assert not a["g0"]["attn"]["bq"].any() and bool((a["final_norm"]["scale"] == 1).all())
    assert abs(float(a["embed"]["tok"].float().std()) - 0.02) < 0.002
    wd = a["g0"]["mlp"]["w_down"].float()             # (L, d_ff, d): fan_in d_ff
    assert abs(float(wd.std()) * np.sqrt(cfg.d_ff) - 1) < 0.05
    padded = port_spec.P((4, 6), (None, None), logical=(4, 5), dtype=torch.float32)
    x = port_spec.init_params({"w": padded}, torch.Generator().manual_seed(0), "cpu")["w"]
    assert x.shape == (4, 6) and not x[:, 5].any() and x[:, :5].all()


def test_init_params_slices_large_leaves(monkeypatch):
    """With the slice threshold lowered below some leaves: a leaf under it
    is drawn bit for bit as before (the generator's state carried over
    from the sliced leaves drawn first), and a sliced leaf keeps the law —
    its scale, zero and one leaves untouched, its head padding zero."""
    spec = {"a_big": port_spec.P((3, 40, 30), (None, None, None)),           # fan_in 40
            "b_pad": port_spec.P((50, 24), (None, None), logical=(50, 20)),  # padded
            "c_ones": port_spec.P((7,), (None,), "ones"),
            "d_small": port_spec.P((8, 9), (None, None), dtype=torch.float32)}
    seed = 5
    before = port_spec.init_params(spec, torch.Generator().manual_seed(seed), "cpu")
    monkeypatch.setattr(port_spec, "SLICE_ABOVE", 999)
    monkeypatch.setattr(port_spec, "SLICE_ELEMS", 256)
    after = port_spec.init_params(spec, torch.Generator().manual_seed(seed), "cpu")
    gen = torch.Generator().manual_seed(seed)
    for n in (3 * 40 * 30, 50 * 20):                             # the sliced leaves' draws
        for lo in range(0, n, 256):
            torch.randn(min(256, n - lo), generator=gen)
    x = torch.randn((8, 9), generator=gen, dtype=torch.float32) * (1 / np.sqrt(8))
    assert torch.equal(after["d_small"], x.to(torch.float32))
    assert torch.equal(before["c_ones"], after["c_ones"]) and bool((after["c_ones"] == 1).all())
    a = after["a_big"]
    assert a.shape == (3, 40, 30) and a.dtype == torch.bfloat16
    assert abs(float(a.float().std()) * np.sqrt(40) - 1) < 0.05
    b = after["b_pad"]
    assert b.shape == (50, 24) and not b[:, 20:].any() and b[:, :20].all()
    assert abs(float(b[:, :20].float().std()) * np.sqrt(50) - 1) < 0.08


def test_init_params_runs_on_the_card_unless_asked():
    """No device means the CUDA card (raising without one), and the
    generator must live where the parameters are drawn."""
    spec = {"w": port_spec.P((2, 3), (None, None))}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_spec.init_params(spec, torch.Generator())
    else:
        with pytest.raises(ValueError, match="generator"):
            port_spec.init_params(spec, torch.Generator())
        assert port_spec.init_params(
            spec, torch.Generator(device="cuda"))["w"].device.type == "cuda"
    assert port_spec.init_params(spec, torch.Generator(), "cpu")["w"].device.type == "cpu"


@pytest.mark.parametrize("src", ["float32", "bfloat16"])
def test_params_from_numpy(jmesh, src):
    """The reference's parameters as numpy arrays -> the port's, key for key:
    bfloat16 leaves (``ml_dtypes``) bit for bit, float32 exactly, or cast."""
    _, jctx = jmesh
    cfg = ref_configs.get_smoke_config("qwen2-1.5b")
    ref = ref_spec.init_params(ref_bb.model_spec(cfg, jctx), jax.random.PRNGKey(0))
    if src == "float32":
        ref = jax.tree.map(lambda a: a.astype(jnp.float32), ref)
    arrays = jax.tree.map(np.asarray, ref)
    got = port_spec.params_from_numpy(arrays, "cpu")
    flat_r, flat_g = jax.tree.leaves(arrays), jax.tree.leaves(got)
    assert jax.tree.structure(arrays) == jax.tree.structure(
        port_spec.tree_map(lambda _: 0, got))
    for r, g in zip(flat_r, flat_g):
        assert tuple(g.shape) == r.shape
        if src == "bfloat16":
            assert r.dtype == ml_dtypes.bfloat16 and g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.view(torch.int16).numpy(), r.view(np.int16))
        else:
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), r)
    cast = port_spec.params_from_numpy(arrays, "cpu", torch.float32)
    assert cast["g0"]["attn"]["wq"].dtype == torch.float32
    np.testing.assert_array_equal(cast["g0"]["attn"]["wq"].numpy(),
                                  np.asarray(arrays["g0"]["attn"]["wq"], np.float32))
