"""The frontend families' serving path — whisper-tiny's encoder-decoder
(``encdec``, frontend ``audio_stub``: cross attention, the encoder, the
``dec`` block and its ``"self"`` / ``"cross"`` cache) and pixtral-12b's
``patch_stub`` frontend (embeddings that replace the positions whose token
is below 0) — held against the JAX package's on the same inputs and
weights: one float32 weight set per config, drawn by ``draw_tree`` with a
numpy seed over the reference's spec and carried to the port with
``params_from_numpy``, as it is or cast to bfloat16 on both sides.  The
frames and patch embeddings are drawn with numpy too: frames standard
normal, patches at the token table's scale (0.02).

The port runs on ``device="cpu"``; the reference's functions run jitted in
a 1x1 ``jax.shard_map``, its step functions and scheduler on a 1x1 mesh.
Both configs run at their smoke widths.  Tolerances, those of
``tests/test_torch_serve.py`` and ``tests/test_torch_models.py``:

* blocks, the encoder and ``forward``'s final-norm states: 1e-4 with
  float32 parameters; 0.05 absolute plus 0.02 relative with bfloat16 ones
  (XLA's CPU backend fuses bfloat16 elementwise work before rounding, torch
  rounds after each op);
* a block's caches (bfloat16 in both packages) with float32 parameters:
  one bfloat16 ulp, 1/128 relative; a cross decode's output reads one, and
  jitted XLA rounds elsewhere than the ops do (``tests/test_torch_models.py``):
  1/128; with bfloat16 parameters the bfloat16 tolerance above;
* prefill and decode steps with float32 parameters: the prefill's caches
  within 1/128 relative; the rows decode steps add carry that fused
  rounding into their layer inputs, 1/32 absolute plus 1/128 relative
  (``tests/test_torch_serve.py``); every step's logits within 1/64 of the
  reference's (measured at most 0.0062 over five weight and prompt seeds
  at these widths).  With bfloat16 parameters: the reference's own
  bfloat16 envelope (``within_bf16_envelope``: the port's caches and logits
  no farther from the reference's float32 run than its bfloat16 run is, up
  to 1.5x, largest and mean difference), since over the encoder and two
  decoder layers the two packages' bfloat16 roundings part by a few ulps
  of single values;
* ``BatchScheduler.run(extras=)``: every ``ServeStats`` count and
  ``finished`` flag equal (``wall_s`` aside); each completion's tokens
  equal up to the first position where the two differ, which must be a near
  tie of the port's no-cache ``forward``: a top-2 margin of at most 1/32 in
  float32 (twice the logit tolerance: two argmaxes of logits within 1/64
  part only below it) and 0.05 in bfloat16 (the forward logits of the two
  packages part by at most 0.0176 at these widths, seven seeds); at least
  half of all generated positions compared.  float32 greedy decodes part
  only at such ties: a top-2 margin of 0.0008 parted pixtral's at one
  position.

Two differences from the reference, each pinned here: the ``max_len``
guard covers the ``dec`` block's ``"self"`` cache, where the reference's
decode writes past ``max_len`` at the position modulo ``max_len``; and a
``patch_stub`` model serves a text-only batch without ``"frontend"``,
where the reference's jitted prefill requires the key.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_models import draw_tree, j, leaves, on_mesh, t, to_np

import repro.configs as ref_configs
import repro.models.attention as ref_attn
import repro.models.backbone as ref_bb
import repro.serve.engine as ref_engine
from repro.launch.mesh import make_local_mesh as ref_mesh
from repro.serve.scheduler import BatchScheduler as RefScheduler
from repro.serve.scheduler import Request as RefRequest
from repro.train.step import mesh_ctx as ref_mesh_ctx
import repro_torch.configs as port_configs
import repro_torch.models.attention as port_attn
import repro_torch.models.backbone as port_bb
import repro_torch.serve.engine as port_engine
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.layers import MeshCtx
from repro_torch.models.spec import params_from_numpy
from repro_torch.serve.scheduler import BatchScheduler, Request

PCTX = MeshCtx()
DTYPES = ["float32", "bfloat16"]
ARCHS = ["whisper-tiny", "pixtral-12b"]
F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=0.05, rtol=0.02)
MARGIN = {"float32": 1 / 32, "bfloat16": 0.05}
LOGIT_TOL = dict(atol=1 / 64, rtol=0)
DECODED_TOL = dict(atol=1 / 32, rtol=1 / 128)
TE = 24          # encoder frames at smoke width


@pytest.fixture(scope="module")
def jmesh():
    mesh = ref_mesh(1, 1)
    return mesh, ref_mesh_ctx(mesh)


@pytest.fixture(scope="module")
def cpu_mesh():
    return make_local_mesh(device="cpu")


def configs(arch):
    return ref_configs.get_smoke_config(arch), port_configs.get_smoke_config(arch)


def weights(jmesh, arch, dtype, seed):
    """(JAX params, port params) of one float32 draw, both in ``dtype``."""
    cfg, _ = configs(arch)
    arrays = draw_tree(ref_bb.model_spec(cfg, jmesh[1]), np.random.default_rng(seed))
    jdt, tdt = (jnp.float32, None) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    return (jax.tree.map(lambda a: jnp.asarray(a, jdt), arrays),
            params_from_numpy(arrays, "cpu", tdt))


def tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


def frames(rng, cfg, B, Te=TE):
    return rng.standard_normal((B, Te, cfg.d_model)).astype(np.float32)


def patches(rng, cfg, B, T):
    return (0.02 * rng.standard_normal((B, T, cfg.d_model))).astype(np.float32)


def image_prompt(rng, cfg, n_text):
    """A prompt of ``n_frontend_tokens`` patch positions (-1), then text."""
    return [-1] * cfg.n_frontend_tokens + [int(x) for x in rng.integers(0, cfg.vocab, n_text)]


def extras_for(arch, rng, cfg, B, T):
    """The inputs besides the tokens that a batch of B prompts of T tokens
    takes: the encoder's frames or the patch embeddings."""
    if arch == "whisper-tiny":
        return {"enc": frames(rng, cfg, B)}
    return {"frontend": patches(rng, cfg, B, T)}


def forward_kwargs(extras, T):
    """``forward``'s keywords for ``extras`` over T positions: a frontend is
    padded with zero rows past the prompt (positions of tokens >= 0)."""
    if "enc" in extras:
        return {"enc_embeds": torch.as_tensor(extras["enc"])}
    fe = torch.as_tensor(extras["frontend"])
    return {"frontend": torch.nn.functional.pad(fe, (0, 0, 0, T - fe.shape[1]))}


def port_logits(pp, pcfg, tokens: np.ndarray, extras) -> torch.Tensor:
    x = port_bb.forward(pp, torch.from_numpy(tokens.astype(np.int32)), PCTX, pcfg,
                        **forward_kwargs(extras, tokens.shape[1]))
    return port_bb.vocab_logits(pp["embed"], x, PCTX, pcfg)


def margins(logits: torch.Tensor) -> np.ndarray:
    top2 = logits.topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).numpy()


def ref_extras(extras):
    return {k: j(v) for k, v in extras.items()}


# ---------------------------------------------------------------------------
# cross attention and the encoder
# ---------------------------------------------------------------------------


def _cross_setup(jmesh, dtype, seed):
    cfg, pcfg = configs("whisper-tiny")
    p = draw_tree(ref_bb.block_spec(cfg, jmesh[1], "dec"), np.random.default_rng(seed))
    tdt, jdt = (None, jnp.float32) if dtype == "float32" else (torch.bfloat16, jnp.bfloat16)
    return cfg, pcfg, tdt, jdt, params_from_numpy(p, "cpu", tdt)["cross"], jax.tree.map(
        lambda a: j(a, jdt), p)["cross"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_prefill(jmesh, dtype):
    """``gqa_apply(memory=)``: no rope on q, k or v; k and v from the memory."""
    cfg, pcfg, tdt, jdt, pp, jp = _cross_setup(jmesh, dtype, 30)
    rng = np.random.default_rng(31)
    x = rng.normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    mem = rng.normal(size=(2, TE, cfg.d_model)).astype(np.float32)
    o, (k, v) = port_attn.gqa_apply(pp, t(x, tdt), PCTX, pcfg, causal=False,
                                    memory=t(mem, tdt), return_kv=True)
    ro, (rk, rv) = on_mesh(jmesh, lambda pa, xx, mm: ref_attn.gqa_apply(
        pa, xx, jmesh[1], cfg, causal=False, memory=mm, return_kv=True), jp, j(x, jdt), j(mem, jdt))
    for got, exp in ((o, ro), (k, rk), (v, rv)):
        assert tuple(got.shape) == exp.shape
        assert str(got.dtype).split(".")[-1] == str(exp.dtype) == dtype
        np.testing.assert_allclose(to_np(got), to_np(exp), **tol(dtype))
    assert tuple(k.shape) == (2, cfg.n_kv_heads, TE, cfg.resolved_head_dim)


def test_cross_attention_over_a_ragged_memory(jmesh):
    """1 500 memory positions (whisper's encoder length) span a whole key
    chunk of 1 024 and a ragged one: the padding keys are masked by
    ``kv_valid_len`` (the memory's length), so the output equals a dense
    float64 softmax over the 1 500 positions, and the reference's."""
    cfg, pcfg, _, _, pp, jp = _cross_setup(jmesh, "float32", 32)
    rng = np.random.default_rng(33)
    x = rng.normal(size=(1, 5, cfg.d_model)).astype(np.float32)
    mem = rng.normal(size=(1, 1500, cfg.d_model)).astype(np.float32)
    o = port_attn.gqa_apply(pp, t(x), PCTX, pcfg, causal=False, memory=t(mem))
    ro = on_mesh(jmesh, lambda pa, xx, mm: ref_attn.gqa_apply(
        pa, xx, jmesh[1], cfg, causal=False, memory=mm), jp, j(x), j(mem))
    w = {k: np.asarray(v, np.float64) for k, v in jp.items()}
    H, dh = cfg.n_heads, cfg.resolved_head_dim
    q = ((x[0] @ w["wq"]) + w.get("bq", 0)).reshape(5, H, dh).transpose(1, 0, 2)
    k = ((mem[0] @ w["wk"]) + w.get("bk", 0)).reshape(1500, H, dh).transpose(1, 0, 2)
    v = ((mem[0] @ w["wv"]) + w.get("bv", 0)).reshape(1500, H, dh).transpose(1, 0, 2)
    s = q @ k.transpose(0, 2, 1) / np.sqrt(dh)
    pr = np.exp(s - s.max(-1, keepdims=True))
    dense = ((pr / pr.sum(-1, keepdims=True)) @ v).transpose(1, 0, 2).reshape(1, 5, H * dh)
    np.testing.assert_allclose(o.numpy(), dense @ w["wo"], **F32_TOL)
    np.testing.assert_allclose(o.numpy(), to_np(ro), **F32_TOL)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_fill_cache_and_decode(jmesh, dtype):
    """The memory's K/V cached once (bfloat16, ``len`` the host int Tm),
    then three decode steps read it whole and leave it as it was."""
    cfg, pcfg, tdt, jdt, pp, jp = _cross_setup(jmesh, dtype, 34)
    rng = np.random.default_rng(35)
    mem = rng.normal(size=(2, TE, cfg.d_model)).astype(np.float32)
    cache = port_attn.cross_fill_cache(pp, t(mem, tdt), pcfg, PCTX)
    rcache = on_mesh(jmesh, lambda pa, mm: ref_attn.cross_fill_cache(pa, mm, cfg, jmesh[1]),
                     jp, j(mem, jdt))
    assert cache["len"] == int(rcache["len"]) == TE and isinstance(cache["len"], int)
    c_tol = dict(atol=1 / 128, rtol=1 / 128) if dtype == "float32" else BF16_TOL
    for name in ("k", "v"):
        assert cache[name].dtype == torch.bfloat16
        np.testing.assert_allclose(to_np(cache[name]), to_np(rcache[name]), **c_tol)
    before = {name: cache[name].clone() for name in ("k", "v")}
    for _ in range(3):
        xt = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        o = port_attn.cross_decode(pp, t(xt, tdt), cache, PCTX, pcfg)
        ro = on_mesh(jmesh, lambda pa, c, xx: ref_attn.cross_decode(pa, xx, c, jmesh[1], cfg),
                     jp, rcache, j(xt, jdt))
        assert str(o.dtype).split(".")[-1] == str(ro.dtype) == dtype
        np.testing.assert_allclose(to_np(o), to_np(ro), **c_tol)
    for name in ("k", "v"):
        assert torch.equal(cache[name], before[name])


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode(jmesh, dtype):
    """The encoder: frames cast to the parameters' dtype, non-causal
    ``attn`` blocks with rope, its own norm."""
    cfg, pcfg = configs("whisper-tiny")
    jp, pp = weights(jmesh, "whisper-tiny", dtype, 36)
    enc = frames(np.random.default_rng(37), cfg, 2)
    got = port_bb.encode(pp, torch.from_numpy(enc), PCTX, pcfg)
    ref = on_mesh(jmesh, lambda p, e: ref_bb.encode(p, e, jmesh[1], cfg, remat=False),
                  jp, j(enc))
    assert tuple(got.shape) == ref.shape == (2, TE, cfg.d_model)
    assert str(got.dtype).split(".")[-1] == str(ref.dtype) == dtype
    np.testing.assert_allclose(to_np(got), to_np(ref), **tol(dtype))


# ---------------------------------------------------------------------------
# forward with the frontends' inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_the_reference(jmesh, arch, dtype):
    cfg, pcfg = configs(arch)
    jp, pp = weights(jmesh, arch, dtype, 38)
    rng = np.random.default_rng(39)
    toks = rng.integers(0, cfg.vocab, size=(2, 13)).astype(np.int32)
    toks[:, :cfg.n_frontend_tokens] = -1          # pixtral's patches lead; whisper has none
    extras = extras_for(arch, rng, cfg, 2, 13)
    got = port_bb.forward(pp, torch.from_numpy(toks), PCTX, pcfg, **forward_kwargs(extras, 13))
    kw = ({"enc_embeds_sp": j(extras["enc"])} if "enc" in extras
          else {"frontend_sp": j(extras["frontend"])})
    ref = on_mesh(jmesh, lambda p, tk, kwa: ref_bb.forward(
        p, tk, jmesh[1], cfg, ep_data_size=1, remat=False, **kwa)[0], jp, jnp.asarray(toks), kw)
    assert str(got.dtype).split(".")[-1] == str(ref.dtype) == dtype
    np.testing.assert_allclose(to_np(got), to_np(ref), **tol(dtype))


def test_frontend_replaces_only_the_negative_positions():
    """``embed_inputs``: where a token is below 0 the frontend's row (cast
    to the parameters' dtype), elsewhere the token's embedding, whatever the
    frontend holds there."""
    _, pcfg = configs("pixtral-12b")
    pp = params_from_numpy(draw_tree(ref_bb.embed_spec(configs("pixtral-12b")[0]),
                                     np.random.default_rng(40)), "cpu", torch.bfloat16)
    rng = np.random.default_rng(41)
    toks = torch.from_numpy(rng.integers(0, pcfg.vocab, size=(2, 11)).astype(np.int32))
    toks[0, :8] = -1
    toks[1, 3:5] = -2
    fe = torch.from_numpy(patches(rng, pcfg, 2, 11))
    got = port_bb.embed_inputs(pp, toks, PCTX, pcfg, fe)
    plain = port_bb.embed_tokens(pp, toks.clamp(min=0), PCTX, pcfg)
    neg = toks < 0
    assert got.dtype == torch.bfloat16
    assert torch.equal(got[neg], fe.to(torch.bfloat16)[neg])
    assert torch.equal(got[~neg], plain[~neg])
    assert torch.equal(port_bb.embed_inputs(pp, toks, PCTX, pcfg), plain)


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------


def within_bf16_envelope(got, ref_bf16, ref_f32, slack: float = 1.5):
    """The port's bfloat16 result lies no farther from the reference's
    float32 result than the reference's own bfloat16 result does, up to
    ``slack``, in the largest and in the mean absolute difference (as in
    ``tests/test_torch_recurrent.py``)."""
    assert tuple(got.shape) == tuple(ref_bf16.shape) == tuple(ref_f32.shape)
    e_port = np.abs(to_np(got) - to_np(ref_f32))
    e_ref = np.abs(to_np(ref_bf16) - to_np(ref_f32))
    assert e_port.max() <= slack * e_ref.max() + 1e-6, (e_port.max(), e_ref.max())
    assert e_port.mean() <= slack * e_ref.mean() + 1e-7, (e_port.mean(), e_ref.mean())


def _ref_logits(p, x, ctx, cfg):
    """In place of the reference's ``greedy_token``: the float32 logits it
    takes the argmax of (no softcap in these configs, one vocab shard)."""
    logits = (x[:, 0] @ ref_bb._unembed_weight(p, cfg)).astype(jnp.float32)
    return ref_bb._mask_vocab_pad(logits, 0, cfg)


def _served(jmesh, cpu_mesh, arch, jp, pp, prompt, forced, extras, monkeypatch):
    """Prefill and ``forced``'s decode steps in both packages, each step's
    logits recorded: (port caches after prefill, after the steps, port
    logits (B, 1 + steps, V); the reference's the same)."""
    cfg, pcfg = configs(arch)
    assert not cfg.logit_softcap
    B, T = prompt.shape
    port_rec, greedy = [], port_engine.greedy_token

    def recording(p, x, ctx, cfg_):
        port_rec.append(port_bb.vocab_logits(p, x[:, 0], ctx, cfg_))
        return greedy(p, x, ctx, cfg_)

    monkeypatch.setattr(port_engine, "greedy_token", recording)
    monkeypatch.setattr(ref_engine, "greedy_token", _ref_logits)
    ref = ref_engine.make_serve_fns(cfg, jmesh[0], batch=B, max_len=24, enc_len=TE)
    port = port_engine.make_serve_fns(pcfg, cpu_mesh, batch=B, max_len=24, enc_len=TE)
    rcaches, rl = ref.prefill(jp, {"tokens": jnp.asarray(prompt), **ref_extras(extras)})
    caches, _ = port.prefill(pp, {"tokens": torch.from_numpy(prompt),
                                  **{k: torch.from_numpy(v) for k, v in extras.items()}})
    # copies: the port's decode writes its caches in place, the reference's
    # donates them
    filled = ({k: v.clone() if isinstance(v, torch.Tensor) else v
               for k, v in leaves(caches)}, {k: np.asarray(v) for k, v in leaves(rcaches)})
    ref_rec = [rl]
    for s in range(forced.shape[1]):
        rl, rcaches = ref.decode(jp, rcaches, jnp.asarray(forced[:, s:s + 1]))
        _, caches = port.decode(pp, caches, torch.from_numpy(forced[:, s:s + 1]))
        ref_rec.append(rl)
    return (filled[0], dict(leaves(caches)), torch.stack(port_rec, 1),
            filled[1], dict(leaves(rcaches)), np.stack([np.asarray(r) for r in ref_rec], 1))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(jmesh, cpu_mesh, arch, dtype, monkeypatch):
    """Prefill with the inputs besides the tokens, then 6 decode steps fed
    the same tokens in both packages: the caches (whisper's ``"self"`` and
    ``"cross"``) and every step's logits against the reference's.  float32:
    prefill caches within a bfloat16 ulp, the decoded rows within
    ``DECODED_TOL``, the logits within ``LOGIT_TOL``.  bfloat16: each within the reference's own
    bfloat16 envelope around its float32 run of the same weights.  whisper's
    cross cache is left as prefill filled it."""
    cfg, pcfg = configs(arch)
    B, T, steps = 2, 12, 6
    rng = np.random.default_rng(43)
    prompt = rng.integers(0, cfg.vocab, size=(B, T)).astype(np.int32)
    prompt[:, :cfg.n_frontend_tokens] = -1
    forced = rng.integers(0, cfg.vocab, size=(B, steps)).astype(np.int32)
    extras = extras_for(arch, rng, cfg, B, T)
    jp, pp = weights(jmesh, arch, dtype, 42)
    filled, final, logits, rfilled, rfinal, rlogits = _served(
        jmesh, cpu_mesh, arch, jp, pp, prompt, forced, extras, monkeypatch)
    assert filled.keys() == rfilled.keys() == final.keys() == rfinal.keys()
    if dtype == "bfloat16":
        jp32, pp32 = weights(jmesh, arch, "float32", 42)
        _, _, _, rfilled32, rfinal32, rlogits32 = _served(
            jmesh, cpu_mesh, arch, jp32, pp32, prompt, forced, extras, monkeypatch)
    for when, got, ref in (("prefill", filled, rfilled), ("decode", final, rfinal)):
        for path, a in got.items():
            if path[-1] == "len":
                n = TE if "cross" in path else T + (steps if when == "decode" else 0)
                assert a == n and np.all(np.asarray(ref[path]) == n), path
                continue
            assert a.dtype == torch.bfloat16 and tuple(a.shape) == ref[path].shape, path
            if dtype == "bfloat16":
                within_bf16_envelope(a, ref[path], (rfilled32 if when == "prefill"
                                                    else rfinal32)[path])
            elif when == "prefill":
                np.testing.assert_allclose(to_np(a), to_np(ref[path]), rtol=1 / 128, atol=1e-6)
            else:
                np.testing.assert_allclose(to_np(a), to_np(ref[path]), **DECODED_TOL)
    assert tuple(logits.shape) == rlogits.shape == (B, 1 + steps, rlogits.shape[-1])
    if dtype == "bfloat16":
        within_bf16_envelope(logits, rlogits, rlogits32)
    else:
        np.testing.assert_allclose(logits.numpy(), rlogits, **LOGIT_TOL)
    if arch == "whisper-tiny":
        assert tuple(final[("g0", "cross", "k")].shape) == (
            cfg.n_layers, B, cfg.n_kv_heads, TE, cfg.resolved_head_dim)
        for name in ("k", "v"):
            assert torch.equal(final[("g0", "cross", name)], filled[("g0", "cross", name)])


def test_cross_cache_is_not_copied_at_decode(jmesh, cpu_mesh, monkeypatch):
    """Decode hands each layer's cross cache back as its views of the
    stacked tensors, so the write-back copies nothing into them; the self
    cache is written in place as well."""
    cfg, pcfg = configs("whisper-tiny")
    _, pp = weights(jmesh, "whisper-tiny", "bfloat16", 44)
    rng = np.random.default_rng(45)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 5)).astype(np.int32))
    port = port_engine.make_serve_fns(pcfg, cpu_mesh, batch=2, max_len=16, enc_len=TE)
    caches, tok = port.prefill(pp, {"tokens": prompt, "enc": torch.from_numpy(frames(rng, cfg, 2))})
    bufs = {part: {n: caches["g0"][part][n] for n in ("k", "v")} for part in ("self", "cross")}
    ptrs = {b.untyped_storage().data_ptr() for part in bufs.values() for b in part.values()}
    copied, copy_ = [], torch.Tensor.copy_

    def recording_copy(dst, src, *a, **kw):
        copied.append(dst.untyped_storage().data_ptr())
        return copy_(dst, src, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "copy_", recording_copy)
    for _ in range(3):
        tok, caches = port.decode(pp, caches, tok[:, None])
    assert not ptrs & set(copied), copied
    for part, names in bufs.items():
        for n, buf in names.items():
            assert caches["g0"][part][n] is buf


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_token_is_the_forward_argmax(jmesh, cpu_mesh, arch):
    """Within the port: prefill's greedy token is the argmax of the no-cache
    forward's logits at the last position, given the same frames or patches
    (the check ``chip_smoke.py`` relies on at full width)."""
    cfg, pcfg = configs(arch)
    _, pp = weights(jmesh, arch, "float32", 46)
    rng = np.random.default_rng(47)
    prompt = rng.integers(0, cfg.vocab, size=(3, 11)).astype(np.int32)
    prompt[:, :cfg.n_frontend_tokens] = -1
    extras = extras_for(arch, rng, cfg, 3, 11)
    _, tok = port_engine.make_serve_fns(pcfg, cpu_mesh, batch=3, max_len=16, enc_len=TE).prefill(
        pp, {"tokens": torch.from_numpy(prompt), **{k: torch.from_numpy(v) for k, v in extras.items()}})
    np.testing.assert_array_equal(tok.numpy(),
                                  port_logits(pp, pcfg, prompt, extras)[:, -1].argmax(-1))


@pytest.mark.parametrize("case", ["enc_len", "enc_batch", "frontend_len", "frontend_batch"])
def test_prefill_refuses_inputs_of_another_shape(jmesh, cpu_mesh, case):
    """``"enc"`` must be (B, enc_len, d) and ``"frontend"`` (B, T, d) for
    tokens (B, T): the port says which, where the reference fails inside
    ``jit`` or not at all."""
    arch = "whisper-tiny" if case.startswith("enc") else "pixtral-12b"
    cfg, pcfg = configs(arch)
    _, pp = weights(jmesh, arch, "float32", 48)
    rng = np.random.default_rng(49)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 10)).astype(np.int32))
    tokens[:, :cfg.n_frontend_tokens] = -1
    shape = {"enc_len": (2, TE + 1), "enc_batch": (1, TE),
             "frontend_len": (2, 9), "frontend_batch": (1, 10)}[case]
    extra = torch.from_numpy(rng.standard_normal(shape + (cfg.d_model,)).astype(np.float32))
    port = port_engine.make_serve_fns(pcfg, cpu_mesh, batch=2, max_len=16, enc_len=TE)
    match = r"enc of shape .*enc_len 24" if arch == "whisper-tiny" else "frontend of shape"
    with pytest.raises(ValueError, match=match):
        port.prefill(pp, {"tokens": tokens, case.split("_")[0]: extra})


@pytest.mark.parametrize("enc_len", [None, 1500])
def test_cache_spec_with_enc_len(jmesh, cpu_mesh, enc_len):
    """whisper-tiny at full width, batch 8, ``max_len`` 448: every cache
    leaf has the reference's path, shape and dtype, the ``"cross"`` part
    ``enc_len`` positions (the reference's default 1 536 where none is
    given), the ``"self"`` part ``max_len``."""
    kw = {} if enc_len is None else {"enc_len": enc_len}
    got = dict(leaves(port_engine.abstract_cache(port_configs.get_config("whisper-tiny"),
                                                 cpu_mesh, 8, 448, **kw)))
    ref = dict(leaves(ref_engine.abstract_cache(ref_configs.get_config("whisper-tiny"),
                                                jmesh[0], 8, 448, **kw)))
    assert got.keys() == ref.keys()
    for path, a in got.items():
        assert tuple(a.shape) == ref[path].shape and a.device.type == "meta", path
        assert str(a.dtype).split(".")[-1] == str(ref[path].dtype), path
    assert tuple(got[("g0", "cross", "k")].shape) == (4, 8, 6, enc_len or 1536, 64)
    assert tuple(got[("g0", "self", "v")].shape) == (4, 8, 6, 448, 64)


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------


def _requests(arch, cfg, cls):
    """whisper: three prompt lengths (a full batch of 2, a full and an
    underfull one, an underfull one) under one ``enc``.  pixtral: one
    length, since a frontend fits one: an image and text, 3 requests."""
    rng = np.random.default_rng(50)
    if arch == "whisper-tiny":
        lens, max_new = [8, 8, 12, 12, 12, 5], [6, 4, 7, 5, 6, 3]
        return [cls(i, [int(x) for x in rng.integers(0, cfg.vocab, n)], m)
                for i, (n, m) in enumerate(zip(lens, max_new))]
    return [cls(i, image_prompt(rng, cfg, 6), m) for i, m in enumerate([6, 7, 4])]


def _run_extras(arch, cfg):
    rng = np.random.default_rng(51)
    return extras_for(arch, rng, cfg, 2, cfg.n_frontend_tokens + 6)


def _compared_prefix(pp, pcfg, prompt, got: list, exp: list, extras, margin) -> int:
    """How many leading tokens of ``got`` and ``exp`` are equal; where they
    first differ the port's no-cache forward must have a near tie.  A
    request's extras are row 0's (the rows of a batch share nothing else)."""
    n = next((i for i, (a, b) in enumerate(zip(got, exp)) if a != b), None)
    if n is None:
        assert len(got) == len(exp), (got, exp)
        return len(got)
    seq = np.asarray([prompt + got[:n]], np.int32)
    assert margins(port_logits(pp, pcfg, seq, extras)[:, -1])[0] <= margin, (n, got, exp)
    return n


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_scheduler_matches_the_reference(jmesh, cpu_mesh, arch, dtype):
    cfg, pcfg = configs(arch)
    jp, pp = weights(jmesh, arch, dtype, 52)
    extras = _run_extras(arch, cfg)
    ref_out, ref_stats = RefScheduler(cfg, jmesh[0], batch=2, max_len=32, eos_id=-1,
                                      enc_len=TE).run(jp, _requests(arch, cfg, RefRequest),
                                                      extras=ref_extras(extras))
    out, stats = BatchScheduler(pcfg, cpu_mesh, batch=2, max_len=32, eos_id=-1,
                                enc_len=TE).run(pp, _requests(arch, cfg, Request), extras=extras)
    reqs = {r.rid: r for r in _requests(arch, cfg, Request)}
    assert out.keys() == ref_out.keys() == reqs.keys()
    compared = 0
    for rid in ref_out:
        assert out[rid].finished == ref_out[rid].finished, rid
        # a request's row: 0 in its batch, or 1 for the second of a full batch
        row = [r.rid for r in reqs.values() if len(r.prompt) == len(reqs[rid].prompt)].index(rid) % 2
        own = {k: v[row:row + 1] for k, v in extras.items()}
        compared += _compared_prefix(pp, pcfg, reqs[rid].prompt, out[rid].tokens,
                                     ref_out[rid].tokens, own, MARGIN[dtype])
    assert compared * 2 >= sum(len(c.tokens) for c in out.values()), compared
    for f in ("requests", "prefill_tokens", "decode_steps", "batches"):
        assert getattr(stats, f) == getattr(ref_stats, f), f
    assert all(len(out[rid].tokens) == r.max_new for rid, r in reqs.items())


@pytest.mark.parametrize("arch", ARCHS)
def test_scheduler_takes_numpy_or_tensor_extras(jmesh, cpu_mesh, arch):
    """``extras`` as numpy arrays or as tensors give the same completions."""
    cfg, pcfg = configs(arch)
    _, pp = weights(jmesh, arch, "float32", 53)
    extras = _run_extras(arch, cfg)
    sched = BatchScheduler(pcfg, cpu_mesh, batch=2, max_len=32, eos_id=-1, enc_len=TE)
    a, _ = sched.run(pp, _requests(arch, cfg, Request), extras=extras)
    b, _ = sched.run(pp, _requests(arch, cfg, Request),
                     extras={k: torch.from_numpy(v) for k, v in extras.items()})
    assert a == b


def test_text_only_batch_needs_no_frontend(jmesh, cpu_mesh):
    """A ``patch_stub`` model's text-only batch: the port serves it without
    ``"frontend"``; the reference's jitted prefill requires the key (its
    input shardings name it), and with one of any values, since no token is
    below 0, gives the port's tokens."""
    cfg, pcfg = configs("pixtral-12b")
    jp, pp = weights(jmesh, "pixtral-12b", "float32", 54)
    rng = np.random.default_rng(55)
    prompts = [[int(x) for x in rng.integers(0, cfg.vocab, 9)] for _ in range(2)]
    noise = {"frontend": patches(rng, cfg, 2, 9)}
    ref_out, _ = RefScheduler(cfg, jmesh[0], batch=2, max_len=32, eos_id=-1).run(
        jp, [RefRequest(i, p, 5) for i, p in enumerate(prompts)], extras=ref_extras(noise))
    out, _ = BatchScheduler(pcfg, cpu_mesh, batch=2, max_len=32, eos_id=-1).run(
        pp, [Request(i, p, 5) for i, p in enumerate(prompts)])
    assert {r: c.tokens for r, c in out.items()} == {r: c.tokens for r, c in ref_out.items()}
    with pytest.raises(ValueError):
        RefScheduler(cfg, jmesh[0], batch=2, max_len=32, eos_id=-1).run(
            jp, [RefRequest(0, prompts[0], 2)])


def test_max_len_guard_covers_the_dec_self_cache(jmesh, cpu_mesh):
    """whisper's ``dec`` blocks keep a self-attention cache of ``max_len``
    positions.  8 prompt + 3 decoded positions need 11; with max_len=10 the
    reference's ``gqa_decode`` writes position 10 over slot 0 (the position
    modulo ``max_len``) and reads on as if nothing was lost.  The port's
    decode refuses the write, and its scheduler refuses a request that needs
    it (exactly full is allowed), as for ``attn`` caches
    (``tests/test_torch_serve.py::test_max_len_guard_where_the_reference_clamps``)."""
    cfg, pcfg = configs("whisper-tiny")
    jp, pp = weights(jmesh, "whisper-tiny", "float32", 56)
    rng = np.random.default_rng(57)
    prompt = rng.integers(0, cfg.vocab, size=(1, 8)).astype(np.int32)
    enc = frames(rng, cfg, 1)
    ref = ref_engine.make_serve_fns(cfg, jmesh[0], batch=1, max_len=10, enc_len=TE)
    rcaches, tok = ref.prefill(jp, {"tokens": jnp.asarray(prompt), "enc": j(enc)})
    slot0 = np.asarray(rcaches["g0"]["self"]["k"][:, :, :, 0])
    for _ in range(3):
        tok, rcaches = ref.decode(jp, rcaches, tok[:, None])
    assert np.all(np.asarray(rcaches["g0"]["self"]["len"]) == 11)
    assert not np.array_equal(np.asarray(rcaches["g0"]["self"]["k"][:, :, :, 0]), slot0)

    port = port_engine.make_serve_fns(pcfg, cpu_mesh, batch=1, max_len=10, enc_len=TE)
    caches, ptok = port.prefill(pp, {"tokens": torch.from_numpy(prompt),
                                     "enc": torch.from_numpy(enc)})
    for _ in range(2):
        ptok, caches = port.decode(pp, caches, ptok[:, None])
    with pytest.raises(ValueError, match="KV cache full"):
        port.decode(pp, caches, ptok[:, None])

    def served(max_len, max_new):
        return BatchScheduler(pcfg, cpu_mesh, batch=1, max_len=max_len, eos_id=-1,
                              enc_len=TE).run(pp, [Request(0, prompt[0].tolist(), max_new)],
                                              extras={"enc": enc})[0][0].tokens

    assert len(served(32, 6)) == 6
    with pytest.raises(ValueError, match="exceed the 10-position KV cache"):
        served(10, 4)
    assert len(served(10, 3)) == 3               # 8 + 3 - 1 = 10 positions
