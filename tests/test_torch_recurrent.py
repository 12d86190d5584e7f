"""The recurrent families' serving path — ``repro_torch.models.rglru``,
``.ssm``, sliding-window attention (``local_*``) and the ``hybrid`` and
``ssm`` plans of ``backbone`` and ``serve`` — held against the JAX
package's on the same inputs and weights (drawn in float32 with a numpy
seed, carried to both packages as they are or cast to bfloat16 on both
sides).  The port runs on ``device="cpu"``; the reference's functions run
jitted inside a 1x1 ``jax.shard_map``.

recurrentgemma-2b runs at its smoke widths with 8 layers (two stacked
periods of rglru, rglru, attn and two unscanned rglru groups) and a window
of 64; mamba2-780m at its smoke config (chunk 32).  Tolerances:

* float32: 2e-5 on a block's output and state (the RG-LRU's doubling scan
  and ``lax.associative_scan`` round in other orders; the SSD's einsums
  contract in other orders), 1e-4 on ``forward``'s final-norm states.
  Against a bfloat16 ring or cache (prefill caches, decode attention,
  decode logits): XLA's CPU fusion rounds to bfloat16 elsewhere than the
  ops do (as in ``tests/test_torch_models.py``), 1/128 there;
* bfloat16, one block: XLA's CPU backend computes bfloat16 elementwise
  work in float32 and fuses ops before rounding, torch rounds after each
  op: 0.05 absolute plus 0.02 relative, the bfloat16 tolerance of
  ``test_torch_models.py``;
* bfloat16, the whole model: over 8 layers the two packages' roundings
  part by as much as bfloat16 parts from float32 (final-norm states up to
  0.15 apart, mean 0.015, in both), so a model's bfloat16 states, caches
  and logits are held to the reference's own envelope: no farther from the
  reference's float32 result than the reference's bfloat16 result is, up
  to 1.5 times, in the largest and in the mean difference;
* ``local_fill_cache``: exactly equal (it only moves and casts);
* tokens: equal wherever the top-2 logit margin exceeds ``MARGIN`` (0.01
  float32, 0.1 bfloat16) and at least ``CHECKED`` of the positions are
  checked (below).

recurrentgemma's tokens are held against the reference's no-cache
``forward``, not its decode: the reference stores the conv *output* tail in
its decode cache (``src/repro/models/rglru.py:87,113,119``), so its decode
departs from its own ``forward`` after every prefill.  The port stores the
pre-conv tail; ``test_rglru_cache_holds_the_pre_conv_tail_where_the_reference_holds_the_conv_output``
pins the difference.  The reference also mishandles prompts shorter than
the conv's 3-step halo: 1 token raises ``IndexError``, 2 tokens convolve a
halo of 2 rows misaligned with the taps
(``test_short_prompts_where_the_reference_fails``).
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
import repro.models.config as ref_config
import repro.models.rglru as ref_rglru
import repro.models.spec as ref_spec
import repro.models.ssm as ref_ssm
import repro.serve.engine as ref_engine
from repro.launch.mesh import make_local_mesh as ref_mesh
from repro.serve.scheduler import BatchScheduler as RefScheduler
from repro.serve.scheduler import Request as RefRequest
from repro.train.step import mesh_ctx as ref_mesh_ctx
import repro_torch.configs as port_configs
import repro_torch.models.attention as port_attn
import repro_torch.models.backbone as port_bb
import repro_torch.models.rglru as port_rglru
import repro_torch.models.ssm as port_ssm
import repro_torch.serve.engine as port_engine
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.layers import MeshCtx
from repro_torch.models.spec import count_params, params_from_numpy, tree_map
from repro_torch.serve.scheduler import BatchScheduler, Request

PCTX = MeshCtx()
RG, MB = "recurrentgemma-2b", "mamba2-780m"
DTYPES = ["float32", "bfloat16"]
F32_TOL = dict(atol=2e-5, rtol=2e-5)
RING_TOL = dict(atol=1 / 128, rtol=1 / 128)
BF16_TOL = dict(atol=0.05, rtol=0.02)
# a token is checked where the top-2 logit margin exceeds this.  float32:
# the two packages' forward logits differ by at most 3e-6, but a decode
# reads bfloat16 rings, which moves recurrentgemma's logits by up to 0.0061
# from the no-cache forward's; bfloat16: the forward logits differ by up to
# 0.034 (75 tokens, both archs)
MARGIN = {"float32": 0.01, "bfloat16": 0.1}
# the share of positions that must be checked.  bfloat16 logits at these
# widths are about 1 in size and rounded to 1/128 before the softcap, so
# few margins exceed 0.1 (14-16 % of recurrentgemma's positions): there
# the served logits are held to the reference's bfloat16 envelope as well
CHECKED = {"float32": 0.5, "bfloat16": 0.125}


@pytest.fixture(scope="module")
def jmesh():
    mesh = ref_mesh(1, 1)
    return mesh, ref_mesh_ctx(mesh)


@pytest.fixture(scope="module")
def cpu_mesh():
    return make_local_mesh(device="cpu")


def configs(arch: str):
    """(reference, port) smoke configs; recurrentgemma at 8 layers."""
    kw = {"n_layers": 8} if arch == RG else {}
    return (ref_configs.get_smoke_config(arch).scaled(**kw),
            port_configs.get_smoke_config(arch).scaled(**kw))


def _dtypes(dtype: str):
    return (jnp.float32, None) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)


def both(arrays, dtype: str):
    """A numpy tree as (JAX, port) trees in ``dtype``."""
    jdt, tdt = _dtypes(dtype)
    return (jax.tree.map(lambda a: j(a, jdt), arrays), params_from_numpy(arrays, "cpu", tdt))


def pair(a: np.ndarray, dtype: str):
    """A numpy array as (JAX, port) arrays in ``dtype``."""
    jdt, tdt = _dtypes(dtype)
    return j(a, jdt), t(a, tdt)


def normal(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def tol(dtype: str, f32=F32_TOL):
    return f32 if dtype == "float32" else BF16_TOL


def close(got, exp, **kw):
    assert tuple(got.shape) == tuple(exp.shape), (got.shape, exp.shape)
    np.testing.assert_allclose(to_np(got), to_np(exp), **kw)


def within_bf16_envelope(got, ref_bf16, ref_f32, slack: float = 1.5):
    """The port's bfloat16 result lies no farther from the reference's
    float32 result than the reference's own bfloat16 result does, up to
    ``slack``, in the largest and in the mean absolute difference."""
    assert tuple(got.shape) == tuple(ref_bf16.shape) == tuple(ref_f32.shape)
    e_port = np.abs(to_np(got) - to_np(ref_f32))
    e_ref = np.abs(to_np(ref_bf16) - to_np(ref_f32))
    assert e_port.max() <= slack * e_ref.max() + 1e-6, (e_port.max(), e_ref.max())
    assert e_port.mean() <= slack * e_ref.mean() + 1e-7, (e_port.mean(), e_ref.mean())


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def _rglru_params(jmesh, dtype, seed=30):
    cfg, pcfg = configs(RG)
    return cfg, pcfg, both(draw_tree(ref_rglru.rglru_spec(cfg, jmesh[1]),
                                     np.random.default_rng(seed)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_apply(jmesh, dtype):
    """Output and last state against the reference; the decode cache's
    ``conv`` against the reference's raw branch input (``_branch_in``)."""
    cfg, pcfg, (jp, pp) = _rglru_params(jmesh, dtype)
    x = normal(31, 2, 37, cfg.d_model)
    jx, px = pair(x, dtype)
    out, st = port_rglru.rglru_apply(pp, px, PCTX, pcfg, return_state=True)
    rout, rst, rtail = on_mesh(jmesh, lambda pa, xx: (
        *ref_rglru.rglru_apply(pa, xx, jmesh[1], cfg, return_state=True),
        ref_rglru._branch_in(pa, xx)[1][:, -3:]), jp, jx)
    close(out, rout, **tol(dtype))
    close(st["h"], rst["h"], **tol(dtype))
    assert st["h"].dtype == torch.float32 and st["conv"].dtype == torch.bfloat16
    assert st["len"] == int(rst["len"]) == 37
    close(st["conv"], rtail.astype(jnp.bfloat16), atol=1e-6, rtol=1 / 128)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_decode(jmesh, dtype):
    """Three steps from the same cache (a float32 state, a bfloat16 ring)."""
    cfg, pcfg, (jp, pp) = _rglru_params(jmesh, dtype, seed=32)
    h, ring = normal(33, 2, cfg.lru_width), normal(34, 2, 3, cfg.lru_width)
    rcache = {"h": j(h), "conv": j(ring, jnp.bfloat16), "len": jnp.int32(5)}
    cache = {"h": t(h), "conv": t(ring, torch.bfloat16), "len": 5}
    for step in range(3):
        jx, px = pair(normal(35 + step, 2, 1, cfg.d_model), dtype)
        o, cache = port_rglru.rglru_decode(pp, px, cache, PCTX, pcfg)
        ro, rcache = on_mesh(jmesh, lambda pa, c, xx: ref_rglru.rglru_decode(
            pa, xx, c, jmesh[1], cfg), jp, rcache, jx)
        close(o, ro, **tol(dtype))
        close(cache["h"], rcache["h"], **tol(dtype))
        close(cache["conv"], rcache["conv"], **tol(dtype, dict(atol=0, rtol=0)))
        assert cache["len"] == int(rcache["len"]) == 6 + step


# ---------------------------------------------------------------------------
# local (sliding-window) attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t_len", [40, 64, 150], ids=["t<w", "t=w", "t>w"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_local_fill_cache(t_len, dtype):
    """The ring equals the reference's exactly; position p sits at slot
    p % window."""
    cfg, pcfg = configs(RG)
    w = cfg.window
    k, v = normal(40, 2, 1, t_len, 32), normal(41, 2, 1, t_len, 32)
    (jk, pk), (jv, pv) = pair(k, dtype), pair(v, dtype)
    got = port_attn.local_fill_cache(None, pk, pv, pcfg)
    ref = ref_attn.local_fill_cache(None, jk, jv, cfg)
    for name in ("k", "v"):
        assert got[name].dtype == torch.bfloat16 and tuple(got[name].shape) == (2, 1, w, 32)
        np.testing.assert_array_equal(to_np(got[name]), to_np(ref[name]))
    assert got["len"] == int(ref["len"]) == t_len
    for pos in range(max(0, t_len - w), t_len):
        assert torch.equal(got["k"][:, :, pos % w], pk[:, :, pos].to(torch.bfloat16))


@pytest.mark.parametrize("start", [62, 126], ids=["fill-then-wrap", "rolled-then-wrap"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_local_decode_across_a_wrap(jmesh, start, dtype):
    """Five decode steps from a ring filled with ``start`` positions, the
    write slot passing from 63 to 0: outputs and the whole ring agree,
    and the port wrote its ring in place."""
    cfg, pcfg = configs(RG)
    _, jctx = jmesh
    jp, pp = both(draw_tree(ref_attn.gqa_spec(cfg, jctx), np.random.default_rng(42)), dtype)
    k, v = normal(43, 2, 1, start, 32), normal(44, 2, 1, start, 32)
    cache = port_attn.local_fill_cache(None, t(k), t(v), pcfg)
    rcache = ref_attn.local_fill_cache(None, j(k), j(v), cfg)
    k_buf = cache["k"]
    ring_tol = RING_TOL if dtype == "float32" else BF16_TOL
    for step in range(5):
        jx, px = pair(normal(45 + step, 2, 1, cfg.d_model), dtype)
        o, cache = port_attn.local_decode(pp, px, cache, PCTX, pcfg)
        ro, rcache = on_mesh(jmesh, lambda pa, c, xx: ref_attn.local_decode(
            pa, xx, c, jctx, cfg), jp, rcache, jx)
        close(o, ro, **ring_tol)
        assert cache["len"] == int(rcache["len"]) == start + step + 1
    assert cache["k"] is k_buf
    for name in ("k", "v"):
        close(cache[name], rcache[name], **ring_tol)


# ---------------------------------------------------------------------------
# Mamba-2 / SSD
# ---------------------------------------------------------------------------


def _ssm_params(jmesh, dtype, seed=50):
    cfg, pcfg = configs(MB)
    return cfg, pcfg, both(draw_tree(ref_ssm.ssm_spec(cfg, jmesh[1]),
                                     np.random.default_rng(seed)), dtype)


@pytest.mark.parametrize("T", [20, 64, 75], ids=["T<chunk", "T=2chunk", "ragged"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_chunked(jmesh, T, dtype):
    """The chunked SSD scan: one short chunk, two full chunks, and a
    ragged tail padded with dt = 0."""
    cfg, pcfg = configs(MB)
    _, H, hp, G, N = ref_ssm._dims(cfg, jmesh[1])
    rng = np.random.default_rng(51)
    xh = rng.normal(size=(2, T, H, hp)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(2, T, H)))).astype(np.float32)
    A = (1 + 0.1 * rng.normal(size=H)).astype(np.float32)
    B, C = (rng.normal(size=(2, T, G, N)).astype(np.float32) for _ in range(2))
    (jxh, pxh), (jdt, pdt), (jB, pB), (jC, pC) = (pair(a, dtype) for a in (xh, dt, B, C))
    y, final = port_ssm._ssd_chunked(pxh, pdt, t(A), pB, pC, pcfg)
    ry, rfinal = on_mesh(jmesh, lambda *a: ref_ssm._ssd_chunked(*a, cfg),
                         jxh, jdt, j(A), jB, jC)
    assert str(y.dtype).split(".")[-1] == str(ry.dtype) and final.dtype == torch.float32
    close(y, ry, **tol(dtype))
    close(final, rfinal, **tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssm_apply(jmesh, dtype):
    """Output and decode cache of a 40-token sequence (chunk 32: one full
    chunk and a ragged one)."""
    cfg, pcfg, (jp, pp) = _ssm_params(jmesh, dtype)
    jx, px = pair(normal(52, 2, 40, cfg.d_model), dtype)
    out, st = port_ssm.ssm_apply(pp, px, PCTX, pcfg, return_state=True)
    rout, rst = on_mesh(jmesh, lambda pa, xx: ref_ssm.ssm_apply(
        pa, xx, jmesh[1], cfg, return_state=True), jp, jx)
    close(out, rout, **tol(dtype))
    close(st["ssd"], rst["ssd"], **tol(dtype))
    for name in ("x", "bc"):
        assert str(st["conv"][name].dtype).split(".")[-1] == str(rst["conv"][name].dtype)
        close(st["conv"][name], rst["conv"][name], **tol(dtype))
    assert st["len"] == int(rst["len"]) == 40


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssm_decode(jmesh, dtype):
    """Three steps from the same cache (a float32 state, bfloat16 rings);
    the port updates the state in place."""
    cfg, pcfg, (jp, pp) = _ssm_params(jmesh, dtype, seed=53)
    d_inner, H, hp, G, N = ref_ssm._dims(cfg, jmesh[1])
    K1 = cfg.ssm_conv - 1
    ssd = normal(54, 2, H, hp, N)
    rx, rbc = normal(55, 2, K1, d_inner), normal(56, 2, K1, 2 * G * N)
    rcache = {"ssd": j(ssd), "conv": {"x": j(rx, jnp.bfloat16), "bc": j(rbc, jnp.bfloat16)},
              "len": jnp.int32(7)}
    cache = {"ssd": t(ssd), "conv": {"x": t(rx, torch.bfloat16), "bc": t(rbc, torch.bfloat16)},
             "len": 7}
    state = cache["ssd"]
    for step in range(3):
        jx, px = pair(normal(57 + step, 2, 1, cfg.d_model), dtype)
        o, cache = port_ssm.ssm_decode(pp, px, cache, PCTX, pcfg)
        ro, rcache = on_mesh(jmesh, lambda pa, c, xx: ref_ssm.ssm_decode(
            pa, xx, c, jmesh[1], cfg), jp, rcache, jx)
        close(o, ro, **tol(dtype))
        close(cache["ssd"], rcache["ssd"], **tol(dtype))
        for name in ("x", "bc"):
            close(cache["conv"][name], rcache["conv"][name], **tol(dtype))
        assert cache["len"] == int(rcache["len"]) == 8 + step
    assert cache["ssd"] is state


# ---------------------------------------------------------------------------
# the model: specs, forward, prefill / decode, the scheduler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rglru", "ssm", "local"])
def test_init_caches_equal_the_reference(jmesh, kind):
    """Each zeroed decode cache: the reference's keys, shapes and dtypes,
    ``len`` 0 (a host int in the port)."""
    cfg, pcfg = configs(MB if kind == "ssm" else RG)
    if kind == "local":
        got, ref = port_attn.local_init_cache(pcfg, 3), ref_attn.local_init_cache(cfg, 3)
    else:
        mod, rmod = (port_ssm, ref_ssm) if kind == "ssm" else (port_rglru, ref_rglru)
        got = getattr(mod, f"{kind}_init_cache")(pcfg, PCTX, 3)
        ref = getattr(rmod, f"{kind}_init_cache")(cfg, jmesh[1], 3)
    got, ref = dict(leaves(got)), dict(leaves(ref))
    assert got.keys() == ref.keys()
    for path, a in got.items():
        if path[-1] == "len":
            assert a == int(ref[path]) == 0
        else:
            assert tuple(a.shape) == ref[path].shape and not a.any(), path
            assert str(a.dtype).split(".")[-1] == str(ref[path].dtype), path


@pytest.mark.parametrize("arch,n", [(RG, 2_658_736_640), (MB, 780_001_536)])
def test_parameter_counts(jmesh, arch, n):
    """At full width ``count_params`` gives the counts the card's bounds use
    (the reference's ``n_params_dense`` undercounts both)."""
    cfg, pcfg = ref_configs.get_config(arch), port_configs.get_config(arch)
    assert count_params(port_bb.model_spec(pcfg, PCTX)) == n == ref_spec.count_params(
        ref_bb.model_spec(cfg, jmesh[1]))
    assert ref_config.n_params_dense(cfg) < n


@pytest.fixture(scope="module", params=[(a, d) for a in (RG, MB) for d in DTYPES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def model(request, jmesh):
    """(arch, reference config, port config, dtype, JAX params, port params,
    JAX float32 params) — one float32 weight set, carried to both packages
    in ``dtype``."""
    arch, dtype = request.param
    cfg, pcfg = configs(arch)
    arrays = draw_tree(ref_bb.model_spec(cfg, jmesh[1]), np.random.default_rng(60))
    return (arch, cfg, pcfg, dtype, *both(arrays, dtype), both(arrays, "float32")[0])


def ref_forward_logits(jmesh, jp, cfg, tokens: np.ndarray) -> np.ndarray:
    """float32 logits at every position of the reference's no-cache forward
    (``greedy_token``'s logits, before its argmax)."""
    def body(p, tk):
        x, _ = ref_bb.forward(p, tk, jmesh[1], cfg, ep_data_size=1, remat=False)
        logits = (x @ ref_bb._unembed_weight(p["embed"], cfg)).astype(jnp.float32)
        if cfg.logit_softcap:
            logits = cfg.logit_softcap * jnp.tanh(logits / cfg.logit_softcap)
        return ref_bb._mask_vocab_pad(logits, 0, cfg)

    return np.asarray(on_mesh(jmesh, body, jp, jnp.asarray(tokens, jnp.int32)))


def port_forward_logits(pp, pcfg, tokens: np.ndarray) -> np.ndarray:
    x = port_bb.forward(pp, torch.from_numpy(tokens.astype(np.int32)), PCTX, pcfg)
    return port_bb.vocab_logits(pp["embed"], x, PCTX, pcfg).numpy()


def margins(logits: np.ndarray) -> np.ndarray:
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def check_tokens(got: np.ndarray, want: np.ndarray, logits: np.ndarray, dtype: str) -> int:
    """``got`` equals ``want`` wherever ``logits``' margin exceeds
    ``MARGIN[dtype]``, and enough positions are checked; returns how many."""
    ok = margins(logits) > MARGIN[dtype]
    assert ok.mean() >= CHECKED[dtype], margins(logits)
    np.testing.assert_array_equal(got[ok], want[ok])
    return int(ok.sum())


def test_forward_matches_the_reference(model, jmesh):
    """Final-norm states over 75 tokens (past the window, a ragged chunk):
    float32 within 1e-4; bfloat16 within the reference's own bfloat16
    envelope around its float32 states."""
    arch, cfg, pcfg, dtype, jp, pp, jf = model
    toks = np.random.default_rng(61).integers(-2, cfg.vocab, size=(2, 75)).astype(np.int32)
    body = lambda p, tk: ref_bb.forward(p, tk, jmesh[1], cfg, ep_data_size=1, remat=False)[0]
    ref = on_mesh(jmesh, body, jp, jnp.asarray(toks))
    got = port_bb.forward(pp, torch.from_numpy(toks), PCTX, pcfg)
    assert str(got.dtype).split(".")[-1] == str(ref.dtype) == dtype
    if dtype == "float32":
        close(got, ref, atol=1e-4, rtol=1e-4)
    else:
        within_bf16_envelope(got, ref, on_mesh(jmesh, body, jf, jnp.asarray(toks)))


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_prefill_and_decode_match_the_reference(model, jmesh, cpu_mesh, monkeypatch):
    """Prefill a prompt longer than the window (recurrentgemma: the ring
    rolls, then wraps) or than a chunk (mamba2: a ragged tail), then 6
    teacher-forced decode steps.

    Caches agree leaf for leaf, but recurrentgemma's ``conv`` (pinned
    below): float32 within a bfloat16 ulp, bfloat16 within the reference's
    own envelope.  Each step's logits against the reference's no-cache
    forward: float32 within 1/128 (the bfloat16 caches), bfloat16 within
    the envelope.  Tokens equal the reference's decode (mamba2) or its
    forward's argmax (recurrentgemma) where the margin allows."""
    arch, cfg, pcfg, dtype, jp, pp, jf = model
    B, T, steps = 2, (70 if arch == RG else 40), 6
    rng = np.random.default_rng(62)
    prompt = rng.integers(0, cfg.vocab, size=(B, T)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab, size=(B, steps)).astype(np.int32)
    seq = np.concatenate([prompt, forced], axis=1)
    recorded, greedy = [], port_engine.greedy_token

    def recording(p, x, ctx, cfg_):                     # each step's logits, then its token
        recorded.append(port_bb.vocab_logits(p, x[:, -1], ctx, cfg_).numpy())
        return greedy(p, x, ctx, cfg_)

    monkeypatch.setattr(port_engine, "greedy_token", recording)
    ref = ref_engine.make_serve_fns(cfg, jmesh[0], batch=B, max_len=128)
    port = port_engine.make_serve_fns(pcfg, cpu_mesh, batch=B, max_len=128)
    rcaches, rtok = ref.prefill(jp, {"tokens": jnp.asarray(prompt)})
    caches, tok = port.prefill(pp, {"tokens": torch.from_numpy(prompt)})
    f32_caches = (ref.prefill(jf, {"tokens": jnp.asarray(prompt)})[0]
                  if dtype == "bfloat16" else None)
    paths = dict(leaves(caches))
    assert paths.keys() == {p for p, _ in leaves(rcaches)}
    for path, got in paths.items():
        exp = _at(rcaches, path)
        if path[-1] == "len":
            assert got == T and np.all(np.asarray(exp) == T)
        elif path[-1] != "conv":
            assert str(got.dtype).split(".")[-1] == str(exp.dtype), path
            if dtype == "float32":
                close(got, exp, **RING_TOL)
            else:
                within_bf16_envelope(got, exp, _at(f32_caches, path))

    got, exp = [tok.numpy()], [np.asarray(rtok)]
    for s in range(steps):
        rtok, rcaches = ref.decode(jp, rcaches, jnp.asarray(forced[:, s:s + 1]))
        tok, caches = port.decode(pp, caches, torch.from_numpy(forced[:, s:s + 1]))
        got.append(tok.numpy())
        exp.append(np.asarray(rtok))
    assert all(v == T + steps for p, v in leaves(caches) if p[-1] == "len")
    logits = ref_forward_logits(jmesh, jp, cfg, seq)[:, T - 1:]
    served = np.stack(recorded, 1)
    if dtype == "float32":
        close(served, logits, atol=1 / 128, rtol=0)
    else:
        within_bf16_envelope(served, logits, ref_forward_logits(jmesh, jf, cfg, seq)[:, T - 1:])
    want = logits.argmax(-1) if arch == RG else np.stack(exp, 1)
    check_tokens(np.stack(got, 1), want, logits, dtype)


def _requests(cfg, cls, arch):
    """Three buckets; the longest is past the window (recurrentgemma) or
    over a chunk and ragged (mamba2)."""
    rng = np.random.default_rng(63)
    long = 70 if arch == RG else 40
    lens, max_new = [long, long, 12, 12, 12, 5], [6, 4, 7, 5, 6, 3]
    return [cls(i, [int(x) for x in rng.integers(0, cfg.vocab, n)], m)
            for i, (n, m) in enumerate(zip(lens, max_new))]


def test_scheduler_against_the_reference(model, jmesh, cpu_mesh):
    """``BatchScheduler.run`` on both packages: the same stats.  mamba2's
    completions equal the reference's (float32), or up to a first
    divergence on a near tie (bfloat16, as ``test_torch_serve.py``).
    recurrentgemma's tokens equal the reference's no-cache forward over
    prompt + tokens where the margin allows (one forward a bucket)."""
    arch, cfg, pcfg, dtype, jp, pp, _ = model
    ref_out, ref_stats = RefScheduler(cfg, jmesh[0], batch=2, max_len=96, eos_id=-1).run(
        jp, _requests(cfg, RefRequest, arch))
    out, stats = BatchScheduler(pcfg, cpu_mesh, batch=2, max_len=96, eos_id=-1).run(
        pp, _requests(cfg, Request, arch))
    reqs = {r.rid: r for r in _requests(cfg, Request, arch)}
    assert out.keys() == ref_out.keys() == reqs.keys()
    for f in ("requests", "prefill_tokens", "decode_steps", "batches"):
        assert getattr(stats, f) == getattr(ref_stats, f), f
    assert stats.batches == 4
    assert all(len(c.tokens) == reqs[rid].max_new and c.finished for rid, c in out.items())
    if arch == RG:
        got, logits = [], []
        for plen in sorted({len(r.prompt) for r in reqs.values()}):
            rids = [rid for rid, r in reqs.items() if len(r.prompt) == plen]
            width = max(reqs[rid].max_new for rid in rids)       # causal: pad at the end
            seq = np.asarray([reqs[rid].prompt + out[rid].tokens[:-1]
                              + [0] * (width - reqs[rid].max_new) for rid in rids], np.int32)
            lg = ref_forward_logits(jmesh, jp, cfg, seq)[:, plen - 1:]
            for row, rid in zip(lg, rids):
                got += out[rid].tokens
                logits.append(row[:reqs[rid].max_new])
        logits = np.concatenate(logits)
        check_tokens(np.asarray(got), logits.argmax(-1), logits, dtype)
        return
    compared = 0
    for rid, c in out.items():
        if dtype == "float32":
            assert c.tokens == ref_out[rid].tokens, rid
        n = next((i for i, (a, b) in enumerate(zip(c.tokens, ref_out[rid].tokens)) if a != b),
                 len(c.tokens))
        if n < len(c.tokens):   # the first difference must be a near tie
            seq = np.asarray([reqs[rid].prompt + c.tokens[:n]], np.int32)
            assert margins(port_forward_logits(pp, pcfg, seq)[0, -1]) <= MARGIN[dtype]
        compared += n
    assert compared >= CHECKED[dtype] * sum(len(c.tokens) for c in out.values()), compared


# ---------------------------------------------------------------------------
# the port's deliberate differences
# ---------------------------------------------------------------------------


def test_rglru_cache_holds_the_pre_conv_tail_where_the_reference_holds_the_conv_output(
        jmesh, cpu_mesh):
    """float32 weights, a 10-token prompt, 6 teacher-forced decode steps.

    1. The reference's prefill + decode departs from its own no-cache
       forward at well-separated logits.
    2. The port's prefill + decode equals the port's forward and the
       reference's forward there.
    3. The port's ``rglru_apply`` state holds the reference's raw
       ``_branch_in`` tail, not the conv output the reference stores."""
    cfg, pcfg = configs(RG)
    arrays = draw_tree(ref_bb.model_spec(cfg, jmesh[1]), np.random.default_rng(66))
    jp, pp = both(arrays, "float32")
    rng = np.random.default_rng(67)
    B, T, steps = 2, 10, 6
    prompt = rng.integers(0, cfg.vocab, size=(B, T)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab, size=(B, steps)).astype(np.int32)
    seq = np.concatenate([prompt, forced], axis=1)
    ref = ref_engine.make_serve_fns(cfg, jmesh[0], batch=B, max_len=32)
    port = port_engine.make_serve_fns(pcfg, cpu_mesh, batch=B, max_len=32)
    rcaches, rtok = ref.prefill(jp, {"tokens": jnp.asarray(prompt)})
    caches, tok = port.prefill(pp, {"tokens": torch.from_numpy(prompt)})
    rgot, got = [np.asarray(rtok)], [tok.numpy()]
    for s in range(steps):
        rtok, rcaches = ref.decode(jp, rcaches, jnp.asarray(forced[:, s:s + 1]))
        tok, caches = port.decode(pp, caches, torch.from_numpy(forced[:, s:s + 1]))
        rgot.append(np.asarray(rtok))
        got.append(tok.numpy())
    rgot, got = np.stack(rgot, 1), np.stack(got, 1)
    ref_logits = ref_forward_logits(jmesh, jp, cfg, seq)[:, T - 1:]
    port_logits = port_forward_logits(pp, pcfg, seq)[:, T - 1:]
    np.testing.assert_allclose(port_logits, ref_logits, atol=1e-4)
    ok = margins(ref_logits) > MARGIN["float32"]
    assert ok.mean() >= CHECKED["float32"]
    want = ref_logits.argmax(-1)
    # 1. the reference's decode departs from its forward (its prefill
    #    token, from the forward itself, does not)
    assert np.array_equal(rgot[:, 0], want[:, 0])
    assert (rgot[ok] != want[ok]).sum() >= 2, (rgot, want)
    # 2. the port's does not
    np.testing.assert_array_equal(got[ok], want[ok])
    np.testing.assert_array_equal(got[ok], port_logits.argmax(-1)[ok])
    # 3. the state's conv rows: raw branch inputs of the block's last 3 positions
    p0 = jax.tree.map(lambda a: a[0], jp["g0"]["b0"]["rec"])
    x = normal(68, B, T, cfg.d_model)
    _, st = port_rglru.rglru_apply(tree_map(lambda a: a[0], pp["g0"]["b0"]["rec"]), t(x),
                                   PCTX, pcfg, return_state=True)
    _, rst = ref_rglru.rglru_apply(p0, j(x), ref_bb.MeshCtx(model_size=1), cfg,
                                   return_state=True)
    raw = ref_rglru._branch_in(p0, j(x))[1][:, -3:].astype(jnp.bfloat16)
    close(st["conv"], raw, atol=1e-6, rtol=1 / 128)
    assert np.abs(to_np(rst["conv"]) - to_np(raw)).max() > 0.1     # the reference's conv output


def test_short_prompts_where_the_reference_fails(jmesh, cpu_mesh):
    """RG-LRU over 1 and 2 tokens.  The reference's zero halo is
    ``zeros_like(rec[:, :3])``, as short as the prompt: at 1 token it
    raises ``IndexError``; at 2 its taps meet a halo of 2 rows and its
    output departs from the first 2 positions of a 5-token run (causal: they
    must equal).  The port's equal that prefix, and a prefill of 1 or 2
    tokens then decode equals the no-cache forward."""
    cfg, pcfg, (jp, pp) = _rglru_params(jmesh, "float32", seed=69)
    x5 = normal(70, 2, 5, cfg.d_model)
    rctx = ref_bb.MeshCtx(model_size=1)
    full = ref_rglru.rglru_apply(jp, j(x5), rctx, cfg)
    with pytest.raises(IndexError):
        ref_rglru.rglru_apply(jp, j(x5[:, :1]), rctx, cfg)
    assert np.abs(to_np(ref_rglru.rglru_apply(jp, j(x5[:, :2]), rctx, cfg))
                  - to_np(full[:, :2])).max() > 1e-3
    for n in (1, 2):
        close(port_rglru.rglru_apply(pp, t(x5[:, :n]), PCTX, pcfg), full[:, :n], **F32_TOL)

    arrays = draw_tree(ref_bb.model_spec(cfg, jmesh[1]), np.random.default_rng(71))
    model_p = params_from_numpy(arrays, "cpu")
    seq = np.random.default_rng(72).integers(0, cfg.vocab, size=(2, 6)).astype(np.int32)
    logits = port_forward_logits(model_p, pcfg, seq)
    for n in (1, 2):
        sv = port_engine.make_serve_fns(pcfg, cpu_mesh, batch=2, max_len=16)
        caches, tok = sv.prefill(model_p, {"tokens": torch.from_numpy(seq[:, :n])})
        got = [tok.numpy()]
        for s in range(n, 6):
            tok, caches = sv.decode(model_p, caches, torch.from_numpy(seq[:, s:s + 1]))
            got.append(tok.numpy())
        want = logits[:, n - 1:]
        check_tokens(np.stack(got, 1), want.argmax(-1), want, "float32")


def test_ssd_short_prompts_where_the_reference_fails(jmesh, cpu_mesh):
    """mamba2 over 1 and 2 tokens.  The reference's decode cache takes the
    last ``ssm_conv - 1`` = 3 raw conv inputs with ``dynamic_slice_in_dim``
    (``src/repro/models/ssm.py:165-168``), which cannot take 3 rows of a
    shorter prompt: its ``make_serve_fns(...).prefill`` raises
    ``TypeError``.  The port zero-pads the rows the causal conv's own
    padding holds (``ssm._tail``): its ``ssm_apply`` equals the first T
    positions of a 5-token run, and a prefill of 1 or 2 tokens then decode
    equals the port's no-cache forward on every checked token."""
    cfg, pcfg, (jp, pp) = _ssm_params(jmesh, "float32", seed=52)
    x5 = normal(70, 2, 5, cfg.d_model)
    rctx = ref_bb.MeshCtx(model_size=1)
    full = ref_ssm.ssm_apply(jp, j(x5), rctx, cfg)
    for n in (1, 2):
        close(port_ssm.ssm_apply(pp, t(x5[:, :n]), PCTX, pcfg), full[:, :n], **F32_TOL)

    arrays = draw_tree(ref_bb.model_spec(cfg, jmesh[1]), np.random.default_rng(71))
    jmodel, model_p = both(arrays, "float32")
    seq = np.random.default_rng(72).integers(0, cfg.vocab, size=(2, 6)).astype(np.int32)
    ref = ref_engine.make_serve_fns(cfg, jmesh[0], batch=2, max_len=16)
    for n in (1, 2):
        with pytest.raises(TypeError, match="slice_sizes must be less than or equal"):
            ref.prefill(jmodel, {"tokens": jnp.asarray(seq[:, :n])})
    logits = port_forward_logits(model_p, pcfg, seq)
    for n in (1, 2):
        sv = port_engine.make_serve_fns(pcfg, cpu_mesh, batch=2, max_len=16)
        caches, tok = sv.prefill(model_p, {"tokens": torch.from_numpy(seq[:, :n])})
        assert all(tuple(c.shape[-2:-1]) == (cfg.ssm_conv - 1,)
                   for path, c in leaves(caches) if "conv" in path)
        got = [tok.numpy()]
        for s in range(n, 6):
            tok, caches = sv.decode(model_p, caches, torch.from_numpy(seq[:, s:s + 1]))
            got.append(tok.numpy())
        want = logits[:, n - 1:]
        check_tokens(np.stack(got, 1), want.argmax(-1), want, "float32")
