"""The serving path of the model scaffold — ``repro_torch.serve`` over
``repro_torch.models`` — held against the JAX package's on the same
weights: one parameter set per config drawn in float32 with a numpy seed
and carried to both packages (``params_from_numpy`` on the port's side),
either as it is or cast to bfloat16 on both sides, the dtype the card
serves in.

The port runs on ``device="cpu"``; the reference's step functions are its
jitted ``shard_map`` steps over a 1x1 mesh.  Tolerances:

* prefill KV caches (bfloat16 in both): float32 parameters, one bfloat16
  ulp (1/128 relative).  The rows the decode steps add come from layer
  inputs that carry the fused rounding below: 1/32 absolute there.
  bfloat16 parameters: XLA's CPU backend computes bfloat16 elementwise
  work in float32 and fuses ops before rounding, torch rounds after each
  op, so a few ulps compound through a layer: 0.05 absolute plus 0.02
  relative, the bfloat16 tolerance of ``tests/test_torch_models.py``;
* the final-norm states of ``forward``: 1e-4 with float32 parameters,
  0.05 absolute plus 0.02 relative with bfloat16 ones;
* tokens: equal wherever the top-2 logit margin of the port's own
  no-cache ``forward`` exceeds 0.05 at that position.  Jitted, XLA's CPU
  fusion rounds the decode attention to bfloat16 elsewhere than the
  reference's ops do (``tests/test_torch_models.py``), which can move a
  logit a little and flip a near tie.  With bfloat16 parameters the two
  packages' forward logits differ by at most 0.0142 at these widths
  (measured over seven prompt seeds), so 0.05 is over three times that;
* ``BatchScheduler``: every ``ServeStats`` count equal (``wall_s``
  aside).  float32: every ``Completion`` equal.  bfloat16: each
  completion's tokens equal up to the first position where the two
  differ, which must be a near tie (margin at most 0.05); once a greedy
  decode diverges its later tokens follow other prompts, so they are not
  compared, and at least half of all generated positions must be.

The port's one deliberate difference, the ``max_len`` guard, is pinned
beside the reference's silent clamp; it holds only for plans whose caches
have ``max_len`` positions (``attn``), not for the recurrent families'
fixed-size caches (``tests/test_torch_recurrent.py`` holds those against
the reference).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from _torch_models import draw_tree, leaves

import repro.configs as ref_configs
import repro.models.backbone as ref_bb
import repro.serve.engine as ref_engine
from repro.launch.mesh import make_local_mesh as ref_mesh
from repro.serve.scheduler import BatchScheduler as RefScheduler
from repro.serve.scheduler import Request as RefRequest
from repro.train.step import mesh_ctx as ref_mesh_ctx
import repro_torch.configs as port_configs
import repro_torch.models.backbone as port_bb
import repro_torch.serve.engine as port_engine
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models.spec import params_from_numpy
from repro_torch.serve.scheduler import BatchScheduler, Request
from repro_torch.train.step import mesh_ctx

ARCHS = ["qwen2-1.5b", "internlm2-1.8b"]        # tied + QKV bias; untied, no bias
DTYPES = ["float32", "bfloat16"]
MARGIN = 0.05
BF16_TOL = dict(atol=0.05, rtol=0.02)
# eos ids that stop some request early in each config's run below (read off
# a run with eos_id=-1); the test asserts the stop happened
EOS = {"qwen2-1.5b": 354, "internlm2-1.8b": 141}


@pytest.fixture(scope="module")
def jmesh():
    return ref_mesh(1, 1)


@pytest.fixture(scope="module")
def cpu_mesh():
    return make_local_mesh(device="cpu")


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS for d in DTYPES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def model(request, jmesh):
    """(arch, reference config, port config, dtype, JAX params, port params)
    — one float32 weight set, carried to both packages in ``dtype``."""
    arch, dtype = request.param
    cfg = ref_configs.get_smoke_config(arch)
    arrays = draw_tree(ref_bb.model_spec(cfg, ref_mesh_ctx(jmesh)), np.random.default_rng(20))
    jdt, tdt = (jnp.float32, None) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    return (arch, cfg, port_configs.get_smoke_config(arch), dtype,
            jax.tree.map(lambda a: jnp.asarray(a, jdt), arrays),
            params_from_numpy(arrays, "cpu", tdt))


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def port_logits(params, pcfg, tokens: np.ndarray) -> torch.Tensor:
    """float32 logits at every position of the port's no-cache forward."""
    ctx = port_bb.MeshCtx()
    x = port_bb.forward(params, torch.from_numpy(tokens.astype(np.int32)), ctx, pcfg)
    return port_bb.vocab_logits(params["embed"], x, ctx, pcfg)


def margins(logits: torch.Tensor) -> np.ndarray:
    top2 = logits.topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).numpy()


def test_forward_matches_the_reference(model, jmesh):
    arch, cfg, pcfg, dtype, jp, pp = model
    toks = np.random.default_rng(22).integers(-2, cfg.vocab, size=(2, 19)).astype(np.int32)
    ctx = ref_mesh_ctx(jmesh)
    body = jax.shard_map(lambda p, tk: ref_bb.forward(p, tk, ctx, cfg, ep_data_size=1,
                                                      remat=False)[0],
                         mesh=jmesh, in_specs=(JP(), JP()), out_specs=JP(), check_vma=False)
    ref = jax.jit(body)(jp, jnp.asarray(toks))
    got = port_bb.forward(pp, torch.from_numpy(toks), port_bb.MeshCtx(), pcfg)
    assert str(got.dtype).split(".")[-1] == str(ref.dtype) == dtype
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(to_np(got), to_np(ref), **tol)


def test_prefill_and_decode_match_the_reference(model, jmesh, cpu_mesh):
    """Prefill, then 6 decode steps fed the same (seeded) tokens in both
    packages: prefill caches within a bfloat16 ulp, every step's token equal
    where the margin allows, the decode writing the port's cache in place."""
    arch, cfg, pcfg, dtype, jp, pp = model
    B, T, L, steps = 2, 10, 24, 6
    tol = dict(rtol=1 / 128, atol=1 / 128) if dtype == "float32" else BF16_TOL
    rng = np.random.default_rng(23)
    prompt = rng.integers(0, cfg.vocab, size=(B, T)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab, size=(B, steps)).astype(np.int32)
    ref = ref_engine.make_serve_fns(cfg, jmesh, batch=B, max_len=L)
    port = port_engine.make_serve_fns(pcfg, cpu_mesh, batch=B, max_len=L)

    rcaches, rtok = ref.prefill(jp, {"tokens": jnp.asarray(prompt)})
    caches, tok = port.prefill(pp, {"tokens": torch.from_numpy(prompt)})
    assert set(caches) == set(rcaches) == {"g0"}
    for name in ("k", "v"):
        assert caches["g0"][name].dtype == torch.bfloat16
        assert tuple(caches["g0"][name].shape) == rcaches["g0"][name].shape
        np.testing.assert_allclose(to_np(caches["g0"][name]), to_np(rcaches["g0"][name]),
                                   **tol)
    assert caches["g0"]["len"] == T and np.all(np.asarray(rcaches["g0"]["len"]) == T)

    seq = np.concatenate([prompt, forced], axis=1)
    marg = margins(port_logits(pp, pcfg, seq)[:, T - 1:])        # (B, steps + 1)
    got, exp = [tok.numpy()], [np.asarray(rtok)]
    k_buf = caches["g0"]["k"]
    for s in range(steps):
        rtok, rcaches = ref.decode(jp, rcaches, jnp.asarray(forced[:, s:s + 1]))
        tok, caches = port.decode(pp, caches, torch.from_numpy(forced[:, s:s + 1]))
        got.append(tok.numpy())
        exp.append(np.asarray(rtok))
    got, exp = np.stack(got, 1), np.stack(exp, 1)
    checked = marg > MARGIN
    assert checked.mean() >= 0.5, marg
    np.testing.assert_array_equal(got[checked], exp[checked])
    assert caches["g0"]["k"] is k_buf and caches["g0"]["len"] == T + steps
    if dtype == "float32":        # the decoded rows: see the module docstring
        tol = dict(rtol=1 / 128, atol=1 / 32)
    for name in ("k", "v"):
        np.testing.assert_allclose(to_np(caches["g0"][name]), to_np(rcaches["g0"][name]),
                                   **tol)


def test_prefill_token_is_the_forward_argmax(model, cpu_mesh):
    """Within the port: prefill's greedy token is the argmax of the no-cache
    forward's logits at the last position (the check ``chip_smoke.py``
    relies on at full width)."""
    arch, cfg, pcfg, _, _, pp = model
    prompt = np.random.default_rng(24).integers(0, cfg.vocab, size=(3, 7)).astype(np.int32)
    _, tok = port_engine.make_serve_fns(pcfg, cpu_mesh, batch=3, max_len=16).prefill(
        pp, {"tokens": torch.from_numpy(prompt)})
    np.testing.assert_array_equal(tok.numpy(), port_logits(pp, pcfg, prompt)[:, -1].argmax(-1))


def _requests(cfg, cls):
    """Three buckets: 8 tokens (one full batch of 2), 12 tokens (a full
    batch and an underfull one), 5 tokens (underfull)."""
    rng = np.random.default_rng(21)
    lens, max_new = [8, 8, 12, 12, 12, 5], [6, 4, 7, 5, 6, 3]
    return [cls(i, [int(x) for x in rng.integers(0, cfg.vocab, n)], m)
            for i, (n, m) in enumerate(zip(lens, max_new))]


def _compared_prefix(pp, pcfg, prompt, got: list, exp: list) -> int:
    """How many leading tokens of ``got`` and ``exp`` are equal; where they
    first differ the port's no-cache forward must have a near tie."""
    n = next((i for i, (a, b) in enumerate(zip(got, exp)) if a != b), None)
    if n is None:
        assert len(got) == len(exp), (got, exp)
        return len(got)
    seq = np.asarray([prompt + got[:n]], np.int32)
    assert margins(port_logits(pp, pcfg, seq)[:, -1])[0] <= MARGIN, (n, got, exp)
    return n


def test_scheduler_matches_the_reference(model, jmesh, cpu_mesh):
    arch, cfg, pcfg, dtype, jp, pp = model
    ref_out, ref_stats = RefScheduler(cfg, jmesh, batch=2, max_len=32, eos_id=EOS[arch]).run(
        jp, _requests(cfg, RefRequest))
    out, stats = BatchScheduler(pcfg, cpu_mesh, batch=2, max_len=32, eos_id=EOS[arch]).run(
        pp, _requests(cfg, Request))
    reqs = {r.rid: r for r in _requests(cfg, Request)}
    assert out.keys() == ref_out.keys() == reqs.keys()
    compared = 0
    for rid in ref_out:
        if dtype == "float32":
            assert (out[rid].rid, out[rid].tokens, out[rid].finished) == (
                ref_out[rid].rid, ref_out[rid].tokens, ref_out[rid].finished), rid
        compared += _compared_prefix(pp, pcfg, reqs[rid].prompt, out[rid].tokens,
                                     ref_out[rid].tokens)
    assert compared * 2 >= sum(len(c.tokens) for c in out.values()), compared
    for f in ("requests", "prefill_tokens", "decode_steps", "batches"):
        assert getattr(stats, f) == getattr(ref_stats, f), f
    # one decode step per generated token after the prefill's
    assert stats.decode_steps == sum(len(c.tokens) - 1 for c in out.values())
    assert stats.batches == 4 and stats.wall_s > 0 and stats.decode_tok_per_s > 0
    stopped = [rid for rid, c in out.items() if len(c.tokens) < reqs[rid].max_new]
    assert stopped and all(out[rid].tokens[-1] == EOS[arch] for rid in stopped)


def test_max_len_guard_where_the_reference_clamps(jmesh, cpu_mesh):
    """8 prompt + 5 decoded positions need 13 cache slots.  With max_len=10
    the reference clamps the decode's write index, overwrites the last slot
    and returns other tokens than with room to spare; the port refuses."""
    cfg = ref_configs.get_smoke_config("qwen2-1.5b")
    pcfg = port_configs.get_smoke_config("qwen2-1.5b")
    arrays = draw_tree(ref_bb.model_spec(cfg, ref_mesh_ctx(jmesh)), np.random.default_rng(25))
    jp, pp = jax.tree.map(jnp.asarray, arrays), params_from_numpy(arrays, "cpu")
    prompt = [int(x) for x in np.random.default_rng(26).integers(0, cfg.vocab, 8)]

    def ref_tokens(max_len):
        out, _ = RefScheduler(cfg, jmesh, batch=1, max_len=max_len, eos_id=-1).run(
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
    # exactly full is allowed: 8 + 3 - 1 = 10 positions
    assert len(BatchScheduler(pcfg, cpu_mesh, batch=1, max_len=10, eos_id=-1).run(
        pp, [Request(0, prompt, 3)])[0][0].tokens) == 3


def test_cache_spec_equals_the_reference(jmesh, cpu_mesh):
    cfg = ref_configs.get_config("qwen2-1.5b")
    pcfg = port_configs.get_config("qwen2-1.5b")
    ref = ref_engine.abstract_cache(cfg, jmesh, 8, 2048)
    got = port_engine.abstract_cache(pcfg, cpu_mesh, 8, 2048)
    assert got.keys() == ref.keys() == {"g0"}
    for name in ("k", "v", "len"):
        assert tuple(got["g0"][name].shape) == ref["g0"][name].shape
        assert str(got["g0"][name].dtype).split(".")[-1] == str(ref["g0"][name].dtype)
        assert got["g0"][name].device.type == "meta"
    assert tuple(got["g0"]["k"].shape) == (28, 8, 2, 2048, 128)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-780m"])
def test_recurrent_cache_specs_equal_the_reference(jmesh, cpu_mesh, arch):
    """At full width, batch 8: every cache leaf (a hybrid period's three
    blocks and the two unscanned rglru groups; the ssm state and conv
    rings) has the reference's path, shape and dtype; no ``max_len``
    positions anywhere."""
    got = dict(leaves(port_engine.abstract_cache(port_configs.get_config(arch), cpu_mesh, 8, 4096)))
    ref = dict(leaves(ref_engine.abstract_cache(ref_configs.get_config(arch), jmesh, 8, 4096)))
    assert got.keys() == ref.keys()
    for path, a in got.items():
        assert tuple(a.shape) == ref[path].shape and a.device.type == "meta", path
        assert str(a.dtype).split(".")[-1] == str(ref[path].dtype), path
        assert 4096 not in a.shape, path


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-780m"])
def test_recurrent_plan_serves_past_max_len(jmesh, cpu_mesh, arch):
    """The ``max_len`` guard holds only where a cache has ``max_len``
    positions (``attn``).  A hybrid or ssm plan has none, so 8 prompt + 5
    decoded positions run at ``max_len`` 10, and the tokens equal the
    no-cache forward's argmax wherever its margin exceeds 0.01 (float32;
    a decode reads bfloat16 rings, which moves these logits by up to
    0.0061).  A prompt of ``max_len`` tokens is still refused."""
    cfg, pcfg = ref_configs.get_smoke_config(arch), port_configs.get_smoke_config(arch)
    arrays = draw_tree(ref_bb.model_spec(cfg, ref_mesh_ctx(jmesh)), np.random.default_rng(64))
    pp = params_from_numpy(arrays, "cpu")
    prompt = [int(x) for x in np.random.default_rng(65).integers(0, cfg.vocab, 8)]
    sched = BatchScheduler(pcfg, cpu_mesh, batch=1, max_len=10, eos_id=-1)
    toks = sched.run(pp, [Request(0, prompt, 6)])[0][0].tokens
    assert len(toks) == 6
    logits = port_logits(pp, pcfg, np.asarray([prompt + toks[:-1]]))[0, 7:]
    checked = margins(logits) > 0.01
    assert checked.mean() >= 0.5
    np.testing.assert_array_equal(np.asarray(toks)[checked], logits.argmax(-1).numpy()[checked])
    with pytest.raises(ValueError, match="longer than max_len"):
        sched.run(pp, [Request(1, prompt + [1, 2], 2)])


def test_meshes_run_on_the_card_unless_asked():
    """``make_local_mesh()`` means the CUDA card and raises without one;
    wider meshes wait for the multi-card slice."""
    if torch.cuda.is_available():
        assert make_local_mesh().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make_local_mesh()
    mesh = make_local_mesh(device="cpu")
    assert mesh.axis_names == ("data", "model") and mesh.device.type == "cpu"
    assert mesh_ctx(mesh).model_size == 1
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_local_mesh(2, 1, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_production_mesh()
