"""``repro_torch.optim`` (AdamW, its int8 codebook, the plan, compression)
held against ``repro.optim`` on the same inputs, on the CPU.

Tolerances, stated before the first run:

* int8 codebook: the scales are equal exactly (a block's absmax, the same
  float32 division); a code may part by one only where its pre-round value
  (recomputed in float64 from the same float32 input) lies within 1e-4 of
  a .5 boundary — XLA's and torch's float32 ``log10`` may part by an ulp
  (≤ 6e-5 after scaling to 254 levels), and both round half to even;
  dequantized values within ``DEQ_RTOL`` = 3e-6 relative: ``10 ** x`` in
  float32, which XLA evaluates as ``exp(x · ln 10)``, so the argument's
  rounding alone moves it by up to ``|x ln 10| · 2^-23`` ≤ 1.9e-6 for the
  codebook's x in [-7, 0] (first stated as 1e-6, which the steps below
  exceeded at 1.76e-6);
* ``lr_schedule``: 1e-6 relative;
* ``build_plan`` and ``opt_state_spec``: equal, field for field;
* one ``apply_updates`` step on the same random gradients and state:
  parameters, master, m and v within 1e-6 relative (+ 1e-9 absolute) for
  float32 states; bfloat16 states within one bfloat16 ulp (1/128
  relative) of the stored moments and 1e-6 of the parameters; int8 codes
  by the boundary rule above, widened by how far the port's moment may lie
  from the reference's: ``DEQ_RTOL`` of the dequantized old moment times beta,
  plus two float32 roundings — where the gradient nearly cancels the old
  moment that is a large share of the new one (``_moment``; the first
  run, holding codes to 1e-4 and scales to 1e-6 relative, parted at 88
  of 12.6 M codes and one scale by 2.07e-6 relative); the scales (a
  block's absmax) within that bound's block maximum; the parameters and
  master within 1e-6 absolute except at most 1e-4 of the entries (a
  parted code, or a moment the bound above moves), there within the
  learning rate;
* ``compressed_sync``: the selected index sets equal (random floats do not
  tie), so the synced gradient and the error buffer are equal exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st
from _torch_models import on_mesh, to_np

import repro.optim as ref_optim
import repro.optim.adamw as ref_adamw
import repro.optim.compression as ref_comp
from repro.configs import get_smoke_config as ref_smoke
from repro.launch.mesh import make_local_mesh as ref_mesh
from repro.models.backbone import model_spec as ref_model_spec
from repro.models.spec import P as RefP
from repro.train.step import mesh_ctx as ref_mesh_ctx
import repro_torch.optim as port_optim
import repro_torch.optim.adamw as port_adamw
import repro_torch.optim.compression as port_comp
from repro_torch.configs import get_smoke_config as port_smoke
from repro_torch.models.backbone import model_spec as port_model_spec
from repro_torch.models.layers import MeshCtx
from repro_torch.models.spec import P as PortP

QBLK = port_adamw.QBLK
DEQ_RTOL = 3e-6
AXES = ("data", "model")
SIZES = {"data": 1, "model": 1}


@pytest.fixture(scope="module")
def jmesh():
    mesh = ref_mesh(1, 1)
    return mesh, ref_mesh_ctx(mesh)


def _pre_round(x: np.ndarray, signed: bool) -> np.ndarray:
    """The codebook's pre-round level of each entry, in float64 from the
    same float32 block division both packages make."""
    blocks = x.reshape(-1, QBLK)
    s = np.maximum(np.abs(blocks).max(1), np.float32(1e-30)).astype(np.float32)
    ay = np.abs(blocks / s[:, None]).astype(np.float64).reshape(-1)
    levels = 126.0 if signed else 254.0
    return (np.log10(np.maximum(ay, 1e-30)) + 7.0) / 7.0 * levels


def _codes_agree(got, want, pre, slack=0.0):
    """Codes equal except by one where the pre-round level lies within
    1e-4 (+ ``slack``, per entry) of a .5 boundary."""
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    near = np.abs(pre - np.floor(pre) - 0.5) < 1e-4 + slack
    assert d.max() <= 1, d.max()
    assert not np.any((d > 0) & ~near), np.flatnonzero((d > 0) & ~near)[:5]
    return int((d > 0).sum())


# ---------------------------------------------------------------------------
# the int8 codebook
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_matches_reference(signed, seed):
    rng = np.random.default_rng(seed)
    n = 64 * QBLK
    mags = 10.0 ** (rng.integers(-6, 3) - 7 * rng.random(n))
    x = (mags * (rng.choice([-1, 1], n) if signed else 1.0)).astype(np.float32)
    x[:QBLK] = 0.0                                     # an all-zero block
    x[QBLK:QBLK + 5] = 0.0
    q_r, s_r = ref_adamw._quantize(jnp.asarray(x), signed=signed)
    q_p, s_p = port_adamw._quantize(torch.from_numpy(x), signed=signed)
    assert q_p.dtype == (torch.int8 if signed else torch.uint8)
    np.testing.assert_array_equal(s_p.numpy(), np.asarray(s_r))
    _codes_agree(q_p.numpy(), np.asarray(q_r), _pre_round(x, signed))
    # dequantize the reference's codes in both packages
    back_r = np.asarray(ref_adamw._dequantize(q_r, s_r, signed=signed))
    back_p = port_adamw._dequantize(torch.from_numpy(np.asarray(q_r)), s_p, signed=signed)
    np.testing.assert_allclose(back_p.numpy(), back_r, rtol=DEQ_RTOL, atol=0)


@settings(max_examples=25, deadline=None)
@given(
    scale_exp=st.integers(-6, 3),
    spread=st.integers(0, 6),
    signed=st.booleans(),
    seed=st.integers(0, 10_000),
)
def test_dynamic_quantization_relative_error(scale_exp, spread, signed, seed):
    """The reference's property (``tests/test_optim.py``) on the port: the
    log-spaced codebook keeps ~7 % relative error across decades."""
    rng = np.random.default_rng(seed)
    n = 2 * QBLK
    mags = 10.0 ** (scale_exp - spread * rng.random(n))
    x = mags * (rng.choice([-1, 1], n) if signed else 1.0)
    q, s = port_adamw._quantize(torch.tensor(x, dtype=torch.float32), signed=signed)
    back = port_adamw._dequantize(q, s, signed=signed).double().numpy()
    rel = np.abs(back - x) / np.maximum(np.abs(x), 1e-20)
    blk_max = np.repeat(np.abs(x).reshape(-1, QBLK).max(1), QBLK)
    covered = np.abs(x) > blk_max * 1.1e-7
    assert np.all(rel[covered] < 0.07), rel[covered].max()


@pytest.mark.parametrize("n", [1, QBLK - 1, QBLK, QBLK + 1, 3 * QBLK + 7,
                               2 * port_adamw.UPDATE_CHUNK + 5])
def test_pad_len_and_state_pad(n):
    assert port_adamw._pad_len(n) == ref_adamw._pad_len(n)
    for kw in ({}, {"state_dtype": "int8"}):
        assert (port_adamw._state_pad(n, port_optim.OptConfig(**kw))
                == ref_adamw._state_pad(n, ref_optim.OptConfig(**kw)))
    assert port_adamw.UPDATE_CHUNK == ref_adamw.UPDATE_CHUNK and QBLK == ref_adamw.QBLK


def test_lr_schedule_matches_reference():
    kw = dict(lr_peak=1e-3, warmup=10, total_steps=100, lr_min_frac=0.1)
    rc, pc = ref_optim.OptConfig(**kw), port_optim.OptConfig(**kw)
    for s in (0, 1, 5, 9, 10, 11, 55, 99, 100, 150):
        want = float(ref_optim.lr_schedule(rc, jnp.int32(s)))
        got = float(port_optim.lr_schedule(pc, torch.tensor(s, dtype=torch.int32)))
        assert abs(got - want) <= 1e-6 * want, (s, got, want)
    lrs = [float(port_optim.lr_schedule(pc, torch.tensor(s))) for s in (0, 9, 10, 55, 100)]
    assert lrs[0] < lrs[1] <= pc.lr_peak * (1 + 1e-6)
    assert abs(lrs[2] - pc.lr_peak) < 1e-6 * pc.lr_peak
    assert lrs[2] > lrs[3] > lrs[4]
    assert abs(lrs[4] - pc.lr_peak * 0.1) < 1e-6


# ---------------------------------------------------------------------------
# the plan and the state layout
# ---------------------------------------------------------------------------


def _example_specs(P, dtype):
    return {
        "norm": P((64,), (None,), dtype=dtype),
        "wq": P((64, 128), (None, "model"), dtype=dtype),
        "experts": P((8, 4, 4), (("data", "model"), None, None), dtype=dtype),
    }


@pytest.mark.parametrize("zero1", [False, True])
def test_build_plan_field_for_field(zero1):
    """The reference's pod/data/model example (``tests/test_optim.py``)."""
    sizes = {"pod": 2, "data": 4, "model": 2}
    axes = ("pod", "data", "model")
    want = ref_optim.build_plan(_example_specs(RefP, jnp.bfloat16), axes, sizes,
                                ref_optim.OptConfig(zero1=zero1))
    got = port_optim.build_plan(_example_specs(PortP, torch.bfloat16), axes, sizes,
                                port_optim.OptConfig(zero1=zero1))
    assert set(got) == set(want)
    for k in want:
        assert tuple(vars(got[k]).items()) == tuple(vars(want[k]).items()), k
    if zero1:
        assert got["wq"].scatter and got["wq"].sync_axes == ("pod",)
        assert not got["experts"].scatter and got["norm"].scatter
    else:
        assert got["norm"].sync_axes == ("pod", "data", "model")
        assert got["experts"].sync_axes == ("pod",)


def _shapes(tree, out=None, path=()):
    out = {} if out is None else out
    for k, v in tree.items():
        if isinstance(v, dict):
            _shapes(v, out, path + (k,))
        else:
            dt = (str(v.dtype).replace("torch.", "") if isinstance(v.dtype, torch.dtype)
                  else np.dtype(v.dtype).name)
            out[path + (k,)] = (tuple(v.shape), dt, v.axes)
    return out


@pytest.mark.parametrize("state", ["float32", "bfloat16", "int8"])
def test_opt_state_spec_matches_reference(state):
    """qwen2's smoke spec plus a leaf above ``2·UPDATE_CHUNK``; each state
    leaf's shape, dtype and axes equal, with the mesh of the reference's
    example (zero1 off)."""
    big = (2 * ref_adamw.UPDATE_CHUNK + 300,)
    rspec = {**ref_model_spec(ref_smoke("qwen2-1.5b"), ref_mesh_ctx(ref_mesh(1, 1))),
             "big": RefP(big, (None,))}
    pspec = {**port_model_spec(port_smoke("qwen2-1.5b"), MeshCtx()), "big": PortP(big, (None,))}
    rdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": "int8"}[state]
    pdt = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": "int8"}[state]
    rc, pc = ref_optim.OptConfig(state_dtype=rdt), port_optim.OptConfig(state_dtype=pdt)
    want = ref_optim.opt_state_spec(rspec, ref_optim.build_plan(rspec, AXES, SIZES, rc),
                                    SIZES, rc)
    got = port_optim.opt_state_spec(pspec, port_optim.build_plan(pspec, AXES, SIZES, pc),
                                    SIZES, pc)
    assert _shapes(got) == _shapes(want)
    pad = _shapes(got)[("leaves", "big", "master")][0][0]
    assert pad % ref_adamw.UPDATE_CHUNK == 0 and pad > big[0]


def test_zero1_scatter_raises_on_one_card():
    """A plan that scatters over 'data' needs the mesh of its ranks: without
    one (a single process) every step that would scatter raises."""
    sizes = {"data": 4, "model": 1}
    spec = _example_specs(PortP, torch.float32)
    plan = port_optim.build_plan(spec, AXES, sizes, port_optim.OptConfig(zero1=True))
    assert plan["wq"].scatter
    with pytest.raises(ValueError, match="needs its mesh"):
        port_optim.sync_gradient(torch.zeros(64, 128), plan["wq"])
    params = {k: torch.zeros(p.shape) for k, p in spec.items()}
    with pytest.raises(ValueError, match="needs its mesh"):
        port_optim.init_opt_state(params, plan, port_optim.OptConfig(zero1=True))


# ---------------------------------------------------------------------------
# one apply_updates step
# ---------------------------------------------------------------------------

BIG = 2 * port_adamw.UPDATE_CHUNK + 777      # chunked update, a ragged last slice


def _draw(rng, big: bool):
    params = {"a": rng.standard_normal((96, 40)).astype(np.float32) * 0.05,
              "n": {"scale": (1 + 0.1 * rng.standard_normal(40)).astype(np.float32)}}
    if big:
        params["big"] = rng.standard_normal(BIG).astype(np.float32) * 0.02
    grads = {"a": rng.standard_normal((96, 40)).astype(np.float32) * 1e-2,
             "n": {"scale": rng.standard_normal(40).astype(np.float32) * 1e-2}}
    if big:
        grads["big"] = rng.standard_normal(BIG).astype(np.float32) * 1e-4
    return params, grads


def _spec_of(P, params):
    return {k: (_spec_of(P, v) if isinstance(v, dict) else P(v.shape, (None,) * v.ndim))
            for k, v in params.items()}


def _state(rng, ref_params, plan, rc, state):
    st = jax.tree.map(np.asarray, ref_optim.init_opt_state(ref_params, plan, rc))
    st["step"] = np.asarray(4, np.int32)

    def fill(node):
        for k, v in list(node.items()):
            if isinstance(v, dict):
                fill(v)
            elif k in ("m", "v"):
                x = (1e-3 * rng.standard_normal(v.shape)) if k == "m" else (
                    1e-4 * (1 + rng.random(v.shape)))
                node[k] = np.asarray(jnp.asarray(x, rc.state_dtype))
            elif k == "m_q":
                node[k] = (rng.integers(1, 128, v.shape) * rng.choice([-1, 1], v.shape)
                           ).astype(np.int8)
            elif k == "v_q":
                node[k] = rng.integers(150, 256, v.shape).astype(np.uint8)
            elif k in ("m_s", "v_s"):
                node[k] = np.full(v.shape, 3e-3 if k == "m_s" else 2e-4, np.float32)

    fill(st["leaves"])
    return st


def _walk(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("state,big", [("float32", False), ("bfloat16", False),
                                       ("int8", False), ("float32", True), ("int8", True)])
def test_apply_updates_one_step_matches_reference(jmesh, state, big):
    rng = np.random.default_rng(17)
    params, grads = _draw(rng, big)
    rdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": "int8"}[state]
    pdt = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": "int8"}[state]
    rc = ref_optim.OptConfig(warmup=2, total_steps=20, state_dtype=rdt)
    pc = port_optim.OptConfig(warmup=2, total_steps=20, state_dtype=pdt)
    rplan = ref_optim.build_plan(_spec_of(RefP, params), AXES, SIZES, rc)
    pplan = port_optim.build_plan(_spec_of(PortP, params), AXES, SIZES, pc)
    jp = jax.tree.map(jnp.asarray, params)
    st = _state(rng, jp, rplan, rc, state)

    def ref_step(g, p, o):
        return ref_optim.apply_updates(g, p, o, rplan, rc, AXES)

    r_params, r_opt, r_m = on_mesh(jmesh, ref_step, jax.tree.map(jnp.asarray, grads), jp,
                                   jax.tree.map(jnp.asarray, st))
    p_params = {k: (v if not isinstance(v, dict) else dict(v)) for k, v in params.items()}
    p_params = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p_params)
    p_opt = port_optim.opt_state_from_numpy(st, "cpu")
    before = {path: v.clone() for path, v in _walk(p_params)}
    out_params, out_opt, p_m = port_optim.apply_updates(
        jax.tree.map(lambda a: torch.from_numpy(np.array(a)), grads), p_params, p_opt, pplan,
        pc, AXES)
    assert out_params is p_params and out_opt is p_opt          # updated in place
    assert int(p_opt["step"]) == 5 and int(r_opt["step"]) == 5
    for k in ("grad_norm", "lr"):
        assert abs(float(p_m[k]) - float(r_m[k])) <= 1e-6 * float(r_m[k]), k
    lr = float(r_m["lr"])

    def params_like(got, want):
        err = np.abs(to_np(got) - to_np(want))
        if state == "int8":
            assert err.max() <= lr and np.mean(err > 1e-6) <= 1e-4, err.max()
        else:
            np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-6, atol=1e-9)

    for path, want in _walk(jax.tree.map(np.asarray, r_opt["leaves"])):
        got = _at(p_opt["leaves"], path)
        if path[-1] in ("m_q", "v_q"):
            signed = path[-1] == "m_q"
            # the pre-round level of the moment the reference quantized, and
            # how far the port's moment may lie from it, in levels
            m, bound = _moment(st, path, grads, rc, float(r_m["grad_norm"]), signed)
            levels = 126.0 if signed else 254.0
            slack = levels / 7.0 / np.log(10) * bound / np.maximum(np.abs(m), 1e-30)
            _codes_agree(got.numpy(), want, _pre_round(m, signed), slack)
        elif path[-1] in ("m_s", "v_s"):
            m, bound = _moment(st, path[:-1] + (path[-1][0] + "_q",), grads, rc,
                               float(r_m["grad_norm"]), path[-1] == "m_s")
            tol = bound.reshape(-1, QBLK).max(1) + 2.5e-7 * want
            assert np.all(np.abs(got.numpy() - want) <= tol), path
        elif path[-1] == "master":
            params_like(got, want)
        elif state == "bfloat16":
            np.testing.assert_allclose(to_np(got), to_np(want), rtol=1 / 128, atol=1e-12)
        else:
            np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-6, atol=1e-9)
    for path, want in _walk(jax.tree.map(np.asarray, r_params)):
        got = _at(p_params, path)
        assert not np.array_equal(got.numpy(), before[path].numpy())
        params_like(got, want)


def _moment(st, path, grads, rc, gnorm, signed):
    """The float32 moment the reference quantizes for the code leaf at
    ``path`` — beta · dequantized old + (1 - beta) · g (or g²), g clipped —
    and a bound on how far the port's lies from it: DEQ_RTOL of beta · old
    (the dequantized value's tolerance; where the gradient nearly cancels
    the old moment this is a large share of the moment) and two float32
    roundings."""
    leaf = _at(st["leaves"], path[:-1])
    g = np.asarray(_at(grads, path[:-1]), np.float32).reshape(-1)
    scale = min(1.0, rc.clip_norm / max(gnorm, 1e-12))
    g = np.pad(g * np.float32(scale), (0, leaf["master"].shape[0] - g.size))
    if signed:
        old = np.asarray(ref_adamw._dequantize(jnp.asarray(leaf["m_q"]), jnp.asarray(leaf["m_s"]),
                                               signed=True))
        m = (old * rc.beta1 + (1 - rc.beta1) * g).astype(np.float32)
        return m, DEQ_RTOL * np.abs(old * rc.beta1) + 2.5e-7 * np.abs(m)
    old = np.asarray(ref_adamw._dequantize(jnp.asarray(leaf["v_q"]), jnp.asarray(leaf["v_s"]),
                                           signed=False))
    v = (old * rc.beta2 + (1 - rc.beta2) * g * g).astype(np.float32)
    return v, DEQ_RTOL * np.abs(old * rc.beta2) + 2.5e-7 * np.abs(v)


def test_opt_state_from_numpy_key_for_key():
    rng = np.random.default_rng(2)
    params, _ = _draw(rng, False)
    for rdt, pdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16),
                     ("int8", None)):
        rc = ref_optim.OptConfig(state_dtype=rdt)
        plan = ref_optim.build_plan(_spec_of(RefP, params), AXES, SIZES, rc)
        st = jax.tree.map(np.asarray, ref_optim.init_opt_state(
            jax.tree.map(jnp.asarray, params), plan, rc))
        got = port_optim.opt_state_from_numpy(st, "cpu")
        for path, want in _walk(st):
            g = _at(got, path)
            assert tuple(g.shape) == want.shape, path
            assert str(g.dtype).replace("torch.", "") == str(want.dtype), path
            np.testing.assert_array_equal(to_np(g), to_np(want))
        if pdt is not None:
            assert got["leaves"]["a"]["m"].dtype == pdt
    with pytest.raises(ValueError):
        port_optim.opt_state_from_numpy({"leaves": {}}, "cpu")


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


def test_compressed_sync_matches_reference(jmesh):
    rng = np.random.default_rng(9)
    g = rng.standard_normal((300, 256)).astype(np.float32)
    err = (0.1 * rng.standard_normal((300, 256))).astype(np.float32)
    spec = {"w": RefP((300, 256), (None, "model"))}
    rc = ref_comp.CompressionConfig(ratio=0.01, min_leaf_size=1000, enabled=True)
    pc = port_comp.CompressionConfig(ratio=0.01, min_leaf_size=1000, enabled=True)
    plan = ref_optim.build_plan(spec, AXES, SIZES, ref_optim.OptConfig())["w"]
    pplan = port_optim.build_plan({"w": PortP((300, 256), (None, "model"))}, AXES, SIZES,
                                  port_optim.OptConfig())["w"]
    assert ref_comp.eligible(plan, rc) and port_comp.eligible(pplan, pc)
    assert port_comp.k_for(pplan, pc) == ref_comp.k_for(plan, rc) == 768
    want = on_mesh(jmesh, lambda a, e: ref_comp.compressed_sync(a, e, plan, rc),
                   jnp.asarray(g), jnp.asarray(err))
    got = port_comp.compressed_sync(torch.from_numpy(g), torch.from_numpy(err), pplan, pc)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int((got[0] != 0).sum()) == 768


def test_compressed_sync_ties_of_zeros_give_equal_sums(jmesh):
    """k above the non-zero count: the sets may differ among zeros, the
    synced gradient and error may not."""
    g = np.zeros((64, 64), np.float32)
    g[3, :10] = np.arange(1, 11)
    spec = {"w": RefP((64, 64), (None, "model"))}
    rc = ref_comp.CompressionConfig(ratio=0.01, min_leaf_size=100, enabled=True)
    pc = port_comp.CompressionConfig(ratio=0.01, min_leaf_size=100, enabled=True)
    plan = ref_optim.build_plan(spec, AXES, SIZES, ref_optim.OptConfig())["w"]
    pplan = port_optim.build_plan({"w": PortP((64, 64), (None, "model"))}, AXES, SIZES,
                                  port_optim.OptConfig())["w"]
    want = on_mesh(jmesh, lambda a, e: ref_comp.compressed_sync(a, e, plan, rc),
                   jnp.asarray(g), jnp.zeros_like(jnp.asarray(g)))
    got = port_comp.compressed_sync(torch.from_numpy(g), torch.zeros(64, 64), pplan, pc)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_sync_all_ledger_matches_reference(jmesh):
    rspec = ref_model_spec(ref_smoke("qwen2-1.5b"), ref_mesh_ctx(ref_mesh(1, 1)))
    pspec = port_model_spec(port_smoke("qwen2-1.5b"), MeshCtx())
    rc = ref_comp.CompressionConfig(ratio=0.01, min_leaf_size=20_000, enabled=True)
    pc = port_comp.CompressionConfig(ratio=0.01, min_leaf_size=20_000, enabled=True)
    rplan = ref_optim.build_plan(rspec, AXES, SIZES, ref_optim.OptConfig())
    pplan = port_optim.build_plan(pspec, AXES, SIZES, port_optim.OptConfig())
    rng = np.random.default_rng(4)
    grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), rspec,
                         is_leaf=lambda x: isinstance(x, RefP))
    rerr = ref_comp.init_error_state(grads, rplan, rc)
    perr = port_comp.init_error_state(
        jax.tree.map(lambda a: torch.from_numpy(a), grads), pplan, pc)
    for path, e in _walk(jax.tree.map(np.asarray, rerr)):
        assert tuple(_at(perr, path).shape) == e.shape, path
    want = on_mesh(jmesh, lambda g, e: ref_comp.sync_all(g, e, rplan, ref_optim.OptConfig(),
                                                         rc)[:2],
                   jax.tree.map(jnp.asarray, grads), rerr)
    gs, ne, ledger = port_comp.sync_all(jax.tree.map(lambda a: torch.from_numpy(a), grads),
                                        perr, pplan, port_optim.OptConfig(), pc)
    for path, w in _walk(jax.tree.map(np.asarray, want[0])):
        np.testing.assert_array_equal(_at(gs, path).numpy(), w)
    for path, w in _walk(jax.tree.map(np.asarray, want[1])):
        np.testing.assert_array_equal(_at(ne, path).numpy(), w)
    sparse = sum(8 * ref_comp.k_for(p, rc) for _, p in _walk(rplan) if ref_comp.eligible(p, rc))
    dense = sum(4 * int(np.prod(p.local_shape)) for _, p in _walk(rplan)
                if not ref_comp.eligible(p, rc))
    assert ledger == {"sparse_bytes": sparse, "dense_bytes": dense}
    assert sparse > 0 and dense > 0
