"""The four round executors of the port == the JAX executors, element for
element, on the CPU.

Both run over *identical* resident stores (the reference ``CohortStore``
carried across with ``cohort_store_from_numpy``) and identical
``CohortRoundPlan.arrays`` from the reference planner, in a round whose
plan carries non-empty removed/added diff overlays and a depth-2 split
filter chain.  Tolerance: 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pbs import (
    PBSConfig,
    new_session_state,
    plan_from_d_known,
    queue_split,
)
from repro.core.simdata import make_pair
from repro.recon import engine as engine_jax
from repro.recon.session import ReconSession, SessionBatch
from repro_torch.kernels.platform import upload
from repro_torch.recon import cohort_store_from_numpy, engine

torch.set_num_threads(1)
CPU = torch.device("cpu")
KEYS = ("row_map", "unit_valid", "seeds", "removed", "removed_cnt",
        "added", "added_cnt", "fseeds", "fbins", "fcnt")


def _round_plan(seed: int, sides=("a", "b")):
    """One cohort's round-2 plan from the reference planner, with overlays
    and a depth-2 filter chain crafted into the session states."""
    cfg = PBSConfig(seed=seed, n_override=127, t_override=5, g_override=6)
    sessions = []
    for sid in range(2):
        rng = np.random.default_rng(100 * seed + sid)
        a, b = make_pair(1500, 40, rng)
        a, b = np.unique(a), np.unique(b)
        plan = plan_from_d_known(cfg, 40)
        st = new_session_state(a, b, plan)
        # recovered so far: some elements Alice holds (-> removed overlay)
        # and some she lacks (-> added overlay)
        st.diff = set(int(x) for x in a[: 9 + sid]) | {
            int(x) for x in rng.integers(1, 1 << 32, size=5 + sid, dtype=np.uint64)
        }
        # a depth-2 split chain: unit 1 splits, then its first child splits
        queue_split(st, st.units[1], 1, cfg.seed)
        queue_split(st, st.units[plan.g], 1, cfg.seed)
        st.rounds = 1
        sessions.append(ReconSession(sid=sid, plan=plan, state=st))
    batch = SessionBatch(sessions, sides=sides)
    (plan,) = batch.plan_round(2)
    arrays = plan.arrays
    assert arrays["removed_cnt"].max() > 0 and arrays["added_cnt"].max() > 0
    assert arrays["fcnt"].max() == 2 and arrays["unit_valid"].min() == 0
    return plan


def _carry(store):
    return cohort_store_from_numpy(
        n=store.n, t=store.t, m=store.m, row_of=store.row_of,
        row_base=store.row_base, device="cpu",
        sides={
            k: (np.asarray(s.flat), np.asarray(s.start), np.asarray(s.cnt))
            for k, s in store.sides.items()
        },
    )


def _same(got: torch.Tensor, exp) -> None:
    exp = np.asarray(exp)
    got = got.numpy()
    if exp.dtype == np.uint32:
        got = got.view(np.uint32)
    assert got.shape == exp.shape
    assert np.array_equal(got, exp)


def _args(plan, store_sides, as_jax):
    out = []
    for s in store_sides:
        out += [s.flat, s.start, s.cnt]
    conv = jnp.asarray if as_jax else (lambda x: upload(x, CPU))
    return out + [conv(plan.arrays[k]) for k in KEYS]


@pytest.mark.parametrize("seed", [1, 2])
def test_execute_round(seed):
    plan = _round_plan(seed)
    ref_store, store = plan.store, _carry(plan.store)
    kw = dict(n=ref_store.n, t=ref_store.t, width_a=plan.width_a, width_b=plan.width_b)
    exp = engine_jax.execute_round(*_args(plan, (ref_store.a, ref_store.b), True), **kw)
    got = engine.execute_round(*_args(plan, (store.a, store.b), False), **kw)
    assert len(got) == len(exp) == 8
    names = ("xors_a", "xors_b", "ok", "pos", "cnt", "csum_a", "csum_b", "sk_diff")
    for name, g, e in zip(names, got, exp):
        _same(g, e)
    # the crafted round is not trivial: something decoded, something differs
    assert np.asarray(exp[4]).max() > 0 and np.asarray(exp[7]).any()
    # padding units sketch to zero and decode trivially ok
    pad = plan.arrays["unit_valid"] == 0
    assert got[2].numpy()[pad].all() and not got[7].numpy()[pad].any()


@pytest.mark.parametrize("side", ["a", "b"])
def test_encode_side(side):
    plan = _round_plan(3)
    ref_store, store = plan.store, _carry(plan.store)
    arrays = dict(plan.arrays)
    if side == "b":         # Bob never carries a diff overlay
        u = len(arrays["row_map"])
        arrays["removed"] = np.zeros((u, 0), np.uint32)
        arrays["added"] = np.zeros((u, 0), np.uint32)
        arrays["removed_cnt"] = np.zeros(u, np.int32)
        arrays["added_cnt"] = np.zeros(u, np.int32)
    plan.arrays = arrays
    width = plan.width_a if side == "a" else plan.width_b
    kw = dict(n=ref_store.n, t=ref_store.t, width=width)
    exp = engine_jax.encode_side(*_args(plan, (ref_store.sides[side],), True), **kw)
    got = engine.encode_side(*_args(plan, (store.sides[side],), False), **kw)
    assert len(got) == len(exp) == 3
    for g, e in zip(got, exp):
        _same(g, e)


@pytest.mark.parametrize("t1", [10, 20])
def test_execute_round_ext(t1):
    plan = _round_plan(4)
    ref_store, store = plan.store, _carry(plan.store)
    kw = dict(n=ref_store.n, t0=ref_store.t, t1=t1,
              width_a=plan.width_a, width_b=plan.width_b)
    exp = engine_jax.execute_round_ext(
        *_args(plan, (ref_store.a, ref_store.b), True), **kw)
    got = engine.execute_round_ext(*_args(plan, (store.a, store.b), False), **kw)
    assert got.shape == (len(plan.arrays["row_map"]), t1 - ref_store.t)
    _same(got, exp)
    assert np.asarray(exp).any()


def test_encode_side_ext_and_prefix_property():
    plan = _round_plan(5)
    ref_store, store = plan.store, _carry(plan.store)
    t0, t1 = ref_store.t, 12
    exp = engine_jax.encode_side_ext(
        *_args(plan, (ref_store.a,), True), n=ref_store.n, t0=t0, t1=t1,
        width=plan.width_a)
    got = engine.encode_side_ext(
        *_args(plan, (store.a,), False), n=store.n, t0=t0, t1=t1, width=plan.width_a)
    _same(got, exp)
    # concat(sketch at t0, increment) == sketch at t1, through the executors
    sk0, _, _ = engine.encode_side(
        *_args(plan, (store.a,), False), n=store.n, t=t0, width=plan.width_a)
    sk1, _, _ = engine.encode_side(
        *_args(plan, (store.a,), False), n=store.n, t=t1, width=plan.width_a)
    assert torch.equal(torch.cat([sk0, got], dim=1), sk1)


def test_store_carried_across_is_identical():
    plan = _round_plan(6)
    store = _carry(plan.store)
    for side in ("a", "b"):
        ref_side, port_side = plan.store.sides[side], store.sides[side]
        _same(port_side.flat, np.asarray(ref_side.flat))
        _same(port_side.start, np.asarray(ref_side.start))
        _same(port_side.cnt, np.asarray(ref_side.cnt))
        assert port_side.h2d_bytes == ref_side.h2d_bytes
        assert np.array_equal(port_side.cnt_host, ref_side.cnt_host)
    assert store.row_of == plan.store.row_of and store.row_base == plan.store.row_base
