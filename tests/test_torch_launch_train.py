"""The training driver, ``repro_torch.launch.train.main``, and the example
twins ``examples/train_lm_torch.py`` and ``examples/elastic_recovery_torch.py``
on ``--device cpu``.

* kill at a step, resume from the last checkpoint: the resumed run's
  losses equal an uninterrupted run's exactly (the CPU is deterministic),
  and the state it resumed with equals the checkpoint bit for bit;
* against ``repro.launch.train.main``: both resume from one step-0
  checkpoint of the reference's own initial state (bfloat16 parameters,
  float32 moments and master), so the same data and the same state; the
  logged losses agree within 1e-2 absolute (stated before the first run:
  the smoke model computes in bfloat16, and XLA rounds its fused bfloat16
  work elsewhere than torch's op-by-op run — a few bfloat16 ulps of the
  activations, ~1e-3 of a loss near 6.2 — which steps of Adam carry on),
  and the learning rates as printed (3 digits) are equal;
* the elastic twin's printed recovery equals the reference example's.
"""
import contextlib
import importlib.util
import io
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.launch.train as ref_train
from repro.checkpoint import save_checkpoint as ref_save
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.launch import train as port_train

ROOT = Path(__file__).resolve().parents[1]
COMMON = ["--arch", "qwen2-1.5b", "--smoke", "--batch", "4", "--seq", "64",
          "--steps", "12", "--ckpt-every", "4", "--log-every", "1"]
LINE = re.compile(r"\[train\] step +(\d+) loss=([-\d.]+) gnorm=([-\d.]+) lr=([-\d.e+]+)")


def _load(name):
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    return {path: tree}


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


def _assert_state_equals_checkpoint(state, ckpt_tree):
    got, want = _flat(state), _flat(ckpt_tree)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)


def test_kill_and_resume_equals_uninterrupted(tmp_path):
    ck = str(tmp_path / "ck")
    whole = port_train.main(COMMON + ["--device", "cpu"])
    with pytest.raises(SystemExit) as e:
        port_train.main(COMMON + ["--device", "cpu", "--ckpt-dir", ck, "--kill-at", "10"])
    assert e.value.code == 17
    seen = {}

    def on_resume(params, opt, step):
        tree, s = restore_checkpoint(ck)
        assert s == step == 8
        _assert_state_equals_checkpoint({"params": params, "opt": opt}, {
            "params": tree["params"], "opt": tree["opt"]})
        seen["step"] = step

    resumed = port_train.main(COMMON + ["--device", "cpu", "--ckpt-dir", ck, "--resume"],
                              on_resume=on_resume)
    assert seen == {"step": 8} and resumed["start"] == 8
    tail = {r["step"]: r for r in whole["steps"] if r["step"] >= 8}
    assert [r["step"] for r in resumed["steps"]] == sorted(tail)
    for r in resumed["steps"]:
        assert r == tail[r["step"]], (r, tail[r["step"]])
    assert all(np.isfinite(r["loss"]) for r in whole["steps"])


def _parse(text):
    return {int(m[1]): (float(m[2]), float(m[3]), m[4]) for m in LINE.finditer(text)}


def test_logged_losses_match_reference_from_one_state(tmp_path):
    """Both drivers resume from the same step-0 checkpoint, written from the
    reference's own ``build`` (its seeded parameters and fresh state)."""
    _, _, _, _, params, opt = ref_train.build("qwen2-1.5b", True, 4, 64, False, steps=12)
    import jax

    tree = {"params": jax.tree.map(np.asarray, params), "opt": jax.tree.map(np.asarray, opt),
            "meta": {"consumed": np.zeros((0,), np.uint32)}}
    ref_save(tmp_path / "ref", 0, tree)
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ref_train.main(COMMON + ["--ckpt-dir", str(tmp_path / "ref"), "--resume"])
    ref_log = _parse(out.getvalue())
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        log = port_train.main(COMMON + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "port"),
                                        "--resume"])
    port_log = _parse(out.getvalue())
    assert "resumed from step 0" in out.getvalue() and log["start"] == 0
    assert sorted(ref_log) == sorted(port_log) == list(range(12))
    for s in range(12):
        (lr_, _, lrr), (lp, _, lrp) = ref_log[s], port_log[s]
        assert abs(lp - lr_) <= 1e-2, (s, lp, lr_)
        assert lrr == lrp, (s, lrr, lrp)
    # both checkpoints at step 12 hold the same keys, shapes and dtypes
    a, _ = restore_checkpoint(tmp_path / "ref")
    b, _ = restore_checkpoint(tmp_path / "port")
    fa, fb = _flat(a), _flat(b)
    assert set(fa) == set(fb)
    for k in fa:
        assert _bits(fa[k]).shape == _bits(fb[k]).shape and \
            _bits(fa[k]).dtype == _bits(fb[k]).dtype, k


def test_train_lm_twin_kill_and_resume():
    twin = _load("train_lm_torch")
    seen = {}

    def on_resume(params, opt, step):
        seen["step"] = step
        seen["state"] = {k: _bits(v).copy() for k, v in
                         _flat({"params": params, "opt": opt}).items()}

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = twin.main(device="cpu", on_resume=on_resume)
        whole = twin.main(device="cpu", kill_at=0)
    assert "simulated failure at step 35" in out.getvalue()
    assert seen["step"] == 20 and res["resumed"]["start"] == 20
    tree, _ = restore_checkpoint(res["ckpt_dir"], 20)
    want = _flat({"params": tree["params"], "opt": tree["opt"]})
    assert set(want) == set(seen["state"])
    for k, v in want.items():
        np.testing.assert_array_equal(seen["state"][k], _bits(v), err_msg=k)
    tail = {r["step"]: r for r in whole["resumed"]["steps"]}
    assert [r["step"] for r in res["resumed"]["steps"]] == list(range(20, 60))
    for r in res["resumed"]["steps"]:
        assert r == tail[r["step"]]
    shutil.rmtree(res["ckpt_dir"], ignore_errors=True)
    shutil.rmtree(whole["ckpt_dir"], ignore_errors=True)


def test_elastic_recovery_twin_prints_the_reference_recovery():
    outs = []
    for name, kw in (("elastic_recovery", {}), ("elastic_recovery_torch", {"device": "cpu"})):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            _load(name).main(**kw)
        outs.append(out.getvalue().splitlines())
    ref, port = outs
    assert len(ref) == len(port) == 4
    assert ref[:3] == port[:3]
    assert port[3].replace(" on cpu", "") == ref[3]
