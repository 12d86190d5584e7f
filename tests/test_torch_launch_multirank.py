"""The training driver across ranks (``repro_torch.launch.train.main`` with
``--data 2 --model 2 --device cpu``: four gloo processes a run) and its
checkpoints, which are gathered to rank 0 and written in the one-rank
layout (``train.layout``).

* a (2, 2) run killed at step 5 leaves its step-4 checkpoint; a one-rank
  run resumes from it, holding the state bit for bit equal to the
  checkpoint, and its losses at steps 4 and 5 agree with an uninterrupted
  one-rank run's within 1e-2 (stated before the first run: the smoke model
  computes in bfloat16, and a sharded step rounds its bfloat16 sums in
  other places than the one-rank step — ``test_torch_launch_train.py``'s
  bound for the port against the reference);
* a (2, 2) run with ZeRO-1 resumes from the one-rank run's step-4
  checkpoint and agrees with it the same way; its own checkpoint, written
  at step 6, restores on one rank.
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import restore_checkpoint
from repro_torch.launch import train as port_train

COMMON = ["--arch", "qwen2-1.5b", "--smoke", "--batch", "4", "--seq", "64",
          "--steps", "6", "--ckpt-every", "4", "--log-every", "1", "--device", "cpu"]
MESH = ["--data", "2", "--model", "2"]


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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("launch_multirank")
    one = port_train.main(COMMON + ["--ckpt-dir", str(tmp / "one")])
    with pytest.raises(SystemExit) as e:
        port_train.main(COMMON + MESH + ["--ckpt-dir", str(tmp / "mesh"), "--kill-at", "5"])
    seen = {}

    def on_resume(params, opt, step):
        tree, s = restore_checkpoint(tmp / "mesh")
        got, want = _flat({"params": params, "opt": opt}), _flat(
            {"params": tree["params"], "opt": tree["opt"]})
        assert set(got) == set(want) and s == step
        for k in want:
            np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)
        seen["step"] = step

    from_mesh = port_train.main(COMMON + ["--ckpt-dir", str(tmp / "mesh"), "--resume"],
                                on_resume=on_resume)
    mesh_resumed = port_train.main(COMMON + MESH + ["--zero1", "--ckpt-dir", str(tmp / "one"),
                                                    "--resume", "--ckpt-every", "2"])
    return {"one": one, "kill_code": e.value.code, "seen": seen, "from_mesh": from_mesh,
            "mesh_resumed": mesh_resumed, "tmp": tmp}


def _tail(log):
    return {r["step"]: r["loss"] for r in log["steps"] if r["step"] >= 4}


def test_mesh_run_killed_then_resumed_on_one_rank(runs):
    assert runs["kill_code"] == 17 and runs["seen"] == {"step": 4}
    assert runs["from_mesh"]["start"] == 4
    want, got = _tail(runs["one"]), _tail(runs["from_mesh"])
    assert sorted(got) == sorted(want) == [4, 5]
    for s in want:
        assert abs(got[s] - want[s]) <= 1e-2, (s, got[s], want[s])


def test_one_rank_checkpoint_resumed_on_a_zero1_mesh(runs):
    log = runs["mesh_resumed"]
    assert log["start"] == 4
    want, got = _tail(runs["one"]), _tail(log)
    assert sorted(got) == [4, 5]
    for s in want:
        assert abs(got[s] - want[s]) <= 1e-2, (s, got[s], want[s])


def test_mesh_checkpoint_is_in_the_one_rank_layout(runs):
    """The (2, 2) ZeRO-1 run wrote its step-6 checkpoint into the one-rank
    run's directory: the same keys, shapes and dtypes as the one-rank
    run's step-4 checkpoint."""
    six, s6 = restore_checkpoint(runs["tmp"] / "one")
    four, s4 = restore_checkpoint(runs["tmp"] / "one", 4)
    assert (s6, s4) == (6, 4)
    a, b = _flat({k: six[k] for k in ("params", "opt")}), _flat(
        {k: four[k] for k in ("params", "opt")})
    assert set(a) == set(b)
    for k in a:
        assert tuple(np.shape(a[k])) == tuple(np.shape(b[k])), k
        assert str(getattr(a[k], "dtype", None)) == str(getattr(b[k], "dtype", None)), k
