"""The torch twins of the four PBS examples (``examples/*_torch.py``), run
at their default sizes on ``device="cpu"`` (each kernel's plain version).

Each twin asserts against the port's own oracle internally; here every
result it returns is held against the reference's numpy oracle
``repro.core.pbs.reconcile`` on the same inputs (tolerance 0: every
``ReconcileResult`` field, so diff, ``bytes_sent``, ``bytes_per_round`` and
``estimator_bytes``), with the wire and device ledgers the reference
examples print.  The reference examples themselves are not run: under the
Pallas interpreter they take tens of seconds each, and the oracle is the
same contract.
"""
import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.core.pbs import PBSConfig as RefConfig
from repro.core.pbs import reconcile

from repro_torch.core.pbs import PBSConfig

from _torch_port import RESULT_FIELDS

ROOT = Path(__file__).resolve().parents[1]
TWINS = ("quickstart", "serve_batch", "serve_endpoints", "blockchain_relay")


def _load(name):
    path = ROOT / "examples" / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _oracle(a, b, cfg, dk):
    return reconcile(a, b, RefConfig(**vars(cfg)), d_known=dk)


def _assert_oracle(got, a, b, cfg, dk, tag=""):
    want = _oracle(a, b, cfg, dk)
    for f in RESULT_FIELDS:
        assert getattr(got, f) == getattr(want, f), (tag, f)
    assert got.success and got.diff == set(int(x) for x in a) ^ set(int(x) for x in b)


def test_quickstart_twin():
    out = _load("quickstart").main(device="cpu")
    _assert_oracle(out["engine"], out["a"], out["b"], PBSConfig(seed=7), None)
    _assert_oracle(out["oracle"], out["a"], out["b"], PBSConfig(seed=7), None)
    st = out["stats"]
    # one estimator session: phase 0, then 2 fused launches a cohort-round
    assert st["kernel_launches"] == 2 * st["cohort_rounds"] > 0
    assert st["legacy_kernel_launches"] == 2 * st["kernel_launches"]
    assert st["h2d_store_bytes"] > 0 and st["h2d_ratio"] > 1
    assert out["engine"].estimator_bytes > 0


def test_serve_batch_twin():
    out = _load("serve_batch").main(device="cpu")
    sessions, results, st = out["sessions"], out["results"], out["stats"]
    assert len(results) == len(sessions) == 8
    for i, (label, a, b, cfg, dk) in enumerate(sessions):
        _assert_oracle(results[i], a, b, cfg, dk, label)
    # the overloaded session split; the estimator session paid phase 0
    labels = [s[0] for s in sessions]
    assert results[labels.index("overload,split")].decode_failures > 0
    assert results[labels.index("two-sided,est")].estimator_bytes > 0
    assert st["kernel_launches"] == 2 * st["cohort_rounds"] > 0
    assert st["store_builds"] >= 1 and st["h2d_ratio"] > 1


def test_serve_endpoints_twin():
    out = _load("serve_endpoints").main(device="cpu")
    assert set(out) == {"memory", "tcp", "lossy"}
    for name, run in out.items():
        for sid, (label, a, b, cfg, dk) in enumerate(run["sessions"]):
            _assert_oracle(run["results"][sid], a, b, cfg, dk, (name, label))
        wa, wb = run["alice"], run["bob"]
        assert wa["frame_bytes_out"] == wb["frame_bytes_in"] > 0, name
        assert wa["frame_bytes_in"] == wb["frame_bytes_out"] > 0, name
        for k in ("estimator_frame_bytes", "protocol_frame_bytes", "verify_frame_bytes"):
            assert wa[k] == wb[k], (name, k)
    # the same sessions frame the same bytes in memory and over TCP
    mem, tcp = out["memory"]["alice"], out["tcp"]["alice"]
    for k in ("frames_out", "frames_in", "frame_bytes_out", "frame_bytes_in",
              "estimator_frame_bytes", "protocol_frame_bytes", "verify_frame_bytes"):
        assert mem[k] == tcp[k], k
    assert tcp["transport_bytes_out"] == tcp["frame_bytes_out"]
    assert out["lossy"]["dropped"] > 0 and out["lossy"]["retransmits"] > 0


def test_blockchain_relay_twin():
    rows = _load("blockchain_relay").main(device="cpu", epochs=3)
    assert [r["epoch"] for r in rows] == [0, 1, 2]
    for row in rows:
        for ch, got in row["results"].items():
            _assert_oracle(got, row["peer_pools"][ch], row["relay_pool"], row["cfgs"][ch],
                           row["d_known"], (row["epoch"], ch))
            ws = row["wire_stats"][ch]
            assert ws["frame_bytes_in"] > 0 and ws["frame_bytes_out"] > 0
    st = [row["stats"] for row in rows]
    # epoch 0 builds the stores; epoch 1 re-plans the estimator sessions'
    # code to the pinned churn budget (one counted rebuild, as the reference
    # example prints); every later epoch patches them in place
    assert st[0]["store_builds"] >= 1 and st[0]["store_uploads"] >= 1
    assert st[1]["store_builds"] == 1
    assert st[2]["store_builds"] == 0 and st[2]["store_compactions"] == 0
    assert 0 < st[2]["h2d_delta_bytes"] < st[0]["h2d_store_bytes"]
    # the hub fuses: 2 encode launches a cohort-round for all four peers
    for s in st:
        assert s["kernel_launches"] == 2 * s["cohort_rounds"] > 0
        assert s["decode_launches"] == s["cohort_rounds"]


@pytest.mark.parametrize("name", TWINS)
def test_twin_without_device_needs_a_card(name):
    """``main()`` with no device means the card: without one it raises before
    any work, and so does the command line without ``--device``."""
    if torch.cuda.is_available():
        from repro_torch.kernels.platform import resolve_device

        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        _load(name).main()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / f"{name}_torch.py")],
        capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode != 0 and "CUDA" in proc.stderr, proc.stderr[-500:]
