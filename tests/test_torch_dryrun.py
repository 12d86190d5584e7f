"""The dry run, ported to ``repro_torch.launch.dryrun``, held against the
JAX package's ``repro.launch.dryrun`` and ``repro.roofline.hlo``.

* ``model_flops`` equals the reference's for every cell (exact: the same
  integer formula).
* The port's flops for train, prefill and decode equal ``analyze_hlo`` of
  the reference's compiled cell on the CPU, at smoke width and a small
  batch and sequence, for qwen2-1.5b, mamba2-780m, recurrentgemma-2b and
  whisper-tiny.  Prefill and decode are equal to the unit.  Training
  parts by one itemised product, pinned to the unit: the port's
  ``ce_loss`` recomputes each chunk's logits in the backward
  (``torch.utils.checkpoint``; at qwen2-1.5b's full width a chunk's
  float32 logits are 1.24 GB), and the reference's compiled step
  computes them once, so the port counts one more (B·T × d)·(d × V)
  product, 2·B·T·d·V flops with V the padded vocabulary (1–5 % of a smoke
  step).  And for mamba2-780m the reference counts 393 216 flops more
  (0.09 % of its smoke step): XLA compiles four small products of the SSD
  block's backward as ``dot``s (2 × 65 536 and 2 × 131 072 flops, in the
  scanned layer body) that the port's autograd computes as elementwise
  products and sums, which neither counter counts.
* The records keep the reference's keys (``fits_v5e`` becomes
  ``fits_h100``, ``times`` holds ``build`` and ``count``, ``hlo`` adds
  ``depth_traces``), under the reference's file names with the mesh
  ``card``, and ``benchmarks/roofline_report.py``'s ``table``, imported
  unedited, renders them, and the ``pod`` and ``multipod`` records of the
  production meshes (``tests/test_torch_dryrun_multicard.py`` holds their
  counts).
"""
import importlib
import json
import os
import sys
from pathlib import Path

import jax
import pytest
import torch

import repro.configs as ref_configs
import repro.launch.cells as ref_cells
from repro.launch.mesh import make_local_mesh as ref_mesh
from repro.roofline.hlo import analyze_hlo
import repro_torch.launch.cells as cells
import repro_torch.models.layers as layers
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.backbone import vocab_pad
from repro_torch.roofline import analyze_step

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ref_dryrun():
    """``repro.launch.dryrun``, whose import sets ``XLA_FLAGS`` for 512 host
    devices: imported after JAX has its devices, the variable put back."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


def test_model_flops_equal_the_reference_for_every_cell(ref_dryrun):
    for arch, shape in cells.all_cells():
        info = cells.SHAPES[shape]
        args = (arch, info["kind"], info["batch"], info["seq"])
        assert dryrun.model_flops(*args) == ref_dryrun.model_flops(*args), (arch, shape)


XLA_SSD_BACKWARD_DOTS = 2 * 65_536 + 2 * 131_072
SMALL = {"train_4k": (4, 64), "prefill_32k": (2, 64), "decode_32k": (2, 64)}
REF_CASES = [(a, s) for a in ("qwen2-1.5b", "mamba2-780m", "recurrentgemma-2b",
                              "whisper-tiny") for s in SMALL]


@pytest.mark.parametrize("arch,shape", REF_CASES, ids=[f"{a}-{s}" for a, s in REF_CASES])
def test_flops_equal_the_reference_compiled_cell(arch, shape, monkeypatch):
    b, s = SMALL[shape]
    monkeypatch.setattr(ref_cells, "get_config", ref_configs.get_smoke_config)
    monkeypatch.setitem(ref_cells.SHAPES, shape, {**ref_cells.SHAPES[shape], "batch": b,
                                                  "seq": s})
    ref_cell = ref_cells.build_cell(arch, shape, ref_mesh(1, 1))
    ref = analyze_hlo(ref_cell.fn.lower(*ref_cell.args).compile().as_text(), 1)
    cfg = get_smoke_config(arch)
    cell = cells.build_cell(arch, shape, make_local_mesh(device="meta"), cfg=cfg, batch=b,
                            seq=s)
    port = analyze_step(cell.fn, cell.args)
    recompute = 2 * b * s * cfg.d_model * vocab_pad(cfg) if shape == "train_4k" else 0
    ssd_dots = XLA_SSD_BACKWARD_DOTS if (arch, shape) == ("mamba2-780m", "train_4k") else 0
    assert port["flops_per_device"] == ref["flops_per_device"] + recompute - ssd_dots
    assert port["unresolved_dots"] == ref["unresolved_dots"] == 0
    assert recompute <= 0.05 * ref["flops_per_device"]


def test_main_writes_the_reference_record(tmp_path, ref_dryrun, capsys):
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "qwen2-1.5b", "--shape", "train_4k", "--out", str(tmp_path)])
    assert done.value.code == 0
    path = tmp_path / "qwen2-1.5b__train_4k__card.json"
    rec = json.loads(path.read_text())
    assert [p.name for p in tmp_path.iterdir()] == [path.name]
    assert set(rec) == {"arch", "shape", "mesh", "tag", "status", "kind", "batch", "seq",
                        "chips", "meta", "times", "memory", "cost_analysis_raw", "hlo",
                        "roofline"}
    assert (rec["status"], rec["mesh"], rec["chips"]) == ("ok", "card", 1)
    assert set(rec["times"]) == {"build", "count"}
    assert set(rec["memory"]) == {"argument_bytes_per_device", "temp_bytes_per_device",
                                  "output_bytes_per_device", "alias_bytes_per_device",
                                  "peak_bytes_per_device", "fits_h100"}
    assert set(rec["hlo"]) == {"flops_global", "bytes_global", "collective_global",
                               "collective_by_op_per_device", "collective_op_counts",
                               "collective_by_link_per_device", "unresolved_dots",
                               "depth_traces"}
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s", "bound",
                                    "step_time_s", "model_flops", "useful_flops_ratio",
                                    "roofline_fraction"}
    ro, hlo = rec["roofline"], rec["hlo"]
    assert ro["model_flops"] == ref_dryrun.model_flops("qwen2-1.5b", "train", 256, 4096)
    assert ro["compute_s"] == hlo["flops_global"] / 989e12
    assert ro["memory_s"] == hlo["bytes_global"] / 3.35e12
    assert ro["step_time_s"] == max(ro["compute_s"], ro["memory_s"]) and ro["collective_s"] == 0
    assert hlo["depth_traces"] == [{"dense": 2}, {"dense": 3}]
    # the full cell is 256 x 4096 tokens: far past one card
    assert rec["memory"]["peak_bytes_per_device"] > 80 * 2**30
    assert rec["memory"]["fits_h100"] is False
    assert rec["meta"]["opt"] == {"zero1": False, "master_fp32": True, "state_dtype": "float32"}
    assert "[dryrun] qwen2-1.5b" in capsys.readouterr().out


def test_a_skipped_cell_is_recorded_as_the_reference_records_it(tmp_path):
    rec = dryrun.run_cell("qwen2-1.5b", "long_500k", out_dir=tmp_path, opt_overrides={})
    assert rec == {"arch": "qwen2-1.5b", "shape": "long_500k", "mesh": "card", "tag": "",
                   "status": "skipped",
                   "reason": ref_cells.cell_status("qwen2-1.5b", "long_500k")[1]}
    assert json.loads((tmp_path / "qwen2-1.5b__long_500k__card.json").read_text()) == rec


def test_the_mesh_flags_write_pod_and_multipod_records(tmp_path):
    """``--multi-pod`` writes the ``multipod`` records and ``--both-meshes``
    the ``pod`` and ``multipod`` ones, under the reference's names: rank 0
    of the meta production mesh, ``chips`` its world, a collective term
    over the NIC (every group spans nodes).  A skipped cell is recorded on
    its mesh."""
    for flag, meshes in (("--multi-pod", ["multipod"]), ("--both-meshes", ["multipod", "pod"])):
        out = tmp_path / flag
        with pytest.raises(SystemExit) as done:
            dryrun.main(["--arch", "qwen2-1.5b", "--shape", "decode_32k", "--out", str(out),
                         flag])
        assert done.value.code == 0
        assert sorted(p.name for p in out.iterdir()) == [
            f"qwen2-1.5b__decode_32k__{m}.json" for m in meshes]
        for m in meshes:
            rec = json.loads((out / f"qwen2-1.5b__decode_32k__{m}.json").read_text())
            assert (rec["status"], rec["mesh"], rec["chips"]) == (
                "ok", m, {"pod": 256, "multipod": 512}[m])
            assert rec["meta"]["mesh"] == ({"data": 16, "model": 16} if m == "pod" else
                                           {"pod": 2, "data": 16, "model": 16})
            assert rec["roofline"]["collective_s"] > 0
            assert set(rec["hlo"]["collective_by_link_per_device"]) == {"nic"}
            assert rec["hlo"]["collective_global"] == pytest.approx(
                rec["chips"] * sum(rec["hlo"]["collective_by_op_per_device"].values()))
    rec = dryrun.run_cell("qwen2-1.5b", "long_500k", multi_pod=True, out_dir=tmp_path,
                          opt_overrides={})
    assert (rec["mesh"], rec["status"]) == ("multipod", "skipped")
    assert (tmp_path / "qwen2-1.5b__long_500k__multipod.json").exists()


@pytest.fixture
def block_skip_restored():
    yield
    layers.BLOCK_SKIP_DEFAULT[0] = True


def test_the_flags_reach_the_cell(tmp_path, block_skip_restored):
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "whisper-tiny", "--shape", "train_4k", "--out", str(tmp_path),
                     "--state-dtype", "int8", "--no-master", "--zero1", "--tag", "t1"])
    rec = json.loads((tmp_path / "whisper-tiny__train_4k__card__t1.json").read_text())
    assert rec["meta"]["opt"] == {"zero1": True, "master_fp32": False, "state_dtype": "int8"}
    assert rec["tag"] == "t1"
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "whisper-tiny", "--shape", "train_4k", "--out", str(tmp_path),
                     "--no-attn-skip", "--tag", "dense"])
    assert layers.BLOCK_SKIP_DEFAULT == [False]
    dense = json.loads((tmp_path / "whisper-tiny__train_4k__card__dense.json").read_text())
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "whisper-tiny", "--shape", "train_4k", "--out", str(tmp_path),
                     "--tag", "skip", "--no-remat", "--microbatch", "2"])
    assert layers.BLOCK_SKIP_DEFAULT == [True]
    skip = json.loads((tmp_path / "whisper-tiny__train_4k__card__skip.json").read_text())
    # the dense pair grid adds the masked chunk pairs; no remat drops the second forward
    assert dense["hlo"]["flops_global"] > rec["hlo"]["flops_global"] > skip["hlo"]["flops_global"]


def test_roofline_report_renders_the_ports_records(tmp_path):
    for arch, shape in (("mamba2-780m", "decode_32k"), ("qwen2-1.5b", "long_500k")):
        dryrun.run_cell(arch, shape, out_dir=tmp_path, opt_overrides={})
    sys.path.insert(0, str(ROOT))
    try:
        report = importlib.import_module("benchmarks.roofline_report")
    finally:
        sys.path.remove(str(ROOT))
    md = report.table(report.load(tmp_path), "card")
    lines = md.splitlines()
    assert lines[0] == "### Mesh `card`" and len(lines) == 6
    assert lines[4].startswith("| mamba2-780m | decode_32k | ok |")
    assert lines[5] == "| qwen2-1.5b | long_500k | skip | — | — | — | — | — | — |"
    for mp, mesh in ((False, "pod"), (True, "multipod")):
        for arch, shape in (("mamba2-780m", "long_500k"), ("qwen2-1.5b", "long_500k")):
            dryrun.run_cell(arch, shape, multi_pod=mp, out_dir=tmp_path, opt_overrides={})
        lines = report.table(report.load(tmp_path), mesh).splitlines()
        assert lines[0] == f"### Mesh `{mesh}`" and len(lines) == 6
        assert lines[4].startswith("| mamba2-780m | long_500k | ok |")
        assert lines[4].split(" | ")[7] == "memory"          # the bound column
        assert lines[5] == "| qwen2-1.5b | long_500k | skip | — | — | — | — | — | — |"
