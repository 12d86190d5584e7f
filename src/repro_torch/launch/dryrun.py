"""Dry run of every (architecture × input-shape) cell on ``meta`` tensors —
on one card, or on rank 0 of the reference's production meshes — and the
roofline terms of each.

The port of ``repro.launch.dryrun``.  The reference lowers and compiles
each cell on a CPU host against 512 fake devices and reads its HLO; the
port builds each cell on the ``meta`` device (``launch.cells``) and counts
its step with ``roofline.analyze_step``, depth by trip count
(``roofline.depth_weighted``).  Nothing is allocated and no card is
needed.  The records keep the reference's keys:

* with no flag, ``mesh`` is ``"card"`` and ``chips`` 1 (one card, no
  collective); ``--multi-pod`` counts rank 0 of the meta (pod 2, data 16,
  model 16) mesh (``launch.mesh.make_production_mesh``), ``mesh``
  ``"multipod"``, ``chips`` 512, and ``--both-meshes`` that and the
  (data 16, model 16) one, ``"pod"``, 256, as the reference's names and
  files.  The per-device counts are rank 0's, times ``chips`` globally
  (uniform SPMD, as the reference's ``analyze_hlo``);
* ``roofline.collective_s`` is each collective's ring bytes over its
  group's link (``roofline.collective_seconds``): NVLink within a node of
  8 cards, the card's NIC between nodes — on the production meshes every
  group spans nodes, so the NIC's 50 GB/s; ``hlo`` adds
  ``collective_by_link_per_device``;
* ``times`` holds ``build`` and ``count`` (the reference's ``lower`` and
  ``compile``), and ``hlo`` adds ``depth_traces``;
* ``memory`` holds ``argument_bytes_per_device`` (the meta arguments; above
  one rank not the global inputs, which a rank holds on the host) and
  ``peak_bytes_per_device`` (the counter's live-storage peak), and
  ``fits_h100`` in place of ``fits_v5e``; the reference's temp, output and
  alias sizes come from XLA's buffer assignment and are 0 here;
* ``hlo`` holds the counter's flops and unfused bytes (an upper count: no
  fusion) and ``cost_analysis_raw`` repeats them, as XLA's own estimate
  has no counterpart;
* an MoE cell's routes are balanced (``meta["moe_routes"]``); above one
  rank ``meta["moe_dispatch"]`` holds rank 0's dispatches, routed pairs
  and pairs dropped at capacity; a decode cell is its last step
  (``meta["decode_position"]``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --out experiments/dryrun_torch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --both-meshes
  ... [--multi-pod] [--zero1] [--state-dtype bfloat16] [--no-master] [--no-remat]
      [--no-attn-skip]
"""
from __future__ import annotations

import argparse
import gc
import json
import time
import traceback
from pathlib import Path

# the record's mesh by ``run_cell``'s ``multi_pod``: one card, or the reference's names
MESH_NAMES = {None: "card", False: "pod", True: "multipod"}


def model_flops(arch: str, kind: str, batch: int, seq: int) -> float:
    from repro_torch.configs import get_config
    from repro_torch.models.config import n_active_params

    cfg = get_config(arch)
    n = n_active_params(cfg)
    if kind == "train":
        return 6.0 * n * batch * seq
    if kind == "prefill":
        return 2.0 * n * batch * seq
    return 2.0 * n * batch  # decode: one token per sequence


def count_cell(arch: str, shape: str, mesh, memo: dict | None = None, **build) -> tuple:
    """(the cell at full depth, its depth-weighted ``analyze_step`` count,
    the seconds spent building cells and counting them): ``build`` goes to
    every ``build_cell`` of the count, ``memo`` (a fresh one if None) to
    every ``analyze_step``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.cells import build_cell
    from repro_torch.roofline import analyze_step, depth_weighted
    from repro_torch.roofline.count import StepCounter

    cfg = build.pop("cfg", None) or get_config(arch)
    memo = {} if memo is None else memo
    times = {"build": 0.0, "count": 0.0}
    t0 = time.time()
    cell = build_cell(arch, shape, mesh, cfg=cfg, **build)
    argument_bytes = StepCounter(host=cell.host).track_all(cell.args)   # at full depth, whole
    times["build"] += time.time() - t0

    def count(c):
        t0 = time.time()
        sub = build_cell(arch, shape, mesh, cfg=c, **build)
        t1 = time.time()
        res = analyze_step(sub.fn, sub.args, memo=memo, mesh=mesh, host=sub.host)
        times["build"] += t1 - t0
        times["count"] += time.time() - t1
        return res

    return cell, depth_weighted(cfg, count, argument_bytes=argument_bytes), times


def run_cell(arch: str, shape: str, *, multi_pod: bool | None = None, out_dir: Path,
             opt_overrides: dict, remat: bool = True,
             capacity_factor: float | None = None, tag: str = "",
             attn_skip: bool = True, microbatch: int = 1, memo: dict | None = None) -> dict:
    """Count one cell and write its record: on one card (``multi_pod``
    None, mesh ``card``), or on rank 0 of the meta production mesh
    (``multi_pod`` False: ``pod``, 256 ranks; True: ``multipod``, 512)."""
    from repro_torch.launch.cells import SHAPES, cell_status, default_opt_cfg
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    from repro_torch.models.layers import BLOCK_SKIP_DEFAULT
    from repro_torch.roofline import HBM_BYTES, HBM_BYTES_PER_S, PEAK_BF16_FLOPS, \
        collective_seconds

    BLOCK_SKIP_DEFAULT[0] = attn_skip

    runnable, why = cell_status(arch, shape)
    mesh_name = MESH_NAMES[multi_pod]
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "tag": tag}
    if not runnable:
        rec.update(status="skipped", reason=why)
        _save(rec, out_dir, tag)
        return rec

    mesh = (make_local_mesh(device="meta") if multi_pod is None
            else make_production_mesh(multi_pod=multi_pod))
    chips = mesh.world
    info = SHAPES[shape]
    opt_cfg = default_opt_cfg(arch, **opt_overrides) if info["kind"] == "train" else None
    cell, roo, times = count_cell(arch, shape, mesh, memo, opt_cfg=opt_cfg, remat=remat,
                                  capacity_factor=capacity_factor, microbatch=microbatch)
    if roo["moe_dispatch"]:
        cell.meta["moe_dispatch"] = roo["moe_dispatch"]

    mf = model_flops(arch, info["kind"], info["batch"], info["seq"])
    compute_s = roo["flops_global"] / (chips * PEAK_BF16_FLOPS)
    memory_s = roo["bytes_global"] / (chips * HBM_BYTES_PER_S)
    coll_s = collective_seconds(roo["collective_by_link_per_device"])
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": coll_s}
    bound = max(terms, key=terms.get)
    step_s = max(terms.values())
    arg_b = roo["argument_bytes_per_device"]
    peak_b = roo["peak_bytes_per_device"]

    rec.update(
        status="ok",
        kind=info["kind"], batch=info["batch"], seq=info["seq"], chips=chips,
        meta=cell.meta,
        times=times,
        memory=dict(
            argument_bytes_per_device=arg_b,
            temp_bytes_per_device=0,
            output_bytes_per_device=0,
            alias_bytes_per_device=0,
            peak_bytes_per_device=peak_b,
            fits_h100=bool(peak_b <= HBM_BYTES),
        ),
        cost_analysis_raw=dict(
            flops=roo["flops_per_device"],
            bytes_accessed=roo["bytes_per_device"],
        ),
        hlo=dict(
            flops_global=roo["flops_global"],
            bytes_global=roo["bytes_global"],
            collective_global=roo["collective_global"],
            collective_by_op_per_device=roo["collective_by_op_per_device"],
            collective_op_counts=roo["collective_op_counts"],
            collective_by_link_per_device=roo["collective_by_link_per_device"],
            unresolved_dots=roo["unresolved_dots"],
            depth_traces=roo["depth_traces"],
        ),
        roofline=dict(
            **terms, bound=bound, step_time_s=step_s,
            model_flops=mf,
            useful_flops_ratio=(mf / roo["flops_global"]) if roo["flops_global"] else 0.0,
            roofline_fraction=(mf / (chips * PEAK_BF16_FLOPS)) / step_s if step_s else 0.0,
        ),
    )
    _save(rec, out_dir, tag)
    print(
        f"[dryrun] {arch:18s} {shape:11s} {mesh_name:8s} "
        f"count={times['count']:7.1f}s peak/dev={peak_b/2**30:7.2f}GiB "
        f"bound={bound:12s} terms(c/m/n)="
        f"{compute_s*1e3:9.3f}/{memory_s*1e3:9.3f}/{coll_s*1e3:9.3f} ms "
        f"MFU-bound={rec['roofline']['roofline_fraction']:.3f}",
        flush=True,
    )
    del cell
    gc.collect()
    return rec


def _save(rec: dict, out_dir: Path, tag: str = ""):
    out_dir.mkdir(parents=True, exist_ok=True)
    sfx = f"__{tag}" if tag else ""
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{sfx}.json"
    (out_dir / name).write_text(json.dumps(rec, indent=1, default=float))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape id or 'all'")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--tag", default="")
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--no-master", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-attn-skip", action="store_true",
                    help="dense chunk-pair attention (paper-faithful baseline)")
    ap.add_argument("--state-dtype", default="float32",
                    choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--microbatch", type=int, default=1)
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch.cells import SHAPES

    sd = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": "int8"}[args.state_dtype]
    overrides = dict(
        zero1=args.zero1,
        master_fp32=not args.no_master,
        state_dtype=sd,
    )
    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = ([False, True] if args.both_meshes else [True] if args.multi_pod else [None])
    out_dir = Path(args.out)
    failures = 0
    memo: dict = {}                      # meta results by op and argument specs, for every cell
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    run_cell(
                        arch, shape, multi_pod=mp, out_dir=out_dir,
                        opt_overrides=overrides, remat=not args.no_remat,
                        capacity_factor=args.capacity_factor, tag=args.tag,
                        attn_skip=not args.no_attn_skip, microbatch=args.microbatch,
                        memo=memo,
                    )
                except Exception:
                    failures += 1
                    print(f"[dryrun] FAIL {arch} {shape} {MESH_NAMES[mp]}", flush=True)
                    traceback.print_exc()
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
