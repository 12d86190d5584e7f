"""Phase ``dryrun`` of ``chip_smoke.py`` alone, on one CUDA card.

    python3 tools/dryrun_probe.py [--seed S] [--out PATH]

Counts the 40-cell grid on meta tensors (``chip_smoke.start_dryrun_grid``,
processes of their own), then runs what phase ``dryrun`` needs of phase
``model_train`` — qwen2-1.5b's f32-state training run at full width
(``chip_smoke.train_run``, its profiled and flop-counted steps included)
and the dry run's prediction of that step — then
``chip_smoke.dryrun_phase``: each prediction held against the card.  No PBS kernel is built
or launched.  Prints the card's name and power limit last.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", metavar="PATH", default=None,
                    help="also write every JSON line to PATH")
    args = ap.parse_args()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        cs._OUT.append(open(args.out, "w"))
    smi = cs.sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    cfg = cs.get_config(cs.TRAIN_ARCH)
    spec = cs.model_spec(cfg, cs.mesh_ctx(cs.make_local_mesh()))
    prediction = cs.dryrun_prediction(
        cs.TRAIN_ARCH, "train_4k", cs.TRAIN_BATCH, microbatch=cs.TRAIN_MICROBATCH,
        opt_cfg=cs.OptConfig(**cs.TRAIN_OPT, state_dtype=cs.torch.float32))
    grid = cs.dryrun_grid(cs.start_dryrun_grid(cs.ROOT / "chiprun_out" / "dryrun"))
    run = cs.train_run(args, cfg, spec, "f32", cs.torch.float32, cs.TRAIN_STEPS, profile=True)
    cs.emit({"phase": "model_train", "step": "full_width", "gpu": smi,
             **{k: v for k, v in run.items() if k != "profile_one_step"}})
    cs.dryrun_phase(args, smi, {"prediction": prediction, "run": run}, grid)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
