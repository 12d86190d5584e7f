"""Phase ``model_train`` of ``chip_smoke.py`` alone, on one CUDA card.

    python3 tools/model_train_probe.py [--seed S] [--out PATH]

Runs ``chip_smoke.model_train_phase``: the ten smoke configs' CPU = card
``bundle.step``, the full-width float32 gradient check, qwen2-1.5b at full
width in three training runs (f32 states, int8 states, compression) and
``examples/train_lm_torch.py``'s kill and resume, each printing its JSON
line; no PBS kernel is built or launched.  Prints the card's name and
power limit last.
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
    cs.model_train_phase(args, smi)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
