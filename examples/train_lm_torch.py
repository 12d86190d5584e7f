"""End-to-end LM training on the PyTorch/CUDA port: data pipeline -> train
step -> checkpoints -> resume-after-failure, via
``repro_torch.launch.train``.

The twin of ``examples/train_lm.py``: the qwen2-family smoke model for 60
steps, a simulated failure at step 35 and a resume from the step-20
checkpoint.  ``--full`` trains the real qwen2-1.5b config (28 layers, d
1536) for 300 steps at sequence 512.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--full] [--device cpu]
(default device: the CUDA card.)
"""
import argparse
import pathlib
import sys
import tempfile

if __name__ == "__main__":  # standalone: make src/ importable
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.train import main as train_main


def main(device=None, full=False, kill_at=35, ckpt_dir=None, on_resume=None):
    """Train on ``device`` (None: the card, and raise without one) until the
    failure at ``kill_at`` (0: no failure), then resume.  Returns
    ``{"ckpt_dir", "resumed"}``, the second the resumed run's log
    (``launch.train.main``'s; the uninterrupted run's where ``kill_at`` is
    0).  ``on_resume`` goes to the resumed run (``launch.train.main``)."""
    ckpt = ckpt_dir or tempfile.mkdtemp(prefix="train_lm_ckpt_")
    dev = [] if device is None else ["--device", str(device)]
    if full:
        base = ["--arch", "qwen2-1.5b", "--steps", "300", "--batch", "8",
                "--seq", "512", "--ckpt-dir", ckpt, "--ckpt-every", "50"]
        return {"ckpt_dir": ckpt, "resumed": train_main(base + dev)}

    common = ["--arch", "qwen2-1.5b", "--smoke", "--batch", "8", "--seq", "128",
              "--ckpt-dir", ckpt, "--ckpt-every", "20", "--steps", "60"] + dev
    if not kill_at:
        return {"ckpt_dir": ckpt, "resumed": train_main(common)}
    print(f"== phase 1: train until simulated failure (ckpt dir {ckpt})")
    try:
        train_main(common + ["--kill-at", str(kill_at)])
    except SystemExit as e:
        if e.code != 17:
            raise
        print("== node failed (exit 17); resuming from last checkpoint")
    log = train_main(common + ["--resume"], on_resume=on_resume)
    print("== train_lm complete")
    return {"ckpt_dir": ckpt, "resumed": log}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true", help="qwen2-1.5b, 300 steps")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    a = ap.parse_args()
    main(a.device, a.full)
