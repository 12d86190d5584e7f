"""Training driver on one card: data pipeline -> train step -> atomic
checkpoints -> (simulated) failure and resume.

The port of ``repro.launch.train``: the same loop, flags, log lines and
checkpoint tree (``params``, ``opt``, ``meta.consumed``), so a checkpoint
of either package resumes the other.  ``--kill-at N`` exits with code 17
at step N; ``--resume`` restores the latest checkpoint (parameters,
optimizer state, data ledger) into the freshly built state, in place.
``--device`` picks the device: none means the CUDA card (raises without
one), ``cpu`` runs the plain PyTorch path.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --smoke \\
      --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt [--resume] [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch


def build(arch: str, smoke: bool, batch: int, seq: int, zero1: bool,
          data: int = 1, model: int = 1, steps: int = 1000, device=None):
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import OptConfig
    from repro_torch.train import init_train_state, make_train_step

    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    mesh = make_local_mesh(data, model, device=device)
    ocfg = OptConfig(warmup=max(5, steps // 20), total_steps=steps, zero1=zero1)
    bundle = make_train_step(cfg, mesh, ocfg, batch=batch)
    params, opt = init_train_state(bundle, cfg, mesh, ocfg)
    return cfg, mesh, ocfg, bundle, params, opt


def load_into(state, tree, path: str = "") -> None:
    """Copy a restored tree (numpy arrays, CPU bfloat16 tensors) into the
    live state of the same keys, shapes and dtypes, in place; raises on
    any mismatch."""
    if isinstance(state, dict):
        if not isinstance(tree, dict) or set(tree) != set(state):
            raise ValueError(f"checkpoint keys at {path or '/'} differ from the state's")
        for k in state:
            load_into(state[k], tree[k], f"{path}/{k}")
        return
    src = tree if isinstance(tree, torch.Tensor) else torch.from_numpy(np.array(tree))
    if tuple(src.shape) != tuple(state.shape) or src.dtype != state.dtype:
        raise ValueError(f"{path}: checkpoint {tuple(src.shape)} {src.dtype} against state "
                         f"{tuple(state.shape)} {state.dtype}")
    with torch.no_grad():
        state.copy_(src)


def make_batch(cfg, gb: dict, batch: int, seq: int) -> dict:
    """The step's inputs from a ``data.global_batch``: tokens and labels,
    zero encoder frames (32 a row) for an encoder-decoder, and for a patch
    frontend the first ``min(n_frontend_tokens, seq // 2)`` positions
    marked -1 with zero embeddings, as the reference driver feeds them."""
    out = {"tokens": gb["tokens"], "labels": gb["labels"]}
    if cfg.family == "encdec":
        out["enc"] = np.zeros((batch, 32, cfg.d_model), np.float32)
    if cfg.frontend == "patch_stub":
        nf = min(cfg.n_frontend_tokens, seq // 2)
        tk = np.array(gb["tokens"], copy=True)
        tk[:, :nf] = -1  # frontend positions: embeddings come from `frontend`
        out["tokens"] = tk
        out["frontend"] = np.zeros((batch, seq, cfg.d_model), np.float32)
    return out


def main(argv=None, on_resume=None):
    """Run the driver; returns its log, ``{"start": first step, "steps":
    [{"step", "loss", "grad_norm", "lr"}, ...]}`` (every step, not only the
    printed ones).  ``on_resume(params, opt, step)``, if given, is called
    right after a checkpoint is restored."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--kill-at", type=int, default=0, help="simulate failure at step N")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)

    from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
    from repro_torch.data import DataConfig, Ledger, global_batch
    from repro_torch.launch.elastic import ElasticConfig, Membership

    cfg, mesh, ocfg, bundle, params, opt = build(
        args.arch, args.smoke, args.batch, args.seq, args.zero1,
        args.data, args.model, args.steps, args.device,
    )
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)
    ledger = Ledger()
    start = 0

    if args.resume and args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        tree, step = restore_checkpoint(args.ckpt_dir)
        load_into(params, tree["params"], "/params")
        load_into(opt, tree["opt"], "/opt")
        ledger.record(np.asarray(tree["meta"]["consumed"], np.uint32))
        start = step
        print(f"[train] resumed from step {step} "
              f"({len(ledger.consumed)} samples in ledger)", flush=True)
        if on_resume is not None:
            on_resume(params, opt, step)

    log = {"start": start, "steps": []}
    membership = Membership([0], ElasticConfig())
    t_last = time.time()
    for step in range(start, args.steps):
        if args.kill_at and step == args.kill_at:
            print(f"[train] simulated failure at step {step} (rerun with --resume)")
            raise SystemExit(17)
        gb = global_batch(step, dcfg)
        params, opt, m = bundle.step(params, opt, make_batch(cfg, gb, args.batch, args.seq))
        ledger.record(gb["ids"])
        log["steps"].append({"step": step, **{k: float(m[k]) for k in
                                             ("loss", "grad_norm", "lr")}})
        dt = time.time() - t_last
        t_last = time.time()
        membership.heartbeat(0, step_time=dt)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step {step:5d} loss={float(m['loss']):.4f} "
                  f"gnorm={float(m['grad_norm']):.3f} lr={float(m['lr']):.2e} "
                  f"dt={dt:.2f}s", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            tree = {"params": params, "opt": opt, "meta": {"consumed": ledger.as_array()}}
            man = save_checkpoint(Path(args.ckpt_dir), step + 1, tree)
            print(f"[train] checkpoint @{step + 1}: {len(man.shards)} shards", flush=True)
    print("[train] done", flush=True)
    return log


if __name__ == "__main__":
    main()
