"""Training driver: data pipeline -> train step -> atomic checkpoints ->
(simulated) failure and resume, on one rank or a (data, model) mesh.

The port of ``repro.launch.train``: the same loop, flags, log lines and
checkpoint tree (``params``, ``opt``, ``meta.consumed``), so a checkpoint
of either package resumes the other.  ``--kill-at N`` exits with code 17
at step N; ``--resume`` restores the latest checkpoint (parameters,
optimizer state, data ledger) into the freshly built state, in place.
``--device`` picks the device: none means the CUDA card (raises without
one), ``cpu`` runs the plain PyTorch path.

``--data D --model M`` above one rank starts ``D · M`` ranks
(``launch.ranks.run_ranks``; ``--backend`` as its rule: NCCL where every
rank has a card, gloo on the CPU or by name for ranks sharing a card);
every rank runs the loop on its shards and rank 0 prints.  Checkpoints
are gathered to rank 0 and written in the one-rank layout
(``train.layout``), so a run on a 2 x 2 mesh resumes on one rank and the
other way round; a resuming rank reads the checkpoint and keeps its part.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --smoke \\
      --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt [--resume] [--device cpu] \\
      [--data 2 --model 2 [--backend gloo]]
"""
from __future__ import annotations

import argparse
import tempfile
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


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="process-group backend above one rank (default: nccl where "
                         "every rank has a card, gloo on the CPU)")
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--kill-at", type=int, default=0, help="simulate failure at step N")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain path)")
    return ap.parse_args(argv)


def main(argv=None, on_resume=None):
    """Run the driver; returns its log, ``{"start": first step, "steps":
    [{"step", "loss", "grad_norm", "lr"}, ...]}`` (every step, not only the
    printed ones; rank 0's above one rank).  ``on_resume(params, opt,
    step)``, if given, is called right after a checkpoint is restored (one
    rank only: it is not sent to other processes)."""
    args = parse(argv)
    world = args.data * args.model
    if world == 1:
        return run(args, args.device, on_resume)
    if on_resume is not None:
        raise ValueError("on_resume runs on one rank only")
    from repro_torch.launch.ranks import run_ranks

    with tempfile.TemporaryDirectory(prefix="train_ranks_") as rdv:
        device = args.device or "cuda"
        # ranks on the CPU take a core each; on the card torch's own default
        logs = run_ranks(_rank_main, world, rdv, device=device, backend=args.backend,
                         args=(args,), timeout=RANKS_TIMEOUT_S,
                         threads=1 if torch.device(device).type == "cpu" else None)
    return logs[0]


# how long a run of several ranks may take before its ranks are killed
RANKS_TIMEOUT_S = 7 * 24 * 3600


def _rank_main(device, args):
    return run(args, device, None)


def run(args, device, on_resume):
    """The training loop on this rank (one rank, or one of a mesh's)."""
    from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
    from repro_torch.data import DataConfig, Ledger, global_batch
    from repro_torch.launch.elastic import ElasticConfig, Membership
    from repro_torch.models.spec import gather_params, shard_params
    from repro_torch.train.layout import from_one_rank, to_one_rank

    cfg, mesh, ocfg, bundle, params, opt = build(
        args.arch, args.smoke, args.batch, args.seq, args.zero1,
        args.data, args.model, args.steps, device,
    )
    sizes = dict(mesh.shape)
    lead = mesh.rank == 0
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)
    ledger = Ledger()
    start = 0

    if args.resume and args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        tree, step = restore_checkpoint(args.ckpt_dir)
        p_tree, o_tree = tree["params"], tree["opt"]
        if mesh.world > 1:
            p_tree, o_tree = from_one_rank(p_tree, o_tree, cfg, ocfg, sizes)
            p_tree = shard_params(p_tree, bundle.param_spec, mesh)
            o_tree = shard_params(o_tree, bundle.opt_spec, mesh)
        load_into(params, p_tree, "/params")
        load_into(opt, o_tree, "/opt")
        ledger.record(np.asarray(tree["meta"]["consumed"], np.uint32))
        start = step
        if lead:
            print(f"[train] resumed from step {step} "
                  f"({len(ledger.consumed)} samples in ledger)", flush=True)
        if on_resume is not None:
            on_resume(params, opt, step)

    log = {"start": start, "steps": []}
    membership = Membership([0], ElasticConfig())
    t_last = time.time()
    for step in range(start, args.steps):
        if args.kill_at and step == args.kill_at:
            if lead:
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
        if lead and (step % args.log_every == 0 or step == args.steps - 1):
            print(f"[train] step {step:5d} loss={float(m['loss']):.4f} "
                  f"gnorm={float(m['grad_norm']):.3f} lr={float(m['lr']):.2e} "
                  f"dt={dt:.2f}s", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            p_out, o_out = params, opt
            if mesh.world > 1:          # gathered to rank 0, in the one-rank layout
                p_out = gather_params(params, bundle.param_spec, mesh)
                o_out = gather_params(opt, bundle.opt_spec, mesh)
                if lead:
                    p_out, o_out = to_one_rank(p_out, o_out, cfg, ocfg, sizes)
            if lead:
                tree = {"params": p_out, "opt": o_out, "meta": {"consumed": ledger.as_array()}}
                man = save_checkpoint(Path(args.ckpt_dir), step + 1, tree)
                print(f"[train] checkpoint @{step + 1}: {len(man.shards)} shards", flush=True)
    if lead:
        print("[train] done", flush=True)
    return log


if __name__ == "__main__":
    main()
