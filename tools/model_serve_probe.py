"""Phase ``model_serve`` of ``chip_smoke.py`` alone, on one CUDA card, then
the calibration behind its token check.

    python3 tools/model_serve_probe.py [--runs N] [--seed S] [--out PATH]

Runs ``chip_smoke.model_serve_phase`` ``--runs`` times in one process (the
spread of its decode and prefill times), then serves the 8 x 128 bucket of
that phase's traffic through ``make_serve_fns`` and holds the logits of
every decode step against the no-cache ``forward``'s at the same position:
the largest and mean logit error, how often the argmax agrees, and the
forward's top-2 margins, which ``chip_smoke.MARGIN_TOL`` is read against.
Prints one JSON line per run and one ``calibration`` line.
"""
import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
import repro_torch.serve.engine as engine  # noqa: E402

THRESHOLDS = (0.0, 0.015625, 0.03125, 0.0625, 0.125, 0.25)


def calibration(seed: int) -> dict:
    cfg = cs.get_config(cs.MODEL_ARCH)
    mesh = cs.make_local_mesh()
    ctx = cs.mesh_ctx(mesh)
    params = cs.init_params(cs.model_spec(cfg, ctx),
                            torch.Generator(device=mesh.device).manual_seed(seed), mesh.device)
    plen, rows = cs.SERVE_BUCKETS[0]
    rng = np.random.default_rng(seed)
    prompts = torch.tensor(rng.integers(0, cfg.vocab, (rows, plen)), dtype=torch.int32,
                           device=mesh.device)
    recorded, greedy = [], engine.greedy_token

    def recording_greedy(p, x, ctx_, cfg_):     # the step's logits, then its token
        recorded.append(cs.vocab_logits(p, x[:, 0], ctx_, cfg_))
        return greedy(p, x, ctx_, cfg_)

    engine.greedy_token = recording_greedy
    try:
        sv = cs.make_serve_fns(cfg, mesh, batch=rows, max_len=cs.SERVE_MAX_LEN)
        caches, tok = sv.prefill(params, {"tokens": prompts})
        gen = [tok]
        for _ in range(cs.SERVE_MAX_NEW - 1):
            tok, caches = sv.decode(params, caches, tok[:, None])
            gen.append(tok)
    finally:
        engine.greedy_token = greedy
    del caches
    gen = torch.stack(gen, 1)                                   # (rows, max_new)
    served = torch.stack(recorded, 1)                           # (rows, max_new, V)
    seq = torch.cat([prompts, gen[:, :-1]], 1)
    ref = cs.vocab_logits(params["embed"], cs.forward(params, seq, ctx, cfg)[:, plen - 1:],
                          ctx, cfg)
    err = (served - ref).abs()
    top2 = ref.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).flatten().cpu()
    return {
        "config": f"{cs.MODEL_ARCH} full width, bfloat16, {rows} x {plen} prompts, "
                  f"{cs.SERVE_MAX_NEW} tokens each",
        "positions": int(margin.numel()),
        "max_abs_logit_err": float(err.max()),
        "mean_abs_logit_err": float(err.mean()),
        "p999_err": float(err.flatten().topk(err.numel() // 1000 + 1).values[-1]),
        "top_logit_err_max": float((served.max(-1).values - top2[..., 0]).abs().max()),
        "argmax_equal": float((served.argmax(-1) == ref.argmax(-1)).float().mean()),
        "margin_quantiles": [float(q) for q in
                             torch.quantile(margin, torch.tensor([0.1, 0.25, 0.5, 0.75]))],
        "frac_margin_gt": {str(t): float((margin > t).float().mean()) for t in THRESHOLDS},
        "margin_tol": cs.MARGIN_TOL,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", metavar="PATH", default=None,
                    help="also write every JSON line to PATH")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("model_serve_probe needs a CUDA card")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        cs._OUT.append(open(args.out, "w"))
    smi = cs.sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    for run in range(args.runs):
        t0 = time.perf_counter()
        cs.emit({"probe_run": run})
        cs.model_serve_phase(args, smi)
        cs.emit({"probe_run": run, "seconds": time.perf_counter() - t0})
    cs.emit({"phase": "model_serve", "step": "calibration", "gpu": smi, **calibration(args.seed)})


if __name__ == "__main__":
    main()
