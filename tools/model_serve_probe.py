"""Rows of phase ``model_serve`` of ``chip_smoke.py`` alone, on one CUDA
card, then the calibration behind each row's token check.

    python3 tools/model_serve_probe.py [--arch NAME ...] [--runs N] [--seed S] [--out PATH]

For each ``--arch`` (a row of ``chip_smoke.MODEL_ROWS``; default
qwen2-1.5b) first serves each prompt-length bucket of that row's traffic
through ``make_serve_fns`` at full width (at the row's depth; with the
bucket's frames or patches, ``chip_smoke.bucket_extras``) and holds
the logits of every decode step against the no-cache ``forward``'s at the
same position: the largest and mean logit error, how often the argmax
agrees, and the forward's top-2 margins, which the row's ``margin_tol`` is
read against (in bfloat16, and for a row checked on a float32 model of
``check_float32_layers`` layers also that model, drawn after the bfloat16
one is freed; at the row's own depth, how far a bfloat16 forward lies from
the float32 one of the same weights).  For an MoE model it also reads, per
MoE layer, how often a decode step's top-k expert set differs from the
forward's at the same position (the router wrapped as the greedy token
is): the decode-to-forward error where no layer's set differs, the
forward's gap between its k-th and (k+1)-th router probability in the
first layer whose set differs (which ``chip_smoke.ROUTE_GAP_TOL`` is
read against), and the share of positions checked at each gap tolerance.
Then it runs ``chip_smoke.model_serve_row`` ``--runs`` times in one
process (the spread of its decode and prefill times).  Prints one
``calibration`` line per row, then one JSON line per run.
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
GAP_THRESHOLDS = (1e-6, 3e-6, 1e-5, 3e-5, 1e-4, 3e-4, 1e-3)
ROWS = {row.arch: row for row in cs.MODEL_ROWS}


def calibrate_bucket(params, cfg, mesh, ctx, row, plen: int, n: int, rng, gen) -> dict:
    prompts = torch.tensor([cs.prompt_tokens(rng, cfg, plen) for _ in range(n)],
                           dtype=torch.int32, device=mesh.device)
    extras = cs.bucket_extras(cfg, plen, n, row.enc_len, lambda shape: torch.randn(
        shape, generator=gen, device=mesh.device)) or {}
    recorded, greedy = [], engine.greedy_token

    def recording_greedy(p, x, ctx_, cfg_):     # the step's logits, then its token
        recorded.append(cs.vocab_logits(p, x[:, 0], ctx_, cfg_))
        return greedy(p, x, ctx_, cfg_)

    engine.greedy_token = recording_greedy
    try:
        with cs.recorded_routes() as served_routes:
            sv = cs.make_serve_fns(cfg, mesh, batch=n, max_len=row.max_len, enc_len=row.enc_len)
            caches, tok = sv.prefill(params, {"tokens": prompts, **extras})
            gen = [tok]
            for _ in range(cs.SERVE_MAX_NEW - 1):
                tok, caches = sv.decode(params, caches, tok[:, None])
                gen.append(tok)
    finally:
        engine.greedy_token = greedy
    del caches
    gen = torch.stack(gen, 1)                                   # (n, max_new)
    served = torch.stack(recorded, 1)                           # (n, max_new, V)
    seq = torch.cat([prompts, gen[:, :-1]], 1)
    with cs.recorded_routes() as forward_routes:
        x = cs.forward(params, seq, ctx, cfg,
                       **cs.forward_inputs(extras, n, seq.shape[1], n, mesh.device))
    ref = cs.vocab_logits(params["embed"], x[:, plen - 1:], ctx, cfg)
    err = (served - ref).abs()
    top2 = ref.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]                           # (n, max_new)
    margin = gap.flatten().cpu()
    same = served.argmax(-1) == ref.argmax(-1)
    routes = {}
    if forward_routes:
        n_moe = len(forward_routes)
        steps = cs.SERVE_MAX_NEW - 1
        sets, gaps = cs.forward_routes(forward_routes, n, plen - 1, steps + 1)
        differs, first_gap = cs.route_flips(sets, gaps,
                                            cs.chunk_routes(served_routes, n_moe, steps))
        kept = ~differs.any(-1)                                 # (n, max_new): no layer flipped
        flip_gap = first_gap[~kept].cpu()
        gap_q = torch.tensor([0.01, 0.05, 0.1, 0.5])
        routes = {"route_set_differs_by_moe_layer": [
                      float(v) for v in differs.float().mean((0, 1))],
                  "first_flip_gap": {
                      "flips": int(flip_gap.numel()),
                      "max": float(flip_gap.max()) if flip_gap.numel() else None,
                      "sorted_top": [float(v) for v in flip_gap.sort(descending=True).values[:8]]},
                  "forward_gap_quantiles": [float(v) for v in
                                            torch.quantile(gaps.flatten().cpu(), gap_q)],
                  "at_gap_tol": {str(t): {
                      "checked_share": float(((gap > row.margin_tol)
                                              & ~(first_gap <= t)).float().mean()),
                      "checked_argmax_differs": int(((gap > row.margin_tol)
                                                     & ~(first_gap <= t) & ~same).sum()),
                      "flips_past_tol": int((~kept & (first_gap > t)).sum())}
                      for t in GAP_THRESHOLDS},
                  "no_route_flip": {
                      "share": float(kept.float().mean()),
                      "max_abs_logit_err": float(err.amax(-1)[kept].max()),
                      "argmax_equal": float(same[kept].float().mean()),
                      "frac_margin_gt": {str(t): float(((gap > t) & kept).float().mean())
                                         for t in THRESHOLDS},
                      "argmax_differs_at_margin_gt": {
                          str(t): int(((gap > t) & kept & ~same).sum()) for t in THRESHOLDS}}}
    return {
        "prompts": f"{n} x {plen}, {cs.SERVE_MAX_NEW} tokens each",
        "positions": int(margin.numel()),
        "max_abs_logit_err": float(err.max()),
        "mean_abs_logit_err": float(err.mean()),
        "p999_err": float(err.flatten().topk(err.numel() // 1000 + 1).values[-1]),
        "top_logit_err_max": float((served.max(-1).values - top2[..., 0]).abs().max()),
        "top_logit_max": float(top2[..., 0].max()),
        "argmax_equal": float(same.float().mean()),
        "margin_quantiles": [float(q) for q in
                             torch.quantile(margin, torch.tensor([0.1, 0.25, 0.5, 0.75]))],
        "frac_margin_gt": {str(t): float((margin > t).float().mean()) for t in THRESHOLDS},
        **routes,
    }


def bfloat16_drift(embed16, xb, params32, cfg, ctx, prompts, kw) -> dict:
    """How far a bfloat16 forward (final-norm states ``xb``, unembedded
    through ``embed16``) lies from a float32 forward of the same weights
    ``params32`` (and the same ``forward`` keywords ``kw``): the states'
    relative norm and the largest logit difference, one sequence at a time."""
    xf = cs.forward(params32, prompts, ctx, cfg, **kw)
    diff, same, n = 0.0, 0, 0
    for b in range(xb.shape[0]):
        lb = cs.vocab_logits(embed16, xb[b], ctx, cfg)
        lf = cs.vocab_logits(params32["embed"], xf[b], ctx, cfg)
        diff = max(diff, float((lb - lf).abs().max()))
        same += int((lb.argmax(-1) == lf.argmax(-1)).sum())
        n += lb.shape[0]
    return {"state_rel_norm": float((xb.float() - xf).norm() / xf.norm()),
            "max_abs_logit_diff": diff, "argmax_equal": same / n}


def calibration(row, seed: int) -> dict:
    """Decode-to-forward logit error of ``row``'s model at full width, one
    batch of fresh prompts a bucket (its real request count), in bfloat16
    and, for a row checked in float32, in the float32 model of
    ``row.check_float32_layers`` layers (at the row's own depth the same
    weights, upcast in place once the bfloat16 forwards are read)."""
    cfg = cs.row_config(row)
    mesh = cs.make_local_mesh()
    ctx = cs.mesh_ctx(mesh)
    params = cs.init_params(cs.model_spec(cfg, ctx),
                            torch.Generator(device=mesh.device).manual_seed(seed), mesh.device)
    out = {"arch": row.arch, "config": f"{row.arch} full width, {cfg.n_layers} layers",
           "margin_tol": row.margin_tol, "route_gap_tol": cs.ROUTE_GAP_TOL,
           "checked_in": "float32" if row.check_float32_layers else "bfloat16"}
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=mesh.device).manual_seed(seed + 1)
    out["bfloat16"] = {plen: calibrate_bucket(params, cfg, mesh, ctx, row, plen, n, rng, gen)
                       for plen, n in row.buckets}
    if row.check_float32_layers == cfg.n_layers:        # the same weights in float32
        rng = np.random.default_rng(seed + 1)
        cases = []
        for plen, n in row.buckets:
            extras = cs.bucket_extras(cfg, plen, n, row.enc_len, lambda shape: torch.randn(
                shape, generator=gen, device=mesh.device))
            prompts = torch.tensor([cs.prompt_tokens(rng, cfg, plen) for _ in range(n)],
                                   dtype=torch.int32, device=mesh.device)
            kw = cs.forward_inputs(extras, n, plen, n, mesh.device)
            cases.append((plen, prompts, kw, cs.forward(params, prompts, ctx, cfg, **kw)))
        embed16 = dict(params["embed"])
        cs.upcast_(params)
        out["bfloat16_forward_vs_float32"] = {
            plen: bfloat16_drift(embed16, xb, params, cfg, ctx, prompts, kw)
            for plen, prompts, kw, xb in cases}
        del cases, embed16
    elif row.check_float32_layers:
        del params
        torch.cuda.empty_cache()
        cfg = cs.row_config(row, row.check_float32_layers)
        params = cs.init_params(cs.model_spec(cfg, ctx),
                                torch.Generator(device=mesh.device).manual_seed(seed),
                                mesh.device)
        cs.upcast_(params)
    if row.check_float32_layers:
        rng = np.random.default_rng(seed)
        gen = torch.Generator(device=mesh.device).manual_seed(seed + 1)
        out[f"float32_{cfg.n_layers}_layers"] = {
            plen: calibrate_bucket(params, cfg, mesh, ctx, row, plen, n, rng, gen)
            for plen, n in row.buckets}
    del params
    torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", nargs="+", default=["qwen2-1.5b"], choices=sorted(ROWS),
                    help="rows of chip_smoke.MODEL_ROWS to run, in turn")
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
    for arch in args.arch:
        row = ROWS[arch]
        t0 = time.perf_counter()
        cs.emit({"phase": "model_serve", "step": "calibration", "gpu": smi,
                 **calibration(row, args.seed),
                 "seconds": time.perf_counter() - t0})
        for run in range(args.runs):
            t0 = time.perf_counter()
            cs.emit({"probe_run": run, "arch": arch})
            cs.model_serve_row(args, smi, row)
            cs.emit({"probe_run": run, "arch": arch, "seconds": time.perf_counter() - t0})


if __name__ == "__main__":
    main()
