"""Dense FFN on one card (the reference's tensor-parallel MLP with a model
axis of 1).  The MoE block comes with a later slice (ROADMAP Queue A)."""
from __future__ import annotations

from .config import ModelConfig
from .layers import MeshCtx, act_fn, ag_seq, matmul, rs_seq
from .spec import P


def mlp_spec(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    return {
        "w_gate": P((d, ff), (None, "model")),
        "w_up": P((d, ff), (None, "model")),
        "w_down": P((ff, d), ("model", None)),
    }


def mlp_apply(p, x_sp, ctx: MeshCtx, cfg: ModelConfig):
    xg = ag_seq(x_sp, ctx)
    h = act_fn(cfg, matmul(xg, p["w_gate"]), matmul(xg, p["w_up"]))
    return rs_seq(matmul(h, p["w_down"]), ctx)


def mlp_decode(p, x, ctx: MeshCtx, cfg: ModelConfig):
    """Decode-mode FFN: x (B, 1, d)."""
    return matmul(act_fn(cfg, matmul(x, p["w_gate"]), matmul(x, p["w_up"])), p["w_down"])
