"""Dense FFN and MoE blocks.

Dense: the reference's tensor-parallel MLP — ``w_gate`` / ``w_up`` split by
columns and ``w_down`` by rows over 'model', inside the sequence-parallel
all-gather / reduce-scatter pair.

MoE: the reference (``repro.models.ffn``) shards experts over the combined
('data', 'model') axis and routes tokens with a capacity-bounded
``all_to_all``; every local expert then runs its three GEMMs over all
``world · cap`` slots and masks the result.  On one card the expert-parallel
world is 1 and ``cap = ceil(1.25 · N · k) + 4 >= N · k``, so no slot is
dropped, and the port gathers each expert's routed rows instead: the N · k
(token, slot) pairs are stable-sorted by expert, the per-expert counts are
read to the host once a call (one sync), each expert with rows runs its
three GEMMs on its own rows only, the outputs go back through the inverse
permutation into (N, k, d), and the top-k weights combine them in the
reference's order, ``(y · topw).sum(1)``.  The router runs in float32
(softmax, top-k, renormalisation by ``max(sum, 1e-9)``) and the switch-style
aux loss is returned, equal to the reference's.
"""
from __future__ import annotations

import torch

from .config import ModelConfig
from .layers import MeshCtx, act_fn, ag_seq, matmul, pad_to, psum_model, rs_seq
from .spec import P

EP_AXES = ("data", "model")  # the reference's expert-parallel world


# --------------------------------------------------------------------------
# dense FFN
# --------------------------------------------------------------------------


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
    """Decode-mode FFN: x (B, 1, d) replicated over 'model'; this rank's
    columns of ``w_gate`` / ``w_up`` and rows of ``w_down``, the partial
    products psummed over 'model'."""
    h = matmul(act_fn(cfg, matmul(x, p["w_gate"]), matmul(x, p["w_up"])), p["w_down"])
    return psum_model(h, ctx)


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------


def ep_world(ctx: MeshCtx) -> int:
    return ctx.data_size * ctx.model_size


def padded_experts(cfg: ModelConfig, ctx: MeshCtx) -> int:
    """Experts padded to a multiple of the expert-parallel world (none on
    one card).  Pad experts own no tokens: the router never scores them."""
    return pad_to(cfg.n_experts, ep_world(ctx))


def moe_spec(cfg: ModelConfig, ctx: MeshCtx) -> dict:
    d, ffm = cfg.d_model, cfg.moe_d_ff
    e_pad = padded_experts(cfg, ctx)
    spec = {
        "router": P((d, cfg.n_experts), (None, None), dtype=torch.float32),
        "we_gate": P((e_pad, d, ffm), (EP_AXES, None, None)),
        "we_up": P((e_pad, d, ffm), (EP_AXES, None, None)),
        "we_down": P((e_pad, ffm, d), (EP_AXES, None, None)),
    }
    if cfg.n_shared_experts:
        spec.update({
            "ws_gate": P((d, cfg.n_shared_experts * ffm), (None, "model")),
            "ws_up": P((d, cfg.n_shared_experts * ffm), (None, "model")),
            "ws_down": P((cfg.n_shared_experts * ffm, d), ("model", None)),
        })
    return spec


def _route(p, x, cfg: ModelConfig):
    """float32 router: x (N, d) -> (probs (N, E), topw (N, k), topi (N, k))."""
    probs = torch.softmax(matmul(x.float(), p["router"]), dim=-1)
    topw, topi = torch.topk(probs, cfg.moe_top_k, dim=-1)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    return probs, topw, topi


def balanced_routes(rows: int, n_experts: int) -> list:
    """``rows`` routed (token, slot) pairs split as evenly as they go over
    ``n_experts``: ``rows // n_experts`` each, one more for the first
    ``rows % n_experts``."""
    q, r = divmod(rows, n_experts)
    return [q + (e < r) for e in range(n_experts)]


def _moe_core(p, x, cfg: ModelConfig, ctx: MeshCtx, ep_data_size: int):
    """Route every token of x (N, d) through its experts (on one card each
    token is this rank's: the reference's ``owned`` mask is all true).
    Returns (y (N, d), aux loss).

    On ``meta`` tensors (the dry run, ``repro_torch.launch.cells``), which
    hold no values to count, the experts take ``balanced_routes`` of the
    N · k pairs in place of the router's counts: a shape for the step's
    work to be counted on, never a result.  The reference's dry run charges
    its capacity-padded dispatch instead (every local expert over
    ``world · cap`` masked slots), so the two counts differ by design."""
    if ep_data_size * ctx.model_size != 1:
        raise NotImplementedError("expert parallelism above one rank: ROADMAP Queue A item "
                                  "15 sub-item 6c (the all_to_all over ('data', 'model'))")
    N, d = x.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    probs, topw, topi = _route(p, x, cfg)
    flat_e = topi.reshape(-1)
    if x.device.type == "meta":
        counts = balanced_routes(N * k, E)
        per_expert = torch.tensor(counts, device=x.device)
    else:
        per_expert = torch.bincount(flat_e, minlength=E)
        counts = None
    aux = E * torch.sum(per_expert.float() / (N * k) * probs.mean(0))

    # each expert's three GEMMs on its own rows: pairs sorted by expert
    order = torch.argsort(flat_e, stable=True)
    rows = x[order // k]                                    # (N·k, d)
    out = torch.empty_like(rows)
    start = 0
    for e, n in enumerate(counts or per_expert.tolist()):    # the one host sync
        if n:
            xe = rows[start:start + n]
            h = act_fn(cfg, matmul(xe, p["we_gate"][e]), matmul(xe, p["we_up"][e]))
            out[start:start + n] = matmul(h, p["we_down"][e])
        start += n
    y_flat = torch.empty_like(out).index_copy_(0, order, out)   # inverse permutation
    y = (y_flat.reshape(N, k, d) * topw[..., None].to(x.dtype)).sum(1)
    return y, aux


def moe_apply(p, x_sp, ctx: MeshCtx, cfg: ModelConfig, ep_data_size: int):
    """Train / prefill: x_sp (B, T, d) -> (y (B, T, d), aux loss)."""
    B, Ts, d = x_sp.shape
    y, aux = _moe_core(p, x_sp.reshape(B * Ts, d), cfg, ctx, ep_data_size)
    y = y.reshape(B, Ts, d)
    if cfg.n_shared_experts:
        xg = ag_seq(x_sp, ctx)
        hs = act_fn(cfg, matmul(xg, p["ws_gate"]), matmul(xg, p["ws_up"]))
        y = y + rs_seq(matmul(hs, p["ws_down"]), ctx)
    return y, aux


def moe_decode(p, x, ctx: MeshCtx, cfg: ModelConfig, ep_data_size: int):
    """Decode: x (B, 1, d) -> (y (B, 1, d), aux loss)."""
    B, _, d = x.shape
    y, aux = _moe_core(p, x.reshape(B, d), cfg, ctx, ep_data_size)
    y = y.reshape(B, 1, d)
    if cfg.n_shared_experts:
        hs = act_fn(cfg, matmul(x, p["ws_gate"]), matmul(x, p["ws_up"]))
        y = y + matmul(hs, p["ws_down"])
    return y, aux
