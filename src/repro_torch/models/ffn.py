"""Dense FFN and MoE blocks.

Dense: the reference's tensor-parallel MLP — ``w_gate`` / ``w_up`` split by
columns and ``w_down`` by rows over 'model', inside the sequence-parallel
all-gather / reduce-scatter pair.

MoE: the reference (``repro.models.ffn``) shards experts over the combined
('data', 'model') axis and routes tokens with a capacity-bounded
``all_to_all``; every local expert then runs its three GEMMs over all
``world · cap`` slots and masks the result.  The router runs in float32
(softmax, top-k, renormalisation by ``max(sum, 1e-9)``) and the
switch-style aux loss is returned, equal to the reference's.

On one card the expert-parallel world is 1 and ``cap = ceil(1.25 · N · k)
+ 4 >= N · k``, so no slot is dropped, and the port gathers each expert's
routed rows instead: the N · k (token, slot) pairs are stable-sorted by
expert, the per-expert counts are read to the host once a call (one
sync), each expert with rows runs its three GEMMs on its own rows only,
the outputs go back through the inverse permutation into (N, k, d), and
the top-k weights combine them in the reference's order,
``(y · topw).sum(1)``.

Above one rank (``_moe_dispatch``) the reference's dispatch is kept pair
for pair: the aux loss's counts psummed over the world, ``cap = ceil(Nt ·
k / world · capacity_factor) + 4`` with Nt the local rows, each owned
(token, slot) pair's place in its destination by a running count in
(token, slot) order, pairs past ``cap`` dropped (they add zero), the
``(world, cap, d)`` send buffer and its expert ids out by one tiled
all-to-all each, the outputs home by the inverse one.  Two deliberate
differences:

* expert ``e`` runs on rank ``e // n_local`` as its local expert ``e %
  n_local``, where ``moe_spec``'s contiguous ('data', 'model') blocks put
  its weights.  The reference sends it to rank ``e % world`` and runs it
  there as local expert ``e // world``: whenever ``n_local > 1`` expert
  ``e`` computes with another expert's weights (a pad row, where the
  experts are padded), so a mesh computes another function than one rank
  (Queue C);
* on the receiving rank each local expert runs its three GEMMs on its own
  received rows only (sorted by local expert, the counts read to the host
  once a call, as on one card), not over all ``world · cap`` slots masked.

The mesh's ``dispatch`` ledger (``launch.mesh.LocalMesh``) counts the calls
above one rank, the owned pairs they routed and those dropped at capacity
(a layer recomputed under remat counts again).

The dry run (meta tensors, which hold no routes) on one card gives each
expert ``balanced_routes`` of the N · k pairs.  Above one rank, on a meta
mesh, the dispatch runs whole — its all-to-all buffers and ids have fixed
shapes, ``(world · cap, d)`` — and only its host counts are drawn
(``meta_dispatch_counts``): each sender routes ``balanced_routes`` of its
owned pairs over the real experts (never a pad expert) and a destination
keeps ``cap`` of them, so deepseek-v2-236b's 160 experts on a 256-rank
world overflow ``cap`` by about 1.28× at a balanced router and a fifth of
the pairs drop, as the reference's dispatch would drop them; the ledger
records them.  The meta branches never run on a computing device.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import (
    EP_AXES,
    MeshCtx,
    act_fn,
    ag_seq,
    all_to_all_ep,
    matmul,
    pad_to,
    psum_ep,
    psum_model,
    rs_seq,
)
from .spec import P


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
    """The reference's spec.  Where the experts are padded, their leaves
    are drawn at ``n_experts`` rows and zero-padded (``logical``), so the pad
    rows are zero and one seed gives one model on every mesh; the reference
    draws its pad rows at random."""
    d, ffm = cfg.d_model, cfg.moe_d_ff
    E, e_pad = cfg.n_experts, padded_experts(cfg, ctx)

    def expert(shape):
        return P((e_pad,) + shape, (EP_AXES, None, None),
                 logical=(E,) + shape if e_pad != E else None)

    spec = {
        "router": P((d, cfg.n_experts), (None, None), dtype=torch.float32),
        "we_gate": expert((d, ffm)),
        "we_up": expert((d, ffm)),
        "we_down": expert((ffm, d)),
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


def _moe_core(p, x, owned, cfg: ModelConfig, ctx: MeshCtx, ep_data_size: int,
              owned_by_model=None):
    """Route the owned tokens of x (N, d) through their experts; ``owned``
    (N,) bool marks the rows this rank owns (on one rank every row).
    Returns (y (N, d), valid where owned, aux loss).  Above one rank see
    ``_moe_dispatch``; ``owned_by_model`` (the owned rows of a rank at each
    'model' coordinate, host ints) is what its meta branch routes.

    On ``meta`` tensors (the dry run, ``repro_torch.launch.cells``), which
    hold no values to count, the experts take ``balanced_routes`` of the
    N · k pairs in place of the router's counts: a shape for the step's
    work to be counted on, never a result.  The reference's dry run charges
    its capacity-padded dispatch instead (every local expert over
    ``world · cap`` masked slots), so the two counts differ by design."""
    if ep_data_size * ctx.model_size != 1:
        return _moe_dispatch(p, x, owned, cfg, ctx, ep_data_size, owned_by_model)
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


def meta_dispatch_counts(owned_by_model, k: int, n_experts: int, n_local: int,
                         world: int, cap: int, rank: int) -> tuple:
    """The meta dispatch's host counts on expert-parallel rank ``rank``:
    (rows each local expert receives, the pairs this rank routes, those it
    drops at capacity).  Sender ``s`` owns ``owned_by_model[s % M]`` rows
    and routes ``balanced_routes`` of their pairs over the ``n_experts``
    real experts (never a pad expert); to each destination it sends at
    most ``cap`` of the pairs of that destination's experts, split over
    them as evenly as they go, as a running count keeps the first ``cap``
    of pairs that cycle through them."""
    M = len(owned_by_model)
    routes = [balanced_routes(n * k, n_experts) for n in owned_by_model]

    def to(dest, sender):                  # the sender's pairs for dest's experts
        return routes[sender % M][dest * n_local:(dest + 1) * n_local]

    sent = [sum(to(dest, rank)) for dest in range(world)]
    dropped = sum(max(0, n - cap) for n in sent)
    mine = [0] * n_local
    for s in range(world):
        experts = to(rank, s)
        for i, n in enumerate(balanced_routes(min(sum(experts), cap), len(experts))
                              if experts else []):
            mine[i] += n
    return mine, sum(sent), dropped


def _moe_dispatch(p, x, owned, cfg: ModelConfig, ctx: MeshCtx, ep_data_size: int,
                  owned_by_model=None):
    """``_moe_core`` above one rank: the reference's capacity-bounded
    dispatch over the ('data', 'model') world with the port's expert
    placement (module docstring).  x (Nt, d) this rank's rows, ``owned``
    (Nt,) bool: every logical token is owned by exactly one rank.

    On ``meta`` tensors (the dry run on a meta mesh) every collective and
    buffer is the real dispatch's — their shapes do not depend on routes —
    and only the host counts are drawn: ``meta_dispatch_counts`` over
    ``owned_by_model``.  The mesh's ``dispatch`` ledger records them."""
    world = ep_data_size * ctx.model_size
    if ep_data_size != ctx.data_size:
        raise ValueError(f"ep_data_size {ep_data_size} on a mesh of 'data' {ctx.data_size}: "
                         "the expert-parallel world is the whole mesh")
    meta = x.device.type == "meta"
    if meta and owned_by_model is None:
        raise ValueError("the MoE dispatch on meta tensors routes owned_by_model")
    Nt, d = x.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    n_local = p["we_gate"].shape[0]
    dev = x.device
    probs, topw, topi = _route(p, x, cfg)
    flat_e = topi.reshape(-1)
    ownf = owned.float()
    valid = owned.repeat_interleave(k)

    # the aux loss's owned counts, expert loads and mean probabilities, summed
    # over the world in one all-reduce (only the probabilities carry gradient)
    load = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(0, flat_e, valid.float())
    summed = psum_ep(torch.cat([ownf.sum()[None], load, (probs * ownf[:, None]).sum(0)]), ctx)
    n_owned = torch.clamp(summed[0], min=1.0)
    frac = summed[1:1 + E] / (n_owned * k)
    pbar = summed[1 + E:] / n_owned
    aux = E * torch.sum(frac * pbar)

    # each pair's slot in its destination: a running count in (token, slot) order
    cap = int(np.ceil(Nt * k / world * cfg.capacity_factor)) + 4
    dest = flat_e // n_local
    onehot = F.one_hot(dest, world) * valid[:, None]
    pos = ((onehot.cumsum(0) - 1) * onehot).sum(-1)
    keep = valid & (pos < cap)
    slot = torch.where(keep, dest * cap + pos, world * cap)     # world · cap: a dump row
    tok = torch.arange(Nt * k, device=dev) // k
    send = x.new_zeros(world * cap + 1, d).index_add(0, slot, x[tok])[:-1]
    ids = torch.full((world * cap + 1,), -1, dtype=torch.int32, device=dev).scatter(
        0, slot, flat_e.to(torch.int32))[:-1]

    recv = all_to_all_ep(send, ctx)                              # (world · cap, d)
    recv_e = ctx.comm().all_to_all(ids, EP_AXES)
    rk = ctx.comm().index("data") * ctx.model_size + ctx.midx()
    lidx = torch.where(recv_e >= 0, recv_e.long() - rk * n_local, n_local)
    order = torch.argsort(lidx, stable=True)
    if meta:
        counts, n_pairs, n_dropped = meta_dispatch_counts(owned_by_model, k, E, n_local,
                                                          world, cap, rk)
    else:
        counts = torch.bincount(lidx, minlength=n_local + 1)
        tally = torch.stack([valid.sum(), (valid & ~keep).sum()])
        *counts, _, n_pairs, n_dropped = torch.cat([counts, tally]).tolist()  # one host sync
    led = ctx.comm().dispatch
    for key, n in (("calls", 1), ("pairs", n_pairs), ("dropped", n_dropped)):
        led[key] = led.get(key, 0) + n

    # each local expert's three GEMMs on its own received rows.  ``rows[:0]``
    # keeps the received rows in the autograd graph where no expert of this
    # rank got a row: every rank must record (and so run backward) the same
    # collectives, in the same order
    n_valid = sum(counts)
    rows = recv[order[:n_valid]]
    parts, start = [rows[:0]], 0
    for e, n in enumerate(counts):
        if n:
            xe = rows[start:start + n]
            h = act_fn(cfg, matmul(xe, p["we_gate"][e]), matmul(xe, p["we_up"][e]))
            parts.append(matmul(h, p["we_down"][e]).to(rows.dtype))
        start += n
    out = recv.new_zeros(world * cap, d).index_copy(0, order[:n_valid], torch.cat(parts))

    back = all_to_all_ep(out, ctx)
    y_flat = torch.cat([back, back.new_zeros(1, d)])[slot]      # dropped pairs: zero
    y = (y_flat.reshape(Nt, k, d) * topw[..., None].to(x.dtype)).sum(1)
    return y, aux


def moe_apply(p, x_sp, ctx: MeshCtx, cfg: ModelConfig, ep_data_size: int):
    """Train / prefill: x_sp (B, T/M, d), this rank's sequence chunk (every
    row owned) -> (y (B, T/M, d), aux loss).  The shared experts run on the
    dense tensor-parallel path."""
    B, Ts, d = x_sp.shape
    owned = torch.ones(B * Ts, dtype=torch.bool, device=x_sp.device)
    y, aux = _moe_core(p, x_sp.reshape(B * Ts, d), owned, cfg, ctx, ep_data_size,
                       [B * Ts] * ctx.model_size)
    y = y.reshape(B, Ts, d)
    if cfg.n_shared_experts:
        xg = ag_seq(x_sp, ctx)
        hs = act_fn(cfg, matmul(xg, p["ws_gate"]), matmul(xg, p["ws_up"]))
        y = y + rs_seq(matmul(hs, p["ws_down"]), ctx)
    return y, aux


def moe_decode(p, x, ctx: MeshCtx, cfg: ModelConfig, ep_data_size: int):
    """Decode: x (B, 1, d), replicated over 'model' -> (y (B, 1, d), aux
    loss).  Batch row ``b`` is owned by 'model' rank ``b % M``; each rank's
    ``y`` is zero off its rows and psummed over 'model', as are the shared
    experts' partial products."""
    B, _, d = x.shape
    M = ctx.model_size
    owned = torch.arange(B, device=x.device) % M == ctx.midx()
    y, aux = _moe_core(p, x.reshape(B, d), owned, cfg, ctx, ep_data_size,
                       [len(range(m, B, M)) for m in range(M)])
    if M > 1:
        y = psum_model(torch.where(owned[:, None], y, 0.0), ctx)
    y = y.reshape(B, 1, d)
    if cfg.n_shared_experts:
        hs = act_fn(cfg, matmul(x, p["ws_gate"]), matmul(x, p["ws_up"]))
        y = y + psum_model(matmul(hs, p["ws_down"]), ctx)
    return y, aux
