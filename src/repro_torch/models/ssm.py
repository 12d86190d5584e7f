"""Mamba-2 / SSD block (state-space duality, arXiv:2405.21060).

As in the reference (``repro.models.ssm``) heads (``d_inner / headdim``)
are sharded over 'model', the B/C projections (``ssm_ngroups`` groups)
replicated: ``ssm_apply`` all-gathers the sequence in and reduce-scatters
its output, the gated RMSNorm psums its sum of squares over the whole
``d_inner``, and the one-token ``ssm_decode`` (its input replicated over
'model') psums its output; its cache holds this rank's heads and
``d_inner`` columns.  On one rank every head is local and the collectives
are identities.

One deliberate difference: each local head reads the B/C group of its
*global* head, ``(midx · H/M + h) // (H / G)`` (``_head_groups``).  The
reference takes the map from the local head count, local head ``h`` reading
group ``h // (H / M / G)``, so above one rank with ``ssm_ngroups > 1`` it
computes another function than on one device (mamba2-780m has one group,
where the maps agree).

Prefill uses the chunked SSD algorithm: a quadratic attention-like term
within each chunk plus a recurrence over chunk-boundary states (a Python
loop over chunks where the reference runs ``lax.scan``).  Decode is the
O(1) recurrent step, which updates the ``ssd`` state of the cache it is
given in place.  Each einsum keeps the reference's operand dtypes and
casts, so bfloat16 activations meet float32 decays where they do there.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import MeshCtx, ag_seq, einsum, matmul, psum_model, rs_seq
from .spec import P


def _dims(cfg: ModelConfig, ctx: MeshCtx):
    d_inner = cfg.d_model * cfg.ssm_expand
    H = d_inner // cfg.ssm_headdim
    return d_inner, H, cfg.ssm_headdim, cfg.ssm_ngroups, cfg.ssm_state


def ssm_spec(cfg: ModelConfig, ctx: MeshCtx) -> dict:
    d = cfg.d_model
    d_inner, H, hp, G, N = _dims(cfg, ctx)
    return {
        "wz": P((d, d_inner), (None, "model")),
        "wx": P((d, d_inner), (None, "model")),
        "wbc": P((d, 2 * G * N), (None, None)),
        "wdt": P((d, H), (None, "model")),
        "dt_bias": P((H,), ("model",), "zeros"),
        "a_log": P((H,), ("model",), "ones"),
        "dskip": P((H,), ("model",), "ones"),
        "conv_x": P((cfg.ssm_conv, d_inner), (None, "model")),
        "conv_bc": P((cfg.ssm_conv, 2 * G * N), (None, None)),
        "gate_norm": P((d_inner,), ("model",), "ones"),
        "wout": P((d_inner, d), ("model", None)),
    }


def _causal_conv(x, w):
    """Depthwise causal conv: x (B, T, C), w (K, C)."""
    K = w.shape[0]
    T = x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i:i + T] * w[i] for i in range(K))
    return F.silu(out)


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)`` at every x
    (``F.softplus`` returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


@functools.lru_cache(maxsize=None)
def _groups_of(start: int, Hl: int, per: int, device: torch.device) -> torch.Tensor:
    # one upload per (rank, shape, device), not one per layer and step; read-only
    return torch.div(torch.arange(start, start + Hl), per, rounding_mode="floor").to(device)


def _head_groups(cfg: ModelConfig, ctx: MeshCtx, Hl: int, device) -> torch.Tensor:
    """The B/C group of each of this rank's ``Hl`` heads: that of its
    global head."""
    _, H, _, G, _ = _dims(cfg, ctx)
    return _groups_of(ctx.midx() * Hl, Hl, max(1, H // G), torch.device(device))


def _ssd_chunked(xh, dt, A, B, C, cfg: ModelConfig, init_state=None, groups=None):
    """Chunked SSD: xh (B, T, H, P), dt (B, T, H), B/C (B, T, G, N);
    ``groups`` (H,) the group each head reads (None: ``H // G`` heads a
    group, in order).

    Returns (y (B, T, H, P), final_state (B, H, P, N) float32).
    """
    Bsz, T, H, Pd = xh.shape
    G, N = B.shape[2], B.shape[3]
    L = min(cfg.ssm_chunk, T)
    T_pad = -(-T // L) * L
    if T_pad != T:  # ragged tail: dt=0 pads are exact no-ops in the SSD math
        xh = F.pad(xh, (0, 0, 0, 0, 0, T_pad - T))
        dt = F.pad(dt, (0, 0, 0, T_pad - T))
        B = F.pad(B, (0, 0, 0, 0, 0, T_pad - T))
        C = F.pad(C, (0, 0, 0, 0, 0, T_pad - T))
    nC = T_pad // L
    if groups is None:
        groups = torch.arange(H, device=xh.device) // (H // G)

    xc = xh.reshape(Bsz, nC, L, H, Pd)
    dtc = dt.reshape(Bsz, nC, L, H)
    Bg = B.reshape(Bsz, nC, L, G, N).index_select(3, groups)
    Cg = C.reshape(Bsz, nC, L, G, N).index_select(3, groups)
    dA = dtc * (-torch.exp(A))[None, None, None, :]    # (B, nC, L, H) negative
    cum = torch.cumsum(dA, dim=2)                        # within-chunk cumulative

    # within-chunk (quadratic) term; mask BEFORE exp, as the reference does
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nC,Lq,Lk,H)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=xh.device))
    decay = torch.exp(torch.where(tri[None, None, :, :, None], seg, -1e30))
    del seg
    scores = einsum("bclhn,bckhn->bclkh", Cg, Bg)       # (B,nC,Lq,Lk,H)
    M = scores * decay * dtc[:, :, None, :, :]
    del scores, decay
    y_diag = einsum("bclkh,bckhp->bclhp", M.to(xc.dtype), xc)
    del M

    # chunk-boundary states
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)   # (B,nC,L,H)
    w_in = (dtc * decay_to_end).to(xc.dtype)
    state_chunk = einsum("bclhn,bclhp->bchpn", Bg * w_in[..., None], xc)   # (B,nC,H,P,N)
    chunk_decay = torch.exp(dA.sum(dim=2))               # (B,nC,H)

    h = init_state if init_state is not None else torch.zeros(
        (Bsz, H, Pd, N), dtype=torch.float32, device=xh.device)
    h_prevs = []
    for c in range(nC):                                  # emit the state BEFORE chunk c
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + state_chunk[:, c].float()
    h_prevs = torch.stack(h_prevs, dim=1)                # (B,nC,H,P,N)

    # inter-chunk contribution: y_off = C · (decay_in · h_prev)
    decay_in = torch.exp(cum)                            # (B,nC,L,H)
    y_off = einsum("bclhn,bchpn->bclhp", Cg * decay_in.to(Cg.dtype)[..., None],
                   h_prevs.to(Cg.dtype))
    y = (y_diag + y_off).reshape(Bsz, T_pad, H, Pd)[:, :T]
    return y, h


def _gated_rmsnorm(y, scale, cfg: ModelConfig, ctx: MeshCtx):
    """RMSNorm of y (…, d_inner / M) over the whole ``d_inner``: the local
    sum of squares psummed over 'model'."""
    d_inner = cfg.d_model * cfg.ssm_expand
    ss = psum_model(torch.sum(torch.square(y.float()), -1, keepdim=True), ctx)
    var = ss / d_inner
    return (y.float() * torch.rsqrt(var + 1e-6)).to(y.dtype) * scale


def _proj(p, xg, cfg: ModelConfig):
    z = matmul(xg, p["wz"])
    xin = matmul(xg, p["wx"])
    bc = matmul(xg, p["wbc"])
    dt = _softplus(matmul(xg, p["wdt"]) + p["dt_bias"])
    return z, xin, bc, dt


def _tail(x, n: int):
    """The last ``n`` positions of x (B, T, C), zero rows first where T < n
    (the causal conv's own zero padding)."""
    return F.pad(x, (0, 0, max(0, n - x.shape[1]), 0))[:, -n:]


def ssm_apply(p, x_sp, ctx: MeshCtx, cfg: ModelConfig, *, return_state=False):
    """Forward over the whole sequence: x (B, T, d) -> (B, T, d).  With
    ``return_state`` also the decode cache: the final ``ssd`` state, the
    last ``ssm_conv - 1`` raw conv inputs of x and of B/C, ``len`` = T."""
    xg = ag_seq(x_sp, ctx)
    Bsz, T, d = xg.shape
    _, H, hp, G, N = _dims(cfg, ctx)
    z, xin_raw, bc_raw, dt = _proj(p, xg, cfg)
    xin = _causal_conv(xin_raw, p["conv_x"])
    bc = _causal_conv(bc_raw, p["conv_bc"])
    Bm = bc[..., :G * N].reshape(Bsz, T, G, N)
    Cm = bc[..., G * N:].reshape(Bsz, T, G, N)
    Hl = xin.shape[-1] // hp
    xh = xin.reshape(Bsz, T, Hl, hp)
    y, state = _ssd_chunked(xh, dt, p["a_log"].float(), Bm, Cm, cfg,
                            groups=_head_groups(cfg, ctx, Hl, xh.device))
    y = y + xh * p["dskip"][None, None, :, None]
    y = y.reshape(Bsz, T, Hl * hp)
    y = y * F.silu(z)
    y = _gated_rmsnorm(y, p["gate_norm"], cfg, ctx)
    out = rs_seq(matmul(y, p["wout"]), ctx)
    if return_state:
        k1 = cfg.ssm_conv - 1
        conv_state = {"x": _tail(xin_raw, k1), "bc": _tail(bc_raw, k1)}
        return out, {"ssd": state, "conv": conv_state, "len": T}
    return out


def ssm_init_cache(cfg: ModelConfig, ctx: MeshCtx, batch: int, device=None):
    """A zeroed cache of this rank's heads and ``d_inner`` columns."""
    _, H, hp, G, N = _dims(cfg, ctx)
    Hl = max(1, H // ctx.model_size)
    return {
        "ssd": torch.zeros((batch, Hl, hp, N), dtype=torch.float32, device=device),
        "conv": {
            "x": torch.zeros((batch, cfg.ssm_conv - 1, Hl * hp), dtype=torch.bfloat16,
                             device=device),
            "bc": torch.zeros((batch, cfg.ssm_conv - 1, 2 * G * N), dtype=torch.bfloat16,
                              device=device),
        },
        "len": 0,
    }


def ssm_decode(p, x, cache, ctx: MeshCtx, cfg: ModelConfig):
    """O(1) recurrent step: x (B, 1, d), replicated over 'model'.  The
    ``ssd`` state of ``cache`` (this rank's heads) is updated in place and
    returned in the next cache; the output is psummed over 'model'."""
    Bsz = x.shape[0]
    _, H, hp, G, N = _dims(cfg, ctx)
    z, xin, bc, dt = _proj(p, x, cfg)                    # (B, 1, ·)
    # conv step over the ring of the last K-1 raw inputs
    cx = torch.cat([cache["conv"]["x"], xin], dim=1)     # (B, K, dl), dtypes promoted
    cbc = torch.cat([cache["conv"]["bc"], bc], dim=1)
    xin = F.silu(einsum("bkc,kc->bc", cx, p["conv_x"]))[:, None]
    bcv = F.silu(einsum("bkc,kc->bc", cbc, p["conv_bc"]))[:, None]
    Bm = bcv[..., :G * N].reshape(Bsz, G, N)
    Cm = bcv[..., G * N:].reshape(Bsz, G, N)
    Hl = xin.shape[-1] // hp
    groups = _head_groups(cfg, ctx, Hl, x.device)
    xh = xin.reshape(Bsz, Hl, hp)
    dt0 = dt[:, 0].float()
    dA = dt0 * (-torch.exp(p["a_log"].float()))          # (B, Hl)
    Bg = Bm.index_select(1, groups)
    Cg = Cm.index_select(1, groups)
    h = cache["ssd"]
    h.mul_(torch.exp(dA)[..., None, None]).add_(
        (dt0[..., None] * xh.float())[..., None] * Bg.float()[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", h, Cg.float()).to(x.dtype)
    y = y + xh * p["dskip"][None, :, None]
    y = y.reshape(Bsz, 1, Hl * hp)
    y = y * F.silu(z)
    y = _gated_rmsnorm(y, p["gate_norm"], cfg, ctx)
    out = psum_model(matmul(y, p["wout"]), ctx)
    new_cache = {
        "ssd": h,
        "conv": {"x": cx[:, 1:], "bc": cbc[:, 1:]},
        "len": cache["len"] + 1,
    }
    return out, new_cache
