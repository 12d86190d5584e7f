"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427) on
one card.

h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t^2) ⊙ (i_t ⊙ x_t),
a_t = exp(c · r_t · log σ(Λ)),  c = 8,
with sigmoid input/recurrence gates (diagonal).

The reference (``repro.models.rglru``) runs the block sequence-parallel:
each rank scans its chunk with ``lax.associative_scan`` and the chunks are
composed with one all-gather of segment summaries and a 3-step conv halo.
On one card the halo is zeros and there is one chunk.  Torch has no
associative scan; ``_linear_scan`` is a log-depth doubling scan
(Hillis–Steele over the affine maps (a, b), ⌈log₂ T⌉ steps) in float32,
whose rounding differs from ``lax.associative_scan``'s tree in the last
bits.

One deliberate difference: the decode cache's ``"conv"`` holds the last 3
**pre-conv** branch inputs, which ``rglru_decode`` convolves with the new
one.  The reference's ``rglru_apply`` stores the last 3 conv *outputs*
there (it rebinds ``rec`` to the conv's output before taking the tail), so
its decode after a prefill convolves twice and departs from its own
no-cache forward.  A prompt shorter than 3 tokens leaves zeros in the
oldest rows, which equal the zero halo.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import MeshCtx, einsum, matmul
from .spec import P

_C = 8.0


def rglru_spec(cfg: ModelConfig, ctx: MeshCtx) -> dict:
    d, w = cfg.d_model, cfg.lru_width
    return {
        "w_gate_branch": P((d, w), (None, None)),
        "w_rec_branch": P((d, w), (None, None)),
        "conv_w": P((4, w), (None, None)),
        "conv_b": P((w,), (None,), "zeros"),
        "lam": P((w,), (None,), "ones"),      # Λ (softplus-domain init)
        "gx_w": P((w,), (None,), "ones"),     # diagonal input gate
        "gx_b": P((w,), (None,), "zeros"),
        "ga_w": P((w,), (None,), "ones"),     # diagonal recurrence gate
        "ga_b": P((w,), (None,), "zeros"),
        "wout": P((w, d), (None, None)),
    }


def _branch_in(p, x):
    gate = F.gelu(matmul(x, p["w_gate_branch"]), approximate="tanh")
    rec = matmul(x, p["w_rec_branch"])
    return gate, rec


def _conv_with_halo(rec, halo, p):
    """Causal depthwise conv over the sequence with a 3-position halo of
    earlier inputs (zeros at the start of a sequence)."""
    K = p["conv_w"].shape[0]
    T = rec.shape[1]
    xp = torch.cat([halo, rec], dim=1)  # (B, T + 3, w)
    out = sum(xp[:, i:i + T] * p["conv_w"][i] for i in range(K))
    return out + p["conv_b"]


def _gates(p, x):
    i_t = torch.sigmoid(x * p["gx_w"] + p["gx_b"])
    r_t = torch.sigmoid(x * p["ga_w"] + p["ga_b"])
    log_a = _C * r_t * F.logsigmoid(p["lam"].float() + 4.0)
    a_t = torch.exp(log_a)
    b_t = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-8)) * (i_t * x)
    return log_a.float(), a_t.float(), b_t.float()


def _linear_scan(a, b):
    """h_t = a_t · h_{t-1} + b_t along dim 1 from h_{-1} = 0: at step s each
    position composes the affine map s positions back into its own."""
    s, T = 1, a.shape[1]
    while s < T:
        b = torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]], dim=1)
        if 2 * s < T:               # the last step needs no composed a
            a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return b


def rglru_apply(p, x_sp, ctx: MeshCtx, cfg: ModelConfig, *, return_state=False):
    """Forward over the whole sequence: x (B, T, d) in, (B, T, d) out.
    With ``return_state`` also the decode cache: the last state ``h``, the
    last 3 pre-conv branch inputs ``conv`` (bfloat16) and ``len`` = T."""
    B, T, _ = x_sp.shape
    gate, rec = _branch_in(p, x_sp)
    halo = rec.new_zeros((B, 3, rec.shape[2]))
    tail = torch.cat([halo, rec], dim=1)[:, -3:]          # pre-conv (see docstring)
    rec = _conv_with_halo(rec, halo, p)
    _, a, b = _gates(p, rec)
    h = _linear_scan(a, b)
    out = matmul(h.to(x_sp.dtype) * gate, p["wout"])
    if return_state:
        return out, {"h": h[:, -1], "conv": tail.to(torch.bfloat16), "len": T}
    return out


def rglru_init_cache(cfg: ModelConfig, ctx: MeshCtx, batch: int, device=None):
    w = cfg.lru_width
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, 3, w), dtype=torch.bfloat16, device=device),
        "len": 0,
    }


def rglru_decode(p, x, cache, ctx: MeshCtx, cfg: ModelConfig):
    """One step: x (B, 1, d) -> (B, 1, d) and the next cache."""
    gate, rec = _branch_in(p, x)                       # (B, 1, w)
    window = torch.cat([cache["conv"].to(rec.dtype), rec], dim=1)
    rec1 = einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    _, a, b = _gates(p, rec1)
    h = a * cache["h"] + b
    out = matmul(h.to(x.dtype) * gate[:, 0], p["wout"])
    return out[:, None], {
        "h": h,
        "conv": window[:, 1:].to(torch.bfloat16),
        "len": cache["len"] + 1,
    }
