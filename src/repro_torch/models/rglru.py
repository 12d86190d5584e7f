"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t^2) ⊙ (i_t ⊙ x_t),
a_t = exp(c · r_t · log σ(Λ)),  c = 8,
with sigmoid input/recurrence gates (diagonal).

As in the reference (``repro.models.rglru``) the block is
sequence-parallel: each rank of 'model' holds its (B, T/M, d) chunk at
full width, the weights replicated over 'model', and scans the chunk
alone; the chunks are composed from each chunk's affine map (A_seg, B_seg)
— the decay it applies to the state it is handed, and the state it leaves
from a zero start.  The port takes two all-gathers over 'model' and no
``ppermute`` (``LocalMesh`` has none):

* every rank's last ``min(3, T/M)`` **pre-conv** branch inputs.  The rows
  before a rank's chunk are its causal conv's halo (zeros before the
  sequence starts), and the last 3 rows of the whole sequence are the
  decode cache's ``"conv"``.  A chunk shorter than the halo hands on all
  its rows, so 1- and 2-row chunks get the right halo;
* the stacked (A_seg, B_seg) summaries: a rank's carry-in state is the
  composition of the chunks before it, and the decode cache's ``"h"`` that
  of all of them.  Then h = exp(cumsum(log a)) · h_in + h_local, as in the
  reference.

Every rank records both gathers in autograd whatever its position (its
halo and carry-in are slices of the gathered tensors, zero on rank 0), so
every rank runs both transposes (reduce-scatters) in the backward.  On one
rank the halo is zeros and there is one chunk.  Torch has no associative
scan; ``_linear_scan`` is a log-depth doubling scan (Hillis–Steele over
the affine maps (a, b), ⌈log₂ T⌉ steps) in float32, whose rounding differs
from ``lax.associative_scan``'s tree in the last bits.  ``rglru_decode``
is replicated over 'model' and takes no collective.

Two deliberate differences from the reference.  The decode cache's
``"conv"`` holds the last 3 **pre-conv** branch inputs, which
``rglru_decode`` convolves with the new one.  The reference's
``rglru_apply`` stores the last 3 conv *outputs* there (it rebinds ``rec``
to the conv's output before taking the tail), so its decode after a
prefill convolves twice and departs from its own no-cache forward.  And a
sequence (above one rank, a chunk) shorter than 3 rows takes its halo from
the rows that exist, zeros before the sequence's start; the reference's
zero halo and its ``ppermute`` of ``rec[:, -3:]`` are then as short as the
chunk, and it raises or misaligns the taps.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import MeshCtx, ag_seq, einsum, matmul
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


def _compose(summ):
    """Every chunk's carry-in state from the gathered summaries summ (B, M,
    2, w), (A_seg, B_seg) a chunk: (B, M + 1, w), row j the state before
    chunk j (row M after the last)."""
    h = torch.zeros_like(summ[:, 0, 1])
    states = [h]
    for j in range(summ.shape[1]):
        h = summ[:, j, 0] * h + summ[:, j, 1]
        states.append(h)
    return torch.stack(states, dim=1)


def rglru_apply(p, x_sp, ctx: MeshCtx, cfg: ModelConfig, *, return_state=False):
    """Sequence-parallel forward: x_sp (B, T/M, d), this rank's chunk, in,
    (B, T/M, d) out (on one rank the whole sequence).  With
    ``return_state`` also the decode cache, the same on every rank: the
    whole sequence's last state ``h``, its last 3 pre-conv branch inputs
    ``conv`` (bfloat16) and ``len`` = T."""
    B, Tc, _ = x_sp.shape
    M, r = ctx.model_size, ctx.midx()
    gate, rec = _branch_in(p, x_sp)
    k = min(3, Tc)
    # 3 zero rows, then every rank's last k pre-conv rows in rank order
    # (B, 3 + k·M, w): the 3 rows before row 3 + r·k are this rank's halo
    tails = torch.cat([rec.new_zeros((B, 3, rec.shape[2])), ag_seq(rec[:, Tc - k:], ctx)], 1)
    conv = _conv_with_halo(rec, tails[:, r * k:r * k + 3], p)
    log_a, a, b = _gates(p, conv)
    h = _linear_scan(a, b)
    if M > 1:
        a_prefix = torch.exp(torch.cumsum(log_a, dim=1))            # (B, Tc, w)
        summ = torch.stack([a_prefix[:, -1], h[:, -1]], dim=1)[:, None]
        states = _compose(ag_seq(summ, ctx))                      # (B, M + 1, w)
        h_last = states[:, M]
        h = a_prefix * states[:, r, None] + h
    else:
        h_last = h[:, -1]
    out = matmul(h.to(x_sp.dtype) * gate, p["wout"])
    if return_state:
        return out, {"h": h_last, "conv": tails[:, -3:].to(torch.bfloat16), "len": Tc * M}
    return out


def rglru_init_cache(cfg: ModelConfig, ctx: MeshCtx, batch: int, device=None):
    w = cfg.lru_width
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, 3, w), dtype=torch.bfloat16, device=device),
        "len": 0,
    }


def rglru_decode(p, x, cache, ctx: MeshCtx, cfg: ModelConfig):
    """One step: x (B, 1, d) -> (B, 1, d) and the next cache.  Above one
    rank x, the weights and the cache are replicated over 'model': no
    collective."""
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
