"""Core transformer layers, one process a rank.

The reference (``repro.models.layers``) runs these inside ``shard_map``:
the residual stream sequence-sharded over 'model' between blocks, Q/O
projections head-sharded, embeddings vocab-sharded.  The port runs the
same functions on this rank's shards.  ``MeshCtx`` carries the mesh
(``repro_torch.launch.mesh.LocalMesh``: its process groups and this rank's
coordinates); on a mesh of one rank every collective is the identity.

The collectives that autograd runs through are ``torch.autograd.Function``s
with the reference's transposes under ``jax.shard_map(...,
check_vma=False)``: the gradient a rank gets is that of the sum of every
rank's objective.  So ``ag_seq`` (all-gather) and ``rs_seq``
(reduce-scatter) are each other's transpose, ``psum_model``'s transpose is
itself (a psum of the cotangents, not the identity), and ``pmax_const`` is
a constant (a zero gradient), as the reference's ``custom_jvp``.  The
expert-parallel pair, over the combined ('data', 'model') world:
``all_to_all_ep`` (the tiled all-to-all, its own transpose) and
``psum_ep``.

``blockwise_attention`` is the reference's own online-softmax attention
over a static list of (q-chunk, k-chunk) pairs, in plain torch ops: the
same pair list with causal / window block skipping, the same ``-1e30``
fills and ``kv_valid_len`` mask.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig
from .spec import P


@dataclass(frozen=True)
class MeshCtx:
    """Axis context passed through every layer: the axis sizes, this rank's
    coordinate on 'model' and the mesh whose process groups the collectives
    run over (``comm()``; a context without one still sizes a spec)."""

    model_axis: str = "model"
    model_size: int = 1
    data_axes: tuple = ("data",)
    data_size: int = 1
    model_index: int = 0
    mesh: Any = field(default=None, repr=False, compare=False)

    def comm(self):
        """The mesh the collectives run over; raises ``ValueError`` where
        the context has none."""
        if self.mesh is None:
            raise ValueError(
                f"collectives over a MeshCtx of model {self.model_size} x data "
                f"{self.data_size} need its mesh (repro_torch.launch.mesh.make_local_mesh "
                "over a process group)")
        return self.mesh

    @property
    def m(self):
        return self.model_axis

    @property
    def world(self) -> int:
        return self.model_size * self.data_size

    def midx(self) -> int:
        return self.model_index


def pad_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with JAX's dtype promotion (bfloat16 @ float32 -> float32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with JAX's dtype promotion of its two operands."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


# --------------------------------------------------------------------------
# sequence-parallel plumbing: collectives over 'model' that autograd records
# --------------------------------------------------------------------------


class _AllGather(torch.autograd.Function):
    """All-gather along ``dim``; its transpose reduce-scatters."""

    @staticmethod
    def forward(fctx, x, mesh, axes, dim):
        fctx.args = (mesh, axes, dim)
        return mesh.all_gather(x, axes, dim)

    @staticmethod
    def backward(fctx, g):
        mesh, axes, dim = fctx.args
        return mesh.reduce_scatter(g, axes, dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    """Reduce-scatter along ``dim``; its transpose all-gathers."""

    @staticmethod
    def forward(fctx, x, mesh, axes, dim):
        fctx.args = (mesh, axes, dim)
        return mesh.reduce_scatter(x, axes, dim)

    @staticmethod
    def backward(fctx, g):
        mesh, axes, dim = fctx.args
        return mesh.all_gather(g, axes, dim), None, None, None


class _Psum(torch.autograd.Function):
    """Sum over ``axes``; its transpose is the same sum of the cotangents
    (``jax.lax.psum``'s under ``check_vma=False``)."""

    @staticmethod
    def forward(fctx, x, mesh, axes):
        fctx.args = (mesh, axes)
        return mesh.all_reduce(x, axes)

    @staticmethod
    def backward(fctx, g):
        mesh, axes = fctx.args
        return mesh.all_reduce(g, axes), None, None


class _AllToAll(torch.autograd.Function):
    """Tiled all-to-all over ``axes`` along dimension 0; its transpose is
    the same all-to-all of the cotangents (block ``j`` came from rank
    ``j``, so its cotangent goes back there)."""

    @staticmethod
    def forward(fctx, x, mesh, axes):
        fctx.args = (mesh, axes)
        return mesh.all_to_all(x, axes)

    @staticmethod
    def backward(fctx, g):
        mesh, axes = fctx.args
        return mesh.all_to_all(g, axes), None, None


class _PmaxConst(torch.autograd.Function):
    """Max over ``axes``, a constant under differentiation."""

    @staticmethod
    def forward(fctx, x, mesh, axes):
        return mesh.all_reduce(x, axes, op="max")

    @staticmethod
    def backward(fctx, g):
        return torch.zeros_like(g), None, None


def ag_seq(x: torch.Tensor, ctx: MeshCtx) -> torch.Tensor:
    """(B, T/M, d) -> (B, T, d): gather the sequence shards."""
    if ctx.model_size == 1:
        return x
    return _AllGather.apply(x, ctx.comm(), ctx.m, 1)


def rs_seq(x: torch.Tensor, ctx: MeshCtx) -> torch.Tensor:
    """(B, T, d) partial sums -> (B, T/M, d) reduced shard (psum_scatter)."""
    if ctx.model_size == 1:
        return x
    return _ReduceScatter.apply(x, ctx.comm(), ctx.m, 1)


def psum_model(x: torch.Tensor, ctx: MeshCtx) -> torch.Tensor:
    if ctx.model_size == 1:
        return x
    return _Psum.apply(x, ctx.comm(), ctx.m)


# the expert-parallel world: every rank of the mesh (never a 'pod' axis)
EP_AXES = ("data", "model")


def all_to_all_ep(x: torch.Tensor, ctx: MeshCtx) -> torch.Tensor:
    """(world · c, …) -> (world · c, …): block ``j`` to expert-parallel rank
    ``j`` (rank ``d · M + m``), every rank's block for this one back."""
    if ctx.world == 1:
        return x
    return _AllToAll.apply(x, ctx.comm(), EP_AXES)


def psum_ep(x: torch.Tensor, ctx: MeshCtx) -> torch.Tensor:
    """Sum over the expert-parallel world; its transpose is itself."""
    if ctx.world == 1:
        return x
    return _Psum.apply(x, ctx.comm(), EP_AXES)


def pmax_const(x: torch.Tensor, ctx: MeshCtx) -> torch.Tensor:
    """The max over 'model', treated as a constant under differentiation
    (the softmax's max shift)."""
    if ctx.model_size == 1:
        return x
    return _PmaxConst.apply(x, ctx.comm(), ctx.m)


# --------------------------------------------------------------------------
# norms / activations / rope
# --------------------------------------------------------------------------


def norm_spec(cfg: ModelConfig, d: int | None = None):
    d = d or cfg.d_model
    if cfg.norm_type == "layernorm":
        return {"scale": P((d,), (None,), "ones"), "bias": P((d,), (None,), "zeros")}
    return {"scale": P((d,), (None,), "ones")}


def apply_norm(p, x, cfg: ModelConfig):
    xf = x.float()
    if cfg.norm_type == "layernorm":
        xf = xf - xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + 1e-6) * p["scale"].float()
    if cfg.norm_type == "layernorm":
        y = y + p["bias"].float()
    return y.to(x.dtype)


def rms_head_norm(scale, x):
    """qk-norm: RMS over the head_dim with a learned per-dim scale."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6) * scale.float()).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _rope_freqs(half: int, theta: float, device: torch.device) -> torch.Tensor:
    # one upload per (width, theta, device), not one per call; read-only
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    return torch.from_numpy(np.asarray(freqs, np.float32)).to(device)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding; x (..., T, Dh), positions (..., T).

    The frequencies are computed in numpy float32, as the reference does at
    trace time, and then moved to the device: computed on the device they
    drift by an ulp at theta = 1e6."""
    dh = x.shape[-1]
    half = dh // 2
    ang = positions[..., None].float() * _rope_freqs(half, theta, x.device)  # (..., T, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def act_fn(cfg: ModelConfig, gate, up):
    if cfg.act == "swiglu":
        return F.silu(gate) * up
    return F.gelu(gate, approximate="tanh") * up  # gated GeLU (jax.nn.gelu's default)


# --------------------------------------------------------------------------
# blockwise (flash-style) attention — plain torch ops, O(chunk^2) memory
# --------------------------------------------------------------------------

# [True]: fully masked chunk pairs are skipped (the default); the dry run's
# ``--no-attn-skip`` sets it to False for the dense pair grid, as the
# reference's ``BLOCK_SKIP_DEFAULT`` (``repro.models.layers``)
BLOCK_SKIP_DEFAULT = [True]


def _static(off):
    return None if isinstance(off, torch.Tensor) else int(off)


def blockwise_attention(
    q: torch.Tensor,          # (B, Hl, Tq, Dh)
    k: torch.Tensor,          # (B, Hkv, Tk, Dh)
    v: torch.Tensor,          # (B, Hkv, Tk, Dv)
    kv_for_q: torch.Tensor,   # (Hl,) int — kv head per local q head
    *,
    causal: bool,
    q_offset=0,
    k_offset=0,
    window: int | None = None,
    q_chunk: int = 1024,
    k_chunk: int = 1024,
    kv_valid_len=None,        # mask k positions >= this (ragged caches)
    block_skip: bool | None = None,
) -> torch.Tensor:
    """Online-softmax attention over a static list of (q-chunk, k-chunk)
    pairs.  With ``block_skip``, chunk pairs that are fully masked (above
    the causal diagonal, or left of the window band) are dropped from the
    list, as in the reference; ``block_skip=False`` runs the dense grid, and
    ``None`` reads ``BLOCK_SKIP_DEFAULT[0]``.  Offsets given as tensors are
    dynamic: nothing is skipped."""
    if block_skip is None:
        block_skip = BLOCK_SKIP_DEFAULT[0]
    B, Hl, Tq, Dh = q.shape
    Dv = v.shape[-1]
    Tk = k.shape[2]
    scale = 1.0 / np.sqrt(Dh)
    kv_for_q = kv_for_q.to(device=k.device, dtype=torch.long)
    kg = k.index_select(1, kv_for_q)  # (B, Hl, Tk, Dh)
    vg = v.index_select(1, kv_for_q)

    q_chunk = min(q_chunk, Tq)
    k_chunk = min(k_chunk, Tk)
    nq = (Tq + q_chunk - 1) // q_chunk
    nk = (Tk + k_chunk - 1) // k_chunk
    Tq_p, Tk_p = nq * q_chunk, nk * k_chunk
    if Tq_p != Tq:
        q = F.pad(q, (0, 0, 0, Tq_p - Tq))
    if Tk_p != Tk:
        kg = F.pad(kg, (0, 0, 0, Tk_p - Tk))
        vg = F.pad(vg, (0, 0, 0, Tk_p - Tk))
    kv_len = kv_valid_len if kv_valid_len is not None else Tk

    qo, ko = _static(q_offset), _static(k_offset)
    pairs = []
    for qi in range(nq):
        for kj in range(nk):
            if block_skip and qo is not None and ko is not None:
                q_lo = qo + qi * q_chunk
                q_hi = qo + (qi + 1) * q_chunk - 1
                k_lo = ko + kj * k_chunk
                k_hi = ko + (kj + 1) * k_chunk - 1
                if causal and k_lo > q_hi:
                    continue                       # fully above the diagonal
                if window is not None and k_hi <= q_lo - window:
                    continue                       # fully left of the band
            pairs.append((qi, kj))

    dev = q.device
    m_all = [torch.full((B, Hl, q_chunk), -1e30, dtype=torch.float32, device=dev)
             for _ in range(nq)]
    l_all = [torch.zeros((B, Hl, q_chunk), dtype=torch.float32, device=dev) for _ in range(nq)]
    acc_all = [torch.zeros((B, Hl, q_chunk, Dv), dtype=torch.float32, device=dev)
               for _ in range(nq)]
    ar_q = torch.arange(q_chunk, device=dev)
    ar_k = torch.arange(k_chunk, device=dev)
    for qi, kj in pairs:
        qc = q[:, :, qi * q_chunk:(qi + 1) * q_chunk]
        ks = kg[:, :, kj * k_chunk:(kj + 1) * k_chunk]
        vs = vg[:, :, kj * k_chunk:(kj + 1) * k_chunk]
        q_pos = q_offset + qi * q_chunk + ar_q
        k_pos = k_offset + kj * k_chunk + ar_k
        s = einsum("bhqd,bhkd->bhqk", qc, ks).float() * scale
        mask = k_pos[None, :] < (k_offset + kv_len)
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window is not None:
            mask = mask & (k_pos[None, :] > (q_pos[:, None] - window))
        s = torch.where(mask[None, None], s, -1e30)
        m_prev, l_prev, acc_prev = m_all[qi], l_all[qi], acc_all[qi]
        m_new = torch.maximum(m_prev, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_prev - m_new)
        l_all[qi] = l_prev * corr + p.sum(-1)
        acc_all[qi] = acc_prev * corr[..., None] + einsum(
            "bhqk,bhkd->bhqd", p.to(vs.dtype), vs).float()
        m_all[qi] = m_new

    out = torch.cat([acc / torch.clamp(l[..., None], min=1e-30)
                     for acc, l in zip(acc_all, l_all)], dim=2)   # (B, H, Tq_p, Dv)
    return out[:, :, :Tq].to(q.dtype)


def attention_partial_lse(q, k, v, kv_for_q, *, k_offset, kv_valid_len, q_pos):
    """Decode-side partial attention over a local KV chunk.

    Returns (numerator (B,H,1,Dv) f32, max (B,H,1) f32, denom (B,H,1) f32),
    the terms the reference LSE-combines across the model axis.
    """
    scale = 1.0 / np.sqrt(q.shape[-1])
    kv_for_q = kv_for_q.to(device=k.device, dtype=torch.long)
    kg = k.index_select(1, kv_for_q)
    vg = v.index_select(1, kv_for_q)
    s = einsum("bhqd,bhkd->bhqk", q, kg).float() * scale
    k_pos = k_offset + torch.arange(k.shape[2], device=k.device)
    q_pos = torch.as_tensor(q_pos, device=k.device)
    mask = (k_pos[None, :] < kv_valid_len) & (k_pos[None, :] <= q_pos[:, None])
    s = torch.where(mask[None, None], s, -1e30)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    num = einsum("bhqk,bhkd->bhqd", p.to(vg.dtype), vg).float()
    return num, m, l


def combine_partials(num, m, l, ctx: MeshCtx):
    """LSE-combine per-shard partial attention across the model axis."""
    if ctx.model_size == 1:
        return (num / torch.clamp(l[..., None], min=1e-30)).to(torch.bfloat16)
    m_all = ctx.comm().all_reduce(m, ctx.m, op="max")
    corr = torch.exp(m - m_all)
    num = ctx.comm().all_reduce(num * corr[..., None], ctx.m)
    l = ctx.comm().all_reduce(l * corr, ctx.m)
    return (num / torch.clamp(l[..., None], min=1e-30)).to(torch.bfloat16)
