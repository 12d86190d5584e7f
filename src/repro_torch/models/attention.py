"""GQA attention blocks on one card: prefill and one-token decode.

The reference (``repro.models.attention``) shards query/out projections over
'model' and the KV cache along the sequence (context parallelism, partials
LSE-combined across shards).  On one card the same functions run with one
shard: ``kv_map`` / ``local_kv_map`` coincide, the combine is a division.

The KV cache is bfloat16, as in the reference.  Its position ``len`` is a
host ``int``: the host always knows it, so decode reads nothing back from
the device to place the new K/V, and it refuses a write past the cache's
capacity where the reference writes at ``len`` modulo the capacity and
silently overwrites its oldest positions.  Decode writes the new K/V into the
cache tensors in place (the reference donates the cache): a caller must not
reuse the cache it passed in.

Sliding-window attention decodes against a ring of ``window`` slots
(``local_*``, slot = position % window), written in place the same way; a
ring never fills, so ``local_decode`` has no capacity to refuse.

MLA (deepseek's multi-head latent attention, ``mla_*``) caches only the
latent ``c_kv`` and the shared rotary key ``k_rope`` and decodes in absorbed
form, in the latent space; its cache takes the same ``len``, in-place
writes and full-cache refusal as the GQA cache.

Cross attention (the encoder-decoder's ``cross`` blocks) reads an encoder
memory without rope: ``gqa_apply(memory=)`` for prefill, and at decode
``cross_decode`` against the memory's K/V, computed once by
``cross_fill_cache``.  That cache's ``len`` is the memory's length, a host
``int``; decode reads it and never writes it.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import (
    MeshCtx,
    ag_seq,
    attention_partial_lse,
    blockwise_attention,
    combine_partials,
    einsum,
    matmul,
    pad_to,
    rms_head_norm,
    rope,
    rs_seq,
)
from .spec import P


def _hq_pad(cfg: ModelConfig, ctx: MeshCtx) -> int:
    return pad_to(cfg.n_heads, ctx.model_size)


@functools.lru_cache(maxsize=None)
def _kv_map(n_heads: int, n_kv_heads: int, hq: int, device: torch.device) -> torch.Tensor:
    # one upload per (heads, device), not one per layer and step; read-only
    group = max(1, n_heads // n_kv_heads)
    full = np.minimum(np.arange(hq) // group, n_kv_heads - 1)
    return torch.as_tensor(full, dtype=torch.int32, device=device)


def kv_map(cfg: ModelConfig, ctx: MeshCtx, device=None) -> torch.Tensor:
    """Global (padded) q-head -> kv-head index map."""
    return _kv_map(cfg.n_heads, cfg.n_kv_heads, _hq_pad(cfg, ctx), torch.device(device or "cpu"))


def local_kv_map(cfg: ModelConfig, ctx: MeshCtx, device=None) -> torch.Tensor:
    qpr = _hq_pad(cfg, ctx) // ctx.model_size
    return kv_map(cfg, ctx, device)[ctx.midx() * qpr:(ctx.midx() + 1) * qpr]


def _mask_pad_heads(out, cfg: ModelConfig, ctx: MeshCtx, *, local: bool = True):
    """Zero the outputs of padding query heads (Hq padded to the axis size;
    none on one card)."""
    hq = _hq_pad(cfg, ctx)
    if hq == cfg.n_heads:
        return out
    Hl = out.shape[1]
    start = ctx.midx() * Hl if (local and ctx.model_size > 1) else 0
    gid = start + torch.arange(Hl, device=out.device)
    return out * (gid < cfg.n_heads)[None, :, None, None].to(out.dtype)


# --------------------------------------------------------------------------
# GQA
# --------------------------------------------------------------------------


def gqa_spec(cfg: ModelConfig, ctx: MeshCtx) -> dict:
    d, dh = cfg.d_model, cfg.resolved_head_dim
    hq = _hq_pad(cfg, ctx)
    hl = cfg.n_heads * dh  # logical (unpadded) head dim
    spec = {
        "wq": P((d, hq * dh), (None, "model"), logical=(d, hl)),
        "wk": P((d, cfg.n_kv_heads * dh), (None, None)),
        "wv": P((d, cfg.n_kv_heads * dh), (None, None)),
        "wo": P((hq * dh, d), ("model", None), logical=(hl, d)),
    }
    if cfg.qkv_bias:
        spec["bq"] = P((hq * dh,), ("model",), "zeros")
        spec["bk"] = P((cfg.n_kv_heads * dh,), (None,), "zeros")
        spec["bv"] = P((cfg.n_kv_heads * dh,), (None,), "zeros")
    if cfg.qk_norm:
        spec["q_norm"] = P((dh,), (None,), "ones")
        spec["k_norm"] = P((dh,), (None,), "ones")
    return spec


def _q(p, xg, cfg: ModelConfig):
    """xg (B, T, d) -> q (B, Hl, T, Dh), before rope."""
    B, T, _ = xg.shape
    q = matmul(xg, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = q.reshape(B, T, -1, cfg.resolved_head_dim).transpose(1, 2)
    return rms_head_norm(p["q_norm"], q) if cfg.qk_norm else q


def _kv(p, xg, cfg: ModelConfig):
    """xg (B, T, d) -> k/v (B, Hkv, T, Dh), before rope."""
    B, T, _ = xg.shape
    dh = cfg.resolved_head_dim
    k = matmul(xg, p["wk"])
    v = matmul(xg, p["wv"])
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    k = k.reshape(B, T, cfg.n_kv_heads, dh).transpose(1, 2)
    v = v.reshape(B, T, cfg.n_kv_heads, dh).transpose(1, 2)
    return (rms_head_norm(p["k_norm"], k) if cfg.qk_norm else k), v


def _qkv(p, xg, cfg: ModelConfig, ctx: MeshCtx, positions):
    """xg (B, T, d) -> q (B, Hl, T, Dh), k/v (B, Hkv, T, Dh), rope at
    ``positions`` (B, T) on q and k."""
    q = _q(p, xg, cfg)
    k, v = _kv(p, xg, cfg)
    q = rope(q, positions[:, None, :], cfg.rope_theta)
    k = rope(k, positions[:, None, :], cfg.rope_theta)
    return q, k, v


def gqa_apply(
    p,
    x_sp,                 # (B, T, d) residual stream
    ctx: MeshCtx,
    cfg: ModelConfig,
    *,
    causal: bool = True,
    window: int | None = None,
    memory=None,          # (B, Tm, d) encoder memory for cross attention
    return_kv: bool = False,
):
    """Self-attention over the whole sequence (train / prefill), or with
    ``memory`` cross attention over it: q, k and v then take no rope."""
    xg = ag_seq(x_sp, ctx)
    B, T, _ = xg.shape
    if memory is None:
        positions = torch.arange(T, device=xg.device).expand(B, T)
        q, k, v = _qkv(p, xg, cfg, ctx, positions)
    else:
        q = _q(p, xg, cfg)
        k, v = _kv(p, memory, cfg)
    out = blockwise_attention(
        q, k, v, local_kv_map(cfg, ctx, xg.device), causal=causal, window=window
    )
    out = _mask_pad_heads(out, cfg, ctx)
    B, Hl, T, dh = out.shape
    o = matmul(out.transpose(1, 2).reshape(B, T, Hl * dh), p["wo"])
    o = rs_seq(o, ctx)
    if return_kv:
        return o, (k, v)
    return o


def gqa_init_cache(cfg: ModelConfig, ctx: MeshCtx, batch: int, max_len: int, device=None):
    """A zeroed KV cache of ``max_len`` positions."""
    dh = cfg.resolved_head_dim
    tc = max_len // ctx.model_size
    shape = (batch, cfg.n_kv_heads, tc, dh)
    return {
        "k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
        "v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
        "len": 0,
    }


def gqa_fill_cache(cache, k, v, ctx: MeshCtx):
    """Write freshly computed prefill K/V into a zeroed cache, in place.

    Prompts shorter than the cache capacity are right-padded (decode masks
    positions >= len)."""
    tc = cache["k"].shape[2]
    t = k.shape[2]
    if t > tc:
        raise ValueError(f"prefill of {t} positions into a cache of {tc}")
    cache["k"][:, :, :t] = k.to(torch.bfloat16)
    cache["v"][:, :, :t] = v.to(torch.bfloat16)
    return {"k": cache["k"], "v": cache["v"], "len": t}


def gqa_decode(p, x, cache, ctx: MeshCtx, cfg: ModelConfig):
    """One-token decode against the cache.  x: (B, 1, d).

    The new K/V go into slot ``len`` of ``cache`` in place; attention reads
    the whole cache with positions > len masked, as the reference does.
    Raises ``ValueError`` when the cache is full."""
    B = x.shape[0]
    dh = cfg.resolved_head_dim
    pos = cache["len"]
    tc = cache["k"].shape[2]
    if pos >= tc:
        raise ValueError(f"KV cache full: position {pos} of a {tc}-position cache")
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _qkv(p, x, cfg, ctx, positions)

    k_c, v_c = cache["k"], cache["v"]
    k_c[:, :, pos:pos + 1] = k_new.to(torch.bfloat16)
    v_c[:, :, pos:pos + 1] = v_new.to(torch.bfloat16)

    kvm = kv_map(cfg, ctx, x.device)
    num, m, l = attention_partial_lse(
        q, k_c, v_c, kvm, k_offset=0, kv_valid_len=pos + 1,
        q_pos=torch.full((1,), pos, device=x.device),
    )
    out = combine_partials(num, m, l, ctx)  # (B, Hq_pad, 1, dh)
    out = _mask_pad_heads(out, cfg, ctx, local=False)
    hq = out.shape[1]
    o = matmul(out.transpose(1, 2).reshape(B, 1, hq * dh), p["wo"])
    return o, {"k": k_c, "v": v_c, "len": pos + 1}


# ---- local (sliding-window) attention decode: a ring cache ----------------


def local_init_cache(cfg: ModelConfig, batch: int, device=None):
    """A zeroed ring of ``window`` KV slots."""
    dh = cfg.resolved_head_dim
    shape = (batch, cfg.n_kv_heads, cfg.window, dh)
    return {
        "k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
        "v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
        "len": 0,
    }


def local_fill_cache(cache, k, v, cfg: ModelConfig):
    """Keep the last ``window`` positions of a prefill's K/V in ring layout
    slot = pos % window (the layout ``local_decode`` updates and reads).
    ``cache`` is unused, as in the reference: the ring is built anew."""
    w = cfg.window
    t = k.shape[2]
    if t < w:  # positions 0..t-1 land at slots 0..t-1; tail slots unused
        kc = F.pad(k, (0, 0, 0, w - t))
        vc = F.pad(v, (0, 0, 0, w - t))
    else:  # last w positions: position p -> slot p % w == roll by (t - w) % w
        kc = torch.roll(k[:, :, t - w:], (t - w) % w, dims=2)
        vc = torch.roll(v[:, :, t - w:], (t - w) % w, dims=2)
    return {"k": kc.to(torch.bfloat16), "v": vc.to(torch.bfloat16), "len": t}


def local_decode(p, x, cache, ctx: MeshCtx, cfg: ModelConfig):
    """Sliding-window decode against the ring.  x: (B, 1, d).

    The new K/V go into slot ``len % window`` of ``cache`` in place; slots
    are masked by the absolute position they hold.  RoPE positions are
    absolute."""
    B = x.shape[0]
    dh = cfg.resolved_head_dim
    w = cfg.window
    pos = cache["len"]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _qkv(p, x, cfg, ctx, positions)
    slot = pos % w
    k_c, v_c = cache["k"], cache["v"]
    k_c[:, :, slot:slot + 1] = k_new.to(torch.bfloat16)
    v_c[:, :, slot:slot + 1] = v_new.to(torch.bfloat16)

    # positions of ring slots: pos - ((slot - i) mod w)
    k_pos = pos - torch.remainder(slot - torch.arange(w, device=x.device), w)
    valid = (k_pos >= max(pos - w + 1, 0)) & (k_pos <= pos)
    kvm = local_kv_map(cfg, ctx, x.device).long()
    kg = k_c.index_select(1, kvm)
    vg = v_c.index_select(1, kvm)
    s = einsum("bhqd,bhkd->bhqk", q, kg).float() / float(np.sqrt(dh))
    s = torch.where(valid[None, None, None, :], s, -1e30)
    pattn = torch.softmax(s, dim=-1)
    out = einsum("bhqk,bhkd->bhqd", pattn.to(vg.dtype), vg)
    out = _mask_pad_heads(out, cfg, ctx)
    qpr = out.shape[1]
    o = matmul(out.transpose(1, 2).reshape(B, 1, qpr * dh), p["wo"])
    return o, {"k": k_c, "v": v_c, "len": pos + 1}


# ---- cross attention decode: the encoder memory's K/V, computed once ------


def cross_fill_cache(p, memory, cfg: ModelConfig, ctx: MeshCtx):
    """The cross-attention K/V of encoder memory (B, Tm, d), bfloat16, with
    ``len`` the host ``int`` Tm."""
    k, v = _kv(p, memory, cfg)
    return {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16), "len": memory.shape[1]}


# past every memory position: cross attention is not causal
_ALL_MEMORY = 1 << 30


def cross_decode(p, x, cache, ctx: MeshCtx, cfg: ModelConfig):
    """One token's cross attention over the whole memory cache.  x: (B, 1, d).
    Only q is projected: the cache holds the memory's K/V."""
    B = x.shape[0]
    dh = cfg.resolved_head_dim
    q = _q(p, x, cfg)
    num, m, l = attention_partial_lse(
        q, cache["k"], cache["v"], kv_map(cfg, ctx, x.device), k_offset=0,
        kv_valid_len=cache["len"], q_pos=torch.full((1,), _ALL_MEMORY, device=x.device),
    )
    out = combine_partials(num, m, l, ctx)  # (B, Hq_pad, 1, dh)
    out = _mask_pad_heads(out, cfg, ctx, local=False)
    hq = out.shape[1]
    return matmul(out.transpose(1, 2).reshape(B, 1, hq * dh), p["wo"])


# --------------------------------------------------------------------------
# MLA (deepseek multi-head latent attention)
# --------------------------------------------------------------------------


def mla_spec(cfg: ModelConfig, ctx: MeshCtx) -> dict:
    d = cfg.d_model
    h = pad_to(cfg.n_heads, ctx.model_size)
    hn = cfg.n_heads
    nope, rpe, vd = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    spec = {
        "wkv_a": P((d, cfg.kv_lora + rpe), (None, None)),
        "kv_a_norm": P((cfg.kv_lora,), (None,), "ones"),
        "wkv_b": P((cfg.kv_lora, h * (nope + vd)), (None, "model"),
                   logical=(cfg.kv_lora, hn * (nope + vd))),
        "wo": P((h * vd, d), ("model", None), logical=(hn * vd, d)),
    }
    if cfg.q_lora:
        spec["wq_a"] = P((d, cfg.q_lora), (None, None))
        spec["q_a_norm"] = P((cfg.q_lora,), (None,), "ones")
        spec["wq_b"] = P((cfg.q_lora, h * (nope + rpe)), (None, "model"),
                         logical=(cfg.q_lora, hn * (nope + rpe)))
    else:
        spec["wq"] = P((d, h * (nope + rpe)), (None, "model"),
                       logical=(d, hn * (nope + rpe)))
    return spec


def _mla_q(p, xg, cfg: ModelConfig, positions):
    """xg (B, T, d) -> q_nope (B, H, T, nope), q_rope (B, H, T, rope)."""
    B, T, _ = xg.shape
    nope, rpe = cfg.nope_head_dim, cfg.rope_head_dim
    if cfg.q_lora:
        qa = rms_head_norm(p["q_a_norm"], matmul(xg, p["wq_a"]))
        q = matmul(qa, p["wq_b"])
    else:
        q = matmul(xg, p["wq"])
    q = q.reshape(B, T, -1, nope + rpe).transpose(1, 2)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    return q_nope, rope(q_rope, positions[:, None, :], cfg.rope_theta)


def _mla_latent(p, xg, cfg: ModelConfig, positions):
    """xg (B, T, d) -> c_kv (B, T, kv_lora), k_rope (B, T, rope)."""
    kv_a = matmul(xg, p["wkv_a"])                   # (B, T, lora + rpe)
    c_kv = rms_head_norm(p["kv_a_norm"], kv_a[..., :cfg.kv_lora])
    k_rope = rope(kv_a[..., cfg.kv_lora:][:, None], positions[:, None, :],
                  cfg.rope_theta)[:, 0]
    return c_kv, k_rope


# query rows per blockwise chunk in MLA's prefill: 128 heads of f32 scores
# at the default 1 024 made deepseek-v2's 8 x 1 536 prefill peak at 74.7 GB
# on one card.  Each query row still meets the same 1 024-key chunks in the
# same order, so the numbers do not change
MLA_Q_CHUNK = 512


def mla_apply(p, x_sp, ctx: MeshCtx, cfg: ModelConfig, *, return_latent=False):
    """Prefill / train: expand the latent to per-head K/V (key width
    nope + rope, value width v) and attend blockwise."""
    xg = ag_seq(x_sp, ctx)
    B, T, _ = xg.shape
    nope, rpe, vd = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    positions = torch.arange(T, device=xg.device).expand(B, T)
    q_nope, q_rope = _mla_q(p, xg, cfg, positions)
    c_kv, k_rope = _mla_latent(p, xg, cfg, positions)
    kvb = p["wkv_b"].reshape(cfg.kv_lora, -1, nope + vd)     # (lora, H, nope + vd)
    kv = einsum("btl,lhe->bhte", c_kv, kvb)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    Hl = k_nope.shape[1]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, None].expand(B, Hl, T, rpe)], dim=-1)
    ident = torch.arange(Hl, dtype=torch.int32, device=xg.device)
    out = blockwise_attention(q, k, v, ident, causal=True, q_chunk=MLA_Q_CHUNK)
    o = rs_seq(matmul(out.transpose(1, 2).reshape(B, T, -1), p["wo"]), ctx)
    if return_latent:
        return o, (c_kv, k_rope)
    return o


def mla_init_cache(cfg: ModelConfig, ctx: MeshCtx, batch: int, max_len: int, device=None):
    """A zeroed latent cache of ``max_len`` positions."""
    tc = max_len // ctx.model_size
    return {
        "c_kv": torch.zeros((batch, tc, cfg.kv_lora), dtype=torch.bfloat16, device=device),
        "k_rope": torch.zeros((batch, tc, cfg.rope_head_dim), dtype=torch.bfloat16,
                              device=device),
        "len": 0,
    }


def mla_fill_cache(cache, c_kv, k_rope, ctx: MeshCtx):
    """Write a prefill's latents into a zeroed cache, in place; positions
    past the prompt stay zero (decode masks them)."""
    tc = cache["c_kv"].shape[1]
    t = c_kv.shape[1]
    if t > tc:
        raise ValueError(f"prefill of {t} positions into a cache of {tc}")
    cache["c_kv"][:, :t] = c_kv.to(torch.bfloat16)
    cache["k_rope"][:, :t] = k_rope.to(torch.bfloat16)
    return {"c_kv": cache["c_kv"], "k_rope": cache["k_rope"], "len": t}


def mla_decode(p, x, cache, ctx: MeshCtx, cfg: ModelConfig):
    """Absorbed one-token decode against the latent cache.  x: (B, 1, d).

    ``q_nope`` is absorbed into the latent through ``wkv_b[..., :nope]``;
    scores are taken against ``c_kv`` and ``k_rope``, and the attended
    latent is expanded through ``wkv_b[..., nope:]`` before ``wo``.  The
    new latents go into slot ``len`` of ``cache`` in place.  Raises
    ``ValueError`` when the cache is full, where the reference writes at
    ``len`` modulo the cache's length, over its oldest position."""
    B = x.shape[0]
    nope, rpe, vd, lora = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim, cfg.kv_lora
    pos = cache["len"]
    tc = cache["c_kv"].shape[1]
    if pos >= tc:
        raise ValueError(f"latent cache full: position {pos} of a {tc}-position cache")
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(p, x, cfg, positions)             # (B, H, 1, ·)
    c_new, kr_new = _mla_latent(p, x, cfg, positions)

    kvb = p["wkv_b"].reshape(lora, -1, nope + vd)
    wb_k, wb_v = kvb[..., :nope], kvb[..., nope:]              # (lora, H, ·)
    q_lat = einsum("bhqe,lhe->bhql", q_nope, wb_k)             # (B, H, 1, lora)

    c_c, r_c = cache["c_kv"], cache["k_rope"]
    c_c[:, pos:pos + 1] = c_new.to(torch.bfloat16)
    r_c[:, pos:pos + 1] = kr_new.to(torch.bfloat16)

    scale = 1.0 / np.sqrt(nope + rpe)
    s = (einsum("bhql,btl->bhqt", q_lat, c_c)
         + einsum("bhqr,btr->bhqt", q_rope, r_c)).float() * scale
    mask = torch.arange(tc, device=x.device) <= pos
    s = torch.where(mask[None, None, None], s, -1e30)
    m = s.amax(-1)
    pw = torch.exp(s - m[..., None])
    l = pw.sum(-1)
    num = einsum("bhqt,btl->bhql", pw.to(c_c.dtype), c_c).float()
    out_lat = combine_partials(num, m, l, ctx)                 # (B, H, 1, lora)

    H = out_lat.shape[1]
    v_out = einsum("bhql,lhe->bhqe", out_lat, wb_v)            # (B, H, 1, vd)
    o = matmul(v_out.transpose(1, 2).reshape(B, 1, H * vd), p["wo"])
    return o, {"c_kv": c_c, "k_rope": r_c, "len": pos + 1}
