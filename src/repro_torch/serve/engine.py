"""Serving engine: prefill and one-token decode step factories, on one card.

The reference (``repro.serve.engine``) builds ``shard_map`` + ``jit`` steps
over a mesh: the decode's residual stream replicated over 'model', the KV
caches sequence-sharded, partials LSE-combined.  The port's steps are plain
functions on tensors over the same parameter tree, looping over each
group's stacked layers in Python where the reference runs ``lax.scan``.

Cache layout is declared as a ``P`` tree (``cache_spec``), as in the
reference; ``abstract_cache`` gives it on the ``meta`` device.  A live cache
group is ``{"k", "v"}`` stacked over the group's layers (bfloat16, allocated
from the spec) and ``"len"``, the number of filled positions, as a host
``int`` where the spec declares an int32 array (see
``models.attention``).  ``decode`` writes into the caches it is given: do
not reuse them after the call.

Block kinds other than ``attn`` raise until their slices (ROADMAP Queue A).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.models.attention import gqa_apply, gqa_decode, gqa_fill_cache
from repro_torch.models.backbone import (
    embed_tokens,
    greedy_token,
    layer_params,
    layer_plan,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.ffn import mlp_apply, mlp_decode
from repro_torch.models.layers import MeshCtx, apply_norm
from repro_torch.models.spec import P, abstract_params, stack_layers
from repro_torch.train.step import batch_axes, mesh_ctx


# ---------------------------------------------------------------------------
# cache P-spec tree
# ---------------------------------------------------------------------------


def _kind_cache_spec(cfg: ModelConfig, kind: str, ba, batch: int, max_len: int) -> dict:
    dh = cfg.resolved_head_dim
    if kind == "attn":
        shape = (batch, cfg.n_kv_heads, max_len, dh)
        return {
            "k": P(shape, (ba, None, "model", None), "zeros", dtype=torch.bfloat16),
            "v": P(shape, (ba, None, "model", None), "zeros", dtype=torch.bfloat16),
            "len": P((), (), "zeros", dtype=torch.int32),
        }
    raise NotImplementedError(f"{kind!r} caches: a later slice (ROADMAP Queue A)")


def cache_spec(cfg: ModelConfig, mesh, batch: int, max_len: int):
    ba = batch_axes(mesh, batch)
    return {
        f"g{gi}": stack_layers(_kind_cache_spec(cfg, kind, ba, batch, max_len), count)
        for gi, (kind, count, _) in enumerate(layer_plan(cfg))
    }


def abstract_cache(cfg: ModelConfig, mesh, batch: int, max_len: int):
    return abstract_params(cache_spec(cfg, mesh, batch, max_len))


# ---------------------------------------------------------------------------
# per-kind prefill / decode block functions
# ---------------------------------------------------------------------------


def _prefill_block(cfg, ctx, kind):
    if kind != "attn":
        raise NotImplementedError(f"{kind!r} prefill: a later slice (ROADMAP Queue A)")

    def attn(p, x, cache):
        h, (k, v) = gqa_apply(p["attn"], apply_norm(p["ln1"], x, cfg), ctx, cfg,
                              causal=True, return_kv=True)
        x = x + h
        x = x + mlp_apply(p["mlp"], apply_norm(p["ln2"], x, cfg), ctx, cfg)
        return x, gqa_fill_cache(cache, k, v, ctx)

    return attn


def _decode_block(cfg, ctx, kind):
    if kind != "attn":
        raise NotImplementedError(f"{kind!r} decode: a later slice (ROADMAP Queue A)")

    def attn(p, x, c):
        h, c2 = gqa_decode(p["attn"], apply_norm(p["ln1"], x, cfg), c, ctx, cfg)
        x = x + h
        x = x + mlp_decode(p["mlp"], apply_norm(p["ln2"], x, cfg), ctx, cfg)
        return x, c2

    return attn


# ---------------------------------------------------------------------------
# step factories
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ServeBundle:
    prefill: Callable
    decode: Callable
    ctx: MeshCtx


def _layer_cache(group, i: int) -> dict:
    return {"k": group["k"][i], "v": group["v"][i], "len": group["len"]}


def make_serve_fns(cfg: ModelConfig, mesh, *, batch: int, max_len: int) -> ServeBundle:
    """``prefill(params, {"tokens": (B, T) int}) -> (caches, token (B,))`` and
    ``decode(params, caches, tokens (B, 1)) -> (token (B,), caches)``, with
    the reference's semantics, on the tensors' device (the mesh's)."""
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"frontend {cfg.frontend!r}: a later slice (ROADMAP Queue A)")
    ctx = mesh_ctx(mesh)
    c_spec = cache_spec(cfg, mesh, batch, max_len)
    plan = layer_plan(cfg)
    prefill_fns = [_prefill_block(cfg, ctx, kind) for kind, _, _ in plan]
    decode_fns = [_decode_block(cfg, ctx, kind) for kind, _, _ in plan]

    def prefill(params, inputs):
        tokens = inputs["tokens"]                       # (B, T)
        x = embed_tokens(params["embed"], tokens.clamp(min=0), ctx, cfg)
        caches = {}
        for gi, (_kind, count, _) in enumerate(plan):
            cs = c_spec[f"g{gi}"]
            group = {n: torch.zeros(cs[n].shape, dtype=cs[n].dtype, device=x.device)
                     for n in ("k", "v")}
            group["len"] = 0
            for i in range(count):
                x, filled = prefill_fns[gi](layer_params(params[f"g{gi}"], i), x,
                                            _layer_cache(group, i))
            group["len"] = filled["len"]
            caches[f"g{gi}"] = group
        x = apply_norm(params["final_norm"], x, cfg)
        return caches, greedy_token(params["embed"], x[:, -1:], ctx, cfg)

    def decode(params, caches, tokens):
        x = embed_tokens(params["embed"], tokens, ctx, cfg)     # (B, 1, d)
        new_caches = {}
        for gi, (_kind, count, _) in enumerate(plan):
            group = caches[f"g{gi}"]
            for i in range(count):
                x, c2 = decode_fns[gi](layer_params(params[f"g{gi}"], i), x,
                                       _layer_cache(group, i))
            new_caches[f"g{gi}"] = {"k": group["k"], "v": group["v"], "len": c2["len"]}
        x = apply_norm(params["final_norm"], x, cfg)
        return greedy_token(params["embed"], x, ctx, cfg), new_caches

    return ServeBundle(prefill=prefill, decode=decode, ctx=ctx)
