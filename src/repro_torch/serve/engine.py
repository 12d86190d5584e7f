"""Serving engine: prefill and one-token decode step factories, on one card.

The reference (``repro.serve.engine``) builds ``shard_map`` + ``jit`` steps
over a mesh: the decode's residual stream replicated over 'model', the KV
caches sequence-sharded, partials LSE-combined.  The port's steps are plain
functions on tensors over the same parameter tree, looping over each
group's layers in Python where the reference runs ``lax.scan``.

Cache layout is declared as a ``P`` tree (``cache_spec``), as in the
reference; ``abstract_cache`` gives it on the ``meta`` device.  A live
cache has the same tree: one entry a group, its leaves stacked over the
group's layers where the group is scanned.  Per block kind:

* ``attn``: ``"k"``, ``"v"``, KV caches of ``max_len`` positions (bfloat16);
* ``attn_window``: ``"k"``, ``"v"``, rings of ``window`` slots (bfloat16);
* ``mla_dense``, ``mla_moe``: ``"c_kv"`` (B, max_len, kv_lora) and
  ``"k_rope"`` (B, max_len, rope_head_dim), MLA's latent caches
  (bfloat16): per position 576 values at deepseek-v2's widths, where
  expanded per-head K/V would hold 128 · (192 + 128);
* ``rglru``: the state ``"h"`` (float32) and ``"conv"``, the last 3
  pre-conv inputs (bfloat16);
* ``dec``: ``"self"``, an ``attn`` cache of ``max_len`` positions, and
  ``"cross"``, the encoder memory's K/V of ``enc_len`` positions
  (bfloat16), filled at prefill and only read by decode;
* ``ssm``: the state ``"ssd"`` (float32) and ``"conv": {"x", "bc"}``, the
  last ``ssm_conv - 1`` raw conv inputs;
* a ``hybrid_period`` group: ``{"b0", "b1", …}``, one of the above a block;

and in each kind's dict ``"len"``, the number of positions seen, as a host
``int`` where the spec declares an int32 array (see ``models.attention``).
The live leaves take the dtypes the blocks give them, as the reference's
do: with bfloat16 parameters those of the spec; with float32 parameters
the ``ssm`` conv rings stay float32, as the reference's ``ssm_apply``
leaves them.  ``decode`` writes into the caches it is given: do not reuse
them after the call.

The MoE blocks' aux loss is discarded, as the reference's serving does.
Every family is served, the encoder-decoder and both stub frontends
included: ``prefill``'s ``inputs`` carry ``"enc"`` (B, enc_len, d), the
frames an encoder-decoder encodes once a prefill, and ``"frontend"`` (B,
T, d), the embeddings of a ``patch_stub`` model's positions whose token is
below 0.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.models.attention import (
    cross_decode,
    cross_fill_cache,
    gqa_apply,
    gqa_decode,
    gqa_fill_cache,
    gqa_init_cache,
    local_decode,
    local_fill_cache,
    mla_apply,
    mla_decode,
    mla_fill_cache,
    mla_init_cache,
)
from repro_torch.models.backbone import (
    embed_inputs,
    embed_tokens,
    encode,
    greedy_token,
    group_layers,
    hybrid_kind,
    layer_plan,
    model_spec,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.ffn import mlp_apply, mlp_decode, moe_apply, moe_decode
from repro_torch.models.layers import MeshCtx, apply_norm
from repro_torch.models.rglru import rglru_apply, rglru_decode
from repro_torch.models.spec import P, abstract_params, stack_layers
from repro_torch.models.ssm import ssm_apply, ssm_decode
from repro_torch.train.step import batch_axes, mesh_ctx


# ---------------------------------------------------------------------------
# cache P-spec tree
# ---------------------------------------------------------------------------


def _kind_cache_spec(cfg: ModelConfig, kind: str, ba, batch: int, max_len: int,
                     enc_len: int) -> dict:
    dh = cfg.resolved_head_dim
    bf16, i32 = torch.bfloat16, torch.int32
    if kind == "attn":
        shape = (batch, cfg.n_kv_heads, max_len, dh)
        return {
            "k": P(shape, (ba, None, "model", None), "zeros", dtype=bf16),
            "v": P(shape, (ba, None, "model", None), "zeros", dtype=bf16),
            "len": P((), (), "zeros", dtype=i32),
        }
    if kind == "attn_window":
        shape = (batch, cfg.n_kv_heads, cfg.window, dh)
        return {
            "k": P(shape, (ba, None, None, None), "zeros", dtype=bf16),
            "v": P(shape, (ba, None, None, None), "zeros", dtype=bf16),
            "len": P((), (), "zeros", dtype=i32),
        }
    if kind in ("mla_dense", "mla_moe"):
        return {
            "c_kv": P((batch, max_len, cfg.kv_lora), (ba, "model", None), "zeros", dtype=bf16),
            "k_rope": P((batch, max_len, cfg.rope_head_dim), (ba, "model", None), "zeros",
                        dtype=bf16),
            "len": P((), (), "zeros", dtype=i32),
        }
    if kind == "ssm":
        d_inner = cfg.d_model * cfg.ssm_expand
        H = d_inner // cfg.ssm_headdim
        G, N, K = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_conv
        return {
            "ssd": P((batch, H, cfg.ssm_headdim, N), (ba, "model", None, None), "zeros",
                     dtype=torch.float32),
            "conv": {
                "x": P((batch, K - 1, d_inner), (ba, None, "model"), "zeros", dtype=bf16),
                "bc": P((batch, K - 1, 2 * G * N), (ba, None, None), "zeros", dtype=bf16),
            },
            "len": P((), (), "zeros", dtype=i32),
        }
    if kind == "rglru":
        w = cfg.lru_width
        return {
            "h": P((batch, w), (ba, None), "zeros", dtype=torch.float32),
            "conv": P((batch, 3, w), (ba, None, None), "zeros", dtype=bf16),
            "len": P((), (), "zeros", dtype=i32),
        }
    if kind == "dec":
        shape = (batch, cfg.n_kv_heads, enc_len, dh)
        return {
            "self": _kind_cache_spec(cfg, "attn", ba, batch, max_len, enc_len),
            "cross": {
                "k": P(shape, (ba, None, "model", None), "zeros", dtype=bf16),
                "v": P(shape, (ba, None, "model", None), "zeros", dtype=bf16),
                "len": P((), (), "zeros", dtype=i32),
            },
        }
    raise ValueError(kind)


def cache_spec(cfg: ModelConfig, mesh, batch: int, max_len: int, enc_len: int = 1536):
    ba = batch_axes(mesh, batch)
    tree = {}
    for gi, (kind, count, scanned) in enumerate(layer_plan(cfg)):
        if count == 0:
            continue
        if kind == "hybrid_period":
            base = {f"b{i}": _kind_cache_spec(cfg, hybrid_kind(k), ba, batch, max_len, enc_len)
                    for i, k in enumerate(cfg.pattern)}
        else:
            base = _kind_cache_spec(cfg, kind, ba, batch, max_len, enc_len)
        tree[f"g{gi}"] = stack_layers(base, count) if scanned else (
            {f"l{i}": base for i in range(count)} if count > 1 else base)
    return tree


def abstract_cache(cfg: ModelConfig, mesh, batch: int, max_len: int, enc_len: int = 1536):
    return abstract_params(cache_spec(cfg, mesh, batch, max_len, enc_len))


# ---------------------------------------------------------------------------
# per-kind prefill / decode block functions
# ---------------------------------------------------------------------------


def _prefill_block(cfg, ctx, kind, batch, max_len, *, memory=None):
    """f(params, x) -> (x, the block's filled cache); a ``dec`` block attends
    to ``memory``, the encoder's output."""
    def attn(p, x):
        h, (k, v) = gqa_apply(p["attn"], apply_norm(p["ln1"], x, cfg), ctx, cfg,
                              causal=True, return_kv=True)
        x = x + h
        x = x + mlp_apply(p["mlp"], apply_norm(p["ln2"], x, cfg), ctx, cfg)
        init = gqa_init_cache(cfg, ctx, batch, max_len, device=x.device)
        return x, gqa_fill_cache(init, k, v, ctx)

    def attn_window(p, x):
        h, (k, v) = gqa_apply(p["attn"], apply_norm(p["ln1"], x, cfg), ctx, cfg,
                              causal=True, window=cfg.window, return_kv=True)
        x = x + h
        x = x + mlp_apply(p["mlp"], apply_norm(p["ln2"], x, cfg), ctx, cfg)
        return x, local_fill_cache(None, k, v, cfg)

    def mla_dense(p, x):
        h, (c_kv, k_rope) = mla_apply(p["attn"], apply_norm(p["ln1"], x, cfg), ctx, cfg,
                                      return_latent=True)
        x = x + h
        x = x + mlp_apply(p["mlp"], apply_norm(p["ln2"], x, cfg), ctx, cfg)
        init = mla_init_cache(cfg, ctx, batch, max_len, device=x.device)
        return x, mla_fill_cache(init, c_kv, k_rope, ctx)

    def mla_moe(p, x):
        h, (c_kv, k_rope) = mla_apply(p["attn"], apply_norm(p["ln1"], x, cfg), ctx, cfg,
                                      return_latent=True)
        x = x + h
        y, _ = moe_apply(p["moe"], apply_norm(p["ln2"], x, cfg), ctx, cfg, 1)
        init = mla_init_cache(cfg, ctx, batch, max_len, device=x.device)
        return x + y, mla_fill_cache(init, c_kv, k_rope, ctx)

    def ssm(p, x):
        h, state = ssm_apply(p["ssm"], apply_norm(p["ln1"], x, cfg), ctx, cfg,
                             return_state=True)
        return x + h, state

    def rglru(p, x):
        h, state = rglru_apply(p["rec"], apply_norm(p["ln1"], x, cfg), ctx, cfg,
                               return_state=True)
        x = x + h
        x = x + mlp_apply(p["mlp"], apply_norm(p["ln2"], x, cfg), ctx, cfg)
        return x, state

    def dec(p, x):
        h, (k, v) = gqa_apply(p["attn"], apply_norm(p["ln1"], x, cfg), ctx, cfg,
                              causal=True, return_kv=True)
        x = x + h
        x = x + gqa_apply(p["cross"], apply_norm(p["lnx"], x, cfg), ctx, cfg,
                          causal=False, memory=memory)
        x = x + mlp_apply(p["mlp"], apply_norm(p["ln2"], x, cfg), ctx, cfg)
        init = gqa_init_cache(cfg, ctx, batch, max_len, device=x.device)
        return x, {"self": gqa_fill_cache(init, k, v, ctx),
                   "cross": cross_fill_cache(p["cross"], memory, cfg, ctx)}

    if kind == "hybrid_period":
        fns = [_prefill_block(cfg, ctx, hybrid_kind(k), batch, max_len) for k in cfg.pattern]

        def period(p, x):
            cc = {}
            for i, f in enumerate(fns):
                x, cc[f"b{i}"] = f(p[f"b{i}"], x)
            return x, cc

        return period
    return {"attn": attn, "attn_window": attn_window, "mla_dense": mla_dense,
            "mla_moe": mla_moe, "ssm": ssm, "rglru": rglru, "dec": dec}[kind]


def _decode_block(cfg, ctx, kind):
    """f(params, x, cache) -> (x, the block's next cache)."""
    def attn(p, x, c):
        h, c2 = gqa_decode(p["attn"], apply_norm(p["ln1"], x, cfg), c, ctx, cfg)
        x = x + h
        x = x + mlp_decode(p["mlp"], apply_norm(p["ln2"], x, cfg), ctx, cfg)
        return x, c2

    def attn_window(p, x, c):
        h, c2 = local_decode(p["attn"], apply_norm(p["ln1"], x, cfg), c, ctx, cfg)
        x = x + h
        x = x + mlp_decode(p["mlp"], apply_norm(p["ln2"], x, cfg), ctx, cfg)
        return x, c2

    def mla_dense(p, x, c):
        h, c2 = mla_decode(p["attn"], apply_norm(p["ln1"], x, cfg), c, ctx, cfg)
        x = x + h
        x = x + mlp_decode(p["mlp"], apply_norm(p["ln2"], x, cfg), ctx, cfg)
        return x, c2

    def mla_moe(p, x, c):
        h, c2 = mla_decode(p["attn"], apply_norm(p["ln1"], x, cfg), c, ctx, cfg)
        x = x + h
        y, _ = moe_decode(p["moe"], apply_norm(p["ln2"], x, cfg), ctx, cfg, 1)
        return x + y, c2

    def ssm(p, x, c):
        h, c2 = ssm_decode(p["ssm"], apply_norm(p["ln1"], x, cfg), c, ctx, cfg)
        return x + h, c2

    def rglru(p, x, c):
        h, c2 = rglru_decode(p["rec"], apply_norm(p["ln1"], x, cfg), c, ctx, cfg)
        x = x + h
        x = x + mlp_decode(p["mlp"], apply_norm(p["ln2"], x, cfg), ctx, cfg)
        return x, c2

    def dec(p, x, c):
        h, c2self = gqa_decode(p["attn"], apply_norm(p["ln1"], x, cfg), c["self"], ctx, cfg)
        x = x + h
        x = x + cross_decode(p["cross"], apply_norm(p["lnx"], x, cfg), c["cross"], ctx, cfg)
        x = x + mlp_decode(p["mlp"], apply_norm(p["ln2"], x, cfg), ctx, cfg)
        return x, {"self": c2self, "cross": c["cross"]}     # the cross cache as it was

    if kind == "hybrid_period":
        fns = [_decode_block(cfg, ctx, hybrid_kind(k)) for k in cfg.pattern]

        def period(p, x, c):
            cc = {}
            for i, f in enumerate(fns):
                x, cc[f"b{i}"] = f(p[f"b{i}"], x, c[f"b{i}"])
            return x, cc

        return period
    return {"attn": attn, "attn_window": attn_window, "mla_dense": mla_dense,
            "mla_moe": mla_moe, "ssm": ssm, "rglru": rglru, "dec": dec}[kind]


# ---------------------------------------------------------------------------
# live caches: stacked storage, layer views, write-back
# ---------------------------------------------------------------------------


def _stacked_like(c: dict, count: int) -> dict:
    """Uninitialised storage for ``count`` layers' caches shaped like ``c``."""
    return {k: _stacked_like(v, count) if isinstance(v, dict) else (
        v if isinstance(v, int) else v.new_empty((count,) + tuple(v.shape)))
        for k, v in c.items()}


def _layer_view(c: dict, i: int | None) -> dict:
    """Layer ``i``'s cache: views of stacked leaves (``i`` None: ``c``'s own)."""
    return {k: _layer_view(v, i) if isinstance(v, dict) else (
        v if isinstance(v, int) or i is None else v[i]) for k, v in c.items()}


def _write(dst: dict, new: dict, i: int | None) -> None:
    """Store a block's returned cache into layer ``i`` of ``dst``; a leaf the
    block updated in place is not copied."""
    for k, v in new.items():
        if isinstance(v, dict):
            _write(dst[k], v, i)
        elif isinstance(v, int):
            dst[k] = v
        else:
            d = dst[k] if i is None else dst[k][i]
            if d.data_ptr() != v.data_ptr():
                d.copy_(v)


def _layer_slots(group: dict, count: int, scanned: bool) -> list:
    """(tree, index) of each layer's cache within a group."""
    if scanned:
        return [(group, i) for i in range(count)]
    return [(group, None)] if count == 1 else [(group[f"l{i}"], None) for i in range(count)]


# ---------------------------------------------------------------------------
# step factories
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ServeBundle:
    prefill: Callable
    decode: Callable
    param_spec: dict          # P tree of the parameters
    cache_pspec: dict         # P tree of the caches (``cache_spec``)
    batch_ax: object          # mesh axes the batch is sharded over (``batch_axes``)
    ctx: MeshCtx


def make_serve_fns(cfg: ModelConfig, mesh, *, batch: int, max_len: int,
                   enc_len: int = 1536) -> ServeBundle:
    """``prefill(params, inputs) -> (caches, token (B,))`` and
    ``decode(params, caches, tokens (B, 1)) -> (token (B,), caches)``, with
    the reference's semantics, on the tensors' device (the mesh's).
    ``inputs`` holds ``"tokens"`` (B, T) int, and ``"enc"`` (B, enc_len, d)
    for an encoder-decoder, and may hold ``"frontend"`` (B, T, d)
    (``backbone.embed_inputs``).  Prefill raises ``ValueError`` where
    ``"enc"`` or ``"frontend"`` has another leading shape."""
    ctx = mesh_ctx(mesh)
    spec = model_spec(cfg, ctx)
    c_spec = cache_spec(cfg, mesh, batch, max_len, enc_len)
    groups = [(f"g{gi}", kind, count, scanned)
              for gi, (kind, count, scanned) in enumerate(layer_plan(cfg)) if count]
    decode_fns = {name: _decode_block(cfg, ctx, kind) for name, kind, _, _ in groups}

    def prefill(params, inputs):
        tokens = inputs["tokens"]                       # (B, T)
        x = embed_inputs(params["embed"], tokens, ctx, cfg, inputs.get("frontend"))
        memory = None
        if cfg.family == "encdec":
            enc = inputs["enc"]
            if tuple(enc.shape[:2]) != (tokens.shape[0], enc_len):
                raise ValueError(f"enc of shape {tuple(enc.shape)}: expected "
                                 f"({tokens.shape[0]}, {enc_len}, d), enc_len {enc_len}")
            memory = encode(params, enc, ctx, cfg)      # once, for every dec block
        caches = {}
        for name, kind, count, scanned in groups:
            fn = _prefill_block(cfg, ctx, kind, batch, max_len, memory=memory)
            filled = []
            for j, p in enumerate(group_layers(params[name], count, scanned)):
                x, c = fn(p, x)
                if scanned:                             # stack as the reference's scan does
                    if j == 0:
                        stacked = _stacked_like(c, count)
                    _write(stacked, c, j)
                else:
                    filled.append(c)
            caches[name] = stacked if scanned else (
                filled[0] if count == 1 else {f"l{j}": c for j, c in enumerate(filled)})
        x = apply_norm(params["final_norm"], x, cfg)
        return caches, greedy_token(params["embed"], x[:, -1:], ctx, cfg)

    def decode(params, caches, tokens):
        x = embed_tokens(params["embed"], tokens, ctx, cfg)     # (B, 1, d)
        for name, _kind, count, scanned in groups:
            layers = group_layers(params[name], count, scanned)
            slots = _layer_slots(caches[name], count, scanned)
            # every view before any write: a stacked group keeps one "len"
            views = [_layer_view(tree, i) for tree, i in slots]
            for p, view, (tree, i) in zip(layers, views, slots):
                x, c2 = decode_fns[name](p, x, view)
                _write(tree, c2, i)
        x = apply_norm(params["final_norm"], x, cfg)
        return greedy_token(params["embed"], x, ctx, cfg), caches

    return ServeBundle(prefill=prefill, decode=decode, param_spec=spec, cache_pspec=c_spec,
                       batch_ax=batch_axes(mesh, batch), ctx=ctx)
