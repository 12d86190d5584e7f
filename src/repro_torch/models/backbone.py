"""Model assembly on one card: embeddings, blocks, the layer stack.

The parameter tree is the reference's (``repro.models.backbone``): the same
keys, and each scanned group's leaves stacked on a leading layer axis.  The
reference scans that axis with ``lax.scan``; the port loops over it in
Python, taking each layer's views of the stacked tensors.

Families served so far: ``dense`` and ``vlm`` (one stacked group of ``attn``
blocks).  ``layer_plan`` raises for the others until their slices
(ROADMAP Queue A): hybrid (RG-LRU + local attention), ssm, moe (MLA + MoE),
encdec.
"""
from __future__ import annotations

import torch

from .attention import gqa_apply, gqa_spec
from .config import ModelConfig
from .ffn import mlp_apply, mlp_spec
from .layers import MeshCtx, apply_norm, matmul, norm_spec, pad_to
from .spec import P, stack_layers, tree_map


def vocab_pad(cfg: ModelConfig) -> int:
    return pad_to(cfg.vocab, 16)


# --------------------------------------------------------------------------
# embedding & logits
# --------------------------------------------------------------------------


def embed_spec(cfg: ModelConfig) -> dict:
    v, d = vocab_pad(cfg), cfg.d_model
    spec = {"tok": P((v, d), ("model", None), scale=0.02)}
    if not cfg.tie_embeddings:
        spec["unembed"] = P((d, v), (None, "model"), scale=0.02)
    return spec


def embed_tokens(p, tokens, ctx: MeshCtx, cfg: ModelConfig):
    """Embedding lookup: ids outside the (padded) vocab embed to zeros, as
    the reference's vocab-parallel lookup does."""
    v = vocab_pad(cfg)
    vl = v // ctx.model_size
    loc = tokens.long()
    ok = (loc >= 0) & (loc < vl)
    emb = p["tok"][loc.clamp(0, vl - 1)]
    emb = torch.where(ok[..., None], emb, 0.0)
    return emb.to(p["tok"].dtype)  # activation dtype follows the params


def _unembed_weight(p, cfg: ModelConfig):
    return p["tok"].T if cfg.tie_embeddings else p["unembed"]


def _mask_vocab_pad(logits, v0, cfg: ModelConfig):
    """-1e30 on the vocab-padding columns so they never win an argmax."""
    v = vocab_pad(cfg)
    if v == cfg.vocab:
        return logits
    gcol = v0 + torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(gcol < cfg.vocab, logits, -1e30)


def vocab_logits(p, x, ctx: MeshCtx, cfg: ModelConfig):
    """float32 logits of final-norm states x (..., d), padding columns
    masked: what ``greedy_token`` takes the argmax of."""
    logits = matmul(x, _unembed_weight(p, cfg)).float()
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return _mask_vocab_pad(logits, 0, cfg)


def greedy_token(p, x, ctx: MeshCtx, cfg: ModelConfig):
    """Argmax over the vocab; x (B, 1, d) -> (B,) int32.  Ties go to the
    first maximum, as ``jnp.argmax``'s do."""
    return vocab_logits(p, x[:, 0], ctx, cfg).argmax(-1).to(torch.int32)


# --------------------------------------------------------------------------
# block kinds
# --------------------------------------------------------------------------


def block_spec(cfg: ModelConfig, ctx: MeshCtx, kind: str) -> dict:
    if kind == "attn":
        return {"ln1": norm_spec(cfg), "attn": gqa_spec(cfg, ctx), "ln2": norm_spec(cfg),
                "mlp": mlp_spec(cfg)}
    raise NotImplementedError(f"block kind {kind!r}: a later slice (ROADMAP Queue A)")


def make_block_fn(cfg: ModelConfig, ctx: MeshCtx, kind: str, *, causal: bool = True):
    """Returns f(params, x) -> x for train / prefill."""
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r}: a later slice (ROADMAP Queue A)")

    def attn_block(p, x):
        x = x + gqa_apply(p["attn"], apply_norm(p["ln1"], x, cfg), ctx, cfg, causal=causal)
        return x + mlp_apply(p["mlp"], apply_norm(p["ln2"], x, cfg), ctx, cfg)

    return attn_block


# --------------------------------------------------------------------------
# layer plans per family
# --------------------------------------------------------------------------


def layer_plan(cfg: ModelConfig):
    """[(kind, count, scanned)] — scanned groups share stacked params."""
    if cfg.family in ("dense", "vlm"):
        return [("attn", cfg.n_layers, True)]
    raise NotImplementedError(
        f"family {cfg.family!r} ({cfg.name}): a later slice of ROADMAP Queue A item 15")


def model_spec(cfg: ModelConfig, ctx: MeshCtx) -> dict:
    spec = {"embed": embed_spec(cfg), "final_norm": norm_spec(cfg)}
    for gi, (kind, count, _scanned) in enumerate(layer_plan(cfg)):
        spec[f"g{gi}"] = stack_layers(block_spec(cfg, ctx, kind), count)
    return spec


def layer_params(stacked, i: int):
    """Layer ``i``'s parameters: views of a stacked group's leaves."""
    return tree_map(lambda t: t[i], stacked)


def forward(params, tokens, ctx: MeshCtx, cfg: ModelConfig):
    """Forward to the final norm: tokens (B, T) -> (B, T, d), no cache.
    Negative ids embed as id 0, as the reference's ``jnp.maximum(tokens, 0)``."""
    x = embed_tokens(params["embed"], tokens.clamp(min=0), ctx, cfg)
    for gi, (kind, count, _scanned) in enumerate(layer_plan(cfg)):
        fn = make_block_fn(cfg, ctx, kind)
        for i in range(count):
            x = fn(layer_params(params[f"g{gi}"], i), x)
    return apply_norm(params["final_norm"], x, cfg)
