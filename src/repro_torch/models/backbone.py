"""Model assembly on one card: embeddings, blocks, the layer stack.

The parameter tree is the reference's (``repro.models.backbone``): the same
keys, and each scanned group's leaves stacked on a leading layer axis.  The
reference scans that axis with ``lax.scan``; the port loops over it in
Python, taking each layer's views of the stacked tensors.

Unscanned groups are as in the reference: a group of one layer holds
that layer's tree, a group of several holds ``l0``, ``l1``, ….

Families served so far: ``dense`` and ``vlm`` (one stacked group of
``attn`` blocks), ``hybrid`` (stacked periods of ``rglru`` and
``attn_window`` blocks, then one unscanned group a remaining layer),
``ssm`` (one stacked group of ``ssm`` blocks), ``moe`` (an unscanned
group of ``n_dense_layers`` ``mla_dense`` blocks, then a stacked group of
``mla_moe`` blocks) and ``encdec`` (one stacked group of ``dec`` blocks:
self attention, cross attention over the encoder's memory, MLP; the
encoder is the stacked non-causal ``attn`` blocks under ``"enc"``).  Every
config of ``repro_torch.configs`` has a plan.  The two stub frontends are
inputs beside the tokens, as in the reference: ``audio_stub`` feeds the
encoder precomputed frame embeddings (``enc_embeds``), ``patch_stub``
replaces the embedding at every position whose token is below 0
(``frontend``).  ``forward`` returns the hidden states only; the MoE
blocks' aux loss stays reachable through ``ffn.moe_apply``.
"""
from __future__ import annotations

import torch

from .attention import gqa_apply, gqa_spec, mla_apply, mla_spec
from .config import ModelConfig
from .ffn import mlp_apply, mlp_spec, moe_apply, moe_spec
from .layers import MeshCtx, apply_norm, matmul, norm_spec, pad_to
from .rglru import rglru_apply, rglru_spec
from .spec import P, stack_layers, tree_map
from .ssm import ssm_apply, ssm_spec


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


def embed_inputs(p, tokens, ctx: MeshCtx, cfg: ModelConfig, frontend=None):
    """The embeddings of tokens (B, T): negative ids embed as id 0, as the
    reference's ``jnp.maximum(tokens, 0)``, and with ``frontend`` (B, T, d)
    its rows replace them where the token is below 0.  Raises
    ``ValueError`` where ``frontend``'s leading shape is not the tokens'."""
    x = embed_tokens(p, tokens.clamp(min=0), ctx, cfg)
    if frontend is None:
        return x
    if tuple(frontend.shape[:2]) != tuple(tokens.shape):
        raise ValueError(f"frontend of shape {tuple(frontend.shape)} for tokens of "
                         f"shape {tuple(tokens.shape)}")
    return torch.where((tokens < 0)[..., None], frontend.to(x.dtype), x)


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
    if kind in ("attn", "attn_window"):
        return {"ln1": norm_spec(cfg), "attn": gqa_spec(cfg, ctx), "ln2": norm_spec(cfg),
                "mlp": mlp_spec(cfg)}
    if kind == "mla_dense":
        return {"ln1": norm_spec(cfg), "attn": mla_spec(cfg, ctx), "ln2": norm_spec(cfg),
                "mlp": mlp_spec(cfg)}
    if kind == "mla_moe":
        return {"ln1": norm_spec(cfg), "attn": mla_spec(cfg, ctx), "ln2": norm_spec(cfg),
                "moe": moe_spec(cfg, ctx)}
    if kind == "ssm":
        return {"ln1": norm_spec(cfg), "ssm": ssm_spec(cfg, ctx)}
    if kind == "rglru":
        return {"ln1": norm_spec(cfg), "rec": rglru_spec(cfg, ctx), "ln2": norm_spec(cfg),
                "mlp": mlp_spec(cfg)}
    if kind == "dec":  # enc-dec decoder block: self attention, cross attention, MLP
        return {"ln1": norm_spec(cfg), "attn": gqa_spec(cfg, ctx), "lnx": norm_spec(cfg),
                "cross": gqa_spec(cfg, ctx), "ln2": norm_spec(cfg), "mlp": mlp_spec(cfg)}
    raise ValueError(kind)


def make_block_fn(cfg: ModelConfig, ctx: MeshCtx, kind: str, *, memory=None,
                  causal: bool = True):
    """Returns f(params, x) -> x for train / prefill; a ``dec`` block attends
    to ``memory`` (B, Tm, d), the encoder's output."""

    def attn_block(p, x):
        w = cfg.window if kind == "attn_window" else None
        x = x + gqa_apply(p["attn"], apply_norm(p["ln1"], x, cfg), ctx, cfg, causal=causal,
                          window=w)
        return x + mlp_apply(p["mlp"], apply_norm(p["ln2"], x, cfg), ctx, cfg)

    def dec_block(p, x):
        x = x + gqa_apply(p["attn"], apply_norm(p["ln1"], x, cfg), ctx, cfg)
        x = x + gqa_apply(p["cross"], apply_norm(p["lnx"], x, cfg), ctx, cfg, causal=False,
                          memory=memory)
        return x + mlp_apply(p["mlp"], apply_norm(p["ln2"], x, cfg), ctx, cfg)

    def mla_dense_block(p, x):
        x = x + mla_apply(p["attn"], apply_norm(p["ln1"], x, cfg), ctx, cfg)
        return x + mlp_apply(p["mlp"], apply_norm(p["ln2"], x, cfg), ctx, cfg)

    def mla_moe_block(p, x):
        x = x + mla_apply(p["attn"], apply_norm(p["ln1"], x, cfg), ctx, cfg)
        y, _aux = moe_apply(p["moe"], apply_norm(p["ln2"], x, cfg), ctx, cfg, 1)
        return x + y

    def ssm_block(p, x):
        return x + ssm_apply(p["ssm"], apply_norm(p["ln1"], x, cfg), ctx, cfg)

    def rglru_block(p, x):
        x = x + rglru_apply(p["rec"], apply_norm(p["ln1"], x, cfg), ctx, cfg)
        return x + mlp_apply(p["mlp"], apply_norm(p["ln2"], x, cfg), ctx, cfg)

    return {"attn": attn_block, "attn_window": attn_block, "mla_dense": mla_dense_block,
            "mla_moe": mla_moe_block, "ssm": ssm_block, "rglru": rglru_block,
            "dec": dec_block}[kind]


# --------------------------------------------------------------------------
# layer plans per family
# --------------------------------------------------------------------------


def hybrid_kind(k: str) -> str:
    """The block kind of a hybrid pattern entry."""
    return "rglru" if k == "rglru" else "attn_window"


def layer_plan(cfg: ModelConfig):
    """[(kind, count, scanned)] — scanned groups share stacked params."""
    if cfg.family in ("dense", "vlm"):
        return [("attn", cfg.n_layers, True)]
    if cfg.family == "moe":
        return [("mla_dense", cfg.n_dense_layers, False),
                ("mla_moe", cfg.n_layers - cfg.n_dense_layers, True)]
    if cfg.family == "ssm":
        return [("ssm", cfg.n_layers, True)]
    if cfg.family == "hybrid":
        period = len(cfg.pattern)
        full = cfg.n_layers // period
        rem = cfg.n_layers - full * period
        return [("hybrid_period", full, True)] + [
            (hybrid_kind(cfg.pattern[i]), 1, False) for i in range(rem)]
    if cfg.family == "encdec":
        return [("dec", cfg.n_layers, True)]
    raise ValueError(cfg.family)


def hybrid_period_spec(cfg: ModelConfig, ctx: MeshCtx) -> dict:
    return {f"b{i}": block_spec(cfg, ctx, hybrid_kind(k)) for i, k in enumerate(cfg.pattern)}


def model_spec(cfg: ModelConfig, ctx: MeshCtx) -> dict:
    spec = {"embed": embed_spec(cfg), "final_norm": norm_spec(cfg)}
    for gi, (kind, count, scanned) in enumerate(layer_plan(cfg)):
        if count == 0:
            continue
        base = (hybrid_period_spec(cfg, ctx) if kind == "hybrid_period"
                else block_spec(cfg, ctx, kind))
        spec[f"g{gi}"] = stack_layers(base, count) if scanned else (
            {f"l{i}": base for i in range(count)} if count > 1 else base)
    if cfg.family == "encdec":
        spec["enc"] = {"layers": stack_layers(block_spec(cfg, ctx, "attn"), cfg.n_enc_layers),
                       "norm": norm_spec(cfg)}
    return spec


def layer_params(stacked, i: int):
    """Layer ``i``'s parameters: views of a stacked group's leaves."""
    return tree_map(lambda t: t[i], stacked)


def group_layers(group, count: int, scanned: bool) -> list:
    """Each layer's parameter tree of a group: views of a scanned group's
    stacked leaves, or an unscanned group's own trees."""
    if scanned:
        return [layer_params(group, i) for i in range(count)]
    return [group] if count == 1 else [group[f"l{i}"] for i in range(count)]


def period_fn(fns):
    """One hybrid period: the blocks ``fns`` in turn over ``b0``, ``b1``, …"""
    def run(p, x):
        for i, f in enumerate(fns):
            x = f(p[f"b{i}"], x)
        return x

    return run


def encode(params, enc_embeds, ctx: MeshCtx, cfg: ModelConfig):
    """The encoder over stub frame embeddings (B, Te, d) -> memory (B, Te, d):
    the frames cast to the parameters' dtype, non-causal ``attn`` blocks
    (rope over the frame positions), then the encoder's own norm."""
    fn = make_block_fn(cfg, ctx, "attn", causal=False)
    x = enc_embeds.to(params["enc"]["norm"]["scale"].dtype)
    for p in group_layers(params["enc"]["layers"], cfg.n_enc_layers, True):
        x = fn(p, x)
    return apply_norm(params["enc"]["norm"], x, cfg)


def forward(params, tokens, ctx: MeshCtx, cfg: ModelConfig, *, frontend=None,
            enc_embeds=None):
    """Forward to the final norm: tokens (B, T) -> (B, T, d), no cache.
    ``frontend`` (B, T, d) and ``enc_embeds`` (B, Te, d) are the stub
    frontends' inputs (``embed_inputs``, ``encode``); an encoder-decoder
    needs ``enc_embeds``."""
    x = embed_inputs(params["embed"], tokens, ctx, cfg, frontend)
    memory = encode(params, enc_embeds, ctx, cfg) if cfg.family == "encdec" else None
    for gi, (kind, count, scanned) in enumerate(layer_plan(cfg)):
        if count == 0:
            continue
        if kind == "hybrid_period":
            fn = period_fn([make_block_fn(cfg, ctx, hybrid_kind(k)) for k in cfg.pattern])
        else:
            fn = make_block_fn(cfg, ctx, kind, memory=memory)
        for p in group_layers(params[f"g{gi}"], count, scanned):
            x = fn(p, x)
    return apply_norm(params["final_norm"], x, cfg)
