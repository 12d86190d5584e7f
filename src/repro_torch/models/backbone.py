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
(``frontend``).  ``forward`` returns the hidden states; with
``with_aux=True`` (training) also the MoE blocks' summed aux loss, as the
reference's ``(x, aux)``.  With ``remat`` (the default, as the reference's
``jax.checkpoint`` of each layer) and autograd recording, each layer runs
under ``torch.utils.checkpoint`` and is recomputed in the backward
(serving records nothing, so it runs the layers as they are).

``ce_loss`` is the reference's chunked cross-entropy with one deliberate
difference: the reference scans ``T // t_chunk`` whole chunks and so
leaves the last ``T % t_chunk`` positions of a longer sequence out of the
sum and the count; the port takes a last, partial chunk and counts every
position.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .attention import gqa_apply, gqa_spec, mla_apply, mla_spec
from .config import ModelConfig
from .ffn import mlp_apply, mlp_spec, moe_apply, moe_spec
from .layers import MeshCtx, ag_seq, apply_norm, matmul, norm_spec, pad_to
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


def _chunk_nll(xs, ys, w, cfg: ModelConfig):
    """Summed negative log-likelihood and count of valid labels of one
    chunk: xs (B, c, d) final-norm states, ys (B, c) labels (negative ones
    do not count).  The row max is a constant shift (detached, as the
    reference's ``stop_gradient``)."""
    vl = vocab_pad(cfg)
    logits = matmul(xs, w).float()
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    logits = _mask_vocab_pad(logits, 0, cfg)
    m = logits.detach().amax(-1)
    se = torch.exp(logits - m[..., None]).sum(-1)
    valid = ys >= 0
    loc = torch.where(valid, ys, 0).long()
    ok = (loc >= 0) & (loc < vl)
    lab = torch.gather(logits, -1, loc.clamp(0, vl - 1)[..., None])[..., 0]
    lab = torch.where(ok, lab, 0.0)
    nll = torch.where(valid, (torch.log(se) + m) - lab, 0.0)
    return nll.sum(), valid.sum()


def ce_loss(p, x_sp, targets, ctx: MeshCtx, cfg: ModelConfig, t_chunk: int = 512):
    """Mean cross-entropy of final-norm states x (B, T, d) against targets
    (B, T), chunked over T: float32 logits of ``t_chunk`` positions at a
    time, the last chunk partial where ``t_chunk`` does not divide T.  With
    autograd recording each chunk's logits are recomputed in the backward,
    not kept (at qwen2's vocab a chunk of 4 x 512 is 1.24 GB)."""
    xg = ag_seq(x_sp, ctx)
    T = xg.shape[1]
    w = _unembed_weight(p, cfg)
    t_chunk = min(t_chunk, T)
    total = torch.zeros((), dtype=torch.float32, device=xg.device)
    cnt = torch.zeros((), dtype=torch.int64, device=xg.device)
    for lo in range(0, T, t_chunk):
        xs, ys = xg[:, lo:lo + t_chunk], targets[:, lo:lo + t_chunk]
        if _records(xs, w):
            nll, n = checkpoint(_chunk_nll, xs, ys, w, cfg, use_reentrant=False)
        else:
            nll, n = _chunk_nll(xs, ys, w, cfg)
        total = total + nll
        cnt = cnt + n
    return total / torch.clamp(cnt, min=1).float()


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
                  causal: bool = True, with_aux: bool = False):
    """Returns f(params, x) -> x for train / prefill; with ``with_aux``
    f(params, x) -> (x, aux), aux the MoE block's aux loss and ``None`` for
    every other kind.  A ``dec`` block attends to ``memory`` (B, Tm, d), the
    encoder's output."""

    def attn_block(p, x):
        w = cfg.window if kind == "attn_window" else None
        x = x + gqa_apply(p["attn"], apply_norm(p["ln1"], x, cfg), ctx, cfg, causal=causal,
                          window=w)
        return x + mlp_apply(p["mlp"], apply_norm(p["ln2"], x, cfg), ctx, cfg), None

    def dec_block(p, x):
        x = x + gqa_apply(p["attn"], apply_norm(p["ln1"], x, cfg), ctx, cfg)
        x = x + gqa_apply(p["cross"], apply_norm(p["lnx"], x, cfg), ctx, cfg, causal=False,
                          memory=memory)
        return x + mlp_apply(p["mlp"], apply_norm(p["ln2"], x, cfg), ctx, cfg), None

    def mla_dense_block(p, x):
        x = x + mla_apply(p["attn"], apply_norm(p["ln1"], x, cfg), ctx, cfg)
        return x + mlp_apply(p["mlp"], apply_norm(p["ln2"], x, cfg), ctx, cfg), None

    def mla_moe_block(p, x):
        x = x + mla_apply(p["attn"], apply_norm(p["ln1"], x, cfg), ctx, cfg)
        y, aux = moe_apply(p["moe"], apply_norm(p["ln2"], x, cfg), ctx, cfg, 1)
        return x + y, aux

    def ssm_block(p, x):
        return x + ssm_apply(p["ssm"], apply_norm(p["ln1"], x, cfg), ctx, cfg), None

    def rglru_block(p, x):
        x = x + rglru_apply(p["rec"], apply_norm(p["ln1"], x, cfg), ctx, cfg)
        return x + mlp_apply(p["mlp"], apply_norm(p["ln2"], x, cfg), ctx, cfg), None

    fn = {"attn": attn_block, "attn_window": attn_block, "mla_dense": mla_dense_block,
          "mla_moe": mla_moe_block, "ssm": ssm_block, "rglru": rglru_block,
          "dec": dec_block}[kind]
    return fn if with_aux else (lambda p, x: fn(p, x)[0])


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


def _unbind_tree(stacked, count: int) -> list:
    """Every layer's tree of a stacked group from one ``torch.unbind`` a
    leaf: one autograd node a leaf, whose backward stacks the layers'
    gradients (``t[i]`` a layer would add a zero-filled gradient of the
    whole stacked leaf for each layer)."""
    if isinstance(stacked, dict):
        parts = {k: _unbind_tree(v, count) for k, v in stacked.items()}
        return [{k: parts[k][i] for k in stacked} for i in range(count)]
    return list(torch.unbind(stacked))


def group_layers(group, count: int, scanned: bool) -> list:
    """Each layer's parameter tree of a group: views of a scanned group's
    stacked leaves (``_unbind_tree``), or an unscanned group's own trees."""
    if scanned:
        return _unbind_tree(group, count)
    return [group] if count == 1 else [group[f"l{i}"] for i in range(count)]


def period_fn(fns):
    """One hybrid period: the blocks ``fns`` (``with_aux`` ones) in turn over
    ``b0``, ``b1``, … -> (x, None)."""
    def run(p, x):
        for i, f in enumerate(fns):
            x, _ = f(p[f"b{i}"], x)
        return x, None

    return run


def _records(*trees) -> bool:
    """Whether autograd records a function of these tensors (trees)."""
    if not torch.is_grad_enabled():
        return False
    found = []
    for t in trees:
        tree_map(lambda a: found.append(a.requires_grad), t)
    return any(found)


def _run_layers(fn, layers, x, aux, remat: bool):
    """x through ``fn`` (-> (x, aux or None)) over each layer's tree, each
    layer recomputed in the backward under ``remat`` where autograd records
    it; the layers' aux losses summed onto ``aux``."""
    for p in layers:
        if remat and _records(x, p):
            x, a = checkpoint(fn, p, x, use_reentrant=False)
        else:
            x, a = fn(p, x)
        if a is not None:
            aux = aux + a
    return x, aux


def encode(params, enc_embeds, ctx: MeshCtx, cfg: ModelConfig, remat: bool = True):
    """The encoder over stub frame embeddings (B, Te, d) -> memory (B, Te, d):
    the frames cast to the parameters' dtype, non-causal ``attn`` blocks
    (rope over the frame positions), then the encoder's own norm."""
    fn = make_block_fn(cfg, ctx, "attn", causal=False, with_aux=True)
    x = enc_embeds.to(params["enc"]["norm"]["scale"].dtype)
    x, _ = _run_layers(fn, group_layers(params["enc"]["layers"], cfg.n_enc_layers, True), x,
                       None, remat)
    return apply_norm(params["enc"]["norm"], x, cfg)


def forward(params, tokens, ctx: MeshCtx, cfg: ModelConfig, *, frontend=None,
            enc_embeds=None, remat: bool = True, with_aux: bool = False):
    """Forward to the final norm: tokens (B, T) -> (B, T, d), no cache; with
    ``with_aux`` -> (x, aux), aux the float32 sum of the MoE blocks' aux
    losses (0 for other families).  ``frontend`` (B, T, d) and
    ``enc_embeds`` (B, Te, d) are the stub frontends' inputs
    (``embed_inputs``, ``encode``); an encoder-decoder needs ``enc_embeds``.
    ``remat`` recomputes each layer in the backward (only while autograd
    records)."""
    x = embed_inputs(params["embed"], tokens, ctx, cfg, frontend)
    memory = (encode(params, enc_embeds, ctx, cfg, remat) if cfg.family == "encdec"
              else None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for gi, (kind, count, scanned) in enumerate(layer_plan(cfg)):
        if count == 0:
            continue
        if kind == "hybrid_period":
            fn = period_fn([make_block_fn(cfg, ctx, hybrid_kind(k), with_aux=True)
                            for k in cfg.pattern])
        else:
            fn = make_block_fn(cfg, ctx, kind, memory=memory, with_aux=True)
        x, aux = _run_layers(fn, group_layers(params[f"g{gi}"], count, scanned), x, aux,
                             remat)
    x = apply_norm(params["final_norm"], x, cfg)
    return (x, aux) if with_aux else x
