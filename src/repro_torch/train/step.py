"""Training-step factory on one card, and the mesh helpers the serving
engine shares.

``make_train_step(cfg, mesh, opt_cfg, batch=...)`` returns a ``TrainBundle``
whose ``step(params, opt_state, batch) -> (params, opt_state, metrics)``
is the reference's (``repro.train.step``): the objective
``(ce + aux_coef · aux) / (world · microbatch)``, gradients by autograd
over every parameter leaf (``torch.autograd.grad``), microbatches
accumulated in a float32 accumulator a leaf, optional error-feedback top-k
compression, then AdamW.  The reference donates ``(params, opt_state)`` to
its jitted step; the port updates both in place and returns the same
trees (at qwen2-1.5b's full width a second copy of the state would be
~50 GB), and frees each microbatch's gradients once they are accumulated.
Metrics are 0-d float32 tensors on the device: ``loss``, ``aux``,
``grad_norm``, ``lr``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.models.backbone import ce_loss, forward, model_spec
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MeshCtx
from repro_torch.models.spec import abstract_params, init_params
from repro_torch.optim import (
    OptConfig,
    apply_updates,
    build_plan,
    init_opt_state,
    opt_state_spec,
)
from repro_torch.optim.adamw import _flat_leaves
from repro_torch.optim.compression import (
    CompressionConfig,
    error_spec,
    init_error_state,
    sync_all,
)


def mesh_ctx(mesh) -> MeshCtx:
    names = mesh.axis_names
    return MeshCtx(
        model_size=mesh.shape["model"],
        data_axes=tuple(a for a in names if a != "model"),
        data_size=mesh.shape.get("data", 1),
    )


def mesh_sizes(mesh) -> dict:
    return {a: mesh.shape[a] for a in mesh.axis_names}


def batch_axes(mesh, batch: int):
    """Mesh axes to shard the batch dim over ('pod'+'data' when divisible)."""
    dp = tuple(a for a in mesh.axis_names if a != "model")
    world = int(np.prod([mesh.shape[a] for a in dp]))
    if batch % world == 0:
        return dp
    if "data" in dp and batch % mesh.shape["data"] == 0:
        return ("data",)
    return None  # replicate


@dataclass(frozen=True)
class TrainBundle:
    step: callable            # (params, opt, batch) -> (params, opt, metrics), in place
    grads: callable           # (params, batch) -> (grads tree, ce, aux): the step's first half
    update: callable          # (params, opt, grads, ce, aux) -> (params, opt, metrics)
    param_spec: dict          # P tree
    opt_spec: dict            # P tree
    ctx: MeshCtx
    plan: dict                # LeafPlan tree
    device: torch.device
    stats: dict = field(default_factory=dict)   # the last step's compression bytes

    def abstract_args(self, batch_shapes: dict):
        """``(params, opt_state, batch)`` as tensors on the ``meta`` device,
        from ``batch_shapes``' ``(shape, dtype)`` entries: nothing allocated."""
        return (
            abstract_params(self.param_spec),
            abstract_params(self.opt_spec),
            {k: torch.empty(shape, dtype=dtype, device="meta")
             for k, (shape, dtype) in batch_shapes.items()},
        )


def batch_pspec_tree(cfg: ModelConfig, mesh, batch: int) -> dict:
    """The logical sharding of each batch entry, as the reference's
    ``PartitionSpec``s (tuples of axis names): what the multi-card and
    dry-run slices of ROADMAP Queue A item 15 shard a batch by."""
    ba = batch_axes(mesh, batch)
    tree = {"tokens": (ba, "model"), "labels": (ba, None)}
    if cfg.family == "encdec":
        tree["enc"] = (ba, "model", None)
    if cfg.frontend == "patch_stub":
        tree["frontend"] = (ba, "model", None)
    return tree


def batch_shapes(cfg: ModelConfig, batch: int, seq: int, enc_len: int = 1536) -> dict:
    """``(shape, dtype)`` of each batch entry, the reference's abstract batch."""
    shapes = {
        "tokens": ((batch, seq), torch.int32),
        "labels": ((batch, seq), torch.int32),
    }
    if cfg.family == "encdec":
        shapes["enc"] = ((batch, enc_len, cfg.d_model), torch.bfloat16)
    if cfg.frontend == "patch_stub":
        shapes["frontend"] = ((batch, seq, cfg.d_model), torch.bfloat16)
    return shapes


def _unflatten(plan, values):
    """A tree shaped like the LeafPlan tree ``plan`` from its leaves' values
    in ``_flat_leaves`` order."""
    it = iter(values)

    def build(pl):
        if isinstance(pl, dict):
            return {k: build(pl[k]) for k in pl}
        return next(it)

    return build(plan)


def _on_device(batch_: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch_.items()}


def make_train_step(
    cfg: ModelConfig,
    mesh,
    opt_cfg: OptConfig,
    *,
    batch: int,
    aux_coef: float = 1e-3,
    remat: bool = True,
    microbatch: int = 1,
    compression: CompressionConfig | None = None,
) -> TrainBundle:
    """microbatch > 1 = gradient accumulation: the batch is processed in
    ``microbatch`` sequential slices (rows ``i·B/mb`` to ``(i+1)·B/mb``), each
    slice's gradients added into one float32 accumulator a leaf.
    compression = error-feedback top-k gradient compression
    (``repro_torch.optim.compression``)."""
    ctx = mesh_ctx(mesh)
    sizes = mesh_sizes(mesh)
    world = int(np.prod(list(sizes.values())))
    spec = model_spec(cfg, ctx)
    plan = build_plan(spec, mesh.axis_names, sizes, opt_cfg)
    o_spec = opt_state_spec(spec, plan, sizes, opt_cfg)
    ccfg = compression or CompressionConfig()
    if ccfg.enabled:
        o_spec["err"] = error_spec(spec, plan, ccfg)
    device = mesh.device
    stats: dict = {}

    def objective(params, mb):
        x, aux = forward(params, mb["tokens"], ctx, cfg, frontend=mb.get("frontend"),
                         enc_embeds=mb.get("enc"), remat=remat, with_aux=True)
        ce = ce_loss(params["embed"], x, mb["labels"], ctx, cfg)
        return (ce + aux_coef * aux) / (world * microbatch), ce, aux

    def grads_of(params, batch_):
        batch_ = _on_device(batch_, device)
        leaves = [x for _, (x,) in _flat_leaves(plan, [params], [])]
        was = [t.requires_grad for t in leaves]
        for t in leaves:
            t.requires_grad_(True)
        try:
            if microbatch == 1:
                obj, ce, aux = objective(params, batch_)
                gs = torch.autograd.grad(obj, leaves, allow_unused=True)
                gs = [torch.zeros_like(t) if g is None else g for g, t in zip(gs, leaves)]
                ce, aux = ce.detach(), aux.detach()
            else:
                gs = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                      for t in leaves]
                ce = torch.zeros((), dtype=torch.float32, device=device)
                aux = torch.zeros((), dtype=torch.float32, device=device)
                rows = next(iter(batch_.values())).shape[0] // microbatch
                for i in range(microbatch):
                    mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch_.items()}
                    obj, ce_i, aux_i = objective(params, mb)
                    g_i = torch.autograd.grad(obj, leaves, allow_unused=True)
                    with torch.no_grad():
                        for acc, g in zip(gs, g_i):
                            if g is not None:
                                acc.add_(g)
                    del g_i                      # this microbatch's gradients, freed
                    ce = ce + ce_i.detach() / microbatch
                    aux = aux + aux_i.detach() / microbatch
        finally:
            for t, w in zip(leaves, was):
                t.requires_grad_(w)
        return _unflatten(plan, gs), ce, aux

    def update(params, opt_state, grads, ce, aux):
        if ccfg.enabled:
            synced, new_err, ledger = sync_all(grads, opt_state["err"], plan, opt_cfg, ccfg)
            with torch.no_grad():
                for _, (e, ne) in _flat_leaves(plan, [opt_state["err"], new_err], []):
                    if ne is not e:
                        e.copy_(ne)
            stats["compression_bytes"] = ledger
            params, opt_state, om = apply_updates(synced, params, opt_state, plan, opt_cfg,
                                                  mesh.axis_names, presynced=True)
        else:
            params, opt_state, om = apply_updates(grads, params, opt_state, plan, opt_cfg,
                                                  mesh.axis_names)
        metrics = {"loss": ce / world, "aux": aux / world, "grad_norm": om["grad_norm"],
                   "lr": om["lr"]}
        return params, opt_state, metrics

    def step(params, opt_state, batch_):
        grads, ce, aux = grads_of(params, batch_)
        return update(params, opt_state, grads, ce, aux)

    return TrainBundle(step=step, grads=grads_of, update=update, param_spec=spec,
                       opt_spec=o_spec, ctx=ctx, plan=plan, device=device,
                       stats=stats)


def init_train_state(bundle: TrainBundle, cfg: ModelConfig, mesh, opt_cfg: OptConfig,
                     seed=0, compression: CompressionConfig | None = None):
    """Materialize (params, opt_state) on the mesh's device: parameters drawn
    from a ``torch.Generator`` seeded with ``seed`` on that device (torch's
    random stream, not JAX's), then the optimizer state of them."""
    gen = torch.Generator(device=mesh.device).manual_seed(seed)
    params = init_params(bundle.param_spec, gen, mesh.device)
    opt = init_opt_state(params, bundle.plan, opt_cfg)
    ccfg = compression or CompressionConfig()
    if ccfg.enabled:
        opt["err"] = init_error_state(params, bundle.plan, ccfg)
    return params, opt
