"""Gradient compression: error-feedback top-k sparsification over 'data'.

The reference (``repro.optim.compression``): per leaf above a size
threshold, each data rank sends only the top-k fraction of its gradient
by magnitude (the residual stays in a local error-feedback buffer and is
added back next step), all-gathers the sparse (index, value) sets over
'data' and scatter-adds them into a dense gradient.  On one card the
'data' axis has size 1: the all-gather is the identity, so the synced
gradient is the top-k entries of (gradient + error) and the new error the
rest.  The byte ledger counts what a data rank would send, as the
reference's does.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.models.spec import P

from .adamw import LeafPlan, OptConfig, sync_gradient


@dataclass(frozen=True)
class CompressionConfig:
    ratio: float = 0.01           # fraction of entries sent per step
    min_leaf_size: int = 65_536   # dense sync below this
    enabled: bool = False


def eligible(plan: LeafPlan, ccfg: CompressionConfig) -> bool:
    size = int(np.prod(plan.local_shape))
    return (
        ccfg.enabled
        and "data" in plan.sync_axes
        and not plan.scatter
        and size >= ccfg.min_leaf_size
    )


def k_for(plan: LeafPlan, ccfg: CompressionConfig) -> int:
    size = int(np.prod(plan.local_shape))
    return max(1, int(size * ccfg.ratio))


def error_spec(spec_tree, plan_tree, ccfg: CompressionConfig):
    """P tree of error-feedback buffers (a (1,) placeholder for ineligible
    leaves)."""

    def walk(spec, plan):
        if isinstance(spec, dict):
            return {k: walk(spec[k], plan[k]) for k in spec}
        if eligible(plan, ccfg):
            return P(spec.shape, spec.axes, "zeros", dtype=torch.float32)
        return P((1,), (None,), "zeros", dtype=torch.float32)  # placeholder

    return walk(spec_tree, plan_tree)


def init_error_state(params, plan_tree, ccfg: CompressionConfig):
    def walk(par, plan):
        if isinstance(par, dict):
            return {k: walk(par[k], plan[k]) for k in par}
        shape = par.shape if eligible(plan, ccfg) else (1,)
        return torch.zeros(shape, dtype=torch.float32, device=par.device)

    return walk(params, plan_tree)


def compressed_sync(g, err, plan: LeafPlan, ccfg: CompressionConfig):
    """EF-top-k reduction over 'data' (size 1 here).  Returns (g_synced,
    new_err), both float32 of g's shape.  Where entries tie in magnitude at
    the k-th place the chosen set may differ from ``jax.lax.top_k``'s; the
    results differ only if tied entries differ in value (ties of zeros
    give the same sums)."""
    acc = g.float() + err.float()
    flat = acc.reshape(-1)
    k = k_for(plan, ccfg)
    _vals, idx = torch.topk(flat.abs(), k)
    send_vals = flat[idx]                                   # (k,)
    new_err = flat.clone()
    new_err[idx] = 0.0
    # the all-gather over a 'data' axis of size 1 is the identity
    dense = torch.zeros_like(flat).index_add_(0, idx, send_vals)
    return dense.reshape(g.shape), new_err.reshape(g.shape)


def sync_all(grads, err_state, plan_tree, cfg: OptConfig, ccfg: CompressionConfig):
    """Per-leaf sync: compressed where eligible, dense elsewhere.

    Returns (synced grads tree (f32), new error state tree, bytes ledger)."""
    sent_dense = [0]
    sent_sparse = [0]

    def walk(g, e, plan):
        if isinstance(plan, dict):
            out = {k: walk(g[k], e[k], plan[k]) for k in plan}
            return {k: v[0] for k, v in out.items()}, {k: v[1] for k, v in out.items()}
        if eligible(plan, ccfg):
            gs, ne = compressed_sync(g, e, plan, ccfg)
            sent_sparse[0] += 8 * k_for(plan, ccfg)
            return gs, ne
        size = int(np.prod(plan.local_shape))
        if "data" in plan.sync_axes or plan.scatter:
            sent_dense[0] += 4 * size
        return sync_gradient(g, plan), e

    with torch.no_grad():
        gs, ne = walk(grads, err_state, plan_tree)
    return gs, ne, {"sparse_bytes": sent_sparse[0], "dense_bytes": sent_dense[0]}
