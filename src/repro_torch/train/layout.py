"""The training state's global layout on a mesh, and the one-rank layout
that checkpoints are written in.

On a (data, model) mesh a parameter leaf's global array is its spec's
shape, query heads padded to a multiple of 'model' (``attention._hq_pad``:
the pad heads are zero and stay zero); an optimizer state leaf is flat,
one block of ``_state_pad(base)`` entries a holder — a holder per
coordinate of the axes that shard the leaf and, under ZeRO-1, of 'data',
each block this holder's flat shard or slice, zero past its end.  On one
rank both are the plain, unpadded layout.  ``to_one_rank`` and
``from_one_rank`` carry the parameters and the float states (m, v,
master, step) between the two, exactly: a checkpoint written on a 2 × 2
mesh resumes on one rank and the other way round.  A routed expert's rows
lie at its own index in both (``models.ffn``'s placement); where the
expert-parallel world does not divide ``n_experts`` the mesh layout pads
them with zero rows, which no token reaches and which are dropped on the
way to one rank.  int8 states do not
carry (their 256-entry blocks and scales lie over each holder's slice)
and neither do error-feedback buffers (which leaves are compressed
depends on the local sizes): both raise ``NotImplementedError`` where
the layouts differ.

Every function here is pure: global arrays in, global arrays out
(``models.spec.gather_params`` / ``shard_params`` move them between
ranks).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.backbone import model_spec
from repro_torch.models.layers import MeshCtx
from repro_torch.models.spec import P, dim_blocks
from repro_torch.optim.adamw import LeafPlan, OptConfig, _state_pad, build_plan

ONE = {"data": 1, "model": 1}


def _holders(plan: LeafPlan, sizes: dict) -> list:
    """Each holder's mesh coordinates, in the order of the state's blocks."""
    axes = tuple(plan.param_axes) + (("data",) if plan.scatter else ())
    dims = [sizes[a] for a in axes]
    return [dict(zip(axes, (int(c) for c in np.unravel_index(h, dims))))
            for h in range(int(np.prod(dims)))]


def _as_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    arr = np.array(a, order="C")
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _fit(x: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``x`` cut or zero-padded, dimension by dimension, to ``shape``."""
    x = x[tuple(slice(0, n) for n in shape)]
    pad = []
    for have, want in reversed(list(zip(x.shape, shape))):
        pad += [0, want - have]
    return torch.nn.functional.pad(x, pad) if any(pad) else x.clone()


def _state_to_param(flat: torch.Tensor, p: P, plan: LeafPlan, sizes: dict,
                    pad: int) -> torch.Tensor:
    """A flat state leaf of the mesh layout -> an array shaped as ``p``."""
    out = torch.zeros(p.shape, dtype=flat.dtype)
    size = int(np.prod(plan.local_shape))
    holders = _holders(plan, sizes)
    D = sizes["data"] if plan.scatter else 1
    for h in range(0, len(holders), D):
        parts = [flat[(h + i) * pad:(h + i) * pad + plan.chunk] for i in range(D)]
        local = torch.cat(parts)[:size].reshape(plan.local_shape)
        out[dim_blocks(p.shape, p.axes, sizes, holders[h])] = local
    return out


def _param_to_state(full: torch.Tensor, p: P, plan: LeafPlan, sizes: dict,
                    pad: int) -> torch.Tensor:
    """An array shaped as ``p`` -> the flat state leaf of the mesh layout."""
    blocks = []
    for at in _holders(plan, sizes):
        local = full[dim_blocks(p.shape, p.axes, sizes, at)].reshape(-1)
        if plan.scatter:
            D, i = sizes["data"], at["data"]
            local = torch.nn.functional.pad(local, (0, plan.chunk * D - local.numel()))
            local = local[i * plan.chunk:(i + 1) * plan.chunk]
        blocks.append(torch.nn.functional.pad(local, (0, pad - local.numel())))
    return torch.cat(blocks)


def _zip(fn, spec, *trees):
    """``fn(leaf spec, *subtrees)`` over the leaves of the spec tree."""
    if isinstance(spec, dict):
        return {k: _zip(fn, spec[k], *(t[k] for t in trees)) for k in spec}
    return fn(spec, *trees)


def _specs(cfg, ocfg: OptConfig, sizes: dict):
    names = tuple(sizes)
    ctx = MeshCtx(model_size=sizes["model"], data_size=sizes["data"])
    spec = model_spec(cfg, ctx)
    return spec, build_plan(spec, names, sizes, ocfg)


def _check(ocfg: OptConfig, opt, sizes: dict) -> None:
    if sizes == ONE:
        return
    if ocfg.int8_states:
        raise NotImplementedError("int8 optimizer states do not carry across mesh layouts "
                                  "(their 256-entry blocks lie over each holder's slice)")
    if "err" in opt:
        raise NotImplementedError("error-feedback buffers do not carry across mesh layouts "
                                  "(which leaves are compressed depends on the local sizes)")


def to_one_rank(params, opt, cfg, ocfg: OptConfig, sizes: dict):
    """Global (params, opt) of a mesh of ``sizes`` -> the one-rank layout
    (CPU tensors).  ``opt`` may be None."""
    spec, plan = _specs(cfg, ocfg, sizes)
    spec1, _ = _specs(cfg, ocfg, ONE)
    p_out = _zip(lambda p1, x: _fit(_as_tensor(x), p1.shape), spec1, params)
    if opt is None:
        return p_out, None
    _check(ocfg, opt, sizes)

    def leaf(p, st, pl, p1):
        base = pl.chunk if pl.scatter else int(np.prod(pl.local_shape))
        pad, pad1 = _state_pad(base, ocfg), _state_pad(int(np.prod(p1.shape)), ocfg)
        out = {}
        for k, a in st.items():
            full = _state_to_param(_as_tensor(a), p, pl, sizes, pad)
            flat = _fit(full, p1.shape).reshape(-1)
            out[k] = torch.nn.functional.pad(flat, (0, pad1 - flat.numel()))
        return out

    leaves = _zip(leaf, spec, opt["leaves"], plan, spec1)
    return p_out, {"step": _as_tensor(opt["step"]).clone(), "leaves": leaves}


def from_one_rank(params, opt, cfg, ocfg: OptConfig, sizes: dict):
    """One-rank (params, opt) -> the global layout of a mesh of ``sizes``
    (CPU tensors); the inverse of ``to_one_rank``.  ``opt`` may be None."""
    spec, plan = _specs(cfg, ocfg, sizes)
    spec1, _ = _specs(cfg, ocfg, ONE)
    p_out = _zip(lambda p, x: _fit(_as_tensor(x), p.shape), spec, params)
    if opt is None:
        return p_out, None
    _check(ocfg, opt, sizes)

    def leaf(p, st, pl, p1):
        base = pl.chunk if pl.scatter else int(np.prod(pl.local_shape))
        pad = _state_pad(base, ocfg)
        n1 = int(np.prod(p1.shape))
        return {k: _param_to_state(_fit(_as_tensor(a)[:n1].reshape(p1.shape), p.shape), p, pl,
                                   sizes, pad)
                for k, a in st.items()}

    leaves = _zip(leaf, spec, opt["leaves"], plan, spec1)
    return p_out, {"step": _as_tensor(opt["step"]).clone(), "leaves": leaves}
