"""AdamW with per-leaf gradient synchronization and optional ZeRO-1 state
sharding, on one card.

The reference (``repro.optim.adamw``) runs inside ``shard_map``: a leaf's
local gradient is partial along its replication axes and is ``psum``-ed
over them (``sync_gradient``), or under ZeRO-1 reduce-scattered over
'data' with the Adam state and the fp32 master kept for this rank's 1/D
slice.  The port keeps the plan (``build_plan`` is pure and works for any
mesh sizes) and the state layout, key for key, so states carry across
packages (``opt_state_from_numpy``).  On one card every replication axis
has size 1: ``sync_gradient`` is the float32 cast, the global-norm
``psum`` the identity.  A plan that scatters (ZeRO-1 needs ``data > 1``)
raises ``NotImplementedError`` where a step would scatter.

``apply_updates`` updates the parameters and the state **in place** under
``torch.no_grad()`` (the reference donates both to its jitted step) and
returns the same trees.  Each leaf is updated in ``UPDATE_CHUNK`` slices
where the reference maps over them, so the float32 temporaries stay a
slice's size; the arithmetic is the reference's, element for element.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.models.spec import P, params_from_numpy, tree_map_p

ZERO1_TODO = ("ZeRO-1 needs data > 1: the multi-card slice of ROADMAP Queue A item 15 "
              "(one card has no 'data' axis to scatter over)")


@dataclass(frozen=True)
class OptConfig:
    lr_peak: float = 3e-4
    lr_min_frac: float = 0.1
    warmup: int = 100
    total_steps: int = 10_000
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: Any = torch.float32  # m/v dtype: a torch float dtype | "int8" (block-quantized)
    master_fp32: bool = True          # keep an fp32 master copy of bf16 params
    zero1: bool = False               # shard states + master over 'data'

    @property
    def int8_states(self) -> bool:
        return isinstance(self.state_dtype, str) and self.state_dtype == "int8"


QBLK = 256  # block size for int8 quantization of m/v

# Log-spaced codebook, as the reference's: index 1..levels+1 spans
# 10^-7..10^0 of the block's absmax geometrically, 0 encodes zero.
_DECADES = 7.0


def _quantize(x: torch.Tensor, *, signed: bool):
    """f32 (N,) padded to a QBLK multiple -> (int8 / uint8 code (N,), f32
    scales (N / QBLK,)).  ``torch.round`` rounds half to even, as
    ``jnp.round``; ``log10`` may part from XLA's by an ulp, so a code can
    part by 1 where the pre-round value lies at a .5 boundary."""
    blocks = x.reshape(-1, QBLK)
    s = torch.clamp(blocks.abs().amax(1), min=1e-30)
    y = blocks / s[:, None]
    ay = y.abs()
    levels = 126.0 if signed else 254.0
    mag = torch.clamp(
        torch.round((torch.log10(torch.clamp(ay, min=1e-30)) + _DECADES) / _DECADES * levels),
        0.0, levels,
    ) + 1.0
    mag = torch.where(ay < 10.0 ** (-_DECADES - 0.5), 0.0, mag)
    if signed:
        q = (torch.sign(y) * mag).to(torch.int8)   # ±(1..127)
    else:
        q = mag.to(torch.uint8)                    # 0..255
    return q.reshape(-1), s


def _dequantize(q: torch.Tensor, s: torch.Tensor, *, signed: bool):
    qi = q.float()
    mag = qi.abs()
    levels = 126.0 if signed else 254.0
    val = torch.pow(10.0, (mag - 1.0) / levels * _DECADES - _DECADES)
    val = torch.where(mag == 0, 0.0, val) * (torch.sign(qi) if signed else 1.0)
    return (val.reshape(-1, QBLK) * s[:, None]).reshape(-1)


def _pad_len(n: int) -> int:
    return -(-n // QBLK) * QBLK


# Big leaves update in UPDATE_CHUNK-sized slices (the reference maps over
# them), so the f32 dequant / update temporaries stay a slice's size.
UPDATE_CHUNK = 1 << 22


def _state_pad(n: int, cfg: OptConfig) -> int:
    base = _pad_len(n) if cfg.int8_states else n
    if base > 2 * UPDATE_CHUNK:
        return -(-base // UPDATE_CHUNK) * UPDATE_CHUNK
    return base


def lr_schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to lr_min_frac (float32, as the
    reference's)."""
    step = torch.as_tensor(step).float()
    warm = cfg.lr_peak * (step + 1.0) / max(1, cfg.warmup)
    prog = torch.clamp((step - cfg.warmup) / max(1, cfg.total_steps - cfg.warmup), 0.0, 1.0)
    cos = cfg.lr_min_frac + (1 - cfg.lr_min_frac) * 0.5 * (1 + torch.cos(np.pi * prog))
    return torch.where(step < cfg.warmup, warm, cfg.lr_peak * cos)


# ---------------------------------------------------------------------------
# per-leaf distribution plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LeafPlan:
    sync_axes: tuple       # plain-psum axes for this leaf's gradient
    scatter: bool          # ZeRO-1: reduce-scatter over 'data' instead
    param_axes: tuple      # mesh axes (mesh order) that shard the param leaf
    norm_weight: float     # 1 / (#ranks holding the synced value)
    chunk: int             # per-rank slice length when scatter
    local_shape: tuple     # local shard shape of the param leaf


def _leaf_axis_names(p: P) -> set:
    names = set()
    for ax in p.axes:
        if ax is None:
            continue
        if isinstance(ax, tuple):
            names.update(ax)
        else:
            names.add(ax)
    return names


def _local_shape(p: P, mesh_sizes: dict) -> tuple:
    shape = []
    for dim, ax in zip(p.shape, p.axes):
        f = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None:
                f *= mesh_sizes[a]
        assert dim % f == 0, (p.shape, p.axes, dim, f)
        shape.append(dim // f)
    return tuple(shape)


def build_plan(spec_tree, mesh_axes: tuple, mesh_sizes: dict, cfg: OptConfig):
    """LeafPlan tree; mesh_axes e.g. ('data','model') or ('pod','data','model')."""

    def plan_leaf(p: P) -> LeafPlan:
        used = _leaf_axis_names(p)
        repl = tuple(a for a in mesh_axes if a not in used)
        local = _local_shape(p, mesh_sizes)
        size = int(np.prod(local))
        D = mesh_sizes.get("data", 1)
        scatter = cfg.zero1 and "data" in repl and size >= D and D > 1
        sync = tuple(a for a in repl if not (scatter and a == "data"))
        weight = 1.0 / int(np.prod([mesh_sizes[a] for a in sync])) if sync else 1.0
        chunk = -(-size // D) if scatter else size
        return LeafPlan(
            sync_axes=sync,
            scatter=scatter,
            param_axes=tuple(a for a in mesh_axes if a in used),
            norm_weight=weight,
            chunk=chunk,
            local_shape=local,
        )

    return tree_map_p(plan_leaf, spec_tree)


def _state_layout(plan: LeafPlan, mesh_sizes: dict):
    """1-D state layout per leaf: (base local length, holders, dim0 axes)."""
    base = plan.chunk if plan.scatter else int(np.prod(plan.local_shape))
    holders = int(np.prod([mesh_sizes[a] for a in plan.param_axes]))
    axes = tuple(plan.param_axes) + (("data",) if plan.scatter else ())
    dim0 = (axes if axes else None,)
    if plan.scatter:
        holders *= mesh_sizes.get("data", 1)
    return base, holders, dim0


def opt_state_spec(spec_tree, plan_tree, mesh_sizes: dict, cfg: OptConfig):
    """P tree for the optimizer state (the global layout the reference's
    ``pspecs`` shard).  All states are flat 1-D per local shard; int8 m/v
    add per-QBLK scales."""

    def leaf(p: P, plan: LeafPlan):
        base, holders, dim0 = _state_layout(plan, mesh_sizes)
        pad = _state_pad(base, cfg)
        if cfg.int8_states:
            st = {
                "m_q": P((holders * pad,), dim0, "zeros", dtype=torch.int8),
                "m_s": P((holders * pad // QBLK,), dim0, "zeros", dtype=torch.float32),
                "v_q": P((holders * pad,), dim0, "zeros", dtype=torch.uint8),
                "v_s": P((holders * pad // QBLK,), dim0, "zeros", dtype=torch.float32),
            }
        else:
            st = {
                "m": P((holders * pad,), dim0, "zeros", dtype=cfg.state_dtype),
                "v": P((holders * pad,), dim0, "zeros", dtype=cfg.state_dtype),
            }
        if cfg.master_fp32:
            st["master"] = P((holders * pad,), dim0, "zeros", dtype=torch.float32)
        return st

    def walk(spec, plan):
        if isinstance(spec, dict):
            return {k: walk(spec[k], plan[k]) for k in spec}
        return leaf(spec, plan)

    return {"step": P((), (), "zeros", dtype=torch.int32), "leaves": walk(spec_tree, plan_tree)}


def init_opt_state(params, plan_tree, cfg: OptConfig):
    """The optimizer state of ``params``, on their device: zero moments, the
    float32 master copy of each leaf, step 0."""

    def leaf(x, plan: LeafPlan):
        if plan.scatter:
            raise NotImplementedError(ZERO1_TODO)
        base = int(np.prod(plan.local_shape))
        pad = _state_pad(base, cfg)
        dev = x.device
        if cfg.int8_states:
            st = {
                "m_q": torch.zeros((pad,), dtype=torch.int8, device=dev),
                "m_s": torch.zeros((pad // QBLK,), dtype=torch.float32, device=dev),
                "v_q": torch.zeros((pad,), dtype=torch.uint8, device=dev),
                "v_s": torch.zeros((pad // QBLK,), dtype=torch.float32, device=dev),
            }
        else:
            st = {
                "m": torch.zeros((pad,), dtype=cfg.state_dtype, device=dev),
                "v": torch.zeros((pad,), dtype=cfg.state_dtype, device=dev),
            }
        if cfg.master_fp32:
            master = torch.zeros((pad,), dtype=torch.float32, device=dev)
            master[:base] = x.detach().reshape(-1)
            st["master"] = master
        return st

    first = []

    def walk(par, plan):
        if isinstance(par, dict):
            return {k: walk(par[k], plan[k]) for k in par}
        first.append(par.device)
        return leaf(par, plan)

    leaves = walk(params, plan_tree)
    return {"step": torch.zeros((), dtype=torch.int32, device=first[0]), "leaves": leaves}


def opt_state_from_numpy(state, device):
    """The reference's optimizer state (``{"step", "leaves"}`` and, with
    compression, ``"err"``; numpy or JAX arrays) as the port's, key for key
    and dtype for dtype — step (int32), m / v (the state dtype), the int8
    codes (int8 m, uint8 v) and their float32 scales, the float32 master,
    the error-feedback buffers — on ``device``."""
    if "step" not in state or "leaves" not in state:
        raise ValueError(f"not an optimizer state: keys {sorted(state)}")
    return params_from_numpy(state, device)


def sync_gradient(g, plan: LeafPlan):
    """Partial local grad -> fully-reduced grad: on one card every sync
    axis has size 1, so the float32 cast."""
    if plan.scatter:
        raise NotImplementedError(ZERO1_TODO)
    return g.float()


def _flat_leaves(plan, trees, out):
    """Every leaf of ``plan`` (a LeafPlan tree), with the matching subtree of
    each of ``trees``: [(plan, (t0, t1, …))], in the plan's key order."""
    if isinstance(plan, dict):
        for k in plan:
            _flat_leaves(plan[k], [t[k] for t in trees], out)
    else:
        out.append((plan, tuple(trees)))
    return out


def apply_updates(grads, params, opt_state, plan_tree, cfg: OptConfig, mesh_axes=None,
                  *, presynced: bool = False):
    """One AdamW step, in place.  Returns (params, opt_state, metrics) — the
    same trees, updated — with metrics ``grad_norm`` and ``lr`` (0-d float32
    tensors on the device).

    presynced=True: ``grads`` are already fully reduced (e.g. by the
    error-feedback top-k compressor, ``repro_torch.optim.compression``).
    ``grads`` is a tree shaped like ``params``."""
    with torch.no_grad():
        flat = _flat_leaves(plan_tree, [grads, params, opt_state["leaves"]], [])
        plans = [pl for pl, _ in flat]
        gs = [g for _, (g, _x, _st) in flat]
        if any(pl.scatter for pl in plans):
            raise NotImplementedError(ZERO1_TODO)
        # the exact global norm: Σ norm_weight · Σ g² (the mesh psum is the identity)
        gnorm = torch.sqrt(sum(pl.norm_weight * torch.sum(torch.square(g.float()))
                               for g, pl in zip(gs, plans)))
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)

        step = opt_state["step"]
        lr = lr_schedule(cfg, step)
        t = (step + 1).float()
        bc1 = 1.0 - cfg.beta1 ** t
        bc2 = 1.0 - cfg.beta2 ** t

        for pl, (g, x, st) in flat:
            _update_leaf(g if presynced else sync_gradient(g, pl), x, st, scale, lr, bc1,
                         bc2, cfg)
        step.add_(1)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}


def _update_leaf(g, x, st, scale, lr, bc1, bc2, cfg: OptConfig) -> None:
    """The reference's ``update_flat`` over one leaf, slice by slice, writing
    the state, the master and the parameter in place."""
    g = g.reshape(-1)
    base = g.shape[0]
    pad = _state_pad(base, cfg)
    step_len = UPDATE_CHUNK if (pad > UPDATE_CHUNK and pad % UPDATE_CHUNK == 0) else pad
    xf = x.view(-1)
    for lo in range(0, pad, step_len):
        hi = lo + step_len
        n = max(0, min(hi, base) - lo)          # real (unpadded) entries of the slice
        gp = (g[lo:lo + n].float() * scale)
        if n < step_len:
            gp = torch.nn.functional.pad(gp, (0, step_len - n))
        if cfg.master_fp32:
            ref = st["master"][lo:hi]
        else:
            ref = torch.nn.functional.pad(xf[lo:lo + n].float(), (0, step_len - n))
        if cfg.int8_states:
            qs = slice(lo // QBLK, hi // QBLK)
            m = (_dequantize(st["m_q"][lo:hi], st["m_s"][qs], signed=True) * cfg.beta1
                 + (1 - cfg.beta1) * gp)
            v = (_dequantize(st["v_q"][lo:hi], st["v_s"][qs], signed=False) * cfg.beta2
                 + (1 - cfg.beta2) * torch.square(gp))
            mq, ms = _quantize(m, signed=True)
            vq, vs = _quantize(v, signed=False)
            st["m_q"][lo:hi] = mq
            st["m_s"][qs] = ms
            st["v_q"][lo:hi] = vq
            st["v_s"][qs] = vs
        else:
            m = st["m"][lo:hi].float() * cfg.beta1 + (1 - cfg.beta1) * gp
            v = st["v"][lo:hi].float() * cfg.beta2 + (1 - cfg.beta2) * torch.square(gp)
            st["m"][lo:hi] = m.to(cfg.state_dtype)
            st["v"][lo:hi] = v.to(cfg.state_dtype)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * ref
        new_ref = ref - lr * upd
        if cfg.master_fp32:
            st["master"][lo:hi] = new_ref
        if n:
            xf[lo:lo + n] = new_ref[:n].to(x.dtype)
