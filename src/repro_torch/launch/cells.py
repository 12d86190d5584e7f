"""The (architecture × input-shape) dry-run grid: 10 archs × 4 shapes = 40 cells.

``build_cell(arch, shape, mesh)`` returns the cell's step function and its
arguments as tensors on the ``meta`` device: calling the one on the other
allocates nothing.  ``cell_status`` marks the documented skips (long_500k
needs sub-quadratic attention), as the reference's
(``repro.launch.cells``) does; the names and values are the reference's.

Where the port's cell differs from the reference's:

* the mesh is one card, ``make_local_mesh(device="meta")``;
* a decode cell's cache is filled to its last position: every ``"len"`` is
  the host ``int`` ``seq - 1`` (a cross cache's the encoder length), where
  the reference's is a traced int32 scalar.  The port's decode places its
  write with a host position, and the cell's last step is its costliest.
  ``meta["decode_position"]`` records it;
* an MoE cell routes its tokens over the experts in a balanced split
  (``models.ffn.balanced_routes``; ``meta["moe_routes"]``), where the
  reference's dispatch charges every expert its capacity-padded slots;
* ``capacity_factor`` is accepted and recorded (in the config and in an
  MoE cell's ``meta``), and changes nothing: the port's MoE drops no
  token.

``cfg``, ``batch`` and ``seq`` override the named cell's config and shape:
the depth-weighted count (``roofline.depth_weighted``) builds a cell at 1
and 2 layers a group, and the card's checks build one at a reduced batch.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models.spec import abstract_params
from repro_torch.optim import OptConfig
from repro_torch.serve.engine import abstract_cache, make_serve_fns
from repro_torch.train.step import batch_shapes, make_train_step

ENC_LEN = 1536  # whisper encoder positions (stub frames), as the reference's

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32_768, batch=32),
    "decode_32k": dict(kind="decode", seq=32_768, batch=128),
    "long_500k": dict(kind="decode", seq=524_288, batch=1),
}


def cell_status(arch: str, shape: str) -> tuple[bool, str]:
    cfg = get_config(arch)
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, "skip: pure full attention is quadratic at 500k (per assignment)"
    return True, "run"


@dataclass
class Cell:
    arch: str
    shape: str
    kind: str
    fn: object            # the step function
    args: tuple           # its arguments, on the meta device
    meta: dict


def default_opt_cfg(arch: str, **overrides) -> OptConfig:
    base = dict(warmup=100, total_steps=10_000)
    base.update(overrides)
    return OptConfig(**base)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def at_position(cache: dict, pos: int) -> dict:
    """``cache`` with every ``"len"`` the host int ``pos``, a cross cache's
    (the encoder memory's, which decode only reads) its K's length."""
    out = {}
    for k, v in cache.items():
        if k == "cross":
            out[k] = {**v, "len": v["k"].shape[-2]}
        elif isinstance(v, dict):
            out[k] = at_position(v, pos)
        else:
            out[k] = pos if k == "len" else v
    return out


def build_cell(arch: str, shape: str, mesh, *, opt_cfg: OptConfig | None = None,
               remat: bool = True, capacity_factor: float | None = None,
               microbatch: int = 1, cfg=None, batch: int | None = None,
               seq: int | None = None) -> Cell:
    info = SHAPES[shape]
    cfg = cfg or get_config(arch)
    if capacity_factor is not None:
        cfg = cfg.scaled(capacity_factor=capacity_factor)
    kind = info["kind"]
    seq, batch = seq or info["seq"], batch or info["batch"]
    meta = dict(arch=arch, shape=shape, kind=kind, seq=seq, batch=batch,
                mesh=dict(zip(mesh.axis_names, (mesh.shape[a] for a in mesh.axis_names))))
    if cfg.n_experts:
        meta.update(moe_routes="balanced", capacity_factor=cfg.capacity_factor)

    if kind == "train":
        ocfg = opt_cfg or default_opt_cfg(arch)
        bundle = make_train_step(cfg, mesh, ocfg, batch=batch, remat=remat,
                                 microbatch=microbatch)
        args = bundle.abstract_args(batch_shapes(cfg, batch, seq, enc_len=ENC_LEN))
        sd = ocfg.state_dtype if isinstance(ocfg.state_dtype, str) else (
            str(ocfg.state_dtype).removeprefix("torch."))
        meta["opt"] = dict(zero1=ocfg.zero1, master_fp32=ocfg.master_fp32,
                           state_dtype=sd)
        return Cell(arch, shape, kind, bundle.step, args, meta)

    sv = make_serve_fns(cfg, mesh, batch=batch, max_len=seq, enc_len=ENC_LEN)
    params_abs = abstract_params(sv.param_spec)
    if kind == "prefill":
        inputs = {"tokens": _meta((batch, seq), torch.int32)}
        if cfg.family == "encdec":
            inputs["enc"] = _meta((batch, ENC_LEN, cfg.d_model), torch.bfloat16)
        if cfg.frontend == "patch_stub":
            inputs["frontend"] = _meta((batch, seq, cfg.d_model), torch.bfloat16)
        return Cell(arch, shape, kind, sv.prefill, (params_abs, inputs), meta)

    caches = at_position(abstract_cache(cfg, mesh, batch, seq, enc_len=ENC_LEN), seq - 1)
    meta["decode_position"] = seq - 1
    toks = _meta((batch, 1), torch.int32)
    return Cell(arch, shape, kind, sv.decode, (params_abs, caches, toks), meta)


def all_cells():
    for arch in ARCH_IDS:
        for shape in SHAPES:
            yield arch, shape
