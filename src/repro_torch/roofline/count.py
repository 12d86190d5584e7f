"""Roofline accounting of a PyTorch step, counted on ``meta`` tensors.

The reference reads its counts from XLA's compiled HLO text
(``repro.roofline.hlo.analyze_hlo``).  A PyTorch program has no such text,
so this is a counterpart, not a port of that parser: ``analyze_step(fn,
args)`` runs ``fn(*args)`` under one ``TorchDispatchMode`` and counts every
aten op that reaches it, the backward's included.  With ``meta`` arguments
nothing is allocated and nothing computes.  It returns the keys of
``analyze_hlo`` and adds ``peak_bytes_per_device``:

* **flops** — matrix products only: ``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, the convolutions and the scaled-dot-product attentions, each
  by ``torch.utils.flop_counter``'s formula, so the count equals
  ``FlopCounterMode``'s over the same step.  This is ``analyze_hlo``'s
  rule, "every ``dot``".  Elementwise work (softmax, norms, the SSD and
  RG-LRU scans' elementwise products) is not counted, as the reference's
  is not.  ``unresolved_dots`` counts the products that have no formula
  there (``dot``, ``mv``, ``addmv``, ``_int_mm``).
* **bytes** — an unfused proxy of device-memory traffic.  An eager step
  has no fusion, so every aten op reads its operands and writes its result
  (a broadcast operand is read once).  Views cost nothing (every op that
  returns an alias: ``view``, ``_unsafe_view``, ``t``, ``transpose``,
  ``expand``, ``slice``, ``select``, ``as_strided``, ``alias``, …), nor does
  an uninitialised allocation (``empty``), as ``analyze_hlo``'s
  ``_NO_TRAFFIC``.  A gather or index costs 2 × its result, as
  ``analyze_hlo``'s dynamic-slice rule, or its result and its whole
  source where the source is the smaller (a broadcast gather, such as the
  KV heads repeated to the query heads: each source byte is read once);
  an in-place window write
  (``copy_``, ``index_put_``, ``index_copy_``, ``scatter_``) 2 × its
  update, as its dynamic-update-slice rule.  An upload (an op that reads
  only host tensors) is host traffic and costs nothing here: the port
  uploads its small index and frequency tables once a process
  (``functools.lru_cache``), so a step's count does not depend on what
  ran before it.  It is an upper count of an eager step's traffic: two
  ops in a row may meet in the card's 50 MB L2.
* **collectives** — 0 on one card.  The keys stay, for the multi-card
  slice to fill.
* **peak** — the largest sum of live storages on the device while ``fn``
  runs.  The arguments count whole; an upload's storage is not charged.
  A storage is live from the op that made it until it is freed (a
  weak reference's callback), and is charged in the card's allocator
  granule of 512 bytes.

On the card (``chip_smoke.py``, phase ``dryrun``) the counted peak is
held within ``PEAK_RTOL`` = 10 % of ``torch.cuda.max_memory_allocated()``
over the same step.  The same Python code runs on both, so they part only
by what the meta trace cannot see: workspaces that CUDA kernels take from
the allocator inside one op (cuBLAS, sort and top-k buffers), and blocks
that the caching allocator hands out whole when a split would leave less
than 1 MB.  Each is megabytes where a full-width step's peak is
gigabytes; 10 % leaves room for them and fails a counter that misses a
saved activation a layer or a gradient tree.

Depth by trip count.  ``analyze_hlo`` charges a ``while`` body its trip
count; the port's layer loops are Python, and a full-depth trace of a long
prefill takes minutes.  ``depth_weighted(cfg, count)`` counts each depth
group of ``depth_axes(cfg)`` at 2 and at 3 layers (periods, for a hybrid;
a group of fewer at its own depth and one more), the other groups at 2,
and charges each group ``base + layers × per_layer``.  flops and bytes are
linear in depth, so this is exact (but for the optimizer's padding of a
large state leaf to whole update chunks, at most one chunk a leaf); the
peak is linear past the first layer (one saved boundary a layer under
remat, one cache a layer at prefill), held to a whole-depth trace by the
tests and to the card by ``chip_smoke.py``.

The card's peaks are stated here and nowhere else (NVIDIA's data sheet,
H100 SXM, dense rates at the 700 W limit).
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

PEAK_BF16_FLOPS = 989e12          # dense bf16 tensor-core rate, FLOP/s
HBM_BYTES_PER_S = 3.35e12         # device memory rate, B/s
NVLINK_BYTES_PER_S = 450e9        # NVLink 4, one direction per card, B/s
HBM_BYTES = 80 * 2**30            # device memory capacity, 80 GiB
PEAK_RTOL = 0.10                  # the counted peak against the card's (docstring)

ALLOC_GRANULE = 512               # bytes: the CUDA caching allocator's rounding

aten = torch.ops.aten
_GATHERS = {aten.index.Tensor, aten.index_select.default, aten.gather.default,
            aten.embedding.default, aten.take.default}
_WINDOW_WRITES = {aten.index_put_.default: 2, aten.index_copy_.default: 3,
                  aten.scatter_.src: 3, aten.index_add_.default: 3}   # op -> update arg
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_strided.default, aten.empty_like.default,
               aten.new_empty.default, aten.new_empty_strided.default}
_UNCOUNTED_PRODUCTS = {aten.dot.default, aten.vdot.default, aten.mv.default,
                       aten.addmv.default, aten._int_mm.default}


def _on_device(t) -> bool:
    return isinstance(t, torch.Tensor) and t.device.type != "cpu"


def _read_bytes(t: torch.Tensor) -> int:
    """Distinct bytes a view spans: a broadcast (stride-0) dim read once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _granule(n: int) -> int:
    return -(-n // ALLOC_GRANULE) * ALLOC_GRANULE


def _tensors(tree, out=None) -> list:
    """Every tensor in nested tuples, lists and dicts."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


_PLAIN = (bool, int, float, str, torch.dtype, torch.device, torch.layout,
          torch.memory_format, type(None))


def _key(x):
    """A hashable stand-in of an op argument for ``StepCounter``'s memo:
    a meta tensor by its shape, strides and dtype, a plain value by its
    type and value; ``None`` where the argument is neither."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype) if x.is_meta else None
    if type(x) in _PLAIN:
        return (type(x), x)
    if isinstance(x, (tuple, list)):
        parts = tuple(map(_key, x))
        return None if None in parts else parts
    if isinstance(x, dict):
        parts = tuple((k, _key(v)) for k, v in x.items())
        return None if any(v is None for _, v in parts) else ("dict",) + parts
    return None


def _spec(out):
    """An op's result as (shape, strides, dtype) specs, or None where it is
    not a meta tensor or a tuple or list of them."""
    if isinstance(out, torch.Tensor):
        return (tuple(out.shape), out.stride(), out.dtype) if out.is_meta else None
    if isinstance(out, (tuple, list)) and out:
        parts = [_spec(t) if isinstance(t, torch.Tensor) else None for t in out]
        return None if None in parts else (type(out), parts)
    return None


def _make(spec):
    if isinstance(spec[0], type):
        return spec[0](_make(p) for p in spec[1])
    shape, stride, dtype = spec
    return torch.empty_strided(shape, stride, dtype=dtype, device="meta")


_VIEW, _MUTATES, _PURE = range(3)
_KINDS: dict = {}


def _kind(func) -> int:
    k = _KINDS.get(func)
    if k is None:
        # _unsafe_view shares its input's storage though its schema says not
        k = (_VIEW if func.is_view or func is aten._unsafe_view.default
             else _MUTATES if func._schema.is_mutable else _PURE)
        _KINDS[func] = k
    return k


def _cost(func, args, kwargs, out) -> tuple:
    """(flops, bytes, unresolved products) of one op by the module's rules,
    and its result tensors on the device to charge; None where it is an
    upload from the host."""
    packet = func.overloadpacket
    flops = unresolved = 0
    if packet in flop_registry:
        flops = flop_registry[packet](*args, **kwargs, out_val=out)
    elif func in _UNCOUNTED_PRODUCTS:
        unresolved = 1
    every_in = _tensors((args, kwargs))
    ins = [t for t in every_in if _on_device(t)]
    outs = [t for t in _tensors(out) if _on_device(t)]
    if outs and not ins and every_in:
        return None                  # an upload from the host: no device traffic, not charged
    if func in _NO_TRAFFIC or not (ins or outs):
        nbytes = 0
    elif func in _GATHERS:
        res = sum(_read_bytes(t) for t in outs)
        nbytes = res + min(res, _read_bytes(args[0]))
    elif func is aten.copy_.default:
        nbytes = _read_bytes(args[1]) + _read_bytes(args[0])
    elif func in _WINDOW_WRITES:
        nbytes = 2 * _read_bytes(args[_WINDOW_WRITES[func]])
    else:
        nbytes = sum(_read_bytes(t) for t in ins) + sum(_read_bytes(t) for t in outs)
    return flops, nbytes, unresolved, outs


class StepCounter(TorchDispatchMode):
    """The dispatch mode behind ``analyze_step``: flops, bytes and the live
    storage peak of every aten op that runs under it.

    ``memo`` (a dict, shared between counters at will) keeps, for every
    functional op on meta tensors, its result specs and its cost by its
    arguments' specs.  Many of torch's meta kernels are Python
    (``torch._refs``), a few hundred microseconds an op, and the blockwise
    attention repeats one chunk pair's ops hundreds of times a layer; a
    repeat then costs one ``empty_strided``.  Views and in-place ops always
    run."""

    def __init__(self, memo: dict | None = None):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.unresolved = 0
        self.live = 0
        self.peak = 0
        self._live: dict = {}        # storage key -> (weakref to it, bytes charged)
        self._memo = memo

    def track(self, t: torch.Tensor) -> None:
        """Charge ``t``'s storage from now until it is freed (once)."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = _granule(st.nbytes())
        self._live[key] = (weakref.ref(st, lambda _, key=key: self._free(key)), n)
        self.live += n
        if self.live > self.peak:
            self.peak = self.live

    def track_all(self, tree) -> int:
        """Charge every device tensor in ``tree`` (``track``); returns the
        bytes live after."""
        for t in _tensors(tree):
            if _on_device(t):
                self.track(t)
        return self.live

    def _free(self, key) -> None:
        self.live -= self._live.pop(key)[1]

    def _charge(self, flops, nbytes, unresolved, outs) -> None:
        self.flops += flops
        self.bytes += nbytes
        self.unresolved += unresolved
        for t in outs:
            self.track(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = _kind(func)
        if kind == _VIEW:
            return func(*args, **kwargs)     # no traffic, no new storage
        key = None
        if self._memo is not None and kind == _PURE:
            key = (func, _key(args), _key(kwargs) if kwargs else ())
            if None in key:
                key = None
            else:
                hit = self._memo.get(key)
                if hit is not None:
                    spec, flops, nbytes, unresolved = hit
                    out = _make(spec)
                    self._charge(flops, nbytes, unresolved, _tensors(out))
                    return out
        out = func(*args, **kwargs)
        cost = _cost(func, args, kwargs, out)
        if cost is None:
            return out
        self._charge(*cost)
        if key is not None:
            spec = _spec(out)
            if spec is not None:
                self._memo[key] = (spec,) + cost[:3]
        return out


def analyze_step(fn, args, chips: int = 1, memo: dict | None = None) -> dict:
    """Run ``fn(*args)`` under a ``StepCounter`` (with ``memo``) and return
    ``analyze_hlo``'s keys for it, plus ``argument_bytes_per_device`` and
    ``peak_bytes_per_device``.  Give ``meta`` arguments to count without
    allocating; a collective is counted nowhere yet, so ``chips`` must be 1
    until the multi-card slice."""
    if chips != 1:
        raise NotImplementedError("collectives across cards: the multi-card slice of "
                                  "ROADMAP Queue A item 15")
    mode = StepCounter(memo)
    arg_bytes = mode.track_all(args)
    with mode:
        result = fn(*args)
    del result
    return {
        "entry": getattr(fn, "__qualname__", repr(fn)),
        "flops_per_device": float(mode.flops),
        "bytes_per_device": float(mode.bytes),
        "collective_per_device": 0.0,
        "flops_global": float(mode.flops) * chips,
        "bytes_global": float(mode.bytes) * chips,
        "collective_global": 0.0,
        "collective_by_op_per_device": {},
        "collective_op_counts": {},
        "unresolved_dots": mode.unresolved,
        "argument_bytes_per_device": float(arg_bytes),
        "peak_bytes_per_device": float(mode.peak),
    }


# ---------------------------------------------------------------------------
# depth by trip count
# ---------------------------------------------------------------------------

_LINEAR = ("flops_per_device", "bytes_per_device", "collective_per_device", "flops_global",
           "bytes_global", "collective_global", "argument_bytes_per_device",
           "peak_bytes_per_device", "unresolved_dots")


def depth_axes(cfg) -> list:
    """The depth groups of ``cfg``'s layer plan (``models.backbone.layer_plan``)
    and the encoder stack: ``(name, count, at)``, ``at(k)`` the config with
    that group at ``k`` layers (a hybrid: ``k`` periods) and the others as
    in ``cfg``.  Groups of 0 layers, and a hybrid's remaining unscanned
    layers, are no axis: they stay as they are in every trace."""
    axes = []
    if cfg.family == "moe":
        moe = cfg.n_layers - cfg.n_dense_layers
        if cfg.n_dense_layers:
            axes.append(("mla_dense", cfg.n_dense_layers,
                         lambda c, k: c.scaled(n_dense_layers=k,
                                               n_layers=k + c.n_layers - c.n_dense_layers)))
        if moe:
            axes.append(("mla_moe", moe,
                         lambda c, k: c.scaled(n_layers=c.n_dense_layers + k)))
    elif cfg.family == "hybrid":
        period = len(cfg.pattern)
        if cfg.n_layers // period:
            axes.append(("hybrid_period", cfg.n_layers // period,
                         lambda c, k: c.scaled(n_layers=k * period + c.n_layers % period)))
    else:
        axes.append((cfg.family, cfg.n_layers, lambda c, k: c.scaled(n_layers=k)))
    if cfg.family == "encdec" and cfg.n_enc_layers:
        axes.append(("enc", cfg.n_enc_layers, lambda c, k: c.scaled(n_enc_layers=k)))
    return axes


def depth_weighted(cfg, count, argument_bytes: float | None = None) -> dict:
    """``count(cfg')`` (an ``analyze_step`` result) at every group's full
    depth, from traces at two depths a group: ``count`` runs once with
    every group at its base depth, ``min(2, its full depth)``, and once
    more a group with that group one deeper.  The base is 2, not 1,
    because a first layer is not a steady one for the peak: a prefill
    allocates its stacked caches after layer 0, so layer 1's peak holds
    them and layer 0's does not (traced at 1 and 2, qwen2-1.5b's 28-layer
    prefill peak read 25 % high on the card).  Given ``argument_bytes``,
    the full-depth arguments' bytes (the optimizer pads a large state leaf
    to whole update chunks, so those are not linear in depth), the peak is
    they plus the extrapolated excess over the arguments.  The result
    carries ``depth_traces``, the group depths traced."""
    axes = depth_axes(cfg)
    base_cfg, depth = cfg, {}
    for name, full, at in axes:
        depth[name] = min(2, full)
        base_cfg = at(base_cfg, depth[name])
    base = count(base_cfg)
    total = dict(base)
    traces = [dict(depth)]
    for name, full, at in axes:
        if full == depth[name]:
            continue                     # traced whole already: nothing to extrapolate
        deeper = count(at(base_cfg, depth[name] + 1))
        for key in _LINEAR:
            total[key] += (full - depth[name]) * (deeper[key] - base[key])
        traces.append({**depth, name: depth[name] + 1})
    if argument_bytes is not None:
        total["peak_bytes_per_device"] += argument_bytes - total["argument_bytes_per_device"]
        total["argument_bytes_per_device"] = float(argument_bytes)
    total["depth_traces"] = traces
    return total
