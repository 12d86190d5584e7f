"""The port's side of the multi-rank tests: what each rank runs.

Every function here is a rank's body for ``repro_torch.launch.ranks.
run_ranks`` (``fn(device, *args)``) and imports nothing of JAX or of the
reference: the children import this module and ``repro_torch`` only.
Inputs are global numpy arrays (the same the reference's script gets);
each rank keeps its part of them and returns its own results (or, where
named, the gathered global arrays on rank 0).
"""
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import attention, backbone, ffn, layers, rglru, ssm
from repro_torch.models.spec import gather_params, shard_params, tree_map, tree_map_p
from repro_torch.optim import OptConfig, build_plan, sync_gradient
from repro_torch.optim.compression import CompressionConfig
from repro_torch.serve.scheduler import BatchScheduler, Request
from repro_torch.train import make_train_step
from repro_torch.train.step import mesh_ctx


def config(arch, scale=None):
    return get_smoke_config(arch).scaled(**(scale or {}))


def draw_tree(spec, rng):
    """float32 parameters of a port spec: norms near 1, biases small,
    weights at their init scale (as ``_torch_models.draw_tree`` draws a
    reference spec's)."""
    def draw(p):
        if p.init == "ones":
            return (1 + 0.1 * rng.standard_normal(p.shape)).astype(np.float32)
        if p.init == "zeros":
            return (0.1 * rng.standard_normal(p.shape)).astype(np.float32)
        fan = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        scale = p.scale if p.scale is not None else 1 / np.sqrt(fan)
        return (scale * rng.standard_normal(p.shape)).astype(np.float32)

    return tree_map_p(draw, spec)


def block(arr, mesh, axes_by_dim):
    """This rank's block of a global array: dimension ``i`` split over the
    mesh axes ``axes_by_dim[i]`` (None: whole)."""
    idx = []
    for dim, ax in zip(arr.shape, axes_by_dim):
        if ax is None:
            idx.append(slice(None))
            continue
        n, i = mesh.shape[ax], mesh.index(ax)
        idx.append(slice(i * (dim // n), (i + 1) * (dim // n)))
    return arr[tuple(idx)]


def _grads(out, leaves_, cot):
    gs = torch.autograd.grad(out, leaves_, grad_outputs=cot)
    return [g.detach() for g in gs]


def collectives(dev, n, cases):
    """Each collective of ``layers`` on a (1, n) mesh, and the tiled
    all-to-all on the mesh ``cases["a2a_mesh"]``: this rank's output and
    the gradient of ``Σ out · cot`` (its cotangent row); with
    ``cases["moe"]``, ``ffn._moe_core`` over that mesh on this rank's rows."""
    mesh = make_local_mesh(1, n, device=dev)
    ctx = mesh_ctx(mesh)
    r = mesh.rank
    fns = {
        "ag": lambda x: layers.ag_seq(x, ctx),
        "rs": lambda x: layers.rs_seq(x, ctx),
        "psum": lambda x: layers.psum_model(x, ctx),
        "pmax": lambda x: x * layers.pmax_const(x, ctx),
    }
    out = {}
    for op, f in fns.items():
        x = torch.from_numpy(cases[op]["x"][r]).requires_grad_(True)
        y = f(x)
        (dx,) = _grads(y, [x], torch.from_numpy(cases[op]["cot"][r]))
        out[op] = {"y": y.detach().numpy(), "dx": dx.numpy()}
    # the tiled all-to-all over the whole world, on a (1, n) or (2, n / 2) mesh
    a2a_mesh = make_local_mesh(*cases["a2a_mesh"], device=dev)
    a2a_ctx = mesh_ctx(a2a_mesh)
    x = torch.from_numpy(cases["a2a"]["x"][r]).requires_grad_(True)
    y = layers.all_to_all_ep(x, a2a_ctx)
    (dx,) = _grads(y, [x], torch.from_numpy(cases["a2a"]["cot"][r]))
    out["a2a"] = {"y": y.detach().numpy(), "dx": dx.numpy()}
    if "moe" in cases:             # the routed experts over the same world
        cfg = config("deepseek-v2-236b", {"capacity_factor": 4.0})
        p = shard_params(cases["moe"]["params"], ffn.moe_spec(cfg, a2a_ctx), a2a_mesh)
        xs = torch.from_numpy(cases["moe"]["x"][r])
        y, aux = ffn._moe_core(p, xs, torch.ones(xs.shape[0], dtype=torch.bool), cfg, a2a_ctx,
                               a2a_mesh.shape["data"])
        out["moe"] = {"y": y.numpy(), "aux": float(aux)}
    c = {k: torch.from_numpy(v[r]) for k, v in cases["combine"].items()}
    out["combine"] = {"y": layers.combine_partials(c["num"], c["m"], c["l"], ctx).float().numpy()}
    if "vocab" in cases:            # the serving side: whole-vocab logits, the distributed argmax
        v = cases["vocab"]
        cfg = config("qwen2-1.5b", {"vocab": int(v["vocab"])})
        p = shard_params({"tok": v["tok"]}, backbone.embed_spec(cfg), mesh)
        x = torch.from_numpy(v["x"])
        out["vocab"] = {"logits": backbone.vocab_logits(p, x[:, 0], ctx, cfg).numpy(),
                        "token": backbone.greedy_token(p, x, ctx, cfg).numpy()}
    out["ledger"] = {k: dict(v) for k, v in mesh.ledger.items()}
    return out


def layer_functions(dev, tasks):
    """``embed_tokens``, ``gqa_apply``, ``mlp_apply`` and ``ce_loss`` on
    each task's mesh: this rank's outputs and gradients (of ``Σ out · cot``;
    of the loss for ``ce_loss``)."""
    results = {}
    for t in tasks:
        d, m = t["mesh"]
        mesh = make_local_mesh(d, m, device=dev)
        ctx = mesh_ctx(mesh)
        cfg = config(t["arch"], t.get("scale"))
        r = mesh.rank
        specs = {"embed": backbone.embed_spec(cfg), "attn": attention.gqa_spec(cfg, ctx),
                 "mlp": ffn.mlp_spec(cfg)}
        seq = ("data", "model", None)
        x = torch.from_numpy(np.ascontiguousarray(block(t["x"], mesh, seq)))
        tokens = torch.from_numpy(np.ascontiguousarray(block(t["tokens"], mesh, ("data", "model"))))
        targets = torch.from_numpy(np.ascontiguousarray(block(t["targets"], mesh, ("data", None))))
        res = {}
        for key, fn, inp in (
                ("embed", lambda p, _x: backbone.embed_tokens(p, tokens, ctx, cfg), None),
                ("attn", lambda p, xs: attention.gqa_apply(p, xs, ctx, cfg), x),
                ("mlp", lambda p, xs: ffn.mlp_apply(p, xs, ctx, cfg), x),
                ("ce", lambda p, xs: backbone.ce_loss(p, xs, targets, ctx, cfg), x)):
            p = shard_params(t["params"]["embed" if key == "ce" else key],
                             specs["embed" if key == "ce" else key], mesh)
            flat = [(k, v.requires_grad_(True)) for k, v in _leaves(p)]
            xs = inp.clone().requires_grad_(True) if inp is not None else None
            y = fn(p, xs)
            wrt = [v for _, v in flat] + ([xs] if xs is not None else [])
            cot = (torch.ones(()) if key == "ce" else torch.from_numpy(t["cot"][key][r]))
            gs = _grads(y, wrt, cot)
            res[key] = {"y": y.detach().numpy(),
                        "dp": {k: g.numpy() for (k, _), g in zip(flat, gs)},
                        "dx": gs[-1].numpy() if xs is not None else None}
        results[t["name"]] = res
    return results


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


def train_steps(dev, tasks):
    """One ``bundle.step`` of each task's mesh from the given global state
    (the mesh layout): on rank 0 the loss, the synced gradients (plain
    sync, gathered), and the parameters, state and metrics after the step
    (gathered); on every rank the collectives' ledger."""
    results = {}
    for t in tasks:
        d, m = t["mesh"]
        mesh = make_local_mesh(d, m, device=dev)
        cfg = config(t["arch"], t.get("scale"))
        ocfg = OptConfig(warmup=2, total_steps=20, zero1=t.get("zero1", False))
        ccfg = CompressionConfig(**t["compression"]) if t.get("compression") else None
        B = t["batch"]["tokens"].shape[0]
        bundle = make_train_step(cfg, mesh, ocfg, batch=B, compression=ccfg)
        params = shard_params(t["params"], bundle.param_spec, mesh)
        opt = shard_params(t["opt"], bundle.opt_spec, mesh)
        round_trip = (gather_params(params, bundle.param_spec, mesh),
                      gather_params(opt, bundle.opt_spec, mesh))
        grads, ce, aux = bundle.grads(params, t["batch"])
        plain = build_plan(bundle.param_spec, mesh.axis_names, mesh.shape,
                           OptConfig(warmup=2, total_steps=20))
        with torch.no_grad():
            synced = _zip_plan(lambda g, pl: sync_gradient(g, pl, mesh), grads, plain)
        loss = mesh.all_reduce(ce / mesh.world, mesh.axis_names)
        # the synced gradients are the same on every data rank: gathered over
        # 'model' alone, every rank holds them whole (where no leaf is sharded
        # over 'data', as routed experts are)
        over_data = []
        tree_map_p(lambda p: over_data.append("data" in str(p.axes)), bundle.param_spec)
        over_model = None if any(over_data) else tree_map(lambda x: x.numpy(), gather_params(
            synced, bundle.param_spec, mesh, everywhere=True, axes=("model",)))
        params, opt, metrics = bundle.update(params, opt, grads, ce, aux)
        out = {"loss": float(loss),
               "grads": gather_params(synced, bundle.param_spec, mesh),
               "params": gather_params(params, bundle.param_spec, mesh),
               "opt": gather_params(opt, bundle.opt_spec, mesh),
               "metrics": {k: float(v) for k, v in metrics.items()},
               "round_trip": round_trip,
               "ledger": {k: dict(v) for k, v in mesh.ledger.items()},
               "dispatch": dict(mesh.dispatch)}
        results[t["name"]] = (dict(out, over_model=over_model) if mesh.rank == 0
                              else {"ledger": out["ledger"], "over_model": over_model,
                                    "dispatch": out["dispatch"]})
        dist.barrier()
    return results


def _zip_plan(fn, tree, plan):
    if isinstance(plan, dict):
        return {k: _zip_plan(fn, tree[k], plan[k]) for k in plan}
    return fn(tree, plan)


def train_losses(dev, d, m, arch, params, tokens, steps, runs):
    """``steps`` steps of ``make_train_step`` on (d, m) from the given
    global parameters (float32 arrays of bfloat16 values, cast back) and a
    fresh state, once a run of ``runs`` (a compression config or None):
    each run's losses."""
    from repro_torch.optim import init_opt_state
    from repro_torch.optim.compression import init_error_state

    mesh = make_local_mesh(d, m, device=dev)
    cfg = config(arch)
    ocfg = OptConfig(warmup=2, total_steps=40)
    batch = {"tokens": tokens, "labels": tokens}
    out = []
    for comp in runs:
        ccfg = CompressionConfig(**comp) if comp else None
        bundle = make_train_step(cfg, mesh, ocfg, batch=tokens.shape[0], compression=ccfg)
        p = tree_map(lambda a: torch.from_numpy(a).to(torch.bfloat16), params)
        p = shard_params(p, bundle.param_spec, mesh)
        opt = init_opt_state(p, bundle.plan, ocfg, mesh)
        if ccfg:
            opt["err"] = init_error_state(p, bundle.plan, ccfg)
        losses = []
        for _ in range(steps):
            p, opt, met = bundle.step(p, opt, batch)
            losses.append(float(met["loss"]))
        err = None
        if ccfg:
            err = float(sum(e.abs().sum() for _, e in _leaves(opt["err"]) if e.numel() > 1))
        out.append({"losses": losses, "err_abs_sum": err})
    return out


def layers_and_steps(dev, layer_tasks, step_tasks):
    """``layer_functions`` then ``train_steps`` in one group of ranks."""
    return {"layers": layer_functions(dev, layer_tasks), "steps": train_steps(dev, step_tasks)}


def fail_on(dev, rank):
    """Rank ``rank`` raises; the others wait in a barrier that never ends."""
    if dist.get_rank() == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    dist.barrier()


def sleep_for(dev, seconds):
    import time

    time.sleep(seconds)


def exit_with(dev, code):
    raise SystemExit(code)


def sparse_sync(dev, d, m, gs, errs, k):
    """``compressed_sync`` of one leaf replicated over the whole mesh (its
    sync axes ('data', 'model')) on (d, m): rank r's partial gradient
    ``gs[r]`` and error ``errs[r]``; returns (synced, new error)."""
    from repro_torch.optim.adamw import LeafPlan
    from repro_torch.optim.compression import compressed_sync

    mesh = make_local_mesh(d, m, device=dev)
    r = mesh.rank
    n = gs.shape[1]
    plan = LeafPlan(sync_axes=("data", "model"), scatter=False, param_axes=(),
                    norm_weight=1.0 / (d * m), chunk=n, local_shape=(n,))
    ccfg = CompressionConfig(ratio=k / n, min_leaf_size=1, enabled=True)
    synced, err = compressed_sync(torch.from_numpy(gs[r]), torch.from_numpy(errs[r]), plan,
                                  ccfg, mesh)
    return synced.numpy(), err.numpy()


def twin(dev, d, m, arch, params, tokens, steps, runs, gs, errs, k):
    """``train_losses`` and ``sparse_sync`` in one group of ranks."""
    return {"losses": train_losses(dev, d, m, arch, params, tokens, steps, runs),
            "sync": sparse_sync(dev, d, m, gs, errs, k)}


def serve(dev, tasks):
    """Each task's ``BatchScheduler`` run on its (data, model) mesh, every
    rank with its shards of the task's global float32 parameters and the
    same requests: the completions, the run's counts and the collectives'
    ledger; then, where the task names a ``prefill`` bucket, that bucket's
    first ``batch`` prompts (padded with copies) through the run's own prefill (this rank's
    caches and the token) and one decode step on them (the token and the
    step's collectives).  A task with ``runs`` serves them one ``run`` each:
    a run is (the indices of its requests, its global ``extras`` — an
    encoder-decoder's frames, a ``patch_stub`` model's patch rows — or
    None), its counts summed; the prefill bucket takes its run's extras."""
    results = {}
    for t in tasks:
        d, m = t["mesh"]
        mesh = make_local_mesh(d, m, device=dev)
        cfg = config(t["arch"], t.get("scale"))
        sched = BatchScheduler(cfg, mesh, batch=t["batch"], max_len=t["max_len"],
                               eos_id=t["eos_id"], enc_len=t.get("enc_len", 32))
        params = shard_params(t["params"], sched._engine.param_spec, mesh)
        reqs = [Request(rid, prompt, max_new) for rid, prompt, max_new in t["requests"]]
        runs = t.get("runs") or [(list(range(len(reqs))), None)]
        done, counts = {}, np.zeros(4, np.int64)
        with torch.no_grad():
            for idx, extras in runs:
                got, stats = sched.run(params, [reqs[i] for i in idx], extras=extras)
                done.update(got)
                counts += (stats.requests, stats.prefill_tokens, stats.decode_steps,
                           stats.batches)
        dispatch = dict(mesh.dispatch)
        res = {"completions": {rid: (c.tokens, c.finished) for rid, c in done.items()},
               "stats": tuple(int(c) for c in counts),
               "ledger": {k: dict(v) for k, v in mesh.ledger.items()}, "dispatch": dispatch}
        if t.get("prefill"):
            prompts = [p for _, p, _ in t["requests"] if len(p) == t["prefill"]][:t["batch"]]
            prompts += [prompts[0]] * (t["batch"] - len(prompts))       # pad with a copy
            extras = next((e for idx, e in runs
                           if any(len(reqs[i].prompt) == t["prefill"] for i in idx)),
                          None) or {}
            sv = sched._engine
            with torch.no_grad():
                caches, tok = sv.prefill(params, {"tokens": torch.tensor(prompts),
                                                  **{k: torch.as_tensor(v)
                                                     for k, v in extras.items()}})
                res["caches"] = tree_map(
                    lambda x: x if isinstance(x, int) else x.float().numpy().copy(), caches)
                res["prefill_token"] = tok.numpy()
                mesh.ledger.clear()
                tok2, _ = sv.decode(params, caches, tok[:, None])
            res["decode_token"] = tok2.numpy()
            res["decode_ledger"] = {k: v["calls"] for k, v in mesh.ledger.items()}
        results[t["name"]] = res
        dist.barrier()
    return results


EXPERT_LEAVES = ("we_gate", "we_up", "we_down")


def _vjp(fn, params, xs, cots, more=()):
    """``fn(params, xs, *more)`` -> outputs; this rank's outputs and the
    gradients of ``Σ out · cot`` over every output, wrt the parameter leaves
    and xs (with ``more``: wrt xs and each of ``more``, a list)."""
    flat = [(k, v.requires_grad_(True)) for k, v in _leaves(params)]
    ins = [x.clone().requires_grad_(True) for x in (xs, *more)]
    outs = fn(params, *ins)
    wrt = [v for _, v in flat] + ins
    gs = torch.autograd.grad(outs, wrt, allow_unused=True,     # a rank's experts may get no row
                             grad_outputs=[torch.as_tensor(c, dtype=o.dtype)
                                           for o, c in zip(outs, cots)])
    gs = [torch.zeros_like(w) if g is None else g.detach() for g, w in zip(gs, wrt)]
    dxs = [g.numpy() for g in gs[len(flat):]]
    return ([o.detach().numpy() for o in outs],
            {k: g.numpy() for (k, _), g in zip(flat, gs)}, dxs if more else dxs[0])


def moe_layers(dev, tasks):
    """Each task's MoE and MLA layers on its (data, model) mesh, this rank's
    shards of the task's global float32 weights (experts in the port's
    placement): ``moe_apply`` and ``moe_decode`` (outputs, aux, gradients of
    ``Σ y · cot + aux · cot_aux``, the dispatch counts), ``mla_apply``
    (output, latents, gradients) and, where the task names ``max_len``,
    ``mla_fill_cache`` then two ``mla_decode`` steps (outputs and this
    rank's cache)."""
    results = {}
    for t in tasks:
        d, m = t["mesh"]
        mesh = make_local_mesh(d, m, device=dev)
        ctx = mesh_ctx(mesh)
        cfg = config(t["arch"], t.get("scale"))
        r = mesh.rank
        res = {}
        seq, rows = ("data", "model", None), ("data", None, None)
        if "moe" in t["params"]:
            p = shard_params(t["params"]["moe"], ffn.moe_spec(cfg, ctx), mesh)
            for key, fn, x, spec in (
                    ("apply", ffn.moe_apply, t["x"], seq),
                    ("decode", ffn.moe_decode, t.get("xdec"), rows)):
                if x is None:
                    continue
                xs = torch.from_numpy(np.ascontiguousarray(block(x, mesh, spec)))
                mesh.dispatch.clear()
                (y, aux), dp, dx = _vjp(lambda pp, xx: fn(pp, xx, ctx, cfg, d), p, xs,
                                        (t["cot"][key][r], t["cot_aux"]))
                res[key] = {"y": y, "aux": float(aux), "dp": dp, "dx": dx,
                            "dispatch": dict(mesh.dispatch)}
        if "mla" in t["params"]:
            p = shard_params(t["params"]["mla"], attention.mla_spec(cfg, ctx), mesh)
            xs = torch.from_numpy(np.ascontiguousarray(block(t["x"], mesh, seq)))

            def mla(pp, xx):
                o, (c, kr) = attention.mla_apply(pp, xx, ctx, cfg, return_latent=True)
                return o, c, kr

            (o, c, kr), dp, dx = _vjp(mla, p, xs, (t["cot"]["mla"][r], t["cot"]["c_kv"][r],
                                                   t["cot"]["k_rope"][r]))
            res["mla"] = {"y": o, "c_kv": c, "k_rope": kr, "dp": dp, "dx": dx}
            if t.get("max_len"):
                with torch.no_grad():
                    xp = torch.from_numpy(np.ascontiguousarray(block(t["x"], mesh, seq)))
                    _, (c, kr) = attention.mla_apply(p, xp, ctx, cfg, return_latent=True)
                    cache = attention.mla_init_cache(cfg, ctx, c.shape[0], t["max_len"])
                    cache = attention.mla_fill_cache(cache, c, kr, ctx)
                    outs = []
                    for xd in t["xsteps"]:
                        xd = torch.from_numpy(np.ascontiguousarray(block(xd, mesh, rows)))
                        o, cache = attention.mla_decode(p, xd, cache, ctx, cfg)
                        outs.append(o.numpy())
                res["mla_decode"] = {"y": outs, "c_kv": cache["c_kv"].float().numpy(),
                                     "k_rope": cache["k_rope"].float().numpy(),
                                     "len": cache["len"]}
        results[t["name"]] = res
        dist.barrier()
    return results


def _recurrent_apply(key, p, x, ctx, cfg):
    """A recurrent-family block function with its state: (out, state dict)."""
    if key == "rglru":
        o, st = rglru.rglru_apply(p, x, ctx, cfg, return_state=True)
        return o, {"h": st["h"], "conv": st["conv"]}
    if key == "attn":
        o, (k, v) = attention.gqa_apply(p, x, ctx, cfg, window=cfg.window, return_kv=True)
        return o, {"k": k, "v": v}
    o, st = ssm.ssm_apply(p, x, ctx, cfg, return_state=True)
    return o, {"ssd": st["ssd"], "conv": st["conv"]}


def _recurrent_chain(key, p, x, steps, ctx, cfg, cache0=None):
    """The decode chain of a recurrent-family block: ``rglru_decode`` from
    ``cache0``, ``local_fill_cache`` + ``local_decode`` or ``ssm_apply`` +
    ``ssm_decode`` over ``steps``: (outputs, last cache)."""
    if key == "rglru":
        cache = dict(cache0, len=0)
        dec = rglru.rglru_decode
    elif key == "attn":
        _, (k, v) = attention.gqa_apply(p, x, ctx, cfg, window=cfg.window, return_kv=True)
        cache = attention.local_fill_cache(None, k, v, cfg)
        dec = attention.local_decode
    else:
        _, cache = ssm.ssm_apply(p, x, ctx, cfg, return_state=True)
        dec = ssm.ssm_decode
    ys = []
    for xd in steps:
        o, cache = dec(p, xd, cache, ctx, cfg)
        ys.append(o.numpy())
    return ys, cache


def _state_np(tree):
    return {k: _state_np(v) if isinstance(v, dict) else (
        v if isinstance(v, int) else v.detach().float().numpy()) for k, v in tree.items()}


def recurrent_layers(dev, tasks):
    """Each task's recurrent-family blocks (``parts`` of ``rglru``, ``attn``
    — windowed — and ``ssm``) on its (data, model) mesh, this rank's shards
    of the task's global float32 weights: output, state and gradients of
    ``Σ out · cot`` of each apply and its collectives (forward and
    backward); where the task has ``xsteps``, each decode chain's outputs
    and this rank's last cache (``rglru_decode`` from the given ``h0`` /
    ``conv0``)."""
    results = {}
    for t in tasks:
        d, m = t["mesh"]
        mesh = make_local_mesh(d, m, device=dev)
        ctx = mesh_ctx(mesh)
        cfg = config(t["arch"], t.get("scale"))
        r = mesh.rank
        seq, rows = ("data", "model", None), ("data", None, None)
        specs = {"rglru": rglru.rglru_spec(cfg, ctx), "attn": attention.gqa_spec(cfg, ctx),
                 "ssm": ssm.ssm_spec(cfg, ctx)}

        def local(a, spec):
            return torch.from_numpy(np.ascontiguousarray(block(a, mesh, spec)))

        xs = local(t["x"], seq)
        steps = [local(xd, rows) for xd in t.get("xsteps", ())]
        res = {}
        for key in t["parts"]:
            p = shard_params(t["params"][key], specs[key], mesh)
            flat = [(k, v.requires_grad_(True)) for k, v in _leaves(p)]
            xg = xs.clone().requires_grad_(True)
            mesh.ledger.clear()
            y, st = _recurrent_apply(key, p, xg, ctx, cfg)
            wrt = [v for _, v in flat] + [xg]
            gs = torch.autograd.grad(y, wrt, grad_outputs=torch.from_numpy(t["cot"][key][r]),
                                     allow_unused=True)
            gs = [torch.zeros_like(w) if g is None else g for g, w in zip(gs, wrt)]
            res[key] = {"y": y.detach().numpy(), "state": _state_np(st),
                        "dp": {k: g.numpy() for (k, _), g in zip(flat, gs)},
                        "dx": gs[-1].numpy(),
                        "ledger": {k: v["calls"] for k, v in mesh.ledger.items()}}
            if steps:
                cache0 = None
                if key == "rglru":
                    cache0 = {"h": local(t["h0"], ("data", None)),
                              "conv": local(t["conv0"], rows).to(torch.bfloat16)}
                p = shard_params(t["params"][key], specs[key], mesh)
                with torch.no_grad():
                    mesh.ledger.clear()
                    ys, cache = _recurrent_chain(key, p, xs, steps, ctx, cfg, cache0)
                res[f"{key}_decode"] = {"y": ys, "state": _state_np(cache),
                                        "ledger": {k: v["calls"]
                                                   for k, v in mesh.ledger.items()}}
        results[t["name"]] = res
        dist.barrier()
    return results


def frontend_layers(dev, tasks):
    """Each task's frontend-family functions on its (data, model) mesh, this
    rank's shards of the task's global float32 weights, where its ``parts``
    name them: ``encode`` over this rank's frames (the gathered memory and
    the gradients of ``Σ memory · cot`` wrt the encoder's leaves and the
    frames), ``gqa_apply(memory=)`` over this rank's stream chunk and its
    rows of the whole memory (output and gradients wrt ``wq`` / ``wk`` /
    ``wv`` / ``wo``, the chunk and the memory), ``cross_fill_cache`` of that
    memory (this rank's chunk), ``cross_decode`` from the given global
    cache (each step's output), and the no-cache ``forward`` over this
    rank's tokens with its chunk of the frames or the patch rows (its
    stream chunk); each part's collectives."""
    results = {}
    for t in tasks:
        d, m = t["mesh"]
        mesh = make_local_mesh(d, m, device=dev)
        ctx = mesh_ctx(mesh)
        cfg = config(t["arch"], t.get("scale"))
        r = mesh.rank
        seq, rows = ("data", "model", None), ("data", None, None)

        def local(a, spec):
            return torch.from_numpy(np.ascontiguousarray(block(a, mesh, spec)))

        res = {}
        if "encode" in t["parts"]:
            spec = backbone.model_spec(cfg, ctx)["enc"]
            p = shard_params(t["params"]["enc"], spec, mesh)
            mesh.ledger.clear()
            (y,), dp, dx = _vjp(
                lambda pp, xx: (backbone.encode({"enc": pp}, xx, ctx, cfg),), p,
                local(t["frames"], seq), [t["cot"]["encode"][r]])
            res["encode"] = {"y": y, "dp": dp, "dx": dx,
                             "ledger": {k: v["calls"] for k, v in mesh.ledger.items()}}
        if "cross" in t["parts"]:
            p = shard_params(t["params"]["cross"], attention.gqa_spec(cfg, ctx), mesh)
            mem = local(t["memory"], rows)
            (y,), dp, (dx, dmem) = _vjp(
                lambda pp, xx, mm: (attention.gqa_apply(pp, xx, ctx, cfg, causal=False,
                                                        memory=mm),),
                p, local(t["x"], seq), [t["cot"]["cross"][r]], more=[mem])
            res["cross"] = {"y": y, "dp": dp, "dx": dx, "dmem": dmem}
            with torch.no_grad():
                p = shard_params(t["params"]["cross"], attention.gqa_spec(cfg, ctx), mesh)
                c = attention.cross_fill_cache(p, mem, cfg, ctx)
                cache = {"k": local(t["cache_k"], (
                    "data", None, "model", None)).to(torch.bfloat16),
                         "v": local(t["cache_v"], (
                    "data", None, "model", None)).to(torch.bfloat16),
                         "len": t["cache_k"].shape[2]}
                mesh.ledger.clear()
                ys = [attention.cross_decode(p, local(xd, rows), cache, ctx, cfg).numpy()
                      for xd in t["xsteps"]]
            res["cross_cache"] = {"k": c["k"].float().numpy(), "v": c["v"].float().numpy(),
                                  "len": c["len"]}
            res["cross_decode"] = {"y": ys,
                                   "ledger": {k: v["calls"] for k, v in mesh.ledger.items()}}
        if "forward" in t["parts"]:
            p = shard_params(t["params"]["model"], backbone.model_spec(cfg, ctx), mesh)
            kw = {}
            if "frames" in t:
                kw["enc_embeds"] = local(t["frames"], seq)
            if "frontend" in t:
                kw["frontend"] = local(t["frontend"], seq)
            with torch.no_grad():
                x = backbone.forward(p, local(t["tokens"], ("data", "model")), ctx, cfg,
                                     remat=False, **kw)
            res["forward"] = {"x": x.numpy()}
        results[t["name"]] = res
        dist.barrier()
    return results


def skewed_router(dev, arch):
    """``ffn.moe_apply`` on a (1, 2) mesh with every token all ones and the
    router's logits 2 for expert 0, 1 for expert 1 and 0 for the rest: the rows each of this rank's
    expert gate / up products took (in order), and the dispatch ledger."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models.spec import init_params

    mesh = make_local_mesh(1, 2, device=dev)
    cfg = config(arch)
    ctx = mesh_ctx(mesh)
    spec = ffn.moe_spec(cfg, ctx)
    p = shard_params(init_params(spec, torch.Generator().manual_seed(0), "cpu"), spec, mesh)
    p["router"].zero_()
    p["router"][:, 0] = 2.0 / cfg.d_model
    p["router"][:, 1] = 1.0 / cfg.d_model
    rows = []

    class Rows(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.mm.default and tuple(args[1].shape) == (
                    cfg.d_model, cfg.moe_d_ff):
                rows.append(args[0].shape[0])
            return func(*args, **(kwargs or {}))

    x = torch.ones(2, 5, cfg.d_model, device=mesh.device)
    with torch.no_grad(), Rows():
        ffn.moe_apply(p, x, ctx, cfg, ctx.data_size)
    return {"rows": rows, "dispatch": dict(mesh.dispatch)}


LEDGER_KEYS = ("calls", "bytes", "out_bytes", "ring_bytes", "ring_bytes_nvlink",
               "ring_bytes_nic")


def _ledger_of(mesh) -> dict:
    out = {op: {k: led[k] for k in LEDGER_KEYS} for op, led in mesh.ledger.items()}
    mesh.ledger.clear()
    return out


def dryrun_ledgers(dev, tasks):
    """Each task's dry-run cell run for real on this rank's (data, model)
    mesh at its arch's smoke config, batch and sequence: a training task
    one ``bundle.step`` (the cell's optimizer config, parameters from seed
    0), a serving task a prefill of the whole sequence (``max_len`` the
    sequence), then a prefill of its first half and one decode step.  The
    collectives' ledger of each step (``<name>/train``, ``/prefill``,
    ``/decode``)."""
    from repro_torch.launch.cells import default_opt_cfg
    from repro_torch.models.spec import init_params
    from repro_torch.serve.engine import make_serve_fns
    from repro_torch.train.step import init_train_state

    results = {}
    for t in tasks:
        d, m = t["mesh"]
        mesh = make_local_mesh(d, m, device=dev)
        cfg = config(t["arch"])
        b, s = t["batch"], t["seq"]
        toks = np.random.default_rng(0).integers(0, cfg.vocab, (b, s)).astype(np.int32)
        if t["kind"] == "train":
            ocfg = default_opt_cfg(t["arch"])
            bundle = make_train_step(cfg, mesh, ocfg, batch=b)
            params, opt = init_train_state(bundle, cfg, mesh, ocfg)
            mesh.ledger.clear()
            bundle.step(params, opt, {"tokens": toks, "labels": toks})
            results[f"{t['name']}/train"] = _ledger_of(mesh)
        else:
            sv = make_serve_fns(cfg, mesh, batch=b, max_len=s)
            params = shard_params(init_params(sv.param_spec, torch.Generator().manual_seed(0),
                                              "cpu"), sv.param_spec, mesh)
            with torch.no_grad():
                sv.prefill(params, {"tokens": torch.from_numpy(toks)})
                results[f"{t['name']}/prefill"] = _ledger_of(mesh)
                caches, tok = sv.prefill(params, {"tokens": torch.from_numpy(toks[:, :s // 2])})
                mesh.ledger.clear()
                sv.decode(params, caches, tok[:, None])
                results[f"{t['name']}/decode"] = _ledger_of(mesh)
        dist.barrier()
    return results
