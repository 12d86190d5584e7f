"""The reference's side of the multi-rank tests, run as a script on fake
CPU devices (``tests/test_compression.py`` runs its 8-device test so):

    python tests/_jax_mesh_ref.py IN.npz OUT.npz DEVICES

``IN.npz`` holds ``job`` (a JSON list of tasks) and each task's input
arrays under ``<name>/...``; the results go to ``OUT.npz`` under the same
prefixes.  Every task runs the reference's own functions inside
``jax.shard_map(..., check_vma=False)`` on a (data, model) mesh of the
first ``data · model`` devices.  A per-rank result comes back stacked on a
leading axis in rank order (``out_specs`` over ('data', 'model') of a
leading axis of one a rank), so a test holds rank ``r`` of the port
against row ``r``.

Tasks (``kind``):

* ``coll``: ``ag_seq``, ``rs_seq``, ``psum_model``, ``pmax_const`` (as
  ``x * pmax_const(x)``) and ``combine_partials`` on a (1, n) mesh, and
  the tiled ``all_to_all`` over ('data', 'model') on the task's ``a2a``
  mesh: each rank's output and ``jax.grad`` of ``Σ out · cot``
  (cotangents per rank);
* ``layers``: ``embed_tokens``, ``ce_loss``, ``gqa_apply`` and
  ``mlp_apply``, each rank's output and gradients of ``Σ out · cot``
  (``ce_loss``: of the loss);
* ``step``: the loss and the synced gradients of the training objective
  (the reference's ``sync_gradient`` a leaf, global arrays), then one
  ``make_train_step`` step from the given state: parameters, state and
  metrics after it;
* ``init``: ``init_train_state``'s parameters (seed 0) and the losses of
  ``steps`` steps of ``make_train_step`` on a repeated batch;
* ``moe_layers``: ``moe_apply`` and ``moe_decode`` (each rank's output,
  aux loss and ``jax.vjp`` of ``Σ y · cot + aux · cot_aux``, and the
  pairs its dispatch drops at capacity, counted by the reference's own
  formula), ``mla_apply`` with its latents (output and gradients), and
  where the task names ``max_len``, ``mla_fill_cache`` then one
  ``mla_decode`` a ``xsteps`` entry (outputs and each rank's cache); the
  weights are given in the reference's placement;
* ``recurrent_layers``: where the task's ``parts`` name them,
  ``rglru_apply``, the windowed ``gqa_apply`` and ``ssm_apply``, each with
  its state (``return_state`` / ``return_kv``): each rank's output, state
  and ``jax.vjp`` of ``Σ out · cot``; ``rglru_decode`` from the given cache
  (``h0``, ``conv0``), ``local_fill_cache`` + ``local_decode`` and
  ``ssm_apply`` + ``ssm_decode`` over the ``xstep`` inputs: each rank's
  outputs and last cache; and the raw pre-conv tail ``_branch_in(p,
  x)[1][:, -3:]`` of the whole sequence.  A part that raises records its
  exception's name under ``<name>/<part>/error``;
* ``frontend_layers``: where the task's ``parts`` name them, ``encode``
  over the frames (each rank's gathered memory and ``jax.vjp`` of ``Σ
  memory · cot``), ``gqa_apply(memory=)`` (output and ``jax.vjp`` wrt the
  weights, the stream and the memory), ``cross_fill_cache`` (each rank's
  chunk) and ``cross_decode`` from the given global cache over the
  ``xstep`` inputs (each step's output);
* ``forward``: the no-cache ``forward`` of the given tokens on the mesh,
  with the task's ``enc`` frames or ``frontend`` rows where it has them:
  the final-norm states, whole;
* ``serve``: the reference's ``BatchScheduler`` on the given global
  parameters and requests (each completion's tokens, ``finished`` and the
  run's counts), one ``run`` a task's ``runs`` entry where it has them (a
  run's requests and its ``extras``, the counts summed), then, where the
  task names a ``prefill`` bucket, that bucket's first ``batch`` prompts
  (padded with copies of the first), with its run's extras, through the
  run's own ``make_serve_fns`` prefill: the global caches (a rank's are
  their blocks by ``cache_spec``) and the token.

* ``dryrun``: the reference's dry-run cell (``repro.launch.cells.
  build_cell``) of the task's arch and shape at its smoke config, batch
  and sequence, on a mesh of the task's ``shape`` over its ``axes`` (a
  leading 'pod' axis where named), compiled; ``analyze_hlo`` of its HLO
  text: per-device flops, and ring bytes and calls by collective op.

The ``step`` task's batch carries ``enc`` / ``frontend`` where the task's
arrays hold them.
"""
import json
import os
import sys

os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={sys.argv[3]}"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import attention, backbone, ffn, layers, rglru, ssm  # noqa: E402
from repro.models.spec import pspecs  # noqa: E402
from repro.optim import OptConfig, build_plan, sync_gradient  # noqa: E402
from repro.optim.compression import CompressionConfig  # noqa: E402
from repro.serve.scheduler import BatchScheduler, Request  # noqa: E402
from repro.train import init_train_state, make_train_step  # noqa: E402
from repro.train.step import mesh_ctx, mesh_sizes  # noqa: E402

RANKS = JP(("data", "model"))


def mesh_of(d, m):
    return jax.make_mesh((d, m), ("data", "model"), devices=jax.devices()[:d * m],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def unflat(flat: dict, prefix: str) -> dict:
    out = {}
    for k, v in flat.items():
        if not k.startswith(prefix + "/"):
            continue
        node = out
        parts = k[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def flat(tree, prefix: str, out: dict) -> dict:
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat(v, f"{prefix}/{k}", out)
    else:
        out[prefix] = np.asarray(jnp.asarray(tree, jnp.float32))
    return out


def config(task):
    return get_smoke_config(task["arch"]).scaled(**task.get("scale", {}))


def per_rank(mesh, fn, in_specs, *args):
    body = jax.shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=RANKS, check_vma=False)
    return jax.jit(body)(*args)


def coll(task, inp, out):
    n = task["n"]
    mesh = mesh_of(1, n)
    ctx = layers.MeshCtx(model_size=n)
    name = task["name"]

    def grad_of(f):
        def body(x, cot):
            y, pull = jax.vjp(f, x[0])
            return y[None], pull(cot[0])[0][None]
        return body

    fns = {
        "ag": lambda x: layers.ag_seq(x, ctx),
        "rs": lambda x: layers.rs_seq(x, ctx),
        "psum": lambda x: layers.psum_model(x, ctx),
        "pmax": lambda x: x * layers.pmax_const(x, "model"),
    }
    for op, f in fns.items():
        y, g = per_rank(mesh, grad_of(f), (RANKS, RANKS), inp[f"{name}/{op}/x"],
                        inp[f"{name}/{op}/cot"])
        out[f"{name}/{op}/y"], out[f"{name}/{op}/dx"] = np.asarray(y), np.asarray(g)

    a2a_mesh = mesh_of(*task["a2a"])
    y, g = per_rank(a2a_mesh, grad_of(lambda x: jax.lax.all_to_all(
        x, ("data", "model"), 0, 0, tiled=True)), (RANKS, RANKS), inp[f"{name}/a2a/x"],
        inp[f"{name}/a2a/cot"])
    out[f"{name}/a2a/y"], out[f"{name}/a2a/dx"] = np.asarray(y), np.asarray(g)

    def comb(num, m, l):
        return layers.combine_partials(num[0], m[0], l[0], ctx).astype(jnp.float32)[None]

    out[f"{name}/combine/y"] = np.asarray(per_rank(
        mesh, comb, (RANKS,) * 3, *(inp[f"{name}/combine/{k}"] for k in ("num", "m", "l"))))


def layer_fns(task, inp, out):
    d, m = task["mesh"]
    mesh = mesh_of(d, m)
    ctx = mesh_ctx(mesh)
    cfg = config(task)
    name = task["name"]
    p = unflat(inp, f"{name}/params")
    x, tokens, targets = (inp[f"{name}/{k}"] for k in ("x", "tokens", "targets"))
    sp = {"embed": pspecs(backbone.embed_spec(cfg)), "attn": pspecs(attention.gqa_spec(cfg, ctx)),
          "mlp": pspecs(ffn.mlp_spec(cfg))}
    seq, rows = JP("data", "model", None), JP("data", None)

    # the parameters' gradients are local shards: return them stacked per
    # rank; the input's too, where it is a float stream (not token ids)
    def stacked(f, wrt_x):
        def body(params, xs, cot):
            if wrt_x:
                y, pull = jax.vjp(f, params, xs)
                gp, gx = pull(cot[0])
            else:
                y, pull = jax.vjp(lambda pp: f(pp, xs), params)
                (gp,), gx = pull(cot[0]), jnp.zeros(())
            return y[None], jax.tree.map(lambda g: g[None], gp), gx[None]
        return body

    def run_stacked(key, f, params, xs, x_spec, wrt_x=True):
        body = jax.shard_map(stacked(f, wrt_x), mesh=mesh, in_specs=(sp[key], x_spec, RANKS),
                             out_specs=RANKS, check_vma=False)
        y, gp, gx = jax.jit(body)(params, xs, inp[f"{name}/cot/{key}"])
        out[f"{name}/{key}/y"], out[f"{name}/{key}/dx"] = np.asarray(y), np.asarray(gx)
        flat(gp, f"{name}/{key}/dp", out)

    run_stacked("embed", lambda pe, t: backbone.embed_tokens(pe, t, ctx, cfg),
                p["embed"], tokens.astype(np.int32), JP("data", "model"), wrt_x=False)
    run_stacked("attn", lambda pa, xs: attention.gqa_apply(pa, xs, ctx, cfg), p["attn"], x, seq)
    run_stacked("mlp", lambda pm, xs: ffn.mlp_apply(pm, xs, ctx, cfg), p["mlp"], x, seq)

    def ce_body(pe, xs, ys):
        loss, (gp, gx) = jax.value_and_grad(
            lambda a, b: backbone.ce_loss(a, b, ys, ctx, cfg), argnums=(0, 1))(pe, xs)
        return loss[None], jax.tree.map(lambda g: g[None], gp), gx[None]

    body = jax.shard_map(ce_body, mesh=mesh, in_specs=(sp["embed"], seq, rows),
                         out_specs=RANKS, check_vma=False)
    loss, gp, gx = jax.jit(body)(p["embed"], x, targets)
    out[f"{name}/ce/y"], out[f"{name}/ce/dx"] = np.asarray(loss), np.asarray(gx)
    flat(gp, f"{name}/ce/dp", out)


def step(task, inp, out):
    d, m = task["mesh"]
    mesh = mesh_of(d, m)
    ctx = mesh_ctx(mesh)
    cfg = config(task)
    name = task["name"]
    ocfg = OptConfig(warmup=2, total_steps=20, zero1=task.get("zero1", False))
    ccfg = CompressionConfig(**task["compression"]) if task.get("compression") else None
    params = unflat(inp, f"{name}/params")
    opt = unflat(inp, f"{name}/opt")
    opt["step"] = jnp.asarray(inp[f"{name}/opt/step"], jnp.int32)
    batch = {k: jnp.asarray(inp[f"{name}/batch/{k}"], jnp.int32) for k in ("tokens", "labels")}
    batch.update({k: jnp.asarray(inp[f"{name}/batch/{k}"], jnp.float32)
                  for k in ("enc", "frontend") if f"{name}/batch/{k}" in inp})
    B = batch["tokens"].shape[0]
    bundle = make_train_step(cfg, mesh, ocfg, batch=B, compression=ccfg)
    world = d * m
    plan = build_plan(bundle.param_spec, mesh.axis_names, mesh_sizes(mesh),
                      OptConfig(warmup=2, total_steps=20))
    p_ps = pspecs(bundle.param_spec)

    def grads_body(params, b):
        def objective(pp):
            x, aux = backbone.forward(pp, b["tokens"], ctx, cfg, ep_data_size=d,
                                      frontend_sp=b.get("frontend"),
                                      enc_embeds_sp=b.get("enc"))
            ce = backbone.ce_loss(pp["embed"], x, b["labels"], ctx, cfg)
            return (ce + 1e-3 * aux) / world, ce
        (_, ce), g = jax.value_and_grad(objective, has_aux=True)(params)
        g = jax.tree.map(lambda gl, pl: sync_gradient(gl, pl), g, plan,
                         is_leaf=lambda z: hasattr(z, "sync_axes"))
        return jax.lax.psum(ce / world, ("data", "model")), g

    body = jax.shard_map(grads_body, mesh=mesh, in_specs=(p_ps, bundle.batch_pspecs),
                         out_specs=(JP(), p_ps), check_vma=False)
    loss, g = jax.jit(body)(params, batch)
    out[f"{name}/loss"] = np.asarray(loss)
    flat(g, f"{name}/grads", out)
    new_p, new_o, metrics = bundle.step(params, opt, batch)
    flat(new_p, f"{name}/after/params", out)
    flat(new_o, f"{name}/after/opt", out)
    flat(metrics, f"{name}/metrics", out)


def init(task, inp, out):
    d, m = task["mesh"]
    mesh = mesh_of(d, m)
    cfg = config(task)
    name = task["name"]
    ocfg = OptConfig(warmup=2, total_steps=40)
    bundle = make_train_step(cfg, mesh, ocfg, batch=task["batch"])
    params, opt = init_train_state(bundle, cfg, mesh, ocfg)
    flat(params, f"{name}/params", out)
    toks = jnp.asarray(inp[f"{name}/tokens"], jnp.int32)
    losses = []
    for _ in range(task["steps"]):
        params, opt, met = bundle.step(params, opt, {"tokens": toks, "labels": toks})
        losses.append(float(met["loss"]))
    out[f"{name}/losses"] = np.asarray(losses, np.float64)


def dropped_pairs(p, x, owned, cfg, ctx, ep_data_size):
    """The (token, slot) pairs ``ffn._moe_core`` drops at capacity on this
    rank: its router, ``cap`` and running count (``ffn.py:107-127``)."""
    Nt = x.shape[0]
    k = cfg.moe_top_k
    world = ep_data_size * ctx.model_size
    probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], axis=-1)
    _, topi = jax.lax.top_k(probs, k)
    cap = int(np.ceil(Nt * k / world * cfg.capacity_factor)) + 4
    valid = jnp.repeat(owned, k)
    dest = topi.reshape(-1) % world
    onehot = jax.nn.one_hot(dest, world, dtype=jnp.int32) * valid[:, None].astype(jnp.int32)
    pos = ((jnp.cumsum(onehot, axis=0) - 1) * onehot).sum(-1)
    return (valid & (pos >= cap)).sum()


def moe_layers(task, inp, out):
    d, m = task["mesh"]
    mesh = mesh_of(d, m)
    ctx = mesh_ctx(mesh)
    cfg = config(task)
    name = task["name"]
    seq, rows = JP("data", "model", None), JP("data", None, None)

    def vjp_body(f):
        def body(params, xs, cots, cot_aux):
            outs, pull = jax.vjp(f, params, xs)
            cot = tuple(c[0] for c in cots) + ((cot_aux,) if len(outs) > len(cots) else ())
            gp, gx = pull(cot)
            return (tuple(o[None] for o in outs), jax.tree.map(lambda g: g[None], gp),
                    gx[None])
        return body

    def run(key, f, params, x_in, x_spec, cots, p_spec):
        body = jax.shard_map(vjp_body(f), mesh=mesh,
                             in_specs=(p_spec, x_spec, (RANKS,) * len(cots), JP()),
                             out_specs=RANKS, check_vma=False)
        outs, gp, gx = jax.jit(body)(params, x_in, cots, jnp.float32(task.get("cot_aux", 0.0)))
        for i, o in enumerate(outs):
            out[f"{name}/{key}/out{i}"] = np.asarray(o)
        out[f"{name}/{key}/dx"] = np.asarray(gx)
        flat(gp, f"{name}/{key}/dp", out)

    if f"{name}/params/moe/router" in inp:
        p = unflat(inp, f"{name}/params/moe")
        p_spec = pspecs(ffn.moe_spec(cfg, ctx))
        for key, x_spec, owned_of in (
                ("apply", seq, lambda n: jnp.ones(n, bool)),
                ("decode", rows, lambda n: (jnp.arange(n) % m) == (ctx.midx() if m > 1 else 0))):
            if f"{name}/x{'' if key == 'apply' else 'dec'}" not in inp:
                continue
            xg = inp[f"{name}/x" if key == "apply" else f"{name}/xdec"]
            fn = ffn.moe_apply if key == "apply" else ffn.moe_decode
            run(key, lambda pp, xx, fn=fn: fn(pp, xx, ctx, cfg, d), p, xg, x_spec,
                (inp[f"{name}/cot/{key}"],), p_spec)

            def drops(pp, xx, owned_of=owned_of):
                xf = xx.reshape(-1, xx.shape[-1])
                return dropped_pairs(pp, xf, owned_of(xf.shape[0]), cfg, ctx, d)[None]

            out[f"{name}/{key}/dropped"] = np.asarray(per_rank(mesh, drops, (p_spec, x_spec),
                                                               p, xg))
    if f"{name}/params/mla/wkv_a" in inp:
        p = unflat(inp, f"{name}/params/mla")
        p_spec = pspecs(attention.mla_spec(cfg, ctx))
        xg = inp[f"{name}/x"]

        def mla(pp, xx):
            o, (c, kr) = attention.mla_apply(pp, xx, ctx, cfg, return_latent=True)
            return o, c, kr

        run("mla", mla, p, xg, seq, tuple(inp[f"{name}/cot/{k}"] for k in ("mla", "c_kv",
                                                                          "k_rope")), p_spec)
        if "max_len" in task:
            steps = [inp[f"{name}/xstep{i}"] for i in range(task["n_steps"])]

            def dec(pp, xx, *xs):
                _, (c, kr) = attention.mla_apply(pp, xx, ctx, cfg, return_latent=True)
                cache = attention.mla_init_cache(cfg, ctx, c.shape[0], task["max_len"])
                cache = attention.mla_fill_cache(cache, c, kr, ctx)
                outs = []
                for xd in xs:
                    o, cache = attention.mla_decode(pp, xd, cache, ctx, cfg)
                    outs.append(o[None])
                return (tuple(outs), cache["c_kv"].astype(jnp.float32)[None],
                        cache["k_rope"].astype(jnp.float32)[None])

            body = jax.shard_map(dec, mesh=mesh, in_specs=(p_spec, seq) + (rows,) * len(steps),
                                 out_specs=RANKS, check_vma=False)
            outs, c, kr = jax.jit(body)(p, xg, *steps)
            for i, o in enumerate(outs):
                out[f"{name}/mla_decode/y{i}"] = np.asarray(o)
            out[f"{name}/mla_decode/c_kv"] = np.asarray(c)
            out[f"{name}/mla_decode/k_rope"] = np.asarray(kr)


def recurrent_layers(task, inp, out):
    d, m = task["mesh"]
    mesh = mesh_of(d, m)
    ctx = mesh_ctx(mesh)
    cfg = config(task)
    name = task["name"]
    parts = task["parts"]
    seq, rows = JP("data", "model", None), JP("data", None, None)
    f32 = jnp.float32
    x = inp[f"{name}/x"]
    steps = [inp[f"{name}/xstep{i}"] for i in range(task.get("n_steps", 0))]
    specs = {"rglru": pspecs(rglru.rglru_spec(cfg, ctx)),
             "attn": pspecs(attention.gqa_spec(cfg, ctx)),
             "ssm": pspecs(ssm.ssm_spec(cfg, ctx))}
    params = {k: unflat(inp, f"{name}/params/{k}") for k in parts}
    per = lambda t: jax.tree.map(lambda a: jnp.asarray(a, f32)[None], t)   # noqa: E731

    def applies(key, pp, xs):
        if key == "rglru":
            o, st = rglru.rglru_apply(pp, xs, ctx, cfg, return_state=True)
            return o, {"h": st["h"], "conv": st["conv"]}
        if key == "attn":
            o, (k, v) = attention.gqa_apply(pp, xs, ctx, cfg, window=cfg.window,
                                            return_kv=True)
            return o, {"k": k, "v": v}
        o, st = ssm.ssm_apply(pp, xs, ctx, cfg, return_state=True)
        return o, {"ssd": st["ssd"], "conv": st["conv"]}

    def vjp_body(key):
        def body(pp, xs, cot):
            y, pull, aux = jax.vjp(lambda a, b: applies(key, a, b), pp, xs, has_aux=True)
            gp, gx = pull(cot[0])
            return y[None], per(aux), per(gp), gx[None]
        return body

    def chains(key, pp, xs, *xd):
        ys = []
        if key == "rglru":
            cache = {"h": xs[0], "conv": xs[1], "len": jnp.int32(0)}
            for xx in xd:
                o, cache = rglru.rglru_decode(pp, xx, cache, ctx, cfg)
                ys.append(o)
            st = {"h": cache["h"], "conv": cache["conv"]}
        elif key == "attn":
            _, (k, v) = attention.gqa_apply(pp, xs, ctx, cfg, window=cfg.window,
                                            return_kv=True)
            cache = attention.local_fill_cache(None, k, v, cfg)
            for xx in xd:
                o, cache = attention.local_decode(pp, xx, cache, ctx, cfg)
                ys.append(o)
            st = {"k": cache["k"], "v": cache["v"]}
        else:
            _, cache = ssm.ssm_apply(pp, xs, ctx, cfg, return_state=True)
            for xx in xd:
                o, cache = ssm.ssm_decode(pp, xx, cache, ctx, cfg)
                ys.append(o)
            st = {"ssd": cache["ssd"], "conv": cache["conv"]}
        return tuple(per(y) for y in ys), per(st)

    for key in parts:
        try:
            body = jax.shard_map(vjp_body(key), mesh=mesh,
                                 in_specs=(specs[key], seq, RANKS), out_specs=RANKS,
                                 check_vma=False)
            y, st, gp, gx = jax.jit(body)(params[key], x, inp[f"{name}/cot/{key}"])
        except Exception as e:          # noqa: BLE001 -- recorded, the test reads it
            out[f"{name}/{key}/error"] = np.asarray(type(e).__name__)
            continue
        out[f"{name}/{key}/y"], out[f"{name}/{key}/dx"] = np.asarray(y), np.asarray(gx)
        flat(st, f"{name}/{key}/state", out)
        flat(gp, f"{name}/{key}/dp", out)
        if not steps:
            continue
        if key == "rglru":
            xs, x_spec = (inp[f"{name}/h0"], inp[f"{name}/conv0"]), (JP("data", None), rows)
        else:
            xs, x_spec = x, seq
        body = jax.shard_map(lambda pp, a, *b, key=key: chains(key, pp, a, *b), mesh=mesh,
                             in_specs=(specs[key], x_spec) + (rows,) * len(steps),
                             out_specs=RANKS, check_vma=False)
        ys, st = jax.jit(body)(params[key], xs, *steps)
        for i, y in enumerate(ys):
            out[f"{name}/{key}_decode/y{i}"] = np.asarray(y)
        flat(st, f"{name}/{key}_decode/state", out)
    if "rglru" in parts:
        out[f"{name}/raw_tail"] = np.asarray(rglru._branch_in(params["rglru"], x)[1][:, -3:])


def forward(task, inp, out):
    d, m = task["mesh"]
    mesh = mesh_of(d, m)
    ctx = mesh_ctx(mesh)
    cfg = config(task)
    name = task["name"]
    params = jax.tree.map(jnp.asarray, unflat(inp, f"{name}/params"))
    spec = pspecs(backbone.model_spec(cfg, ctx))
    extra = [k for k in ("enc", "frontend") if f"{name}/{k}" in inp]

    def body(p, t, *xs):
        kw = dict(zip(("enc_embeds_sp" if k == "enc" else "frontend_sp" for k in extra), xs))
        return backbone.forward(p, t, ctx, cfg, ep_data_size=d, remat=False, **kw)[0]

    body = jax.shard_map(
        body, mesh=mesh,
        in_specs=(spec, JP("data", "model")) + (JP("data", "model", None),) * len(extra),
        out_specs=JP("data", "model", None), check_vma=False)
    out[f"{name}/x"] = np.asarray(jax.jit(body)(
        params, jnp.asarray(inp[f"{name}/tokens"], jnp.int32),
        *(jnp.asarray(inp[f"{name}/{k}"], jnp.float32) for k in extra)))


def frontend_layers(task, inp, out):
    d, m = task["mesh"]
    mesh = mesh_of(d, m)
    ctx = mesh_ctx(mesh)
    cfg = config(task)
    name = task["name"]
    parts = task["parts"]
    seq, rows = JP("data", "model", None), JP("data", None, None)
    per = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float32)[None], t)   # noqa: E731
    if "encode" in parts:
        p = unflat(inp, f"{name}/params/enc")
        p_spec = pspecs(backbone.model_spec(cfg, ctx))["enc"]

        def enc_body(pp, xs, cot):
            y, pull = jax.vjp(lambda a, b: backbone.encode({"enc": a}, b, ctx, cfg), pp, xs)
            gp, gx = pull(cot[0])
            return y[None], per(gp), gx[None]

        body = jax.shard_map(enc_body, mesh=mesh, in_specs=(p_spec, seq, RANKS),
                             out_specs=RANKS, check_vma=False)
        y, gp, gx = jax.jit(body)(p, inp[f"{name}/frames"], inp[f"{name}/cot/encode"])
        out[f"{name}/encode/y"], out[f"{name}/encode/dx"] = np.asarray(y), np.asarray(gx)
        flat(gp, f"{name}/encode/dp", out)
    if "cross" in parts:
        p = unflat(inp, f"{name}/params/cross")
        p_spec = pspecs(attention.gqa_spec(cfg, ctx))

        def cross_body(pp, xs, mem, cot):
            y, pull = jax.vjp(lambda a, b, c: attention.gqa_apply(
                a, b, ctx, cfg, causal=False, memory=c), pp, xs, mem)
            gp, gx, gm = pull(cot[0])
            return y[None], per(gp), gx[None], gm[None]

        body = jax.shard_map(cross_body, mesh=mesh, in_specs=(p_spec, seq, rows, RANKS),
                             out_specs=RANKS, check_vma=False)
        y, gp, gx, gm = jax.jit(body)(p, inp[f"{name}/x"], inp[f"{name}/memory"],
                                      inp[f"{name}/cot/cross"])
        out[f"{name}/cross/y"], out[f"{name}/cross/dx"] = np.asarray(y), np.asarray(gx)
        out[f"{name}/cross/dmem"] = np.asarray(gm)
        flat(gp, f"{name}/cross/dp", out)
        steps = [inp[f"{name}/xstep{i}"] for i in range(task["n_steps"])]
        cache_spec = JP("data", None, "model", None)

        def cache_body(pp, mem, k, v, *xd):
            c = attention.cross_fill_cache(pp, mem, cfg, ctx)
            given = {"k": k.astype(jnp.bfloat16), "v": v.astype(jnp.bfloat16),
                     "len": jnp.int32(task["cache_len"])}
            ys = tuple(attention.cross_decode(pp, xx, given, ctx, cfg)[None] for xx in xd)
            return per({"k": c["k"], "v": c["v"]}), ys

        body = jax.shard_map(cache_body, mesh=mesh,
                             in_specs=(p_spec, rows, cache_spec, cache_spec)
                             + (rows,) * len(steps), out_specs=RANKS, check_vma=False)
        c, ys = jax.jit(body)(p, inp[f"{name}/memory"], inp[f"{name}/cache_k"],
                              inp[f"{name}/cache_v"], *steps)
        flat(c, f"{name}/cross_cache", out)
        for i, y in enumerate(ys):
            out[f"{name}/cross_decode/y{i}"] = np.asarray(y)


def serve(task, inp, out):
    d, m = task["mesh"]
    mesh = mesh_of(d, m)
    cfg = config(task)
    name = task["name"]
    params = jax.tree.map(jnp.asarray, unflat(inp, f"{name}/params"))
    sched = BatchScheduler(cfg, mesh, batch=task["batch"], max_len=task["max_len"],
                           eos_id=task["eos_id"], enc_len=task.get("enc_len", 32))
    reqs = [Request(rid, prompt, max_new) for rid, prompt, max_new in task["requests"]]
    runs = task.get("runs") or [list(range(len(reqs)))]
    run_extras = []
    counts = np.zeros(4, np.int64)
    for i, idx in enumerate(runs):
        extras = {k: jnp.asarray(inp[f"{name}/extras{i}/{k}"], jnp.float32)
                  for k in ("enc", "frontend") if f"{name}/extras{i}/{k}" in inp} or None
        run_extras.append(extras)
        done, stats = sched.run(params, [reqs[j] for j in idx], extras=extras)
        for rid, c in done.items():
            out[f"{name}/tokens/{rid}"] = np.asarray(c.tokens, np.int32)
            out[f"{name}/finished/{rid}"] = np.asarray(c.finished)
        counts += (stats.requests, stats.prefill_tokens, stats.decode_steps, stats.batches)
    out[f"{name}/stats"] = counts
    plen = task.get("prefill")
    if plen:
        prompts = [r.prompt for r in reqs if len(r.prompt) == plen][:task["batch"]]
        prompts += [prompts[0]] * (task["batch"] - len(prompts))     # pad with a copy
        toks = jnp.asarray(np.asarray(prompts, np.int32))
        extras = next(e for idx, e in zip(runs, run_extras)
                      if any(len(reqs[i].prompt) == plen for i in idx)) or {}
        caches, tok = sched._engine(plen).prefill(params, {"tokens": toks, **extras})
        flat(caches, f"{name}/caches", out)
        out[f"{name}/prefill_token"] = np.asarray(tok)


def dryrun(task, inp, out):
    import repro.launch.cells as ref_cells
    from repro.roofline.hlo import analyze_hlo

    shape, name = task["shape"], task["name"]
    n = int(np.prod(task["mesh"]))
    mesh = jax.make_mesh(tuple(task["mesh"]), tuple(task["axes"]), devices=jax.devices()[:n],
                         axis_types=(jax.sharding.AxisType.Auto,) * len(task["axes"]))
    saved = ref_cells.get_config, dict(ref_cells.SHAPES[shape])
    ref_cells.get_config = get_smoke_config
    ref_cells.SHAPES[shape].update(batch=task["batch"], seq=task["seq"])
    try:
        cell = ref_cells.build_cell(task["arch"], shape, mesh)
        text = cell.fn.lower(*cell.args).compile().as_text()
    finally:
        ref_cells.get_config = saved[0]
        ref_cells.SHAPES[shape] = saved[1]
    res = analyze_hlo(text, n)
    out[f"{name}/flops"] = np.float64(res["flops_per_device"])
    out[f"{name}/unresolved"] = np.int64(res["unresolved_dots"])
    for op, b in res["collective_by_op_per_device"].items():
        out[f"{name}/ring/{op}"] = np.float64(b)
        out[f"{name}/calls/{op}"] = np.int64(res["collective_op_counts"][op])
    for key, b in _by_dtype(text, n).items():
        out[f"{name}/dtype/{key}"] = np.float64(b)


def _by_dtype(text, n):
    """``analyze_hlo``'s ring bytes of each collective split by element type,
    ``{op}|{dtype}`` -> bytes (trip counts included), and the tensors each
    carries, ``{op}|{dtype}|tensors`` -> count (an element of a combined,
    tuple-shaped collective counts as one)."""
    import repro.roofline.hlo as hlo

    scan = hlo._scan_line

    def split(comp, line):
        d = hlo._DEF_RE.match(line)
        op = d.group(3) if d else ""
        base = op[:-6] if op.endswith("-start") else op
        if base in hlo._COLL_OPS and not op.endswith("-done"):
            parts = hlo._participants(line, 0) or 1
            for dt, dims in hlo._SHAPE_TOK.findall(d.group(2)):
                size = int(np.prod([int(x) for x in dims.split(",") if x.strip()]))
                comp.coll[f"{base}|{dt}"] += hlo._coll_bytes(
                    base, size * hlo._DTYPE_BYTES[dt], parts)
                comp.coll_counts[f"{base}|{dt}|tensors"] += 1
        scan(comp, line)

    hlo._scan_line = split
    try:
        res = hlo.analyze_hlo(text, n)
    finally:
        hlo._scan_line = scan
    out = {k: v for k, v in res["collective_by_op_per_device"].items() if "|" in k}
    out.update((k, v) for k, v in res["collective_op_counts"].items() if "|" in k)
    return out


def main():
    inp = dict(np.load(sys.argv[1]))
    out = {}
    for task in json.loads(str(inp.pop("job"))):
        {"coll": coll, "layers": layer_fns, "step": step, "init": init,
         "serve": serve, "moe_layers": moe_layers, "recurrent_layers": recurrent_layers,
         "forward": forward, "frontend_layers": frontend_layers,
         "dryrun": dryrun}[task["kind"]](
            task, inp, out)
    np.savez(sys.argv[2], **out)


if __name__ == "__main__":
    main()
