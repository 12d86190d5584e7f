"""Which collectives a process group runs on CUDA tensors when its ranks
share one card.

    python3 tools/multirank_probe.py [--out PATH] [--mib N]
        [--phase [dense] [moe] [recurrent] [frontends]]

Starts two ranks on ``cuda:0`` (``repro_torch.launch.ranks.run_ranks``,
``backend="gloo"``) and tries each collective the multi-rank training path
uses — ``all_reduce``, ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_to_all_single`` — on CUDA tensors in float32 and bfloat16, each
result checked against what it must be.  Then times an all-gather of
``--mib`` MiB a rank two ways: on CUDA tensors (where gloo takes them) and
through pinned host memory (copy out, gloo on CPU tensors, copy back).
Last, asks NCCL for two ranks on the one card, under a 90 s limit, and
records whether it refuses.  Prints one JSON line; with ``--phase`` then
runs phase ``multirank`` of ``chip_smoke.py`` alone (no kernel build),
``--phase moe`` only its MoE family's checks and serving (deepseek-v2),
``--phase dense`` only the dense family's, ``--phase recurrent`` only the
recurrent families' (recurrentgemma-2b and mamba2-780m), ``--phase
frontends`` only the frontend families' (whisper-tiny and pixtral-12b);
last the card's name and power limit.
"""
import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.launch.ranks import run_ranks  # noqa: E402

OPS = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor", "all_to_all_single")


def _try(name, dtype, dev, world, rank):
    x = (torch.arange(4 * world, dtype=torch.float32, device=dev) + 100 * rank).to(dtype)
    full = torch.stack([torch.arange(4 * world, dtype=torch.float32) + 100 * r
                        for r in range(world)])
    if name == "all_reduce":
        out = x.clone()
        dist.all_reduce(out)
        want = full.sum(0)
    elif name == "all_gather_into_tensor":
        out = torch.empty(4 * world * world, dtype=dtype, device=dev)
        dist.all_gather_into_tensor(out, x)
        want = full.reshape(-1)
    elif name == "reduce_scatter_tensor":
        out = torch.empty(4, dtype=dtype, device=dev)
        dist.reduce_scatter_tensor(out, x)
        want = full.sum(0)[4 * rank:4 * rank + 4]
    else:
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        want = full[:, 4 * rank:4 * rank + 4].reshape(-1)
    torch.cuda.synchronize()
    return bool(torch.equal(out.float().cpu(), want))


def gloo_rank(dev, mib: int):
    world, rank = dist.get_world_size(), dist.get_rank()
    ops = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name in OPS:
            try:
                ops[f"{name}/{str(dtype)[6:]}"] = "ok" if _try(name, dtype, dev, world, rank) \
                    else "wrong result"
            except (RuntimeError, ValueError, TypeError) as e:
                ops[f"{name}/{str(dtype)[6:]}"] = f"refused: {str(e).splitlines()[0][:160]}"
    n = mib * (1 << 20) // 2
    x = torch.randn(n, device=dev).to(torch.bfloat16)
    times = {}
    if ops["all_gather_into_tensor/bfloat16"] == "ok":
        out = torch.empty(n * world, dtype=torch.bfloat16, device=dev)
        for rep in range(3):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            dist.all_gather_into_tensor(out, x)
            torch.cuda.synchronize()
            times.setdefault("cuda_tensors_s", []).append(time.perf_counter() - t0)
    h_in = torch.empty(n, dtype=torch.bfloat16, pin_memory=True)
    h_out = torch.empty(n * world, dtype=torch.bfloat16, pin_memory=True)
    out = torch.empty(n * world, dtype=torch.bfloat16, device=dev)
    for rep in range(3):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        h_in.copy_(x)
        dist.all_gather_into_tensor(h_out, h_in)
        out.copy_(h_out, non_blocking=True)
        torch.cuda.synchronize()
        times.setdefault("host_staged_s", []).append(time.perf_counter() - t0)
    return {"rank": rank, "device": str(dev), "ops": ops, "all_gather_mib_a_rank": mib,
            "all_gather_times": times}


NCCL_SCRIPT = r"""
import sys, tempfile
sys.path.insert(0, sys.argv[1])
import torch, torch.distributed as dist
from datetime import timedelta
def main():
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    d = tempfile.mkdtemp()
    ps = [ctx.Process(target=child, args=(r, d)) for r in range(2)]
    [p.start() for p in ps]
    [p.join(50) for p in ps]
    alive = [p.is_alive() for p in ps]
    [p.kill() for p in ps if p.is_alive()]
    print("EXITCODES", [p.exitcode for p in ps], "HUNG", alive, flush=True)
def child(r, d):
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{d}/rdv", rank=r, world_size=2,
                            timeout=timedelta(seconds=30))
    t = torch.ones(4, device="cuda:0")
    dist.all_reduce(t)
    torch.cuda.synchronize()
    print("RANK", r, "OK", float(t[0]), flush=True)
if __name__ == "__main__":
    main()
"""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--mib", type=int, default=96)
    ap.add_argument("--phase", nargs="*", choices=("dense", "moe", "recurrent", "frontends"),
                    default=None,
                    help="then run phase multirank of chip_smoke.py (given families only)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-probe", action="store_true",
                    help="skip the probe itself (with --phase: the phase alone)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("multirank_probe: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    if not args.no_probe:
        probe(args, smi)
    if args.phase is not None:
        sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
        import chip_smoke as cs

        if args.out:
            cs._OUT.append(open(args.out, "a"))
        cs.multirank_phase(args, smi, tuple(args.phase or cs.MR_FAMILIES))
    print(smi, flush=True)


def probe(args, smi) -> None:
    """The gloo collectives on CUDA tensors, the all-gather's two routes
    and NCCL's answer for two ranks on one card: one JSON line."""
    t0 = time.perf_counter()
    gloo = run_ranks(gloo_rank, 2, tempfile.mkdtemp(), device="cuda", backend="gloo",
                     args=(args.mib,), timeout=240, threads=None)
    gloo_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    src = str(Path(__file__).resolve().parents[1] / "src")
    script = Path(tempfile.mkdtemp()) / "nccl_two_ranks.py"   # spawn needs a file
    script.write_text(NCCL_SCRIPT)
    try:
        r = subprocess.run([sys.executable, str(script), src], capture_output=True,
                           text=True, timeout=90)
        nccl = {"stdout": r.stdout[-600:], "stderr_tail": r.stderr[-1500:],
                "returncode": r.returncode}
    except subprocess.TimeoutExpired:
        nccl = {"timeout": 90}
    line = {"probe": "multirank", "gpu": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda, "device_count": torch.cuda.device_count(),
            "gloo_two_ranks_one_card": gloo, "gloo_s": gloo_s,
            "nccl_two_ranks_one_card": nccl, "nccl_s": time.perf_counter() - t0}
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        Path(args.out).write_text(text + "\n")


if __name__ == "__main__":
    main()
