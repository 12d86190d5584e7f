#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--sessions-per-d 7] [--size 1000000] [--seed 0]

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version on the card (exact equality —
everything is integer / GF(2) arithmetic, tolerance 0), then drives the
main path — ``ReconcileServer.submit -> run`` — over sessions of |A| = 10^6
uint32 keys and compares every result with the package's own numpy oracle
``core.pbs.reconcile`` and with the true set difference.  Last, every kernel
is compared with its plain version, timed and held against its bound at
exactly the shapes that run launched it at (read from the launch ledger).

Each phase prints one JSON line; any failed phase raises and the process
exits non-zero.  The last line of standard output is
``{"ok": true, "device": {...}}``.  Needs a CUDA device: exits 1 without one.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: no CUDA device available\n")
    sys.exit(1)

from repro_torch.core.pbs import PBSConfig, reconcile  # noqa: E402
from repro_torch.core.simdata import make_pair, make_pair_two_sided  # noqa: E402
from repro_torch.kernels import platform  # noqa: E402
from repro_torch.kernels.bin_xorsum import (  # noqa: E402
    bin_parity_xorsum_units,
    bin_parity_xorsum_units_plain,
)
from repro_torch.kernels.gf2_matmul import gf2_matmul, gf2_matmul_plain  # noqa: E402
from repro_torch.kernels.ops import bch_decode_batched  # noqa: E402
from repro_torch.kernels.tow_sketch import tow_sketch, tow_sketch_plain  # noqa: E402
from repro_torch.recon import ReconcileServer  # noqa: E402

DEV = torch.device("cuda", 0)

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): device memory
# 3.35 TB/s; int8 tensor cores 1979 TOP/s (the rate a 0/1 matrix product is
# held to); 67 T op/s for 32-bit arithmetic outside the tensor cores (the
# float32 figure — the integer pipes are narrower, so the bound is generous).
HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1979e12
ALU32_OPS_PER_S = 67e12

# 32-bit operations per hashed key: mix32 is 3 shifts, 3 xors, 2 multiplies,
# 1 add, plus the seed multiply
MIX32_OPS = 10
K1_OPS_PER_KEY = MIX32_OPS + 1 + 2        # + multiply-high + two atomic xors
K3_OPS_PER_KEY_SEED = MIX32_OPS + 1 + 3   # + seed xor, low bit, sign, add

KERNELS = {
    "bin_xorsum_units": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bin_xorsum_units.cu",
        "replaces": "src/repro/kernels/bin_xorsum.py:180",
    },
    "gf2_matmul": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gf2_matmul.cu",
        "replaces": "src/repro/kernels/gf2_matmul.py:70",
    },
    "tow_sketch": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tow_sketch.cu",
        "replaces": "src/repro/kernels/tow_sketch.py:72",
    },
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def sh(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def times_ms(fn, reps: int) -> list:
    """Device time of each of ``reps`` calls of ``fn`` after one warm-up."""
    fn()
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    marks[0].record()
    for i in range(reps):
        fn()
        marks[i + 1].record()
    torch.cuda.synchronize()
    return [marks[i].elapsed_time(marks[i + 1]) for i in range(reps)]


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    return float(np.mean(times_ms(fn, reps)))


def dev_u32(arr: np.ndarray) -> torch.Tensor:
    return platform.upload(np.asarray(arr, dtype=np.uint32), DEV)


def max_err(*pairs) -> int:
    return max(
        int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0
        for a, b in pairs
    )


# ---------------------------------------------------------------------------
# kernel cases
# ---------------------------------------------------------------------------


def k1_case(rng, U, E, n_bins, fill="ragged"):
    """Packed unit rows on the card: ragged valid prefixes, per-unit seeds,
    keys over the whole uint32 range, one fully masked row (where U > 1)."""
    elems = torch.from_numpy(
        rng.integers(0, 1 << 32, size=(U, E), dtype=np.uint64).astype(np.uint32).view(np.int32)
    ).to(DEV)
    if fill == "ragged":
        counts = rng.integers(0, E + 1, size=U)
        counts[0] = E
    else:                                       # main-path rows: nearly full
        counts = rng.integers(int(0.9 * E), E + 1, size=U)
    if U > 1:
        counts[1] = 0
    valid = torch.arange(E, device=DEV)[None, :] < torch.from_numpy(counts).to(DEV)[:, None]
    seeds = dev_u32(rng.integers(0, 1 << 32, size=U, dtype=np.uint64))
    return elems, valid, seeds, int(counts.sum())


def check_k1(case, n_bins):
    """Largest difference between the kernel and its plain version on
    ``case``; a fully masked row must come back all zero."""
    elems, valid, seeds, _ = case
    p, x = bin_parity_xorsum_units(elems, valid, seeds, n_bins=n_bins)
    pp, xp = bin_parity_xorsum_units_plain(elems, valid, seeds, n_bins=n_bins)
    masked = ~valid.any(dim=1)
    assert not bool(p[masked].any()) and not bool(x[masked].any()), "masked row not zero"
    return max_err((p, pp), (x, xp))


def k2_case(rng, M, K, N):
    a = torch.from_numpy(rng.integers(0, 2, (M, K)).astype(np.int32)).to(DEV)
    b = torch.from_numpy(rng.integers(0, 2, (K, N)).astype(np.int32)).to(DEV)
    return a, b


def k3_case(rng, E, ell, n_valid=None):
    elems = dev_u32(rng.integers(0, 1 << 32, size=E, dtype=np.uint64))
    seeds = dev_u32(rng.integers(0, 1 << 32, size=ell, dtype=np.uint64))
    valid = None
    if n_valid is not None:
        valid = torch.arange(E, device=DEV) < n_valid
    return elems, seeds, valid


def kernel_sweeps(rng):
    """Each kernel against its plain version on the card over the shape
    sweeps of the CPU tests (and a few larger ones), exact equality."""
    checks = []

    err, shapes = 0, []
    for n_bins in (63, 127, 8191, 16383):
        for U, E in ((6, 257), (3, 1), (16, 5000), (5, 20011)):
            err = max(err, check_k1(k1_case(rng, U, E, n_bins), n_bins))
            shapes.append([U, E, n_bins])
    checks.append({"name": "bin_xorsum_units", "shapes": shapes, "equal": err == 0})

    err = 0
    shapes = [[1, 127, 91], [8, 255, 88], [17, 511, 153], [64, 1023, 110],
              [3, 2047, 187], [130, 300, 260], [5, 64, 640], [100, 700, 200],
              [70, 16383, 28]]
    for mm, kk, nn in shapes:
        a, b = k2_case(rng, mm, kk, nn)
        err = max(err, max_err((gf2_matmul(a, b), gf2_matmul_plain(a, b))))
    checks.append({"name": "gf2_matmul", "shapes": shapes, "equal": err == 0})

    err, shapes = 0, []
    for ell in (32, 100, 128, 300):
        for E, n_valid in ((5, None), (2048, None), (7001, None), (8192, 7001), (4096, 0)):
            e, s, v = k3_case(rng, E, ell, n_valid)
            err = max(err, max_err((tow_sketch(e, s, v, ell=ell), tow_sketch_plain(e, s, v))))
            shapes.append([E, ell, n_valid])
    checks.append({"name": "tow_sketch", "shapes": shapes, "equal": err == 0})

    torch.cuda.synchronize()
    emit({"phase": "kernels", "kernel_checks": checks})
    for c in checks:
        assert c["equal"], f"{c['name']} differs from its plain version"


def bound(b_bytes: float, b_ops: float) -> dict:
    return {"bound_ms": 1e3 * max(b_bytes, b_ops),
            "bound_by": "bytes" if b_bytes >= b_ops else "operations"}


def main_shape_phase(args, rng, launched):
    """Each kernel at exactly the shapes the serve run launched it at
    (``launched``: ``platform.launch_shapes()`` read just after that run):
    compared with its plain version, timed, and held against its bound.
    The headline numbers of a kernel are those of its largest launch."""
    report = {}

    # ---- K1: keys (U, E) into n bins --------------------------------------
    k1 = launched["bin_xorsum_units"]
    biggest = max(k1, key=lambda k: k[0] * k[1])
    longest = max(k1, key=lambda k: k[1])
    rows, kept = {}, {}
    for (U, E, n), count in sorted(k1.items()):
        case = k1_case(rng, U, E, n, fill="full")
        elems, valid, seeds, _ = case
        err = check_k1(case, n)
        ts = times_ms(lambda: bin_parity_xorsum_units(elems, valid, seeds, n_bins=n), 50)
        rows[(U, E, n)] = {
            "shape": [U, E, n], "launches": count, "max_abs_err": err,
            "ms": float(np.mean(ts)), "ms_min": min(ts), "ms_median": float(np.median(ts))}
        if (U, E, n) in (biggest, longest):
            kept[(U, E, n)] = case
    U, E, n = biggest
    elems, valid, seeds, n_valid = kept[biggest]
    report["bin_xorsum_units"] = {
        "shapes": {"elems": [U, E], "n_bins": n},
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": rows[biggest]["ms"],
        "plain_ms": time_ms(
            lambda: bin_parity_xorsum_units_plain(elems, valid, seeds, n_bins=n), 2),
        **bound((U * E * 5 + U * 4 + 2 * U * n * 4) / HBM_BYTES_PER_S,
                n_valid * K1_OPS_PER_KEY / ALU32_OPS_PER_S),
        "library_ms": None,
        "launched_shapes": list(rows.values()),
    }
    # the other extreme of the main path: the launch with the longest rows
    U, E, n = longest
    report["bin_xorsum_units"]["long_rows"] = {
        **rows[longest],
        **bound((U * E * 5 + U * 4 + 2 * U * n * 4) / HBM_BYTES_PER_S,
                kept[longest][3] * K1_OPS_PER_KEY / ALU32_OPS_PER_S),
    }
    del kept, case, elems, valid, seeds

    # ---- K2: (M, K) @ (K, N) ----------------------------------------------
    rows = []
    for (M, K, N), count in sorted(launched["gf2_matmul"].items()):
        a, b = k2_case(rng, M, K, N)
        err = max_err((gf2_matmul(a, b), gf2_matmul_plain(a, b)))
        rows.append({"shape": [M, K, N], "launches": count, "max_abs_err": err,
                     "ms": time_ms(lambda: gf2_matmul(a, b), 20)})
    head = max(rows, key=lambda r: r["shape"][0] * r["shape"][1] * r["shape"][2])
    M, K, N = head["shape"]
    a, b = k2_case(rng, M, K, N)
    report["gf2_matmul"] = {
        "shapes": {"a": [M, K], "b": [K, N]},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": head["ms"],
        "plain_ms": time_ms(lambda: gf2_matmul_plain(a, b), 5),
        **bound((M * K + K * N + M * N) * 4 / HBM_BYTES_PER_S,
                2 * M * K * N / INT8_TENSOR_OPS_PER_S),
        # the one PyTorch call computing the same function; used nowhere in the port
        "library_ms": time_ms(lambda: (a.float() @ b.float()) % 2, 5),
        "launched_shapes": rows,
    }
    del a, b

    # ---- K3: (R, E) keys, ell seeds; the path pads |S| up to E -------------
    rows = []
    for (R, E, ell), count in sorted(launched["tow_sketch"].items()):
        assert R == 1, (R, E, ell)
        n_valid = min(args.size, E)
        e, s, v = k3_case(rng, E, ell, n_valid)
        err = max_err((tow_sketch(e, s, v, ell=ell), tow_sketch_plain(e, s, v)))
        rows.append({"shape": [R, E, ell], "valid": n_valid, "launches": count,
                     "max_abs_err": err,
                     "ms": time_ms(lambda: tow_sketch(e, s, v, ell=ell), 20)})
    head = max(rows, key=lambda r: r["shape"][1])
    _, E, ell = head["shape"]
    e, s, v = k3_case(rng, E, ell, head["valid"])
    report["tow_sketch"] = {
        "shapes": {"elems": [E], "ell": ell, "valid": head["valid"]},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": head["ms"],
        "plain_ms": time_ms(lambda: tow_sketch_plain(e, s, v), 2),
        **bound((E * 5 + 2 * ell * 4) / HBM_BYTES_PER_S,
                (E * MIX32_OPS + head["valid"] * ell * K3_OPS_PER_KEY_SEED)
                / ALU32_OPS_PER_S),
        "library_ms": None,
        "launched_shapes": rows,
    }
    del e, s, v

    # ---- the third device stage of a round (plain tensor ops, no kernel),
    # at the unit count and code of the largest K2 launch ---------------------
    m = (K + 1).bit_length() - 1
    u, t = M // 2, N // m
    sk = torch.from_numpy(rng.integers(0, 1 << m, size=(u, t)).astype(np.int32)).to(DEV)
    sk[::2] = 0
    decode_ms = time_ms(lambda: bch_decode_batched(sk, n=K, t=t), 3)

    torch.cuda.synchronize()
    for name, rep in report.items():
        assert rep["max_abs_err"] == 0, f"{name} differs from its plain version"
    emit({"phase": "main_path_shapes",
          "bch_decode_batched": {"shapes": {"sketches": [u, t], "n": K, "t": t},
                                 "ms": decode_ms}})
    return report


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------


def make_sessions(args, rng):
    """(label, a, b, cfg, d_known-for-the-server, true d) per session."""
    out = []
    for d in (10, 100, 1000, 10000):
        for _ in range(args.sessions_per_d):
            a, b = make_pair(args.size, d, rng)
            out.append((f"known d={d}", a, b, PBSConfig(), d))
    for _ in range(2):
        a, b = make_pair(args.size, 1000, rng)
        out.append(("estimator d=1000", a, b, PBSConfig(), None))
    a, b = make_pair_two_sided(args.size, 300, 200, rng)
    out.append(("two-sided d=500", a, b, PBSConfig(), 500))
    a, b = make_pair(args.size, 1000, rng)
    out.append(("rateless d=1000 told 100", a, b, PBSConfig(rateless=True), 100))
    return out


def run_server(sessions):
    """Submit every session and run; returns (server, results, wall seconds,
    seconds of that spent in submit)."""
    server = ReconcileServer()           # device=None: the card
    t0 = time.perf_counter()
    for _, a, b, cfg, dk in sessions:
        server.submit(a, b, cfg=cfg, d_known=dk)
    submit_s = time.perf_counter() - t0
    results = server.run()
    torch.cuda.synchronize()
    return server, results, time.perf_counter() - t0, submit_s


def oracle_results(sessions):
    """``core.pbs.reconcile`` of every pair, on the host.  One oracle run
    takes seconds at |A| = 10^6, so they go to a pool of worker processes
    (numpy only; none touches the device)."""
    jobs = [(a, b, cfg, dk) for _, a, b, cfg, dk in sessions]
    workers = max(1, min(len(jobs), (os.cpu_count() or 2) - 1))
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        return pool.starmap(reconcile, jobs)


def serve_phase(args, rng):
    t0 = time.perf_counter()
    sessions = make_sessions(args, rng)
    data_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    platform.reset_launch_counts()
    server, results, cold_s, cold_submit_s = run_server(sessions)
    launches, launched = platform.launch_counts(), platform.launch_shapes()
    stats = server.stats
    peak = torch.cuda.max_memory_allocated()

    for name in KERNELS:
        assert launches.get(name, 0) > 0, f"main path never launched {name}: {launches}"
    assert stats["retraces"] > 0, "a cold run met no new executor variant"
    # two kernel launches per cohort-round, plus two per rateless extension
    # level: the ledger's count must be the launches that really happened
    bins, mats = launches["bin_xorsum_units"], launches["gf2_matmul"]
    assert bins == mats and stats["kernel_launches"] == bins + mats, (launches, stats)
    ext_levels = bins - stats["cohort_rounds"]
    assert ext_levels > 0 and stats["parity_extensions"] > 0, (launches, stats)
    n_est = sum(1 for s in sessions if s[4] is None)
    assert launches["tow_sketch"] == 2 * n_est, launches

    # every session against the package's own numpy oracle and the truth
    t0 = time.perf_counter()
    wants = oracle_results(sessions)
    for sid, (label, a, b, cfg, dk) in enumerate(sessions):
        got, want = results[sid], wants[sid]
        assert got.success, (sid, label)
        assert got == want, (sid, label, got, want)      # every result field
        assert got.diff == set(np.setxor1d(a, b).tolist()), (sid, label)
    oracle_s = time.perf_counter() - t0

    warm_server, warm_results, warm_s, warm_submit_s = run_server(sessions)
    wstats = warm_server.stats
    assert wstats["retraces"] == 0, f"warm run met new variants: {wstats['retraces']}"
    for sid in results:
        assert results[sid] == warm_results[sid], sid

    ledger = ("rounds", "cohort_rounds", "kernel_launches", "parity_extensions",
              "h2d_store_bytes", "h2d_round_bytes", "h2d_bytes", "store_builds",
              "retraces")
    emit({
        "phase": "serve",
        "sessions": len(sessions), "set_size": args.size,
        "sessions_cut": args.sessions_per_d != 7,
        "data_s": data_s, "oracle_check_s": oracle_s,
        "cold_s": cold_s, "warm_s": warm_s,
        "cold_submit_s": cold_submit_s, "warm_submit_s": warm_submit_s,
        "sessions_per_s_warm": len(sessions) / warm_s,
        "warm_run_s": wstats["total_s"], "device_s": wstats["device_s"],
        "host_s": wstats["host_s"], "phase0_s": wstats["phase0_s"],
        "cold": {k: stats[k] for k in ledger},
        "warm": {k: wstats[k] for k in ledger},
        "launches": launches,
        "peak_memory_allocated_bytes": peak,
        "all_sessions_match_oracle": True,
    })
    if args.profile:
        profile_run(sessions, args.profile)
    return launches, launched


def profile_run(sessions, out_path):
    """One more warm ``run()`` under ``torch.profiler``: device time by
    kernel name and the device's busy share of the run, written as JSON."""
    from torch.profiler import ProfilerActivity, profile

    server = ReconcileServer()
    for _, a, b, cfg, dk in sessions:
        server.submit(a, b, cfg=cfg, d_known=dk)
    server.sessions                      # flush phase 0 outside the window
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        server.run()
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue                     # host-side op rows repeat their kernels' time
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            rows.append({"name": ev.key[:120], "device_ms": us / 1e3, "calls": ev.count})
    if not rows:
        emit({"phase": "profile", "error": "the profiler recorded no device time"})
        return
    rows.sort(key=lambda r: -r["device_ms"])
    busy_ms = sum(r["device_ms"] for r in rows)
    report = {
        "wall_s_under_profiler": wall_s,
        "device_busy_ms": busy_ms,
        "device_busy_share_of_profiled_wall": busy_ms / (wall_s * 1e3),
        "device_launches": sum(r["calls"] for r in rows),
        "by_kernel": rows,
    }
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    Path(out_path).write_text(json.dumps(report, indent=1))
    emit({"phase": "profile", **{k: v for k, v in report.items() if k != "by_kernel"},
          "top": rows[:12], "written_to": str(out_path)})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions-per-d", type=int, default=7,
                    help="known-d sessions per d in {10, 100, 1000, 10000}")
    ap.add_argument("--size", type=int, default=1_000_000, help="|A| per session")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", metavar="PATH", default=None,
                    help="after the serve phase, profile one more run with "
                         "torch.profiler and write device time by kernel to PATH")
    ap.add_argument("--kernels-only", action="store_true",
                    help="build the kernels and run their shape sweeps; skip the "
                         "serve phase and the measurements at its shapes")
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    t_start = time.perf_counter()

    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    nvcc = sh([platform._nvcc(), "--version"]).splitlines()[-2:]
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    emit({
        "phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
        "cuda_runtime": torch.version.cuda, "nvcc": nvcc,
        "triton_installed_unused": triton_version,
        "driver_version": sh(["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"]),
        "gpu": smi,
    })

    t0 = time.perf_counter()
    libs = platform.build_kernels(verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(p.name for p in libs.values())})

    kernel_sweeps(rng)
    if not args.kernels_only:
        launches, launched = serve_phase(args, rng)
        report = main_shape_phase(args, rng, launched)
        emit({"kernels": [{"name": name, **meta, "launches": launches[name], **report[name]}
                          for name, meta in KERNELS.items()]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
