#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--sessions-per-d 3] [--size 1000000] [--seed 0] [--out PATH]

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version on the card (exact equality —
everything is integer / GF(2) arithmetic, tolerance 0), then drives six
paths of the port on the card, each run with the launch counts set to 0
just before it and read just after:

* ``serve`` — ``ReconcileServer.submit -> run`` over sessions of |A| = 10^6
  uint32 keys;
* ``tree`` — ``tree.tree_reconcile`` (the cold-start front end, one
  ``tree_digest`` launch per level, then every divergent range as a leaf
  session of the server) on a uniform pair of union 10^6, d = 10^4, and on
  a clustered pair whose whole difference sits in one 2^16-wide window;
* ``encode_group`` — ``kernels.ops.encode_group`` on a 10^6-key set and a
  4096-key group, and a two-sided encode/decode round trip;
* ``wire`` — ``net.AliceEndpoint`` / ``net.BobEndpoint`` reconciling over
  frames only (``run_pair``, Bob on a worker thread): 4 of the serve
  phase's sessions over ``InMemoryDuplex`` (phase 0 over ``MSG_TOW_SKETCH``
  and rateless ``MSG_PARITY`` included), 2 over a TCP loopback socket, and
  ``submit_tree`` of the tree phase's uniform pair over ``MSG_TREE``;
* ``hub`` — one ``net.HubEndpoint`` serving 8 ``AliceEndpoint``s on threads
  (``run_hub``): 7 of the serve phase's sessions (one over TCP loopback) and a
  tree peer on the tree phase's uniform pair, every peer's round work fused
  into 2 encode launches and 1 decode launch per cohort-round; then a
  2-peer hub where one peer crashes and resumes through ``MSG_RESUME``;
* ``sync`` — a continuous hub (``run_hub_epoch``) with 2 peers of |A| =
  10^6 for 3 epochs of seeded churn, the resident stores patched in place.

Every result is compared with the package's own numpy oracle
``core.pbs.reconcile`` (per session, per tree leaf) and with the true set
difference; every wire result with the in-process result of the same
session (serve phase, tree phase), every hub result likewise, and every
epoch of the sync phase with ``core.pbs.reconcile``.  Last, every kernel is
compared with its plain version, timed and held against its bound at
exactly the shapes its path launched it at (read from the launch ledger).  Each shape gets two times: ``ms``, CUDA
events around the wrapper (host issue included), and ``device_ms``, the
kernel's own duration from ``torch.profiler`` (or a CUDA-graph replay where
the profiler records none; ``device_ms_by`` says which).  Bounds count one
bit per 0/1 entry (parity bitmaps, K2's A, B and C).  K1 and K2 are measured
through the packed entries the main path calls, K4 through the ragged entry
``tree_digest_ranges`` the walk calls, with the old route (the padded level
gather plus the masked-rows kernel) timed beside it on the same ranges.  K3
and K4 also get an issue floor: SASS instructions per hash from
``cuobjdump -sass`` of the built kernels (phase ``sass``).

Each phase prints one JSON line; any failed phase raises and the process
exits non-zero.  The last line of standard output is
``{"ok": true, "device": {...}}``.  Needs a CUDA device: exits 1 without one.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import multiprocessing
import os
import re
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

from repro_torch.core.bch import BCHCode  # noqa: E402
from repro_torch.core.pbs import PBSConfig, plan_from_d_known, reconcile  # noqa: E402
from repro_torch.core.simdata import make_pair, make_pair_two_sided  # noqa: E402
from repro_torch.kernels import platform  # noqa: E402
from repro_torch.kernels.bin_xorsum import (  # noqa: E402
    bin_parity_xorsum,
    bin_parity_xorsum_plain,
    bin_parity_xorsum_units,
    bin_parity_xorsum_units_packed,
    bin_parity_xorsum_units_packed_plain,
    bin_parity_xorsum_units_plain,
)
from repro_torch.kernels.gf2_matmul import (  # noqa: E402
    gf2_matmul,
    gf2_matmul_packed,
    gf2_matmul_packed_plain,
    gf2_matmul_plain,
    pack_bits,
    pack_bits_plain,
    pack_columns,
    packed_words,
    unpack_bits,
)
from repro_torch.kernels.ops import (  # noqa: E402
    bch_decode_batched,
    encode_group,
    pack_bits_to_field,
)
from repro_torch.kernels.tow_sketch import tow_sketch, tow_sketch_plain  # noqa: E402
from repro_torch.kernels.tree_digest import (  # noqa: E402
    range_rows,
    range_tiles,
    ragged_tile,
    tree_digest,
    tree_digest_plain,
    tree_digest_ranges,
    tree_digest_ranges_plain,
)
from repro_torch.core.hashing import derive_seed  # noqa: E402
from repro_torch.core.tow import tow_sketches  # noqa: E402
from repro_torch.net import (  # noqa: E402
    AliceEndpoint,
    BobEndpoint,
    ChaosTransport,
    FaultPlan,
    HubEndpoint,
    InMemoryDuplex,
    TransportError,
    run_hub,
    run_hub_epoch,
    run_pair,
    tcp_loopback_pair,
)
from repro_torch.net.hub import _drive_hub as drive_hub  # noqa: E402
from repro_torch.obs import Recorder, Tracer  # noqa: E402
from repro_torch.recon import ReconcileServer  # noqa: E402
from repro_torch.tree import TreeConfig, leaf_slices, partition_pair, tree_reconcile  # noqa: E402
from repro_torch.tree import partition as tree_partition  # noqa: E402

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
        "source": "src/repro_torch/kernels/csrc/bin_xorsum.cu",
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
    "tree_digest": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tow_sketch.cu",
        "replaces": "src/repro/kernels/tree_digest.py:75",
    },
    "bin_parity_xorsum": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bin_xorsum.cu",
        "replaces": "src/repro/kernels/bin_xorsum.py:109",
    },
    # packs 0/1 rows for K2 where they do not come packed out of K1
    # (encode_group's K5 parity); part of the reference's gf2_matmul
    "gf2_pack_bits": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gf2_matmul.cu",
        "replaces": "src/repro/kernels/gf2_matmul.py:70",
    },
}
# the CUDA kernel symbols each wrapper launches, as the profiler names them
SYMBOLS = {
    "bin_xorsum_units": ("short_rows_kernel", "long_rows_kernel"),
    "gf2_matmul": ("gf2_tile_kernel", "gf2_warp_kernel"),
    "tow_sketch": ("tow_rows_warp_kernel", "tow_rows_block_kernel"),
    # the tree path's entry is the ragged one; the padded contract runs K3's
    "tree_digest": ("tow_ranges_kernel",),
    "tree_digest_padded": ("tow_rows_warp_kernel", "tow_rows_block_kernel"),
    "bin_parity_xorsum": ("long_rows_kernel",),
    "gf2_pack_bits": ("gf2_pack_kernel",),
}
# the kernels each path must launch, and the path whose run gives each
# kernel's `launches` in the `kernels` line
PATHS = {
    "serve": ("bin_xorsum_units", "gf2_matmul", "tow_sketch"),
    "tree": ("tree_digest", "bin_xorsum_units", "gf2_matmul"),
    "encode_group": ("bin_parity_xorsum", "gf2_pack_bits", "gf2_matmul"),
    "wire": ("bin_xorsum_units", "gf2_matmul", "tree_digest"),
    "hub": ("bin_xorsum_units", "gf2_matmul", "tree_digest"),
    "sync": ("bin_xorsum_units", "gf2_matmul"),
}
HOME_PATH = {"bin_xorsum_units": "serve", "gf2_matmul": "serve", "tow_sketch": "serve",
             "tree_digest": "tree", "bin_parity_xorsum": "encode_group",
             "gf2_pack_bits": "encode_group"}


_OUT = []     # files that receive every JSON line besides standard output


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    for f in _OUT:
        f.write(line + "\n")
        f.flush()


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


def device_ms(fn, name: str, reps: int = 20, every_activity: bool = False) -> dict:
    """Device time per call of ``fn``, which launches kernel ``name`` once:
    the mean CUDA duration of its symbols (``SYMBOLS[name]``) over the
    launches ``torch.profiler`` recorded in ``reps`` calls (it may keep
    fewer than ``reps``; how many is returned).  Where it records none, a
    CUDA graph of 50 calls is replayed between two events instead.  Returns
    the time and the method that gave it.  ``every_activity``: instead,
    every device activity of a call (kernels, copies, memsets) summed over
    the window and divided by the launches of ``name``'s symbols it kept
    (the calls it recorded); no fallback (``device_ms`` None where it kept
    none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us, calls, every_us = 0.0, 0, 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        us = us if us is not None else getattr(ev, "self_cuda_time_total", 0)
        every_us += us
        if any(k in ev.key for k in SYMBOLS[name]):
            total_us += us
            calls += ev.count
    if every_activity:
        return {"device_ms": every_us / calls / 1e3 if calls and every_us > 0 else None,
                "device_ms_by": "profiler, every device activity", "profiled_launches": calls}
    if calls > 0 and total_us > 0:
        return {"device_ms": total_us / calls / 1e3, "device_ms_by": "profiler",
                "profiled_launches": calls}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(50):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return {"device_ms": start.elapsed_time(end) / 50, "device_ms_by": "cuda_graph_replay"}


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
    ``case``, packed entry and the reference contract both; a fully masked
    row (a padding unit) must come back all zero, and the pad bits of the
    last parity word must be 0."""
    elems, valid, seeds, _ = case
    w, x = bin_parity_xorsum_units_packed(elems, valid, seeds, n_bins=n_bins)
    wp, xp = bin_parity_xorsum_units_packed_plain(elems, valid, seeds, n_bins=n_bins)
    p, x2 = bin_parity_xorsum_units(elems, valid, seeds, n_bins=n_bins)
    pu, xu = bin_parity_xorsum_units_plain(elems, valid, seeds, n_bins=n_bins)
    masked = ~valid.any(dim=1)
    assert not bool(w[masked].any()) and not bool(x[masked].any()), "masked row not zero"
    if n_bins % 32 and w.numel():
        pad = (w[:, -1].to(torch.int64) & 0xFFFFFFFF) >> (n_bins % 32)
        assert not bool(pad.any()), "pad bits of the last parity word set"
    return max_err((w, wp), (x, xp), (p, pu), (x2, xu), (unpack_bits(w, n_bins), pu))


def k2_case(rng, M, K, N):
    """0/1 A (M, K) and B (K, N) on the card, and both packed (A per row, B
    per column) with the packing kernel."""
    a = torch.from_numpy(rng.integers(0, 2, (M, K)).astype(np.int32)).to(DEV)
    b = torch.from_numpy(rng.integers(0, 2, (K, N)).astype(np.int32)).to(DEV)
    return a, b, pack_bits(a), pack_columns(b)


def check_k2(case):
    """The packed kernel against its plain version, the public contract
    against the plain product, and the packing kernel against its plain
    version on both operands."""
    a, b, aw, bt = case
    k = a.shape[1]
    return max_err((gf2_matmul_packed(aw, bt, k), gf2_matmul_packed_plain(aw, bt, k)),
                   (gf2_matmul(a, b), gf2_matmul_plain(a, b)),
                   (aw, pack_bits_plain(a)), (bt, pack_bits_plain(b.t())))


def k3_case(rng, E, ell, n_valid=None):
    elems = dev_u32(rng.integers(0, 1 << 32, size=E, dtype=np.uint64))
    seeds = dev_u32(rng.integers(0, 1 << 32, size=ell, dtype=np.uint64))
    valid = None
    if n_valid is not None:
        valid = torch.arange(E, device=DEV) < n_valid
    return elems, seeds, valid


def rand_i32(g, shape) -> torch.Tensor:
    """Random int32 bit patterns (keys over nearly the whole uint32 range),
    made on the card."""
    return torch.randint(-(1 << 31), (1 << 31) - 1, shape, dtype=torch.int32,
                         device=DEV, generator=g)


def k4_case(g, R, E, mask="ragged"):
    """(R, E) range rows on the card: ragged valid prefixes (row 0 full, row
    1 fully masked where R > 1), or a scattered mask; junk keys in the
    padding; ell = 32 seeds."""
    elems = rand_i32(g, (R, E))
    if mask == "scattered":
        valid = torch.rand((R, E), device=DEV, generator=g) < 0.5
    else:
        counts = torch.randint(0, E + 1, (R,), device=DEV, generator=g)
        counts[0] = E
        if R > 1:
            counts[1] = 0
        valid = torch.arange(E, device=DEV)[None, :] < counts[:, None]
    return elems, valid, rand_i32(g, (TreeConfig().ell,))


def check_k4(elems, valid, seeds):
    """Largest difference between the kernel and its plain version; a fully
    masked row must come back all zero, and one row must equal
    ``tow_sketch`` at the same ell."""
    out = tree_digest(elems, valid, seeds, ell=seeds.shape[0])
    masked = ~valid.any(dim=1)
    assert not bool(out[masked].any()), "masked row not zero"
    err = max_err((out, tree_digest_plain(elems, valid, seeds)))
    if elems.shape[0] == 1:
        err = max(err, max_err((out[0], tow_sketch(elems[0], seeds, valid[0],
                                                   ell=seeds.shape[0]))))
    return err


def ranges_case(g, counts, gap=3, n_keys=None):
    """Ragged rows over one key array on the card: row r is ``counts[r]``
    consecutive keys, rows ``gap`` keys apart (so rows never touch, as two
    sides stacked do not), the last row ending at the last key, or ``n_keys``
    keys in all where given (then counts must fit); lo of an empty row
    points anywhere in range.  Returns keys, lo, cnt, seeds and the walk's
    width (the longest row as a ``pow2_bucket``)."""
    cnt = np.asarray(counts, dtype=np.int64)
    lo = np.concatenate([[0], np.cumsum(cnt + gap)[:-1]]).astype(np.int64)
    total = int(lo[-1] + cnt[-1]) if len(cnt) else 0
    if n_keys is not None:
        total = n_keys
    lo[cnt == 0] = np.minimum(lo[cnt == 0], total)
    keys = rand_i32(g, (total,))
    width = platform.pow2_bucket(int(cnt.max()) if len(cnt) else 1, TreeConfig().tile)
    return keys, lo, cnt, rand_i32(g, (TreeConfig().ell,)), width


def check_k4_ranges(keys, lo, cnt, seeds, width):
    """The ragged entry against its plain version and against the padded
    entry on ``range_rows`` of the same ranges; rows with cnt 0 must come
    back zero."""
    ell = seeds.shape[0]
    out = tree_digest_ranges(keys, lo, cnt, seeds, ell=ell, width=width)
    assert not bool(out[torch.from_numpy(cnt == 0).to(DEV)].any()), "empty range not zero"
    padded = tree_digest(*range_rows(keys, lo, cnt, width), seeds, ell=ell)
    return max_err((out, tree_digest_ranges_plain(keys, lo, cnt, seeds, width=width)),
                   (out, padded))


def check_k5(elems, n_bins, seed):
    p, x = bin_parity_xorsum(elems, n_bins=n_bins, seed=seed)
    pp, xp = bin_parity_xorsum_plain(elems, n_bins=n_bins, seed=seed)
    return max_err((p, pp), (x, xp))


def kernel_sweeps(rng):
    """Each kernel against its plain version on the card over the shape
    sweeps of the CPU tests (and a few larger ones), exact equality."""
    checks = []

    # K1 and K2: the cases of earlier runs draw from ``rng`` in their old
    # order, the cases added since from ``extra``, so the paths' data after
    # the sweeps stay those of earlier runs (the serve ledger depends on them)
    extra = np.random.default_rng(rng.bit_generator.seed_seq.spawn(1)[0])   # draws nothing

    # K1: short rows (odd widths load scalar, E = 0 still writes zeros, U
    # not a multiple of the rows a block holds), rows just past the short
    # limit, long rows over one whole cluster and over more than a cluster
    # covers in one pass; row 1 fully masked (a padding unit) wherever U > 1
    err, shapes = 0, []
    for n_bins in (63, 127, 8191, 16383):
        for U, E in ((6, 257), (3, 1), (16, 5000), (5, 20011)):
            err = max(err, check_k1(k1_case(rng, U, E, n_bins), n_bins))
            shapes.append([U, E, n_bins])
    short = ((3, 0), (13, 1000), (16, 4096), (9, 4097))
    long_ = ((2, 524296), (1, 2_000_000), (33, 65540))
    for n_bins in (63, 127, 255, 511, 8191, 16383):
        for U, E in short + (long_ if n_bins in (63, 511, 8191) else ()):
            err = max(err, check_k1(k1_case(extra, U, E, n_bins), n_bins))
            shapes.append([U, E, n_bins])
    checks.append({"name": "bin_xorsum_units", "shapes": shapes, "equal": err == 0})

    # K2 in both regimes (tile: M >= 256 and K <= 2048; warp otherwise),
    # M = 1 and M = 2U, K not a multiple of 32, ragged row and column tiles;
    # the packing kernel on every operand
    err = 0
    shapes = [[1, 127, 91], [8, 255, 88], [17, 511, 153], [64, 1023, 110],
              [3, 2047, 187], [130, 300, 260], [5, 64, 640], [100, 700, 200],
              [70, 16383, 28]]
    added = [[1, 8191, 208], [2, 511, 90], [32768, 511, 90], [300, 511, 90],
             [1000, 2047, 300], [257, 33, 5], [256, 64, 1], [4096, 63, 42],
             [520, 2048, 257], [600, 2049, 70]]
    for mm, kk, nn in shapes:
        err = max(err, check_k2(k2_case(rng, mm, kk, nn)))
    for mm, kk, nn in added:
        err = max(err, check_k2(k2_case(extra, mm, kk, nn)))
    shapes += added
    checks.append({"name": "gf2_matmul", "shapes": shapes, "equal": err == 0})

    err, shapes = 0, []
    for ell in (32, 100, 128, 300):
        for E, n_valid in ((5, None), (2048, None), (7001, None), (8192, 7001), (4096, 0)):
            e, s, v = k3_case(rng, E, ell, n_valid)
            err = max(err, max_err((tow_sketch(e, s, v, ell=ell), tow_sketch_plain(e, s, v))))
            shapes.append([E, ell, n_valid])
    checks.append({"name": "tow_sketch", "shapes": shapes, "equal": err == 0})

    # K4 at the shapes of a tree level: R = 2 x pow2 frontier rows (16 at
    # the root, 2^17 for an adversarial pair at 10^6 keys, 2^20 to show the
    # row axis holds), E = pow2 row length; and one scattered mask, one
    # length that is not a multiple of the tile
    g = torch.Generator(device=DEV)
    g.manual_seed(int(rng.integers(1 << 62)))
    err, shapes = 0, []
    for R, E, mask in ((1, 512, "ragged"), (1, 4096, "ragged"), (1, 1 << 20, "ragged"),
                       (3, 512, "ragged"), (3, 4096, "ragged"), (3, 1 << 20, "ragged"),
                       (16, 512, "ragged"), (16, 4096, "ragged"), (16, 1 << 20, "ragged"),
                       (131072, 512, "ragged"), (131072, 4096, "ragged"),
                       (1 << 20, 64, "ragged"), (5, 5000, "scattered"), (7, 1300, "ragged")):
        err = max(err, check_k4(*k4_case(g, R, E, mask)))
        shapes.append([R, E, mask])
    checks.append({"name": "tree_digest", "shapes": shapes, "equal": err == 0})

    # the ragged entry: a root level (2 real rows of ~10^6 of 16, both sides
    # stacked; items of 512 keys), rows at and around the group edges
    # (items of 32), a level cut into items of 128, 2^17 short rows, rows
    # of 0 keys, an empty key array, and ell of 64, 100 and 128
    err, shapes = 0, []
    edge = [0, 1, 31, 32, 33, 511, 512, 513, 1024, 1025, 3000, 0, 7]
    cases = [([995_000] + [0] * 7 + [995_000] + [0] * 7, 32),
             (edge, 32), (edge[::-1], 32), (edge, 64), (edge, 128), (edge, 100),
             ([0] * 8, 32), ([5000, 0, 0], 32), ([200_000, 0, 222_000, 77], 32)]
    for counts, ell in cases:
        keys, lo, cnt, seeds, width = ranges_case(g, counts)
        seeds = rand_i32(g, (ell,))
        err = max(err, check_k4_ranges(keys, lo, cnt, seeds, width))
        shapes.append([len(cnt), int(cnt.sum()), ell])
    keys, lo, cnt, seeds, width = ranges_case(g, extra.integers(0, 17, size=1 << 17), gap=0)
    err = max(err, check_k4_ranges(keys, lo, cnt, seeds, width))
    shapes.append([len(cnt), int(cnt.sum()), 32])
    keys, lo, cnt, seeds, width = ranges_case(g, [0] * 8, n_keys=0)     # no keys at all
    err = max(err, check_k4_ranges(keys, lo, cnt, seeds, width))
    shapes.append([8, 0, 32])
    checks.append({"name": "tree_digest_ranges", "shapes": shapes, "equal": err == 0})

    # K5: one set, mod-n bins; key 0 is a member wherever E >= 100
    err, shapes = 0, []
    for n_bins in (63, 127, 255, 1023, 8191):
        for E in (1, 100, 5000, 1_000_000):
            elems = rand_i32(g, (E,))
            if E >= 100:
                elems[E // 2] = 0
            err = max(err, check_k5(elems, n_bins, int(rng.integers(1 << 32))))
            shapes.append([E, n_bins, E >= 100])
    checks.append({"name": "bin_parity_xorsum", "shapes": shapes, "equal": err == 0})

    torch.cuda.synchronize()
    emit({"phase": "kernels", "kernel_checks": checks})
    for c in checks:
        assert c["equal"], f"{c['name']} differs from its plain version"


def seeds_per_lane(ell: int) -> int:
    """Seeds a lane of ``csrc/tow_sketch.cu`` owns per span (its template
    argument NS)."""
    return 1 if ell <= 32 else 2 if ell <= 64 else 4


# the multiply by 0x85EBCA6B that every mix32 round has, as cuobjdump prints
# its immediate
_MIX_MUL = ("0x85ebca6b", "-0x7a143595")


def sass_inner_loops(lib: Path) -> dict:
    """Instructions per hash in the inner loop of each ``tow_sketch.cu``
    kernel, from ``cuobjdump -sass`` of the built library.  Candidates are
    the innermost loops (a backward branch and its target) and the basic
    blocks (cut at branch targets and after branches) of each function; the
    one with the most mix32 multiplies (a loop where they tie) is the walk
    over a full group's keys — an unrolled loop, or straight-line code where
    the walk is unrolled whole — and its instructions over those multiplies
    are the SASS per (key, seed), the shuffles and any loop control
    included.  ``{(kernel, NS): {...}}``; empty where the toolchain has no
    ``cuobjdump``."""
    tool = Path(platform._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return {}
    out, fn, ins = {}, None, []

    def close():
        loops, targets = [], set()
        for i, (addr, op) in enumerate(ins):
            if re.search(r"\b(BRA|BSSY|CALL)", op):
                targets.update(int(t, 16) for t in re.findall(r"0x[0-9a-f]+", op.split(",")[-1]))
            m = re.search(r"\bBRA\s+(0x[0-9a-f]+)", op)
            if m and not op.startswith("BRA.DIV") and int(m.group(1), 16) <= addr:
                tgt = int(m.group(1), 16)
                loops.append((next(k for k, (a, _) in enumerate(ins) if a >= tgt), i))
        regions = [[op for _, op in ins[j: i + 1]] for j, i in loops
                   if not any(j <= j2 and i2 <= i and (j2, i2) != (j, i) for j2, i2 in loops)]
        cur = []
        for addr, op in ins:
            if addr in targets and cur:
                regions.append(cur)
                cur = []
            cur.append(op)
            if re.search(r"\b(BRA|EXIT|RET|BSYNC)", op):
                regions.append(cur)
                cur = []
        regions.append(cur)
        best = max(((len([o for o in r if not o.startswith("NOP")]),
                     sum(any(c in o.lower() for c in _MIX_MUL) for o in r)) for r in regions),
                   key=lambda nh: nh[1], default=(0, 0))
        for kern in ("tow_rows_warp_kernel", "tow_rows_block_kernel", "tow_ranges_kernel"):
            for ns in (1, 2, 4):
                if best[1] and f"{kern}ILi{ns}E" in (fn or ""):
                    out[(kern, ns)] = {"region_instructions": best[0], "region_hashes": best[1],
                                       "per_hash": best[0] / best[1]}

    for line in sh([str(tool), "-sass", str(lib)]).splitlines():
        stripped = line.strip()
        if stripped.startswith("Function :"):
            close()
            fn, ins = stripped.split(":", 1)[1].strip(), []
        elif fn is not None:
            m = re.match(r"/\*([0-9a-f]+)\*/\s*(.*?)\s*;", stripped)
            if m:
                ins.append((int(m.group(1), 16), m.group(2)))
    close()
    return out


def issue_floor(sass_entry, hashes: int, device_time) -> dict:
    """The issue floor of ``hashes`` (key, seed) evaluations: SASS
    instructions per hash (``sass_inner_loops``) x hashes over SMs x 4
    schedulers x the SM clock (``nvidia-smi clocks.sm`` read just after the
    timing; at ``clocks.max.sm`` beside it) — one warp instruction a
    scheduler a cycle.  The integer pipes issue at half that rate, so a
    kernel that waits on issue alone sits between 1x and 2x the floor."""
    clk, clk_max = (float(x) for x in sh(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"]).splitlines()[0].split(","))
    if not sass_entry:
        return {"issue_floor_ms": None, "sass_per_hash": None, "sm_clock_mhz": clk}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    warp_instr = sass_entry["per_hash"] * hashes / 32
    return {"sass_per_hash": sass_entry["per_hash"], "sm_clock_mhz": clk,
            "sm_clock_max_mhz": clk_max,
            "issue_floor_ms": 1e3 * warp_instr / (sms * 4 * clk * 1e6),
            "issue_floor_at_max_clock_ms": 1e3 * warp_instr / (sms * 4 * clk_max * 1e6),
            "device_over_floor": (device_time / (1e3 * warp_instr / (sms * 4 * clk * 1e6))
                                  if device_time else None)}


def bound(b_bytes: float, b_ops: float) -> dict:
    return {"bound_ms": 1e3 * max(b_bytes, b_ops),
            "bound_by": "bytes" if b_bytes >= b_ops else "operations"}


def masked_bound(n_valid: int, cells: int, other_bytes: int, ops_per_key: int) -> dict:
    """Bound of a kernel over masked key cells: the function must read every
    1-byte mask cell and the 4-byte key of each valid cell only (a masked
    key is never needed), plus ``other_bytes`` of seeds and outputs; it
    hashes only the valid keys, ``ops_per_key`` 32-bit operations each."""
    return bound((n_valid * 4 + cells + other_bytes) / HBM_BYTES_PER_S,
                 n_valid * ops_per_key / ALU32_OPS_PER_S)


def k1_report(rng, launched):
    """K1 at every ``(U, E, n)`` one path launched it at (``launched``, read
    from the launch ledger just after that path's run): the packed entry the
    path calls, compared with its plain version, timed (events over the
    wrapper, and device time) and held against its one-bit bound: the
    parity leaves as n bits a row.  The headline is the largest launch;
    ``long_rows`` the launch with the longest rows."""
    biggest = max(launched, key=lambda k: k[0] * k[1])
    rows, head_case = [], None
    for (U, E, n), count in sorted(launched.items()):
        case = k1_case(rng, U, E, n, fill="full")
        elems, valid, seeds, n_valid = case

        def call():
            return bin_parity_xorsum_units_packed(elems, valid, seeds, n_bins=n)

        err = check_k1(case, n)
        ts = times_ms(call, 50)
        rows.append({
            "shape": [U, E, n], "valid": n_valid, "launches": count, "max_abs_err": err,
            "ms": float(np.mean(ts)), "ms_min": min(ts), "ms_median": float(np.median(ts)),
            **device_ms(call, "bin_xorsum_units"),
            **masked_bound(n_valid, U * E, U * 4 + U * n * 4 + U * n / 8, K1_OPS_PER_KEY)})
        if (U, E, n) == biggest:
            head_case = case
    del case, elems, valid, seeds
    head = next(r for r in rows if tuple(r["shape"]) == biggest)
    U, E, n = biggest
    elems, valid, seeds, _ = head_case
    return {
        "shapes": {"elems": [U, E], "n_bins": n, "valid": head["valid"]},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": head["ms"], "device_ms": head["device_ms"], "device_ms_by": head["device_ms_by"],
        "plain_ms": time_ms(
            lambda: bin_parity_xorsum_units_packed_plain(elems, valid, seeds, n_bins=n), 2),
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
        "long_rows": max(rows, key=lambda r: r["shape"][1]),
        "launched_shapes": rows,
    }


def k2_bound(M, K, N) -> dict:
    """One bit per 0/1 entry of A, B and C, and 2 M K N operations at the
    int8 tensor-core rate; beside it the time to write C as int32, the form
    the port returns."""
    return {**bound((M * K + K * N + M * N) / 8 / HBM_BYTES_PER_S,
                    2 * M * K * N / INT8_TENSOR_OPS_PER_S),
            "int32_c_ms": 1e3 * M * N * 4 / HBM_BYTES_PER_S}


def k2_report(rng, launched):
    """K2 at every ``(M, K, N)`` one path launched it at: the packed entry on
    packed operands, as the path calls it, against its plain version; event
    and device time, one-bit bound, and the float matmul on the unpacked
    matrices (the one PyTorch call computing the same function; used nowhere
    in the port) at every shape.  Headline: the largest product."""
    rows = []
    for (M, K, N), count in sorted(launched.items()):
        a, b, aw, bt = case = k2_case(rng, M, K, N)

        def call():
            return gf2_matmul_packed(aw, bt, K)

        rows.append({"shape": [M, K, N], "launches": count, "max_abs_err": check_k2(case),
                     "ms": time_ms(call, 20), **device_ms(call, "gf2_matmul"),
                     "plain_ms": time_ms(lambda: gf2_matmul_packed_plain(aw, bt, K), 5),
                     "library_ms": time_ms(lambda: (a.float() @ b.float()) % 2, 5),
                     **k2_bound(M, K, N)})
    head = max(rows, key=lambda r: r["shape"][0] * r["shape"][1] * r["shape"][2])
    M, K, N = head["shape"]
    return {
        "shapes": {"a": [M, K], "b": [K, N], "a_words": [M, packed_words(K)],
                   "bt_words": [N, packed_words(K)]},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        **{k: head[k] for k in ("ms", "device_ms", "device_ms_by", "plain_ms",
                                "bound_ms", "bound_by", "library_ms")},
        "launched_shapes": rows,
    }


def pack_report(rng, launched):
    """The packing kernel at every ``(R, K)`` one path launched it at,
    against its plain version; bound: K 4-byte entries a row read, K bits
    written."""
    rows = []
    for (R, K), count in sorted(launched.items()):
        bits = torch.from_numpy(rng.integers(0, 2, (R, K)).astype(np.int32)).to(DEV)

        def call():
            return pack_bits(bits)

        rows.append({"shape": [R, K], "launches": count,
                     "max_abs_err": max_err((call(), pack_bits_plain(bits))),
                     "ms": time_ms(call, 20), **device_ms(call, "gf2_pack_bits"),
                     "plain_ms": time_ms(lambda: pack_bits_plain(bits), 5),
                     **bound((R * K * 4 + R * packed_words(K) * 4) / HBM_BYTES_PER_S,
                             R * K / ALU32_OPS_PER_S)})
    head = max(rows, key=lambda r: r["shape"][0] * r["shape"][1])
    return {
        "shapes": {"bits": head["shape"]},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        **{k: head[k] for k in ("ms", "device_ms", "device_ms_by", "plain_ms",
                                "bound_ms", "bound_by")},
        "library_ms": None,
        "launched_shapes": rows,
    }


def k3_report(rng, launched, set_size, sass):
    """K3 at every ``(1, E, ell)`` one path launched it at; the path pads
    |S| = ``set_size`` keys up to E.  Headline: the longest launch."""
    rows = []
    for (_, E, ell), count in sorted(launched.items()):
        n_valid = min(set_size, E)
        e, s, v = k3_case(rng, E, ell, n_valid)
        err = max_err((tow_sketch(e, s, v, ell=ell), tow_sketch_plain(e, s, v)))
        dev = device_ms(lambda: tow_sketch(e, s, v, ell=ell), "tow_sketch")
        kern = "tow_rows_warp_kernel" if E <= 1024 else "tow_rows_block_kernel"
        rows.append({"shape": [1, E, ell], "valid": n_valid, "launches": count,
                     "max_abs_err": err,
                     "ms": time_ms(lambda: tow_sketch(e, s, v, ell=ell), 20), **dev,
                     **masked_bound(n_valid, E, 2 * ell * 4,
                                    MIX32_OPS + ell * K3_OPS_PER_KEY_SEED),
                     **issue_floor(sass.get((kern, seeds_per_lane(ell))), n_valid * ell,
                                   dev["device_ms"])})
    head = max(rows, key=lambda r: r["shape"][1])
    _, E, ell = head["shape"]
    e, s, v = k3_case(rng, E, ell, head["valid"])
    return {
        "shapes": {"elems": [E], "ell": ell, "valid": head["valid"]},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": head["ms"], "device_ms": head["device_ms"], "device_ms_by": head["device_ms_by"],
        "plain_ms": time_ms(lambda: tow_sketch_plain(e, s, v), 2),
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "issue_floor_ms": head["issue_floor_ms"], "sass_per_hash": head["sass_per_hash"],
        "library_ms": None,
        "launched_shapes": rows,
    }


def k4_report(captured, launched, sass):
    """K4 at every shape the tree path launched it at, on the ranges that
    path gave it (``captured``: keys, lo, cnt, seeds, width): the ragged
    entry the walk calls, compared with its plain version and with the
    padded entry on ``range_rows`` of the same ranges, timed and bounded;
    beside it the old route on the same rows — the ``range_rows`` gather
    plus the padded kernel — with events (``old_route_ms``), all of its
    device activity (``old_route_device_ms``: gather, copies, kernel) and
    the padded kernel alone (``padded_device_ms``).  ``ragged_all_device_ms``
    is every device activity of the ragged entry (descriptor copy, memset,
    kernel).  The bound counts what the function needs: 4 B and ell hashes
    per key, the descriptors (lo, cnt: 8 B a row; 12 B a tail tile), the
    seeds and the output.  Headline: the largest launch."""
    rows = []
    for (R, Ep, ell), count in sorted(launched.items()):
        keys, lo, cnt, seeds, width = captured[(R, Ep, ell)]

        def call():
            return tree_digest_ranges(keys, lo, cnt, seeds, ell=ell, width=width)

        def old():
            return tree_digest(*range_rows(keys, lo, cnt, width), seeds, ell=ell)

        def padded():
            return tree_digest(mat, valid, seeds, ell=ell)

        err = check_k4_ranges(keys, lo, cnt, seeds, width)
        mat, valid = range_rows(keys, lo, cnt, width)
        ts = times_ms(call, 20)
        n_valid = int(cnt.sum())
        tile = ragged_tile(n_valid, torch.cuda.get_device_properties(0).multi_processor_count)
        n_tail = range_tiles(lo, cnt, tile)[1]
        dev = device_ms(call, "tree_digest")
        padded_ms = device_ms(padded, "tree_digest_padded")["device_ms"]
        del mat, valid
        rows.append({
            "shape": [R, Ep, ell], "valid": n_valid, "tile": tile, "tail_tiles": n_tail,
            "launches": count,
            "max_abs_err": err, "ms": float(np.mean(ts)), "ms_min": min(ts), **dev,
            "ragged_all_device_ms": device_ms(call, "tree_digest", every_activity=True)[
                "device_ms"],
            "old_route_ms": time_ms(old, 10),
            "old_route_device_ms": device_ms(old, "tree_digest_padded", every_activity=True)[
                "device_ms"],
            "padded_device_ms": padded_ms,
            **bound((n_valid * 4 + 8 * R + 12 * n_tail + ell * 4 + R * ell * 4) / HBM_BYTES_PER_S,
                    n_valid * (MIX32_OPS + ell * K3_OPS_PER_KEY_SEED) / ALU32_OPS_PER_S),
            **issue_floor(sass.get(("tow_ranges_kernel", seeds_per_lane(ell))),
                          n_valid * ell, dev["device_ms"])})
    head = max(rows, key=lambda r: r["shape"][0] * r["shape"][1])
    keys, lo, cnt, seeds, width = captured[tuple(head["shape"])]
    return {
        "shapes": {"keys": [int(keys.shape[0])], "rows": head["shape"][0],
                   "padded_as": head["shape"][:2], "ell": head["shape"][2],
                   "valid": head["valid"]},
        "entry": "tree_digest_ranges",
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        **{k: head[k] for k in ("ms", "device_ms", "device_ms_by", "ragged_all_device_ms",
                                "old_route_ms", "old_route_device_ms", "padded_device_ms",
                                "bound_ms", "bound_by", "issue_floor_ms", "sass_per_hash")},
        "plain_ms": time_ms(
            lambda: tree_digest_ranges_plain(keys, lo, cnt, seeds, width=width), 2),
        "library_ms": None,
        "sum_device_ms": sum(r["device_ms"] * r["launches"] for r in rows),
        "sum_ragged_all_device_ms": sum((r["ragged_all_device_ms"] or 0) * r["launches"]
                                        for r in rows),
        "sum_old_route_device_ms": sum((r["old_route_device_ms"] or 0) * r["launches"]
                                       for r in rows),
        "launched_shapes": rows,
    }


def k5_report(rng, launched):
    """K5 at every ``(E, n)`` the encode_group path launched it at; bound:
    every key read, the folds and one bit a bin written."""
    g = torch.Generator(device=DEV)
    g.manual_seed(int(rng.integers(1 << 62)))
    rows, cases = [], {}
    for (E, n), count in sorted(launched.items()):
        elems, seed = rand_i32(g, (E,)), int(rng.integers(1 << 32))
        cases[(E, n)] = (elems, seed)

        def call():
            return bin_parity_xorsum(elems, n_bins=n, seed=seed)

        ts = times_ms(call, 50)
        rows.append({
            "shape": [E, n], "launches": count, "max_abs_err": check_k5(elems, n, seed),
            "ms": float(np.mean(ts)), "ms_min": min(ts), "ms_median": float(np.median(ts)),
            **device_ms(call, "bin_parity_xorsum"),
            **bound((E * 4 + n * 4 + n / 8) / HBM_BYTES_PER_S,
                    E * K1_OPS_PER_KEY / ALU32_OPS_PER_S)})
    head = max(rows, key=lambda r: r["shape"][0])
    elems, seed = cases[tuple(head["shape"])]
    n = head["shape"][1]
    return {
        "shapes": {"elems": [head["shape"][0]], "n_bins": n},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": head["ms"], "device_ms": head["device_ms"], "device_ms_by": head["device_ms_by"],
        "plain_ms": time_ms(lambda: bin_parity_xorsum_plain(elems, n_bins=n, seed=seed), 5),
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
        "launched_shapes": rows,
    }


def main_shape_phase(args, rng, launched, k4_inputs, sass):
    """Every kernel at exactly the shapes each path launched it at
    (``launched[path]``: ``platform.launch_shapes()`` read just after that
    path's run): compared with its plain version, timed and held against its
    bound.  A kernel's headline numbers are those of its home path
    (``HOME_PATH``); its shapes on every other path that launched it are
    measured the same way under ``other_paths``.  K4 runs on the ranges
    each path gave it (``k4_inputs[path]``)."""
    reports = {
        "bin_xorsum_units": lambda path, shapes: k1_report(rng, shapes),
        "gf2_matmul": lambda path, shapes: k2_report(rng, shapes),
        "tow_sketch": lambda path, shapes: k3_report(rng, shapes, args.size, sass),
        "tree_digest": lambda path, shapes: k4_report(k4_inputs[path], shapes, sass),
        "bin_parity_xorsum": lambda path, shapes: k5_report(rng, shapes),
        "gf2_pack_bits": lambda path, shapes: pack_report(rng, shapes),
    }
    report = {}
    for name, fn in reports.items():
        home = HOME_PATH[name]
        rep = fn(home, launched[home][name])
        others = {path: fn(path, shapes[name]) for path, shapes in launched.items()
                  if path != home and name in shapes}
        if others:
            rep["other_paths"] = others
            rep["max_abs_err"] = max([rep["max_abs_err"]]
                                     + [o["max_abs_err"] for o in others.values()])
        report[name] = rep

    # the third device stage of a round (plain tensor ops, no kernel), at
    # the unit count and code of the serve path's largest K2 launch
    M, K = report["gf2_matmul"]["shapes"]["a"]
    N = report["gf2_matmul"]["shapes"]["b"][1]
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


def oracle_pool():
    """Worker processes for ``core.pbs.reconcile`` on the host: one oracle
    run takes seconds at |A| = 10^6 (numpy only; none touches the device)."""
    return multiprocessing.get_context("spawn").Pool(max(1, (os.cpu_count() or 2) - 1))


def serve_phase(args, rng, pool):
    t0 = time.perf_counter()
    sessions = make_sessions(args, rng)
    data_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    platform.reset_launch_counts()
    server, results, cold_s, cold_submit_s = run_server(sessions)
    launches, launched = platform.launch_counts(), platform.launch_shapes()
    stats = server.stats
    peak = torch.cuda.max_memory_allocated()

    for name in PATHS["serve"]:
        assert launches.get(name, 0) > 0, f"serve path never launched {name}: {launches}"
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
    wants = pool.starmap(reconcile, [(a, b, cfg, dk) for _, a, b, cfg, dk in sessions])
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
    return launches, launched, sessions, results


# ---------------------------------------------------------------------------
# the tree front end
# ---------------------------------------------------------------------------


def tree_pairs(args):
    """The two pairs of the tree phase, as (label, a, b).

    ``uniform``: built exactly as the ``tree`` point of
    ``benchmarks/recon_throughput.py`` builds it (union |A| keys, d =
    d_frac·|A| with d_frac = 0.01, split half and half between the sides).
    ``clustered``: |A| shared keys, and all of the difference — 2000 keys,
    half on each side — inside one 2^16-wide window, which walks deep."""
    rng = np.random.default_rng(args.seed + 77)
    union = args.size
    d = max(2, int(0.01 * union))
    half = d // 2
    univ = np.unique(rng.choice(1 << 32, size=union, replace=False).astype(np.uint32))
    a = univ[: union - d + half]
    b = np.concatenate([univ[: union - d], univ[union - d + half :]])
    rng = np.random.default_rng(args.seed + 78)
    shared = rng.choice(1 << 32, size=union, replace=False).astype(np.uint64)
    lo = int(rng.integers(0, (1 << 32) - (1 << 16)))
    hot = lo + rng.choice(1 << 16, size=2000, replace=False)
    a2 = np.unique(np.concatenate([shared, hot[:1000]]).astype(np.uint32))
    b2 = np.unique(np.concatenate([shared, hot[1000:]]).astype(np.uint32))
    return [("uniform", a, b), ("clustered", a2, b2)]


def tree_run(label, a, b, cfg, pool, captured):
    """``tree_reconcile`` of one pair on the card, checked against the
    truth, per leaf against ``core.pbs.reconcile``, and on bytes per diff
    against plain PBS told a 10x-wrong d; then a warm re-walk, which also
    keeps in ``captured`` the ``tree_digest_ranges`` inputs of each
    launched shape ``(R, Ep, ell)`` not yet there — so the kernel is later
    measured on the ranges the path really gave it (two real rows of 16 at
    the root, say) — and splits the walk's set-up outside its level spans
    (``walk_setup_split``).  Returns the launches and launched shapes of the
    counted run."""
    tcfg = TreeConfig()
    rec = Recorder()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()      # the inputs kept from earlier pairs
    platform.reset_launch_counts()
    t0 = time.perf_counter()
    tr = tree_reconcile(a, b, cfg, tcfg, recorder=rec)      # device=None: the card
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, shapes = platform.launch_counts(), platform.launch_shapes()
    peak = torch.cuda.max_memory_allocated() - held
    st = tr.stats

    for name in PATHS["tree"]:
        assert launches.get(name, 0) > 0, f"tree path never launched {name}: {launches}"
    assert st.launches == st.levels == launches["tree_digest"], (st, launches)
    assert tr.success, label
    truth = set(np.setxor1d(a, b).tolist())
    assert tr.diff == truth, label
    depth_bound = 32 - int(np.floor(np.log2(tcfg.leaf_d)))
    assert st.depth <= depth_bound, (label, st.depth, depth_bound)

    # every leaf against a standalone oracle session over its range at the
    # tree's planned d; plain PBS at the honest and a 10x-wrong d beside it
    t0 = time.perf_counter()
    au, bu = np.unique(a), np.unique(b)
    jobs = [(sa, sb, cfg, leaf.d_plan)
            for sa, sb, leaf in zip(leaf_slices(au, tr.leaves), leaf_slices(bu, tr.leaves),
                                    tr.leaves)]
    d = len(truth)
    honest, wrongd, *wants = pool.starmap(
        reconcile, [(a, b, cfg, d), (a, b, cfg, 10 * d)] + jobs, chunksize=1)
    assert sorted(tr.results) == list(range(len(jobs)))
    for sid, want in enumerate(wants):
        assert tr.results[sid] == want, (label, sid, tr.leaves[sid])
    oracle_s = time.perf_counter() - t0
    assert honest.success and wrongd.success, label
    tree_bpd = tr.total_bytes / max(1, len(tr.diff))
    wrongd_bpd = wrongd.bytes_sent / max(1, len(wrongd.diff))
    honest_bpd = honest.bytes_sent / max(1, len(honest.diff))
    assert tree_bpd < wrongd_bpd, (label, tree_bpd, wrongd_bpd)

    # the warm walk alone, its levels split by the walk's own spans into
    # dispatch (bounds, descriptors, launch) and collect (readback wait,
    # verdicts, byte ledger), keeping the ragged entry's inputs
    tracer = Tracer()
    with recording_k4(captured):
        t0 = time.perf_counter()
        warm_leaves, warm = partition_pair(a, b, tcfg, tracer=tracer)
        torch.cuda.synchronize()
        walk_s = time.perf_counter() - t0
    span_s = {}
    for ev in tracer.events():
        if ev.get("ph") == "X":
            span_s[ev["name"]] = span_s.get(ev["name"], 0.0) + ev["dur"] / 1e6
    assert warm.retraces == 0, (label, warm)
    split = walk_setup_split(a, b)
    split["rest_s"] = (walk_s - span_s["tree.level.dispatch"] - span_s["tree.level.collect"]
                       - sum(split.values()))
    assert warm_leaves == tr.leaves and warm.launches == warm.levels == st.levels, label
    emit({
        "phase": "tree", "pair": label, "size_a": len(au), "size_b": len(bu), "d": d,
        "levels": st.levels, "depth": st.depth, "depth_bound": depth_bound,
        "leaves": st.leaves, "pruned": st.pruned, "recursed": st.recursed,
        "frontier_peak": st.max_frontier, "tree_digest_launches": launches["tree_digest"],
        "cold_retraces": st.retraces, "warm_retraces": warm.retraces,
        "digest_bytes": tr.tree_bytes, "pbs_bytes": tr.pbs_bytes,
        "bytes_per_diff": tree_bpd, "honest_bytes_per_diff": honest_bpd,
        "wrongd_bytes_per_diff": wrongd_bpd,
        "tree_reconcile_s": wall_s, "warm_walk_s": walk_s,
        "warm_walk_dispatch_s": span_s["tree.level.dispatch"],
        "warm_walk_collect_s": span_s["tree.level.collect"],
        **{f"warm_walk_{k}": v for k, v in split.items()},
        "leaf_run_s": rec.value("server.total_s"), "leaf_device_s": rec.value("server.device_s"),
        "oracle_check_s": oracle_s, "launches": launches,
        "peak_memory_above_start_bytes": peak, "all_leaves_match_oracle": True,
    })
    return launches, shapes, tr


@contextlib.contextmanager
def recording_k4(captured):
    """Keep in ``captured`` the ``tree_digest_ranges`` inputs of each launched
    shape ``(R, Ep, ell)`` not yet there (the key array is one tensor a walk;
    lo and cnt are copied), so K4 is later measured on the ranges a path
    really gave it."""
    launch = tree_partition.tree_digest_ranges

    def recording(keys, lo, cnt, seeds, *, ell, width, tile):
        key = (len(cnt), max(tile, -(-width // tile) * tile), ell)
        if key not in captured:
            captured[key] = (keys, np.array(lo), np.array(cnt), seeds, width)
        return launch(keys, lo, cnt, seeds, ell=ell, width=width, tile=tile)

    tree_partition.tree_digest_ranges = recording
    try:
        yield
    finally:
        tree_partition.tree_digest_ranges = launch


def walk_setup_split(a, b, reps: int = 3) -> dict:
    """The set-up pieces of ``partition_pair`` outside its level spans, each
    timed alone on the same pair as the walk runs them (median of ``reps``):
    ``np.unique`` of each side, the two checksum prefix sums, the key
    upload."""
    times = {"unique_s": [], "prefix_s": [], "upload_s": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        ua = np.unique(np.asarray(a, dtype=np.uint32))
        ub = np.unique(np.asarray(b, dtype=np.uint32))
        t1 = time.perf_counter()
        tree_partition._checksum_prefix(ua)
        tree_partition._checksum_prefix(ub)
        t2 = time.perf_counter()
        platform.upload(np.concatenate([ua, ub]), DEV)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, v in zip(times, (t1 - t0, t2 - t1, t3 - t2)):
            times[k].append(v)
    return {k: float(np.median(v)) for k, v in times.items()}


def merge_launches(launches, launched, counts, shapes) -> None:
    """Add one run's launch counts and launched shapes to a path's totals."""
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n
    for name, by_shape in shapes.items():
        for shape, n in by_shape.items():
            launched.setdefault(name, {})
            launched[name][shape] = launched[name].get(shape, 0) + n


def tree_phase(args, pool):
    """Both pairs through ``tree_reconcile``; returns the launches of both
    runs by kernel, the shapes they launched each kernel at, the
    ``tree_digest`` inputs by shape, and ``{label: (a, b, cfg, TreeResult)}``."""
    launches, launched, captured, trees = {}, {}, {}, {}
    for label, a, b in tree_pairs(args):
        cfg = PBSConfig(seed=args.seed)
        counts, shapes, tr = tree_run(label, a, b, cfg, pool, captured)
        merge_launches(launches, launched, counts, shapes)
        trees[label] = (a, b, cfg, tr)
    return launches, launched, captured, trees


# ---------------------------------------------------------------------------
# encode_group
# ---------------------------------------------------------------------------


def encode_group_plain(elems, code, seed):
    """``encode_group`` composed of the plain versions, on the same device."""
    parity, xors = bin_parity_xorsum_plain(elems, n_bins=code.n, seed=seed)
    P = torch.from_numpy(code.field.syndrome_matrix(code.t).astype(np.int32)).to(elems.device)
    return parity, xors, pack_bits_to_field(gf2_matmul_plain(parity[None, :], P), code.m)[0]


def encode_group_phase(rng):
    """``encode_group`` on the card against its plain composition: a
    10^6-key set with BCH(8191, 16), a 4096-key group with BCH(255, 16),
    and the two-sided round trip of the kernel tests (BCH(255, 11), 6
    differing keys, decoded by ``bch_decode_batched``)."""
    platform.reset_launch_counts()
    keys = np.unique(rng.integers(1, 1 << 32, size=1_000_100, dtype=np.uint64).astype(np.uint32))
    big = np.concatenate([[0], keys[:999_999]]).astype(np.uint32)    # key 0 is a member
    group = rng.integers(1, 1 << 32, size=4096, dtype=np.uint64).astype(np.uint32)
    base = np.unique(rng.integers(1, 1 << 32, size=4000, dtype=np.uint64).astype(np.uint32))
    cases = [("set 10^6", big, BCHCode(8191, 16), 7), ("group 4096", group, BCHCode(255, 16), 7),
             ("round trip A", base, BCHCode(255, 11), 11),
             ("round trip B", base[:-6], BCHCode(255, 11), 11)]
    err, outs, rows = 0, {}, []
    for label, keys, code, seed in cases:
        e = dev_u32(keys)
        got = encode_group(e, code, seed)
        err = max(err, max_err(*zip(got, encode_group_plain(e, code, seed))))
        outs[label] = got
        rows.append({"case": label, "keys": len(keys), "n": code.n, "t": code.t})
    launches = platform.launch_counts()
    pa, xa, ska = outs["round trip A"]
    pb, xb, skb = outs["round trip B"]
    ok, pos, cnt = bch_decode_batched((ska ^ skb)[None, :], n=255, t=11)
    torch.cuda.synchronize()
    diff = set(base.tolist()) ^ set(base[:-6].tolist())
    xab = (xa ^ xb).cpu().numpy().view(np.uint32)
    recovered = {int(xab[p]) for p in pos[0][: int(cnt[0])].tolist()}
    for name in PATHS["encode_group"]:
        assert launches.get(name, 0) > 0, f"encode_group never launched {name}: {launches}"
    assert err == 0, "encode_group differs from its plain composition"
    assert bool(ok[0]) and len(recovered & diff) >= 4, (recovered, diff)
    emit({"phase": "encode_group", "cases": rows, "max_abs_err": err,
          "round_trip_recovered": len(recovered & diff), "launches": launches})
    return launches, platform.launch_shapes()


# ---------------------------------------------------------------------------
# the wire pair
# ---------------------------------------------------------------------------

# the ReconcileResult fields a wire result must share with the in-process one
WIRE_FIELDS = ("diff", "bytes_per_round", "bytes_sent", "estimator_bytes", "rounds",
               "success", "decode_failures", "fake_rejections")


def wire_picks(sessions) -> list:
    """The sessions the wire, hub and sync phases draw from, as indices
    into the serve phase's set: the first known-d session at each d, the
    first estimator session, the two-sided and the rateless one."""
    picked, seen = [], set()
    for sid, (label, *_) in enumerate(sessions):
        if label not in seen:
            seen.add(label)
            picked.append(sid)
    return picked


def cohort_rounds(tracer) -> int:
    """Cohort-rounds one endpoint encoded (its ``round.encode`` spans)."""
    return sum(ev["args"]["cohorts"] for ev in tracer.events()
               if ev.get("ph") == "X" and ev["name"] == "round.encode")


def drive_pair(transport, submit):
    """Connect a port Alice and Bob over ``transport()`` (each on the card,
    ``device`` left at its default), let ``submit(alice, bob)`` stage both
    sides, and run the pair with the launch counts reset just before.
    Returns (alice, bob, results, timings, launches, launched shapes)."""
    ta, tb = transport()
    alice, bob = AliceEndpoint(ta, tracer=Tracer()), BobEndpoint(tb, tracer=Tracer())
    try:
        submit_s = submit(alice, bob)
        platform.reset_launch_counts()
        t0 = time.perf_counter()
        results = run_pair(alice, bob)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches, shapes = platform.launch_counts(), platform.launch_shapes()
    finally:
        ta.close()
        tb.close()
    return alice, bob, results, {"run_pair_s": run_s, **submit_s}, launches, shapes


def side_report(ep, levels: int) -> dict:
    """One endpoint's wire ledger and the launches it dispatched: K1 = K2 =
    one each per cohort encode (plain or rateless), K4 one per tree level."""
    enc = ep.launches["kernel_launches"] - levels
    assert enc % 2 == 0, ep.launches
    phase0 = sum(ev["dur"] / 1e6 for ev in ep.tracer.events()
                 if ev.get("ph") == "X" and ev["name"] == "phase0")
    return {"wire_stats": ep.wire_stats,
            "launches": {"bin_xorsum_units": enc // 2, "gf2_matmul": enc // 2,
                         "tree_digest": levels, "bch_decode_batched": ep.launches[
                             "decode_launches"]},
            "cohort_rounds": cohort_rounds(ep.tracer), "phase0_span_s": phase0,
            "parity_extensions": ep.parity_extensions}


def check_pair_launches(alice, bob, launches, levels: int) -> None:
    """The global launch ledger agrees with what both endpoints dispatched."""
    for name in ("bin_xorsum_units", "gf2_matmul"):
        assert launches.get(name, 0) > 0, f"wire pair never launched {name}: {launches}"
    enc = alice.launches["kernel_launches"] + bob.launches["kernel_launches"] - 2 * levels
    assert launches["bin_xorsum_units"] == launches["gf2_matmul"] == enc // 2, (
        launches, alice.launches, bob.launches)
    assert launches.get("tree_digest", 0) == 2 * levels, (launches, levels)
    assert alice.launches["decode_launches"] == 0 < bob.launches["decode_launches"]


def wire_sessions_run(label, transport, picks, sessions, serve_results):
    """Serve-phase sessions ``picks`` over one transport; every result equal
    to the in-process server's for the same session."""
    def submit(alice, bob):
        t0 = time.perf_counter()
        for sid in picks:
            _, a, _, cfg, dk = sessions[sid]
            alice.submit(a, cfg=cfg, d_known=dk)
        t1 = time.perf_counter()
        for sid in picks:
            _, _, b, cfg, dk = sessions[sid]
            bob.submit(b, cfg=cfg, d_known=dk)
        return {"alice_submit_s": t1 - t0, "bob_submit_s": time.perf_counter() - t1}

    alice, bob, results, times, launches, shapes = drive_pair(transport, submit)
    assert sorted(results) == list(range(len(picks))), label
    for i, sid in enumerate(picks):
        got, want = results[i], serve_results[sid]
        for f in WIRE_FIELDS:
            assert getattr(got, f) == getattr(want, f), (label, sessions[sid][0], f)
    assert alice.verified == bob.verified == [True] * len(picks), label
    assert alice.parity_extensions == bob.parity_extensions, label
    check_pair_launches(alice, bob, launches, 0)
    sa, sb = side_report(alice, 0), side_report(bob, 0)
    wa, wb = sa["wire_stats"], sb["wire_stats"]
    assert wa["frame_bytes_out"] == wb["frame_bytes_in"], label
    assert wa["frame_bytes_in"] == wb["frame_bytes_out"], label
    for k in ("estimator_frame_bytes", "protocol_frame_bytes", "verify_frame_bytes"):
        assert wa[k] == wb[k], (label, k)
    diffs = sum(len(results[i].diff) for i in range(len(picks)))
    ledger = sum(results[i].bytes_sent + results[i].estimator_bytes for i in range(len(picks)))
    framed = wa["frame_bytes_out"] + wa["frame_bytes_in"]
    emit({"phase": "wire", "run": label, "sessions": [sessions[s][0] for s in picks],
          "set_size": len(sessions[picks[0]][1]), **times,
          "diffs": diffs, "ledger_bytes_per_diff": ledger / diffs,
          "framed_bytes_per_diff": framed / diffs,
          "alice": sa, "bob": sb, "launches": launches,
          "decode_launches_per_cohort_round": sb["launches"]["bch_decode_batched"]
          / sb["cohort_rounds"],
          "all_results_match_in_process": True})
    return alice, bob, launches, shapes


def wire_tree_run(a, b, cfg, tr, captured):
    """``submit_tree`` of one pair over ``InMemoryDuplex``: the union of the
    leaf diffs is the true difference, every leaf result equals the
    in-process walk's (``tr``), and so do the tree's bytes, leaves and
    depth; one ``tree_digest_ranges`` launch a level a side."""
    tcfg = TreeConfig()

    def submit(alice, bob):
        t0 = time.perf_counter()
        alice.submit_tree(a, cfg, tcfg)
        t1 = time.perf_counter()
        bob.submit_tree(b, cfg, tcfg)
        return {"alice_submit_s": t1 - t0, "bob_submit_s": time.perf_counter() - t1}

    with recording_k4(captured):
        alice, bob, results, times, launches, shapes = drive_pair(
            InMemoryDuplex.pair, submit)
    st = tr.stats
    levels = alice.tree_depth + 1
    assert levels == st.levels, (levels, st)
    assert alice.tree_leaves == bob.tree_leaves == st.leaves, (alice.tree_leaves, st)
    assert alice.tree_depth == bob.tree_depth == st.depth, st
    diff = set()
    for sid in range(st.leaves):
        assert results[sid] == tr.results[sid], sid          # every result field
        diff |= results[sid].diff
    assert sorted(results) == list(range(st.leaves))
    assert diff == set(np.setxor1d(a, b).tolist())
    assert bob.verified == [True] * st.leaves
    sa, sb = side_report(alice, levels), side_report(bob, levels)
    tree_bytes = sa["wire_stats"]["tree_frame_bytes"]
    assert tree_bytes == sb["wire_stats"]["tree_frame_bytes"] == tr.tree_bytes, (
        tree_bytes, tr.tree_bytes)
    check_pair_launches(alice, bob, launches, levels)
    emit({"phase": "wire", "run": "tree over InMemoryDuplex", "pair": "uniform",
          "size_a": len(a), "size_b": len(b), "d": len(diff), **times,
          "levels": levels, "depth": st.depth, "leaves": st.leaves,
          "tree_frame_bytes": tree_bytes, "pbs_bytes": sum(r.bytes_sent for r in results.values()),
          "bytes_per_diff": (tree_bytes + sum(r.bytes_sent for r in results.values()))
          / len(diff),
          "alice": sa, "bob": sb, "launches": launches,
          "all_leaves_match_in_process": True})
    return launches, shapes


def wire_phase(sessions, serve_results, trees):
    """The wire pair on the card (see the module docstring).  Returns the
    launches of its runs by kernel, the shapes they launched each kernel
    at, and the ``tree_digest`` inputs by shape."""
    t_phase = time.perf_counter()
    launches, launched, captured = {}, {}, {}
    picks = wire_picks(sessions)
    est = next(s for s in picks if sessions[s][4] is None)
    _, a, _, cfg, _ = sessions[est]
    t0 = time.perf_counter()
    tow_sketches(np.unique(a), derive_seed(cfg.seed, 0x70), cfg.ell)
    emit({"phase": "wire", "host_phase0_sketch_s": time.perf_counter() - t0,
          "keys": len(a), "ell": cfg.ell})

    # the known d = 10 and 10 000 sessions run over the hub only, and the
    # d = 100 one over TCP: a depth cut that keeps the script's time
    memory = [s for s in picks
              if sessions[s][0] not in ("known d=10", "known d=100", "known d=10000")]
    _, _, counts, shapes = wire_sessions_run(
        "pair over InMemoryDuplex", InMemoryDuplex.pair, memory, sessions, serve_results)
    merge_launches(launches, launched, counts, shapes)
    tcp = [s for s in picks if sessions[s][0] in ("known d=100", "known d=1000")]
    alice, _, counts, shapes = wire_sessions_run(
        "pair over tcp_loopback_pair", tcp_loopback_pair, tcp, sessions, serve_results)
    ws = alice.wire_stats
    assert ws["transport_bytes_out"] == ws["frame_bytes_out"], ws
    merge_launches(launches, launched, counts, shapes)
    a, b, cfg, tr = trees["uniform"]
    counts, shapes = wire_tree_run(a, b, cfg, tr, captured)
    merge_launches(launches, launched, counts, shapes)
    for name in PATHS["wire"]:
        assert launches.get(name, 0) > 0, f"wire path never launched {name}: {launches}"
    emit({"phase": "wire", "wire_phase_s": time.perf_counter() - t_phase,
          "launches": launches})
    return launches, launched, captured


# ---------------------------------------------------------------------------
# the hub
# ---------------------------------------------------------------------------


def frame_totals(stats_list) -> dict:
    """Framed bytes by class, and frames, summed over ``wire_stats`` dicts."""
    keys = ("frames_out", "frames_in", "frame_bytes_out", "frame_bytes_in",
            "estimator_frame_bytes", "protocol_frame_bytes", "verify_frame_bytes",
            "tree_frame_bytes", "resume_frame_bytes", "epoch_envelope_bytes",
            "mux_bytes_out", "mux_bytes_in")
    return {k: sum(ws[k] for ws in stats_list) for k in keys}


def alice_encodes(alices, levels: int) -> int:
    """Cohort encodes the Alices dispatched (each one K1 and one K2 launch):
    their ``kernel_launches`` less one ``tree_digest`` launch a tree level."""
    enc = sum(ep.launches["kernel_launches"] for ep in alices.values()) - levels
    assert enc % 2 == 0, [ep.launches for ep in alices.values()]
    return enc // 2


def check_hub_launches(hub, alices, launches, levels: int) -> None:
    """The global launch ledger equals what the hub and its peers counted:
    K1 = K2 = the hub's cohort encodes plus the Alices', one ``tree_digest``
    a level a side; only the hub decodes."""
    hub_enc = hub.stats["kernel_launches"]
    assert hub_enc % 2 == 0, hub.stats
    enc = hub_enc // 2 + alice_encodes(alices, levels)
    assert launches["bin_xorsum_units"] == launches["gf2_matmul"] == enc, (
        launches, hub.stats, [ep.launches for ep in alices.values()])
    assert launches.get("tree_digest", 0) == 2 * levels, (launches, levels)
    assert all(ep.launches["decode_launches"] == 0 for ep in alices.values())


def hub_run(sessions, serve_results, trees, captured):
    """One ``HubEndpoint`` on the card serving 8 port ``AliceEndpoint``s on
    threads (``run_hub``): 7 of the serve phase's sessions of |A| = 10^6 (the
    known d = 100 one over a TCP loopback socket, the others over
    ``InMemoryDuplex``) and a tree peer on the tree phase's uniform pair.
    Every plain result equals serve's for the same session, every tree leaf
    the in-process walk's; the hub's launches are fused (2 encodes and 1
    decode a cohort-round, whatever the peer count) and the global launch
    ledger equals hub plus Alices.  Keeps the ``tree_digest_ranges``
    inputs in ``captured``."""
    picks = wire_picks(sessions)
    a3, b3, cfg3, tr = trees["uniform"]
    tcfg = TreeConfig()
    hub = HubEndpoint(tracer=Tracer())      # device=None: the card
    alices, sid_of, links = {}, {}, []
    walls = {"hub_submit_s": 0.0, "alice_submit_s": 0.0}

    def timed(key, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        walls[key] = walls.get(key, 0.0) + time.perf_counter() - t0
        return out

    try:
        for sid in picks:
            label, a, b, cfg, dk = sessions[sid]
            ta, tb = (tcp_loopback_pair if label == "known d=100" else InMemoryDuplex.pair)()
            links += [ta, tb]
            ch = hub.add_peer(tb, label=label)
            timed("hub_submit_s", hub.submit, ch, b, cfg=cfg, d_known=dk)
            alices[ch] = AliceEndpoint(ta, channel=ch)
            timed("alice_submit_s", alices[ch].submit, a, cfg=cfg, d_known=dk)
            sid_of[ch] = sid
        ta, tb = InMemoryDuplex.pair()
        links += [ta, tb]
        ch_tree = hub.add_peer(tb, label="tree uniform")
        timed("hub_submit_tree_s", hub.submit_tree, ch_tree, b3, cfg=cfg3, tree=tcfg)
        alices[ch_tree] = AliceEndpoint(ta, channel=ch_tree)
        timed("alice_submit_tree_s", alices[ch_tree].submit_tree, a3, cfg3, tcfg)
        platform.reset_launch_counts()
        with recording_k4(captured):
            t0 = time.perf_counter()
            outcomes, results, errors = run_hub(hub, alices)
            torch.cuda.synchronize()
            walls["run_hub_s"] = time.perf_counter() - t0
        launches, shapes = platform.launch_counts(), platform.launch_shapes()
    finally:
        for t in links:
            t.close()
    assert not errors, errors

    for ch, sid in sid_of.items():
        got, want = results[ch][0], serve_results[sid]
        for f in WIRE_FIELDS:
            assert getattr(got, f) == getattr(want, f), (sessions[sid][0], f)
    st, ts = hub.stats, tr.stats
    for sid in range(ts.leaves):
        assert results[ch_tree][sid] == tr.results[sid], sid      # every result field
    assert sorted(results[ch_tree]) == list(range(ts.leaves))
    tree_diff = set().union(*(r.diff for r in results[ch_tree].values()))
    assert tree_diff == set(np.setxor1d(a3, b3).tolist())
    for ch, o in outcomes.items():
        assert o.ok and o.error_kind is None, (ch, o.error)
        assert o.verified == [True] * len(results[ch]), ch
        assert o.wire_stats["frame_bytes_in"] == alices[ch].wire_stats["frame_bytes_out"], ch
        assert o.wire_stats["frame_bytes_out"] == alices[ch].wire_stats["frame_bytes_in"], ch
    o3 = outcomes[ch_tree]
    assert (o3.tree_leaves, o3.tree_depth, st["tree_levels"]) == (ts.leaves, ts.depth, ts.levels)
    assert alices[ch_tree].wire_stats["tree_frame_bytes"] == o3.wire_stats[
        "tree_frame_bytes"] == tr.tree_bytes

    # fusion: one rateless session, so each ladder level is one cohort and
    # parity_extensions counts the ladder's cohort-levels
    ext = st["parity_extensions"]
    assert ext > 0, st
    assert st["kernel_launches"] == 2 * (st["cohort_rounds"] + ext), st
    assert st["decode_launches"] == st["cohort_rounds"] + ext, st
    check_hub_launches(hub, alices, launches, ts.levels)
    peer_enc = alice_encodes(alices, ts.levels)
    assert st["kernel_launches"] // 2 < peer_enc, (st, peer_enc)

    plain = [results[ch][0] for ch in sid_of]
    diffs = sum(len(r.diff) for r in plain) + len(tree_diff)
    ledger = (sum(r.bytes_sent + r.estimator_bytes for r in plain)
              + sum(r.bytes_sent for r in results[ch_tree].values()) + tr.tree_bytes)
    frames = frame_totals([o.wire_stats for o in outcomes.values()])
    emit({"phase": "hub", "run": "8 peers",
          "peers": [sessions[sid][0] for sid in sid_of.values()] + ["tree uniform"],
          "set_size": len(sessions[picks[0]][1]), **walls,
          "rounds": st["rounds"], "cohort_rounds": st["cohort_rounds"],
          "parity_extensions": ext, "tree_levels": st["tree_levels"],
          "tree_leaves": st["tree_leaves"],
          "hub_kernel_launches": st["kernel_launches"],
          "hub_decode_launches": st["decode_launches"],
          "alices_kernel_launches": sum(ep.launches["kernel_launches"] for ep in alices.values()),
          "alices_cohort_encodes": peer_enc,
          "alices_decode_launches": sum(ep.launches["decode_launches"] for ep in alices.values()),
          "peer_rounds": sum(r.rounds for res in results.values() for r in res.values()),
          "hub_frames": frames, "diffs": diffs,
          "ledger_bytes_per_diff": ledger / diffs,
          "framed_bytes_per_diff": (frames["frame_bytes_in"] + frames["frame_bytes_out"])
          / diffs,
          "h2d_bytes": st["h2d_bytes"], "store_uploads": st["store_uploads"],
          "retraces": st["retraces"], "launches": launches,
          "all_results_match_serve": True, "all_leaves_match_in_process": True})
    return launches, shapes


def hub_resume_run(sessions, serve_results):
    """A 2-peer hub with a resume window on the card, serving serve's known
    d = 100 and d = 1000 sessions; the peer whose session runs more rounds
    crashes after two sends (``FaultPlan(crash_after_sends=2)``), reconnects
    over a fresh duplex and resumes through ``MSG_RESUME``.  Both results
    equal serve's; the crashed peer's outcome is ``resumed``."""
    picks = [sid for sid in wire_picks(sessions)
             if sessions[sid][0] in ("known d=100", "known d=1000")]
    crash_sid = max(picks, key=lambda s: serve_results[s].rounds)
    hub = HubEndpoint(resume_window=30.0)
    alices, sid_of, links, pending, calls = {}, {}, [], {}, {}
    try:
        for sid in picks:
            label, a, b, cfg, dk = sessions[sid]
            ta, tb = InMemoryDuplex.pair()
            links += [ta, tb]
            if sid == crash_sid:
                ta = ChaosTransport(ta, FaultPlan(crash_after_sends=2))
            ch = hub.add_peer(tb, label=label)
            hub.submit(ch, b, cfg=cfg, d_known=dk)
            alices[ch] = AliceEndpoint(ta, channel=ch)
            alices[ch].submit(a, cfg=cfg, d_known=dk)
            sid_of[ch] = sid
            calls[ch] = alices[ch].run
        ch_crash = next(ch for ch, s in sid_of.items() if s == crash_sid)
        crash = {}

        def crasher():
            try:
                return alices[ch_crash].run()
            except TransportError as e:
                crash["error"] = repr(e)
            na, nh = InMemoryDuplex.pair()
            links.extend([na, nh])
            pending["t"] = nh
            alices[ch_crash].resume(na)
            return alices[ch_crash].resume_run()

        def on_barrier(rnd):
            if "t" in pending and hub._peers[ch_crash].suspended:
                hub.resume_peer(ch_crash, pending.pop("t"))

        calls[ch_crash] = crasher
        hub.on_barrier = on_barrier
        platform.reset_launch_counts()
        t0 = time.perf_counter()
        outcomes, results, errors = drive_hub(hub, calls, join_timeout=120.0)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches, shapes = platform.launch_counts(), platform.launch_shapes()
    finally:
        for t in links:
            t.close()
    assert not errors, errors
    assert "error" in crash, "the scripted crash never fired"
    st = hub.stats
    for ch, sid in sid_of.items():
        got, want = results[ch][0], serve_results[sid]
        for f in WIRE_FIELDS:
            assert getattr(got, f) == getattr(want, f), (sessions[sid][0], f)
        assert outcomes[ch].ok and outcomes[ch].verified == [True], ch
    assert outcomes[ch_crash].error_kind == "resumed" and alices[ch_crash].resumes == 1
    assert st["peers_resumed"] == 1 and st["peers_failed"] == 0, st
    check_hub_launches(hub, alices, launches, 0)
    aw = alices[ch_crash].wire_stats
    assert aw["resume_frame_bytes"] == outcomes[ch_crash].wire_stats["resume_frame_bytes"] > 0
    emit({"phase": "hub", "run": "resume", "sessions": [sessions[s][0] for s in picks],
          "crashed": sessions[crash_sid][0], "crash": crash["error"],
          "crashed_rounds": serve_results[crash_sid].rounds, "run_hub_s": run_s,
          "error_kinds": {sessions[sid_of[ch]][0]: o.error_kind for ch, o in outcomes.items()},
          "peers_resumed": st["peers_resumed"],
          "resume_replay_bytes": st["resume_replay_bytes"],
          "resume_frame_bytes": aw["resume_frame_bytes"],
          "hub_kernel_launches": st["kernel_launches"],
          "hub_decode_launches": st["decode_launches"], "cohort_rounds": st["cohort_rounds"],
          "launches": launches, "all_results_match_serve": True})
    return launches, shapes


def hub_phase(sessions, serve_results, trees):
    """The hub on the card (see the module docstring).  Returns the
    launches of its runs by kernel, the shapes they launched each kernel
    at, and the ``tree_digest`` inputs by shape."""
    t_phase = time.perf_counter()
    launches, launched, captured = {}, {}, {}
    counts, shapes = hub_run(sessions, serve_results, trees, captured)
    merge_launches(launches, launched, counts, shapes)
    counts, shapes = hub_resume_run(sessions, serve_results)
    merge_launches(launches, launched, counts, shapes)
    for name in PATHS["hub"]:
        assert launches.get(name, 0) > 0, f"hub path never launched {name}: {launches}"
    emit({"phase": "hub", "hub_phase_s": time.perf_counter() - t_phase, "launches": launches})
    return launches, launched, captured


# ---------------------------------------------------------------------------
# continuous sync over the hub
# ---------------------------------------------------------------------------

SYNC_EPOCHS = 3
SYNC_CHURN = 1000       # keys added and keys removed per side per epoch


def epoch_churn(rng, base, n: int):
    """Each side's churn of one epoch over the shared converged set
    ``base``: ``n`` fresh keys added and ``n`` keys removed a side, the two
    sides' keys disjoint, so the epoch's difference is exactly 4n keys."""
    removed = rng.permutation(base)[: 2 * n]
    fresh = np.setdiff1d(
        np.unique(rng.integers(1, 1 << 32, size=3 * n, dtype=np.uint64).astype(np.uint32)),
        base)
    fresh = rng.permutation(fresh)[: 2 * n]
    assert len(fresh) == 2 * n
    return (fresh[:n], removed[:n]), (fresh[n:], removed[n:])


def sync_run(args, sessions, pool, cold=None):
    """One continuous hub (``run_hub_epoch``) on the card with 2 peers,
    serve's known d = 100 and d = 1000 pairs of |A| = 10^6, for
    ``SYNC_EPOCHS`` epochs of seeded churn (``SYNC_CHURN`` keys added and
    removed a side).  The sessions pin the layout planned for the epochs'
    d = 4 * SYNC_CHURN (n, t, g overrides, as the reference's churn soak pins
    its layout), so every epoch patches the resident stores in place.  Each
    epoch's results equal ``core.pbs.reconcile`` in ``pool`` and the true
    difference, or, given the rows of an earlier run ``cold`` over the same
    epochs, that run's results.  No store rebuilds after epoch 0 and
    cumulative delta H2D <= 25 % of rebuilding every epoch.  Returns the
    per-epoch rows, and the launches and launched shapes of the run."""
    rng = np.random.default_rng(args.seed + 99)
    d_epoch = 4 * SYNC_CHURN
    plan = plan_from_d_known(PBSConfig(), d_epoch)
    layout = {"n_override": plan.n, "t_override": plan.t, "g_override": plan.g}
    picks = [sid for sid in wire_picks(sessions)
             if sessions[sid][0] in ("known d=100", "known d=1000")]
    hub = HubEndpoint(continuous=True)
    alices, cfgs, dks, links = {}, {}, {}, []
    try:
        t0 = time.perf_counter()
        for sid in picks:
            label, a, b, cfg, dk = sessions[sid]
            cfg = PBSConfig(seed=cfg.seed, **layout)
            ta, tb = InMemoryDuplex.pair()
            links += [ta, tb]
            ch = hub.add_peer(tb, label=label)
            hub.submit(ch, b, cfg=cfg, d_known=dk)
            alices[ch] = AliceEndpoint(ta, channel=ch, continuous=True)
            alices[ch].submit(a, cfg=cfg, d_known=dk)
            cfgs[ch], dks[ch] = cfg, dk
        submit_s = time.perf_counter() - t0
        platform.reset_launch_counts()
        rows, store_bytes, delta = [], None, []
        for e in range(SYNC_EPOCHS + 1):
            t0 = time.perf_counter()
            if e:
                hub_muts, alice_muts = {}, {}
                for ch, ep in alices.items():
                    base = outcomes[ch].sessions[0].state.b      # converged last epoch
                    (a_add, a_rem), (b_add, b_rem) = epoch_churn(rng, base, SYNC_CHURN)
                    hub_muts[ch] = {0: (b_add, b_rem)}
                    alice_muts[ch] = {0: (a_add, a_rem)}
                hub.advance_epoch(hub_muts, d_known={ch: {0: d_epoch} for ch in alices})
                for ch, ep in alices.items():
                    ep.advance_epoch(alice_muts[ch], d_known={0: d_epoch})
                    dks[ch] = d_epoch
            advance_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            outcomes, results, errors = (run_hub_epoch if e else run_hub)(hub, alices)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            assert not errors, (e, errors)
            st = hub.stats
            got = [results[ch][0] for ch in alices]
            if cold is None:
                jobs = [(alices[ch].sessions[0].state.a, outcomes[ch].sessions[0].state.b,
                         cfgs[ch], dks[ch]) for ch in alices]
                for r, want, (a_e, b_e, _, _) in zip(got, pool.starmap(reconcile, jobs), jobs):
                    assert r.success and r == want, (e, r, want)
                    truth = set(np.setxor1d(a_e, b_e).tolist())
                    assert r.diff == truth and (e == 0 or len(truth) == d_epoch), e
            else:
                assert got == cold[e]["results"], e
            assert all(o.ok and o.verified == [True] for o in outcomes.values()), e
            if e == 0:
                store_bytes = st["h2d_store_bytes"]
                assert store_bytes > 0 and st["store_builds"] == st["store_uploads"], st
            else:
                assert st["store_builds"] == 0 and st["store_compactions"] == 0, (e, st)
                assert 0 < st["h2d_delta_bytes"] < store_bytes, (e, st)
                delta.append(st["h2d_delta_bytes"])
            rows.append({"epoch": e, "advance_s": advance_s, "run_s": run_s,
                         "diffs": sum(len(r.diff) for r in got),
                         "rounds": st["rounds"], "cohort_rounds": st["cohort_rounds"],
                         "kernel_launches": st["kernel_launches"],
                         "decode_launches": st["decode_launches"],
                         "store_builds": st["store_builds"],
                         "h2d_store_bytes": st["h2d_store_bytes"],
                         "h2d_delta_bytes": st["h2d_delta_bytes"],
                         "h2d_round_bytes": st["h2d_round_bytes"], "retraces": st["retraces"],
                         "frames": frame_totals([o.wire_stats for o in outcomes.values()]),
                         "results": got})
        launches, shapes = platform.launch_counts(), platform.launch_shapes()
    finally:
        for t in links:
            t.close()
    frac = sum(delta) / (SYNC_EPOCHS * store_bytes)
    assert frac <= 0.25, (frac, delta, store_bytes)
    return {"sessions": [sessions[s][0] for s in picks], "layout": layout,
            "submit_s": submit_s, "store_bytes": store_bytes,
            "delta_h2d_fraction_of_rebuild": frac, "rows": rows}, launches, shapes


def sync_phase(args, sessions, pool):
    """The sync path on the card: a cold continuous hub over the epochs (the
    counted run: every epoch against the oracle), then a second hub over the
    same epochs in the warmed process, equal to the first epoch for epoch,
    which must meet no new executor variant in any epoch (``retraces`` 0:
    the shape buckets a workload's epochs need are all seen after one pass
    over them; which buckets rounds 2 and 3 need depends on the epoch's
    data, so a first pass may still meet new ones in any epoch)."""
    t_phase = time.perf_counter()
    cold, launches, shapes = sync_run(args, sessions, pool)
    for name in PATHS["sync"]:
        assert launches.get(name, 0) > 0, f"sync path never launched {name}: {launches}"
    assert cold["rows"][0]["retraces"] > 0, "a cold hub met no new executor variant"
    warm, _, _ = sync_run(args, sessions, None, cold=cold["rows"])
    assert [r["retraces"] for r in warm["rows"]] == [0] * (SYNC_EPOCHS + 1), warm["rows"]

    def public(run):
        return {**run, "rows": [{k: v for k, v in r.items() if k != "results"}
                                for r in run["rows"]]}

    emit({"phase": "sync", "set_size": len(sessions[0][1]), "churn_per_side": SYNC_CHURN,
          "cold": public(cold), "warm": public(warm), "launches": launches,
          "sync_phase_s": time.perf_counter() - t_phase, "all_epochs_match_oracle": True})
    return launches, shapes


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
    # 7 before the wire phase joined the run, 5 before the hub and sync
    # phases did; 3 keeps the whole script near the time it took before
    ap.add_argument("--sessions-per-d", type=int, default=3,
                    help="known-d sessions per d in {10, 100, 1000, 10000}")
    ap.add_argument("--size", type=int, default=1_000_000, help="|A| per session")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", metavar="PATH", default=None,
                    help="after the serve phase, profile one more run with "
                         "torch.profiler and write device time by kernel to PATH")
    ap.add_argument("--out", metavar="PATH", default=None,
                    help="also write every JSON line to PATH (the kernels line "
                         "runs to tens of KB)")
    ap.add_argument("--kernels-only", action="store_true",
                    help="build the kernels and run their shape sweeps; skip the "
                         "serve phase and the measurements at its shapes")
    args = ap.parse_args()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        _OUT.append(open(args.out, "w"))
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
    sass = sass_inner_loops(libs["tow_sketch"])
    emit({"phase": "sass", "tow_sketch_inner_loops": [
        {"kernel": k, "NS": ns, **v} for (k, ns), v in sorted(sass.items())]})

    kernel_sweeps(rng)
    if not args.kernels_only:
        launches, launched = {}, {}
        k4_inputs = {}
        with oracle_pool() as pool:
            launches["serve"], launched["serve"], sessions, serve_results = serve_phase(
                args, rng, pool)
            launches["tree"], launched["tree"], k4_inputs["tree"], trees = tree_phase(
                args, pool)
            launches["encode_group"], launched["encode_group"] = encode_group_phase(rng)
            launches["wire"], launched["wire"], k4_inputs["wire"] = wire_phase(
                sessions, serve_results, trees)
            launches["hub"], launched["hub"], k4_inputs["hub"] = hub_phase(
                sessions, serve_results, trees)
            launches["sync"], launched["sync"] = sync_phase(args, sessions, pool)
        del sessions, serve_results, trees
        report = main_shape_phase(args, rng, launched, k4_inputs, sass)
        emit({"kernels": [
            {"name": name, **meta, "launches": launches[HOME_PATH[name]][name], **report[name],
             "launches_by_path": {path: n[name] for path, n in launches.items() if name in n}}
            for name, meta in KERNELS.items()]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
