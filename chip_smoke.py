#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--sessions-per-d 3] [--size 1000000] [--seed 0] [--out PATH]

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version on the card (exact equality —
everything is integer / GF(2) arithmetic, tolerance 0), then drives nine
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
  10^6 for 3 epochs of seeded churn, the resident stores patched in place;
* ``obs`` — the observability layer at deployment size: a 2-peer chaos hub
  (one peer crashes and resumes, one sits behind a lossy ARQ channel) with
  one shared ``Tracer(torch_profiler=True)`` as every component's tracer
  and the engine's dispatch tracer, its whole ``serve`` inside
  ``torch.profiler``: the acceptance trace's events, both exports loading
  equal, the profiler's K1/K2 device launches equal to the launch ledgers,
  and each thread's host / device / wire split of its spans;
* ``examples`` — each ``examples/*_torch.py`` twin's ``main()`` on the card
  at its default size (its own asserts against ``core.pbs.reconcile``);
* ``model_serve`` — the model scaffold's serving path, which runs no PBS
  kernel (the launch counts must read 0), for each row of ``MODEL_ROWS``:
  qwen2-1.5b (dense GQA), recurrentgemma-2b (RG-LRU with sliding-window
  attention), mamba2-780m (SSD), deepseek-v2-236b (MLA with absorbed
  decode over a latent cache, routed experts gathered per expert),
  whisper-tiny (encoder-decoder: 1 500 stub frames encoded once a
  prefill, cross attention over their cached K/V) and pixtral-12b (a
  1 024-position stub image patch frontend).  First the
  model at smoke width served through ``serve.scheduler.BatchScheduler``
  on the CPU and on the card from one float32 weight set (equal
  completions, last-position logits within ``SMOKE_LOGIT_ATOL``); then at
  full width and about half their depth (``MODEL_ROWS``) in bfloat16,
  weights from a seeded ``torch.Generator``, serving 20 requests in three
  prompt-length buckets, one ``run`` a bucket with that bucket's frames or
  patches (``run(extras=)``; 32 new tokens each, batch 8; qwen2 8 x 128,
  8 x 512, 4 x 1536 at ``max_len`` 2048; recurrentgemma 8 x 128, 8 x 512,
  4 x 3000, past its 2048-slot window; mamba2 8 x 128, 8 x 1000, a ragged
  chunk, 4 x 2048; deepseek-v2 as qwen2; whisper 8 x 4, 8 x 132, 4 x 224
  at ``max_len`` 448; pixtral 8 x 128 text, 8 x 1056 and 4 x 2048 after
  an image, at ``max_len`` 3072), every generated token held
  against the no-cache ``models.backbone.forward`` given the same frames
  or patches (equal wherever the forward's top-2 margin
  exceeds the row's ``margin_tol``, at least half the positions checked;
  deepseek-v2's on a float32 model of 3 layers at full width, and only
  where every MoE layer routed the token as the forward did),
  and prefill and decode timed with CUDA events beside their bounds (bytes
  for a decode step, bf16 tensor operations for a prefill; for the MoE row
  the active parameters only, and the routed experts a decode step read,
  counted from the router's top-k on the card; for whisper the encoder's
  operations over its frames, and a decode step's cross cache without
  the encoder's weights);
* ``model_train`` — the training path (``train.make_train_step``:
  autograd through the serving path's torch ops with per-layer remat and a
  chunked loss, ``optim`` AdamW with float32 or int8 states, error-feedback
  top-k compression; ``checkpoint``, ``data`` and ``launch.train`` through
  ``examples/train_lm_torch.py``), which launches no PBS kernel: one
  ``bundle.step`` of each of the ten smoke configs on the CPU and on the
  card from one carried float32 state (metrics, every parameter and
  state leaf after the step); qwen2-1.5b's gradients at full width and 2
  layers in float32 over 512 tokens, card against CPU, leaf by leaf; then
  qwen2-1.5b at full width, all 28 layers in bfloat16, 8 x 4 096 tokens a
  step as 2 microbatches of 4 (the reference's ``train_4k`` cell, its
  batch of 256 cut to 8): 6 steps with float32 states on one repeated
  batch (the loss must fall by ``TRAIN_DESCENT``), the same with int8
  states (within ``TRAIN_INT8_RTOL`` of them), 3 with 1 % compression,
  each step timed beside its bound, peak memory, the forward-and-backward
  and optimizer halves of a step and the card's busy share of one; last
  the ``train_lm`` twin killed at step 35 and resumed (the resumed state
  bit-equal to the checkpoint, its losses within ``TWIN_LOSS_ATOL`` of an
  uninterrupted run's).
* ``multirank`` — training across ranks (``launch.ranks`` starting the
  ranks, ``launch.mesh`` with its axis groups, the sequence-parallel and
  vocab-sharded layers, ZeRO-1, compression over 'data'), the ranks
  processes sharing the one card over gloo (named: NCCL refuses two ranks
  on one card), which launches no PBS kernel: qwen2-1.5b at full width,
  2 layers in float32, 4 x 512 tokens, one step from one carried state on
  (1, 2), (2, 1) with ZeRO-1 and (2, 2) with 1 % compression, every rank's
  shards of the loss, synced gradients and updated parameters against the
  one-rank step on the card; then (1, 2) and (2, 1) with ZeRO-1 timed at 2
  layers in bfloat16 on ``model_train``'s 8 x 4 096 rows: step wall, the
  host wall inside the collectives and each rank's peak memory — figures
  of ranks sharing a card, not of NVLink or of scaling.  Then the 2-rank
  group serves qwen2-1.5b at full width and 14 of its 28 layers in bfloat16
  (``BatchScheduler`` over each rank's shards, the sequence-sharded KV
  cache, the distributed argmax) on (1, 2) and (2, 1), buckets 128 x 8
  and 1 536 x 4, 16 new tokens: prefill ms a bucket, decode ms a step,
  the collectives of a step from the mesh's ledger, each rank's peak;
  after them rank 0 alone runs one rank and checks every mesh's tokens
  against its no-cache forward (``MR_SERVE_MARGIN``) and a float32
  2-layer model's against its run (``MR_SERVE_F32_MARGIN``), on a line
  ``"step": "serve"`` before the phase's own.  The MoE family the same
  way (``MR_MOE_ARCH``, deepseek-v2-236b): its training check at reduced
  width on the same three meshes (the routed experts over the whole
  world, their tokens dispatched by all-to-all, no pair dropped at
  capacity), then served at full width and 4 layers in bfloat16 on
  (1, 2) and (2, 1) with the same traffic, each rank drawing the weights
  leaf by leaf and keeping its shard (``draw_shards``), and a float32
  3-layer model's tokens checked by rank 0 against the one-rank forward
  (``MR_MOE_MARGIN`` and the route rule) and the one-rank run (near ties
  only), on a line ``"step": "serve_moe"``.  The recurrent families
  (``MR_REC_ARCHS``, recurrentgemma-2b and mamba2-780m) the same way: the
  training check at full width and reduced depth on (1, 2) and (2, 1)
  with ZeRO-1 (the RG-LRU's gathered tails and summaries, the SSD's
  head-sharded norm), then served at full width and half their layers in
  bfloat16 on (1, 2) and (2, 1) with the same traffic, and the tokens
  checked by rank 0 (``MR_REC_CHECK``), on a line ``"step":
  "serve_recurrent"``.  The frontend families (``MR_FRONT_ARCHS``,
  whisper-tiny and pixtral-12b) the same way: the training check on (1, 2)
  and (2, 1) with ZeRO-1, whisper at full width and depth beside 1 500
  frames, pixtral at reduced width with 384 patch positions; then served in
  bfloat16 (``MR_FAMILY_SERVE``: whisper all its layers over 1 500 frames,
  pixtral 8 of 40 layers with a 1 024-patch image and a text-only bucket)
  and their float32 tokens checked by rank 0 (``MR_FRONT_CHECK``), on a
  line ``"step": "serve_frontends"``.
* ``dryrun`` — ``launch.dryrun`` and ``roofline``, which launch no PBS
  kernel: the 40-cell grid counted on meta tensors by
  ``python -m repro_torch.launch.dryrun``, one process an arch, and one
  cell a family (``DRYRUN_MESH_CELLS``) on rank 0 of the meta production
  meshes, (16, 16) and (2, 16, 16), in one more process, the card hidden
  from them, counting beside the kernels' build and sweeps and read
  before the first path runs (at most ``DRYRUN_GRID_BUDGET_S``; records
  under ``chiprun_out/dryrun/``; each mesh cell's three terms, bound, peak
  and dropped pairs on the phase's line), then four cells at a reduced
  batch predicted on meta tensors and run for real — qwen2-1.5b train_4k
  (``model_train``'s f32 run, re-used), prefill_32k and decode_32k,
  mamba2-780m long_500k: flops equal to ``FlopCounterMode``'s over the
  real step, the peak within ``roofline.PEAK_RTOL`` of
  ``max_memory_allocated``, the measured step no faster than the roofline
  step; and phase ``multirank``'s timed (1, 2) training step counted on a
  meta mesh, equal per op (calls, bytes in, ring bytes) to the ledgers its
  two ranks recorded on the card (``meta_ledger_check``).

Every result is compared with the package's own numpy oracle
``core.pbs.reconcile`` (per session, per tree leaf) and with the true set
difference; every wire result with the in-process result of the same
session (serve phase, tree phase), every hub result likewise (the obs
phase's too), and every epoch of the sync phase with ``core.pbs.reconcile``.  Last, every kernel is
compared with its plain version, timed and held against its bound at
exactly the shapes its path launched it at (read from the launch ledger).  Each shape gets two times: ``ms``, CUDA
events around the wrapper (host issue included), and ``device_ms``, the
kernel's own duration from ``torch.profiler`` (or a CUDA-graph replay where
the profiler records none; ``device_ms_by`` says which).  Bounds count one
bit per 0/1 entry (parity bitmaps, K2's A, B and C).  K1 and K2 are measured
through the packed entries the main path calls, K4 through the ragged entry
``tree_digest_ranges`` the walk calls, with the old route (the padded level
gather plus the masked-rows kernel) timed beside it on the same ranges.  K5
is timed per call over every stage (fold and merge, split by kernel) with
its launch geometry, and its PR 13 route (one cluster) beside it on the
same keys.  K3, K4 and K5 also get an issue floor: SASS instructions per
hash from ``cuobjdump -sass`` of the built kernels (phase ``sass``).

Each phase prints one JSON line (a few print more); any failed phase
raises and the process exits non-zero.  ``--kernels-only`` skips every
path, ``model_serve``, ``model_train``, ``multirank`` and ``dryrun`` included.  The last line of standard output is
``{"ok": true, "device": {...}}``.  Needs a CUDA device: exits 1 without one.
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import ctypes
import dataclasses
import gc
import json
import multiprocessing
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
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
from repro_torch.core.sets import setdiff_keys, setxor_keys, unique_keys  # noqa: E402
from repro_torch.kernels import platform  # noqa: E402
from repro_torch.kernels.bin_xorsum import (  # noqa: E402
    bin_parity_xorsum,
    bin_parity_xorsum_plain,
    bin_parity_xorsum_units,
    bin_parity_xorsum_units_packed,
    bin_parity_xorsum_units_packed_plain,
    bin_parity_xorsum_units_plain,
    set_plan,
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
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models import ffn  # noqa: E402
from repro_torch.models.backbone import forward, model_spec, vocab_logits  # noqa: E402
from repro_torch.models.config import n_params_dense  # noqa: E402
from repro_torch.models.spec import (  # noqa: E402
    count_params,
    init_params,
    params_from_numpy,
    tree_map,
    tree_map_p,
)
from repro_torch.serve.engine import make_serve_fns  # noqa: E402
import repro_torch.serve.engine as serve_engine  # noqa: E402
from repro_torch.serve.scheduler import BatchScheduler, Completion, Request  # noqa: E402
from repro_torch.train.step import mesh_ctx  # noqa: E402
from repro_torch.checkpoint import restore_checkpoint  # noqa: E402
from repro_torch.data import DataConfig, global_batch  # noqa: E402
from repro_torch.models.backbone import ce_loss  # noqa: E402
from repro_torch.optim import OptConfig, apply_updates, build_plan, init_opt_state  # noqa: E402
from repro_torch.optim import sync_gradient  # noqa: E402
from repro_torch.optim.adamw import QBLK  # noqa: E402
from repro_torch.optim.compression import CompressionConfig, init_error_state  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.models.spec import gather_params, shard_params  # noqa: E402
import repro_torch.models.spec as pspec  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.cells import ENC_LEN, SHAPES, all_cells, at_position, build_cell  # noqa: E402
from repro_torch.roofline import (  # noqa: E402
    HBM_BYTES,
    HBM_BYTES_PER_S,
    PEAK_BF16_FLOPS,
    PEAK_RTOL,
    analyze_step,
)
from repro_torch.serve.engine import cache_spec  # noqa: E402

DEV = torch.device("cuda", 0)

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): device memory
# at HBM_BYTES_PER_S and the dense bf16 tensor-core rate PEAK_BF16_FLOPS
# (phase model_serve and the roofline), both from repro_torch.roofline;
# int8 tensor cores 1979 TOP/s (the rate a 0/1 matrix product is held to);
# 67 T op/s for 32-bit arithmetic outside the tensor cores (the float32
# figure — the integer pipes are narrower, so the bound is generous).
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
    # the fold stage first: each call launches it once (device_ms per_call)
    "bin_parity_xorsum": ("set_fold_kernel", "set_merge_kernel"),
    "bin_parity_xorsum_cluster": ("long_rows_kernel",),
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
    "obs": ("bin_xorsum_units", "gf2_matmul"),
    "examples": ("bin_xorsum_units", "gf2_matmul", "tow_sketch"),
}
HOME_PATH = {"bin_xorsum_units": "serve", "gf2_matmul": "serve", "tow_sketch": "serve",
             "tree_digest": "tree", "bin_parity_xorsum": "encode_group",
             "gf2_pack_bits": "encode_group"}


_OUT = []     # files that receive every JSON line besides standard output
_T_START = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line (and write it to every ``--out`` file); a phase's
    line also gets ``t_s``, the seconds since the script started, so a log
    splits the whole run's time by phase."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T_START}
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


# profiler windows a function that cannot be captured in a CUDA graph gets
# before its device time falls back to events over back-to-back calls
PROFILE_WINDOWS = 4


def profile_window(fn, name: str, reps: int):
    """One ``torch.profiler`` window of ``reps`` calls of ``fn``: the CUDA
    time and launches of ``name``'s symbols, every device activity's time,
    and each symbol's time and launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us, calls, every_us = 0.0, 0, 0.0
    sym_us, sym_calls = dict.fromkeys(SYMBOLS[name], 0.0), dict.fromkeys(SYMBOLS[name], 0)
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        us = us if us is not None else getattr(ev, "self_cuda_time_total", 0)
        every_us += us
        if any(k in ev.key for k in SYMBOLS[name]):
            total_us += us
            calls += ev.count
        for k in SYMBOLS[name]:
            if k in ev.key:
                sym_us[k] += us
                sym_calls[k] += ev.count
    return total_us, calls, every_us, sym_us, sym_calls


def device_ms(fn, name: str, reps: int = 20, every_activity: bool = False,
              per_call: bool = False, capturable: bool = True) -> dict:
    """Device time per call of ``fn``, which launches kernel ``name`` once:
    the mean CUDA duration of its symbols (``SYMBOLS[name]``) over the
    launches ``torch.profiler`` recorded in ``reps`` calls (it may keep
    fewer than ``reps``; how many is returned).  Where it records none, a
    CUDA graph of 50 calls is replayed between two events instead.  Returns
    the time and the method that gave it.  ``every_activity``: instead,
    every device activity of a call (kernels, copies, memsets) summed over
    the window and divided by the launches of ``name``'s symbols it kept
    (the calls it recorded); no fallback (``device_ms`` None where it kept
    none).  ``per_call``: for a wrapper that may launch several kernels a
    call — every device activity of the window over the calls it recorded,
    counted as the launches of ``name``'s first symbol (one a call), each
    symbol's share beside it (``device_ms_by_symbol``); the graph replay
    where it recorded none.  ``capturable=False``: ``fn`` uploads host data
    each call (a pageable copy, which a graph capture refuses), so the
    profiler gets ``PROFILE_WINDOWS`` windows, and where none records the
    kernel the time is events over 50 back-to-back calls, host work between
    the launches included (said in ``device_ms_by``)."""
    fn()
    torch.cuda.synchronize()
    first = SYMBOLS[name][0]
    for _ in range(1 if capturable else PROFILE_WINDOWS):
        total_us, calls, every_us, sym_us, sym_calls = profile_window(fn, name, reps)
        if per_call and sym_calls[first] > 0 and every_us > 0:
            n = sym_calls[first]
            return {"device_ms": every_us / n / 1e3,
                    "device_ms_by": f"profiler, every device activity per call ({first} launches)",
                    "profiled_launches": n,
                    "device_ms_by_symbol": {k: sym_us[k] / n / 1e3 for k in SYMBOLS[name]},
                    "launches_by_symbol": sym_calls}
        if every_activity and calls and every_us > 0:
            return {"device_ms": every_us / calls / 1e3,
                    "device_ms_by": "profiler, every device activity", "profiled_launches": calls}
        if not per_call and not every_activity and calls > 0 and total_us > 0:
            return {"device_ms": total_us / calls / 1e3, "device_ms_by": "profiler",
                    "profiled_launches": calls}
    if every_activity:
        return {"device_ms": None, "device_ms_by": "profiler, every device activity",
                "profiled_launches": calls}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if not capturable:
        start.record()
        for _ in range(50):
            fn()
        end.record()
        torch.cuda.synchronize()
        return {"device_ms": start.elapsed_time(end) / 50,
                "device_ms_by": "cuda_events over 50 back-to-back calls, host work included"}
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
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    by = "cuda_graph_replay, every device activity per call" if per_call else "cuda_graph_replay"
    return {"device_ms": start.elapsed_time(end) / 50, "device_ms_by": by}


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


def check_k5(elems, n_bins, seed, poison=False):
    """K5 against its plain version; ``poison``: first fill freed blocks of
    the outputs' and the partials' sizes with a pattern, so the caching
    allocator hands the kernel memory where a word it fails to write shows."""
    if poison:
        plan = set_plan(elems.shape[0], n_bins, DEV)
        part = plan["partials"] * (n_bins + packed_words(n_bins)) if plan["partials"] > 1 else 0
        junk = [torch.full((size,), -0x5A5A5A5B, dtype=torch.int32, device=DEV)
                for size in (n_bins, n_bins, part)]
        del junk
    p, x = bin_parity_xorsum(elems, n_bins=n_bins, seed=seed)
    pp, xp = bin_parity_xorsum_plain(elems, n_bins=n_bins, seed=seed)
    return max_err((p, pp), (x, xp))


def k5_cluster_route(elems, n_bins, seed):
    """K5 on its PR 13 route (``long_rows_kernel<true>``: one cluster of at
    most 16 blocks), for the before/after times only: no wrapper calls it,
    and it counts no launch."""
    fn = platform.load_kernel_lib("bin_xorsum").bin_parity_xorsum_cluster_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    parity = torch.empty(n_bins, dtype=torch.int32, device=DEV)
    xors = torch.empty(n_bins, dtype=torch.int32, device=DEV)
    rc = fn(elems.data_ptr(), seed & 0xFFFFFFFF, parity.data_ptr(), xors.data_ptr(),
            elems.shape[0], n_bins, platform.current_stream_ptr())
    platform.check_launch("bin_parity_xorsum_cluster", rc)
    return parity, xors


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
    # over the set-wide geometry (one block to E = 8192, a cluster pair,
    # the whole card, 4 slices a thread at 4 * 10^6), n up to the limit;
    # key 0 first or last in turn, the outputs over a poisoned pool; one hot
    # bin (every key equal, an odd count); scalar loads (one element into a
    # larger tensor)
    i = 0
    for n_bins in (3, 63, 255, 8191, 16383, 28000):
        for E in (0, 1, 100, 8191, 8192, 8193, 65537, (1 << 20) + 3, 1_000_000, 4_000_000):
            elems = dev_u32(extra.integers(0, 1 << 32, size=E, dtype=np.uint64))
            if E:
                elems[0 if i % 2 == 0 else E - 1] = 0
            err = max(err, check_k5(elems, n_bins, int(extra.integers(1 << 32)), poison=True))
            shapes.append([E, n_bins, "key 0 " + ("first" if i % 2 == 0 else "last")])
            i += 1
    hot = torch.full((1_000_001,), int(extra.integers(1, 1 << 31)), dtype=torch.int32, device=DEV)
    err = max(err, check_k5(hot, 8191, 5, poison=True))
    shapes.append([1_000_001, 8191, "every key equal"])
    longer = dev_u32(extra.integers(0, 1 << 32, size=1_000_001, dtype=np.uint64))
    longer[500_000] = 0
    for n_bins in (255, 8191):
        err = max(err, check_k5(longer[1:], n_bins, 9, poison=True))
        shapes.append([1_000_000, n_bins, "unaligned view"])
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


# the kernels whose inner loops phase ``sass`` counts: key -> a piece of the
# mangled name (the template arguments pick the instantiation)
SASS_KERNELS = {
    **{(kern, ns): f"{kern}ILi{ns}E"
       for kern in ("tow_rows_warp_kernel", "tow_rows_block_kernel", "tow_ranges_kernel")
       for ns in (1, 2, 4)},
    ("set_fold_kernel", "wide"): "set_fold_kernelILb0E",
    ("set_fold_kernel", "packed"): "set_fold_kernelILb1E",
    ("long_rows_kernel", "modulo"): "long_rows_kernelILb1E",
}


def sass_inner_loops(lib: Path) -> dict:
    """Instructions per hash in the inner loop of each kernel of
    ``SASS_KERNELS`` that ``lib`` holds (``tow_sketch.cu``'s, and K5's fold
    in ``bin_xorsum.cu``, new and old), from ``cuobjdump -sass`` of the
    built library.  Candidates are
    the innermost loops (a backward branch and its target) and the basic
    blocks (cut at branch targets and after branches) of each function; the
    one with the most mix32 multiplies (a loop where they tie) is the walk
    over a full group's keys — an unrolled loop, or straight-line code where
    the walk is unrolled whole — and its instructions over those multiplies
    are the SASS per (key, seed), the shuffles, atomics and any loop
    control included.  ``{key of SASS_KERNELS: {...}}``; empty where the
    toolchain has no ``cuobjdump``."""
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
        for key, piece in SASS_KERNELS.items():
            if best[1] and piece in (fn or ""):
                out[key] = {"region_instructions": best[0], "region_hashes": best[1],
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
        dev = device_ms(call, "tree_digest", capturable=False)
        padded_ms = device_ms(padded, "tree_digest_padded")["device_ms"]
        del mat, valid
        rows.append({
            "shape": [R, Ep, ell], "valid": n_valid, "tile": tile, "tail_tiles": n_tail,
            "launches": count,
            "max_abs_err": err, "ms": float(np.mean(ts)), "ms_min": min(ts), **dev,
            "ragged_all_device_ms": device_ms(call, "tree_digest", every_activity=True,
                                              capturable=False)["device_ms"],
            "old_route_ms": time_ms(old, 10),
            "old_route_device_ms": device_ms(old, "tree_digest_padded", every_activity=True,
                                             capturable=False)["device_ms"],
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


def k5_floor(sass_entry, keys: int, device_time) -> dict:
    """``issue_floor`` of K5's fold over ``keys`` keys, one hash a key."""
    floor = issue_floor(sass_entry, keys, device_time)
    floor["sass_per_key"] = floor.pop("sass_per_hash")
    return floor


def k5_report(rng, launched, sass):
    """K5 at every ``(E, n)`` the encode_group path launched it at: the
    launch geometry (``set_plan``), events over the wrapper, the device
    time per call summed over every stage (``device_ms_by_symbol`` splits
    fold and merge), the issue floor of the fold; beside them the PR 13
    route on the same keys (``old_route_*``: one cluster, ``long_rows_kernel``).
    Bound: every key read, the folds and one bit a bin written."""
    g = torch.Generator(device=DEV)
    g.manual_seed(int(rng.integers(1 << 62)))
    rows, cases = [], {}
    for (E, n), count in sorted(launched.items()):
        elems, seed = rand_i32(g, (E,)), int(rng.integers(1 << 32))
        cases[(E, n)] = (elems, seed)

        def call():
            return bin_parity_xorsum(elems, n_bins=n, seed=seed)

        def old():
            return k5_cluster_route(elems, n, seed)

        geometry = set_plan(E, n, DEV)
        ts = times_ms(call, 50)
        dev = device_ms(call, "bin_parity_xorsum", per_call=True)
        old_dev = device_ms(old, "bin_parity_xorsum_cluster")["device_ms"]
        rows.append({
            "shape": [E, n], "launches": count,
            "max_abs_err": max(check_k5(elems, n, seed), max_err(*zip(old(), call()))),
            "geometry": geometry,
            "ms": float(np.mean(ts)), "ms_min": min(ts), "ms_median": float(np.median(ts)),
            **dev,
            **bound((E * 4 + n * 4 + n / 8) / HBM_BYTES_PER_S,
                    E * K1_OPS_PER_KEY / ALU32_OPS_PER_S),
            **k5_floor(sass.get(("set_fold_kernel", geometry["table"])), E, dev["device_ms"]),
            "old_route_ms": time_ms(old, 20), "old_route_device_ms": old_dev,
            **{f"old_route_{k}": v for k, v in k5_floor(
                sass.get(("long_rows_kernel", "modulo")), E, old_dev).items()
               if k in ("sass_per_key", "issue_floor_ms")}})
    head = max(rows, key=lambda r: r["shape"][0])
    elems, seed = cases[tuple(head["shape"])]
    n = head["shape"][1]
    return {
        "shapes": {"elems": [head["shape"][0]], "n_bins": n},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        **{k: head[k] for k in ("geometry", "ms", "device_ms", "device_ms_by",
                                "device_ms_by_symbol", "bound_ms", "bound_by",
                                "issue_floor_ms", "sass_per_key", "old_route_ms",
                                "old_route_device_ms", "old_route_sass_per_key",
                                "old_route_issue_floor_ms") if k in head},
        "plain_ms": time_ms(lambda: bin_parity_xorsum_plain(elems, n_bins=n, seed=seed), 5),
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
        "tow_sketch": lambda path, shapes: k3_report(
            rng, shapes, EXAMPLES_LARGEST_SET if path == "examples" else args.size, sass),
        "tree_digest": lambda path, shapes: k4_report(k4_inputs[path], shapes, sass),
        "bin_parity_xorsum": lambda path, shapes: k5_report(rng, shapes, sass),
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
        assert got.diff == set(setxor_keys(a, b).tolist()), (sid, label)
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
    univ = unique_keys(rng.choice(1 << 32, size=union, replace=False).astype(np.uint32))
    a = univ[: union - d + half]
    b = np.concatenate([univ[: union - d], univ[union - d + half :]])
    rng = np.random.default_rng(args.seed + 78)
    shared = rng.choice(1 << 32, size=union, replace=False).astype(np.uint64)
    lo = int(rng.integers(0, (1 << 32) - (1 << 16)))
    hot = lo + rng.choice(1 << 16, size=2000, replace=False)
    a2 = unique_keys(np.concatenate([shared, hot[:1000]]).astype(np.uint32))
    b2 = unique_keys(np.concatenate([shared, hot[1000:]]).astype(np.uint32))
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
    truth = set(setxor_keys(a, b).tolist())
    assert tr.diff == truth, label
    depth_bound = 32 - int(np.floor(np.log2(tcfg.leaf_d)))
    assert st.depth <= depth_bound, (label, st.depth, depth_bound)

    # every leaf against a standalone oracle session over its range at the
    # tree's planned d; plain PBS at the honest and a 10x-wrong d beside it
    t0 = time.perf_counter()
    au, bu = unique_keys(a), unique_keys(b)
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
    ``unique_keys`` of each side, the two checksum prefix sums, the key
    upload."""
    times = {"unique_s": [], "prefix_s": [], "upload_s": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        ua = unique_keys(np.asarray(a, dtype=np.uint32))
        ub = unique_keys(np.asarray(b, dtype=np.uint32))
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
    keys = unique_keys(rng.integers(1, 1 << 32, size=1_000_100, dtype=np.uint64).astype(np.uint32))
    big = np.concatenate([[0], keys[:999_999]]).astype(np.uint32)    # key 0 is a member
    group = rng.integers(1, 1 << 32, size=4096, dtype=np.uint64).astype(np.uint32)
    base = unique_keys(rng.integers(1, 1 << 32, size=4000, dtype=np.uint64).astype(np.uint32))
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
    assert diff == set(setxor_keys(a, b).tolist())
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
    tow_sketches(unique_keys(a), derive_seed(cfg.seed, 0x70), cfg.ell)
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
    assert tree_diff == set(setxor_keys(a3, b3).tolist())
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
    fresh = setdiff_keys(
        unique_keys(rng.integers(1, 1 << 32, size=3 * n, dtype=np.uint64).astype(np.uint32)),
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
                    truth = set(setxor_keys(a_e, b_e).tolist())
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


# ---------------------------------------------------------------------------
# the observability layer, traced on the card
# ---------------------------------------------------------------------------

# the events a traced chaos hub must show (the acceptance trace)
OBS_EVENTS = ("peer.round.reply", "arq.retransmit", "peer.suspend", "peer.resume",
              "resume", "chaos.crash")
OBS_WINDOWS = ("repro.encode_side", "repro.encode_side_ext")


def union_us(intervals) -> float:
    """Covered length of possibly overlapping (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def span_split(events) -> dict:
    """Per thread of a trace: its span window (first start to last end) and
    how the spans cover it — ``device`` (``cat="device"``), ``wire``
    (``cat="wire"``), the rest host — each category's spans unioned, as
    ``tools/trace_report.py`` splits occupancy; times in ms and shares of
    the window."""
    names = {e["tid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    by_tid = {}
    for e in events:
        if e.get("ph") == "X":
            by_tid.setdefault(e["tid"], {}).setdefault(e.get("cat", "host"), []).append(
                (e["ts"], e["ts"] + e["dur"]))
    out = {}
    for tid, cats in by_tid.items():
        spans = [iv for ivs in cats.values() for iv in ivs]
        wall = max(e for _, e in spans) - min(s for s, _ in spans)
        device, wire = union_us(cats.get("device", [])), union_us(cats.get("wire", []))
        host = union_us(spans) - device - wire
        out[names.get(tid, str(tid))] = {
            "window_ms": wall / 1e3, "device_ms": device / 1e3, "wire_ms": wire / 1e3,
            "host_ms": host / 1e3, "spans": len(spans),
            **{f"{k}_share": v / wall if wall else 0.0
               for k, v in (("device", device), ("wire", wire), ("host", host))}}
    return out


def profiled_kernels(prof) -> dict:
    """The device side of a ``torch.profiler`` capture: K1 and K2 launches
    (their ``SYMBOLS``) with their summed duration, every device activity's
    summed duration and the union of their intervals (the card's busy time).
    The device timeline's user annotations (each ``record_function``
    window's span over the kernels it launched) are counted apart, not as
    activity."""
    from torch.autograd import DeviceType

    out = {"bin_xorsum_units": 0, "gf2_matmul": 0, "k1_k2_device_ms": 0.0,
           "device_activities": 0, "every_activity_device_ms": 0.0,
           "device_annotations": 0}
    busy = []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        if getattr(ev, "is_user_annotation", False) or ev.name.startswith(("repro.", "obs.")):
            out["device_annotations"] += 1
            continue
        us = ev.time_range.end - ev.time_range.start
        out["device_activities"] += 1
        out["every_activity_device_ms"] += us / 1e3
        busy.append((ev.time_range.start, ev.time_range.end))
        for name in ("bin_xorsum_units", "gf2_matmul"):
            if any(k in ev.name for k in SYMBOLS[name]):
                out[name] += 1
                out["k1_k2_device_ms"] += us / 1e3
    out["device_busy_ms"] = union_us(busy) / 1e3
    return out


def obs_phase(sessions, serve_results):
    """The acceptance trace at deployment size: one ``HubEndpoint`` with a
    resume window on the card serves two port Alices, serve's known d = 100
    and d = 1000 sessions of |A| = 10^6.  Peer 0 (the session of more
    rounds) runs over ``ChaosTransport(FaultPlan(crash_after_sends=1))``,
    then reconnects and resumes; peer 1 sits behind a seeded lossy
    ``ChaosTransport`` and ``ReliableTransport`` on both sides.  One shared
    ``Tracer(torch_profiler=True)`` covers hub, Alices, transports and
    injectors and is the engine's dispatch tracer; the whole ``serve`` runs
    inside ``torch.profiler`` (CPU and CUDA, every thread).  Both results
    equal serve's, peer 0 resumes, the trace holds every acceptance event
    and both exports load equal; the profiler's K1 and K2 launches equal
    the launch ledgers and what hub and Alices counted.  Returns the
    launches by kernel and the launched shapes."""
    t_phase = time.perf_counter()
    from torch._C._profiler import _ExperimentalConfig
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.net import ReliableTransport
    from repro_torch.obs import load_events
    from repro_torch.recon import engine

    picks = [sid for sid in wire_picks(sessions)
             if sessions[sid][0] in ("known d=100", "known d=1000")]
    # peer 0 crashes: the session of more rounds, so the crash falls mid-protocol
    picks.sort(key=lambda s: -serve_results[s].rounds)
    labels = ("crasher", "lossy")
    tracer = Tracer(torch_profiler=True)
    hub = HubEndpoint(resume_window=30.0, tracer=tracer)      # device=None: the card
    alices, sid_of, links, pending, calls, crash = {}, {}, [], {}, {}, {}
    try:
        for i, sid in enumerate(picks):
            label, a, b, cfg, dk = sessions[sid]
            raw, th = InMemoryDuplex.pair()
            links += [raw, th]
            if i == 0:
                ta = ChaosTransport(raw, FaultPlan(crash_after_sends=1), tracer=tracer)
            else:
                chaos = ChaosTransport(raw, FaultPlan(seed=73, loss=0.15, dup=0.05),
                                       tracer=tracer)
                ta = ReliableTransport(chaos, timeout=0.02, max_retries=400, seed=1,
                                       tracer=tracer)
                th = ReliableTransport(th, timeout=0.02, max_retries=400, seed=101,
                                       tracer=tracer)
                links += [ta, th]
            ch = hub.add_peer(th, label=labels[i])
            hub.submit(ch, b, cfg=cfg, d_known=dk)
            alices[ch] = AliceEndpoint(ta, channel=ch, tracer=tracer)
            alices[ch].submit(a, cfg=cfg, d_known=dk)
            sid_of[ch] = sid
            calls[ch] = alices[ch].run
        ch0, ch1 = list(sid_of)
        label_of = dict(zip(sid_of, labels))

        def crasher():
            try:
                return alices[ch0].run()
            except TransportError as e:
                crash["error"] = repr(e)
            na, nh = InMemoryDuplex.pair()
            links.extend([na, nh])
            pending["t"] = nh
            alices[ch0].resume(na)
            return alices[ch0].resume_run()

        def on_barrier(rnd):
            if "t" in pending and hub._peers[ch0].suspended:
                hub.resume_peer(ch0, pending.pop("t"))

        calls[ch0] = crasher
        hub.on_barrier = on_barrier
        engine.set_dispatch_tracer(tracer)
        platform.reset_launch_counts()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
            with record_function("obs.hub_serve"):      # marks the hub's thread
                t0 = time.perf_counter()
                outcomes, results, errors = drive_hub(hub, calls, join_timeout=120.0)
                torch.cuda.synchronize()
                serve_s = time.perf_counter() - t0
        launches, shapes = platform.launch_counts(), platform.launch_shapes()
    finally:
        engine.set_dispatch_tracer(None)
        for t in links:
            t.close()
    assert not errors, errors
    assert "error" in crash, "the scripted crash never fired"

    # the results, the resume and the ledgers
    st = hub.stats
    for ch, sid in sid_of.items():
        got, want = results[ch][0], serve_results[sid]
        for f in WIRE_FIELDS:
            assert getattr(got, f) == getattr(want, f), (sessions[sid][0], f)
    assert outcomes[ch0].error_kind == "resumed" and alices[ch0].resumes == 1, outcomes
    assert outcomes[ch1].ok and outcomes[ch1].verified == [True], outcomes[ch1]
    assert st["peers_resumed"] == 1 and st["resume_replay_bytes"] > 0, st
    check_hub_launches(hub, alices, launches, 0)
    retransmits = sum(ep.wire_stats.get("retransmits", 0) for ep in alices.values())
    assert retransmits >= 1, "the lossy peer needed no retransmit"

    # the acceptance trace, and both exports loading equal
    events = tracer.events()
    names = {e["name"] for e in events}
    missing = [n for n in OBS_EVENTS if n not in names]
    assert not missing, f"trace lacks {missing}"
    replies = {e["args"]["peer"] for e in events if e["name"] == "peer.round.reply"}
    assert replies == set(labels), replies
    assert sum(e["ph"] == "M" for e in events) >= 2, "fewer than two named threads"
    with tempfile.TemporaryDirectory() as tmp:
        chrome, jsonl = Path(tmp) / "obs.json", Path(tmp) / "obs.jsonl"
        n = tracer.export_chrome(chrome)
        assert n == tracer.export_jsonl(jsonl) == len(events)
        loaded = load_events(chrome)
        assert loaded == load_events(jsonl) and len(loaded) == n
        doc = json.loads(chrome.read_text())
    for e in doc["traceEvents"]:
        assert all(k in e for k in ("name", "ph", "pid", "tid")), e
        assert e["ph"] != "X" or ("ts" in e and "dur" in e), e
        assert e["ph"] != "i" or e["s"] == "t", e

    # the profiler: K1 and K2 device launches against the ledgers
    kern = profiled_kernels(prof)
    hub_enc = st["kernel_launches"] // 2
    alice_enc = {ch: ep.launches["kernel_launches"] // 2 for ch, ep in alices.items()}
    enc = hub_enc + sum(alice_enc.values())
    assert kern["bin_xorsum_units"] == kern["gf2_matmul"] == enc == launches[
        "bin_xorsum_units"], (kern, st, alice_enc, launches)

    # the dispatch windows per profiler thread (host-side events; the
    # profiler mirrors each window on the device timeline too, as a GPU user
    # annotation); the hub serves on the thread of ``obs.hub_serve``
    windows, hub_thread, device_windows = {}, None, 0
    for ev in prof.events():
        if ev.device_type != DeviceType.CPU:
            device_windows += ev.name in OBS_WINDOWS
        elif ev.name == "obs.hub_serve":
            hub_thread = ev.thread
        elif ev.name in OBS_WINDOWS:
            windows[ev.thread] = windows.get(ev.thread, 0) + 1
    hub_windows = windows.pop(hub_thread, 0)
    assert hub_windows == hub_enc, (hub_windows, hub_enc, windows)
    assert sorted(windows.values()) == sorted(n for n in alice_enc.values() if n), (
        windows, alice_enc)

    split = span_split(events)
    hub_name = next(e["args"]["name"] for e in events if e.get("ph") == "M"
                    and e["tid"] == threading.get_ident())
    emit({"phase": "obs", "sessions": {label_of[ch]: sessions[sid][0]
                                       for ch, sid in sid_of.items()},
          "set_size": len(sessions[picks[0]][1]), "crash": crash["error"],
          "serve_s_under_profiler": serve_s, "trace_events": len(events),
          "obs_phase_s": time.perf_counter() - t_phase,
          "error_kinds": {label_of[ch]: o.error_kind for ch, o in outcomes.items()},
          "peers_resumed": st["peers_resumed"], "resume_replay_bytes": st["resume_replay_bytes"],
          "retransmits": retransmits, "cohort_rounds": st["cohort_rounds"],
          "hub_kernel_launches": st["kernel_launches"],
          "alices_kernel_launches": {ch: ep.launches["kernel_launches"]
                                     for ch, ep in alices.items()},
          "launches": launches, "profiled": kern,
          "hub_device_span_ms": split[hub_name]["device_ms"],
          "hub_thread": hub_name, "span_split_by_thread": split,
          "encode_windows": {"hub": hub_windows, "other_threads": sorted(windows.values()),
                             "device_timeline_annotations": device_windows},
          "all_results_match_serve": True, "acceptance_events": list(OBS_EVENTS)})
    return launches, shapes


# ---------------------------------------------------------------------------
# the examples' torch twins
# ---------------------------------------------------------------------------

# the largest set a twin sketches in phase 0 (quickstart's |A|): K3 on the
# examples path is held to its bound at min(this, E) valid keys a launch
EXAMPLES_LARGEST_SET = 100_000
# each twin and the kernels it must launch on the card
TWINS = {
    "quickstart": ("tow_sketch", "bin_xorsum_units", "gf2_matmul"),
    "serve_batch": ("tow_sketch", "bin_xorsum_units", "gf2_matmul"),
    "serve_endpoints": ("bin_xorsum_units", "gf2_matmul"),
    "blockchain_relay": ("bin_xorsum_units", "gf2_matmul"),
}


def examples_phase():
    """Each ``examples/*_torch.py``'s ``main()`` on the card at its default
    size, the launch counts reset before each; the twins' own asserts (every
    result against ``core.pbs.reconcile``) are the check, and a twin that
    raises fails the run.  Their printed reports go to standard error.
    Returns the launches by kernel and the launched shapes of all four."""
    import importlib.util

    t_phase = time.perf_counter()
    launches, launched, rows = {}, {}, {}
    for name, kernels in TWINS.items():
        path = ROOT / "examples" / f"{name}_torch.py"
        spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        platform.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            mod.main()                           # device=None: the card
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, shapes = platform.launch_counts(), platform.launch_shapes()
        for k in kernels:
            assert counts.get(k, 0) > 0, f"{name} never launched {k}: {counts}"
        assert counts["bin_xorsum_units"] == counts["gf2_matmul"], (name, counts)
        merge_launches(launches, launched, counts, shapes)
        rows[name] = {"wall_s": wall, "launches": counts}
    for name in PATHS["examples"]:
        assert launches.get(name, 0) > 0, f"examples never launched {name}: {launches}"
    emit({"phase": "examples", "twins": rows, "launches": launches,
          "examples_phase_s": time.perf_counter() - t_phase})
    return launches, launched


# ---------------------------------------------------------------------------
# the model scaffold's serving path
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelRow:
    """One model of phase ``model_serve``: its smoke-width CPU = card check,
    its full-width traffic and the margin of its forward check."""

    arch: str
    # smoke width, float32: depth (None: the smoke config's own), prompt
    # lengths (max_new 6 each, batch 2) and the scheduler's max_len
    smoke_layers: int | None
    smoke_prompts: tuple
    smoke_max_len: int
    # full width, bfloat16: (prompt tokens, requests), max_new 32 each
    buckets: tuple
    max_len: int
    # a decoded token must equal the no-cache forward's argmax wherever the
    # forward's top-2 logit margin exceeds this (tools/model_serve_probe.py
    # --arch measures the decode-to-forward logit error it is read against)
    margin_tol: float
    # the bucket whose full batch times a decode step and is profiled
    decode_bucket: int
    # the full-width config's depth, cut to this many layers (None: its own)
    layers: int | None = None
    # hold the tokens of a float32 model of this many layers at full width
    # (weights drawn anew from the row's seed and upcast, the bfloat16 ones
    # freed first; at the row's own depth they are the row's weights)
    # against its float32 forward, not the bfloat16 run's
    check_float32_layers: int | None = None
    # an encoder-decoder's frames a request (the scheduler's enc_len; other
    # families read none)
    enc_len: int = 32


# Every row but whisper's runs cut below its full-width depth (``layers``)
# for the script's budget: qwen2 14 of 28, recurrentgemma 13 of 26 (four
# periods and an rglru), mamba2 12 of 48, deepseek-v2 2 of 60 (one dense
# and one MoE layer), pixtral 10 of 40 (the last three halved again when
# the frontend families joined phase multirank and a whole run on a slower
# host took 1 013 s).  The calibrations below were taken at the depths they
# name; fewer layers part decode from forward by less.
MODEL_ROWS = (
    # the two paths round bfloat16 activations in other places (blockwise
    # attention against one-query attention over a bfloat16 cache; other
    # matmul shapes), so near ties may go either way.  Logits are bfloat16
    # products; the top ones lie in [2, 4), where a bfloat16 ulp is 1/64:
    # 4 ulps.  Traffic: two full batches, one of 4 requests padded with
    # copies whose 1 536 tokens span two ragged query chunks.
    ModelRow("qwen2-1.5b", None, (8, 8, 12, 12, 12, 5), 64,
             ((128, 8), (512, 8), (1536, 4)), 2048, 0.0625, 512, layers=14),
    # 8 layers: two stacked periods and the unscanned rglru groups; a 70
    # token prompt rolls the 64-slot ring at the fill and wraps it at
    # decode, a 62 token one crosses its last slot while decoding.  At full
    # width 3 000 tokens are past the 2 048-slot window.  The softcap (30)
    # leaves the top logits near 5.6, where a bfloat16 ulp is 1/32; decode
    # and forward logits part by up to 0.133 and the top one by up to 0.061
    # (calibration on an H100): the margin is qwen2's.
    ModelRow("recurrentgemma-2b", 8, (70, 62, 12, 12, 12, 5), 96,
             ((128, 8), (512, 8), (3000, 4)), 4096, 0.0625, 512, layers=13),
    # 40 tokens: one chunk of 32 and a ragged one.  At full width 1 000 is
    # a ragged SSD tail (chunk 256), 2 048 eight whole chunks.  In bfloat16
    # its 48 layers at these random weights carry rounding far: decode and
    # forward logits part by up to 2.9 and agree on the argmax at 43 % of
    # positions (calibration on an H100, which also reads how far a
    # bfloat16 forward lies from the float32 one), so no margin is both
    # fair and checks half the tokens.  Its check runs in float32 (TF32
    # off) on the same weights, all 48 layers, where decode and forward
    # logits part by at most 0.0029: the margin is 2.7 times that.
    ModelRow("mamba2-780m", None, (40, 40, 12, 12, 12, 5), 96,
             ((128, 8), (1000, 8), (2048, 4)), 4096, 0.0078125, 1000, layers=12,
             check_float32_layers=12),
    # calibrated at 7 of 60 layers at full width (1 mla_dense + 6 mla_moe,
    # 50.45 GB in bfloat16, the most one card holds beside the 8 x 1 536
    # prefill), with qwen2's traffic.  The latent cache is bfloat16 whatever
    # the weights, so a decode step's router sees other roundings than the
    # forward's and flips a near tie of the 6th and 7th expert: in bfloat16 on
    # 5-35 % of steps a layer, rising with depth (calibration on an H100),
    # which moves logits by up to 2.25; half the positions keep every layer's
    # route, and among them decode and forward logits part by up to 0.195, so
    # no fair margin checks half the tokens.  The check runs on a float32
    # model of 3 layers at full width (1 dense + 2 MoE, the bfloat16 one freed
    # first): 4-9 % route flips a layer; where no layer's route flipped,
    # decode and forward logits part by at most 0.054, so tokens there can
    # part only below a margin of 0.108: the margin is 0.125.  Route flips:
    # see ROUTE_GAP_TOL below.
    ModelRow("deepseek-v2-236b", None, (8, 8, 12, 12, 12, 5), 64,
             ((128, 8), (512, 8), (1536, 4)), 2048, 0.125, 512, layers=2,
             check_float32_layers=3),
    # whisper-tiny, all of it (4 encoder and 4 decoder layers, d 384): a 30 s
    # window's 1 500 frames (standard normal at the encoder's input) and
    # whisper's 448-token decoder context; the start-of-transcript prompt,
    # 128 tokens of previous text, whisper's longest prompt.  Its tied
    # logits are small (the top one near 2, a bfloat16 ulp 1/64): in
    # bfloat16 decode and forward logits part by up to 0.0283, so a fair
    # margin is 0.0625, which checks 47-49 % of positions (calibration on
    # an H100).  Its check runs in float32 at its own 4 layers, on the same
    # weights: the self and cross caches stay bfloat16, so decode and
    # forward logits still part by up to 0.0140 and tokens only below
    # 0.028: the margin is 1/32, which checks 71-80 %.
    ModelRow("whisper-tiny", None, (8, 8, 12, 12, 12, 5), 64,
             ((4, 8), (132, 8), (224, 4)), 448, 0.03125, 132, enc_len=1500,
             check_float32_layers=4),
    # pixtral-12b: text-only turns, then one 512 x 512 image (1 024 patch
    # positions, -1 at the prompt's start, their embeddings drawn at the token
    # table's scale, 0.02) with a 32- or 1 024-token question; at smoke width
    # 8 patch positions lead the 12- and 20-token prompts.  In bfloat16 decode
    # and forward logits part by up to 0.164 over 40 layers (calibration on an
    # H100), so a fair margin (0.375) checks under half the positions.  Its
    # check runs in float32 at all 40 layers on the same weights (49 GB, the
    # bfloat16 ones freed first), where they part by at most 0.0446 and tokens
    # only below 0.089: the margin is 0.125, which checks 68-85 %.
    ModelRow("pixtral-12b", None, (12, 12, 20, 20, 20, 5), 64,
             ((128, 8), (1056, 8), (2048, 4)), 3072, 0.125, 1056, layers=10,
             check_float32_layers=10),
)
# MoE rows: a position is left out of the token check where a layer's
# decode routed it to another top-k expert set than the forward did and, in
# the first such layer, the forward's k-th and (k+1)-th router
# probabilities lie within ROUTE_GAP_TOL (a near tie).  A flip at a wider
# gap fails the row, as does a layer that flips at more than
# ROUTE_FLIP_CEILING of the positions.  deepseek-v2's float32 3-layer
# model (calibration on an H100): every flip came at a near tie, the first
# flipped layer's gap at most 2.89e-4 (56 flips over 640 positions; the
# median gap over all positions and layers is 1.1e-3), and a layer flipped
# at most 9.4 % of positions.  The tolerance is twice that gap.
ROUTE_GAP_TOL, ROUTE_FLIP_CEILING = 6e-4, 0.15
# smoke width, float32 weights on both devices: the card's last-position
# logits within this of the CPU's.  Float32 matmuls on the card differ from
# the CPU's in summation order only (7.45e-7 measured on an H100 for
# qwen2-1.5b); a TF32 matmul (10 mantissa bits) would miss by ~1e-3 on these
# logits and fail.
SMOKE_LOGIT_ATOL = 1e-5
SERVE_BATCH, SERVE_MAX_NEW = 8, 32
SMOKE_ENC_LEN = 40          # encoder frames at smoke width: one ragged key chunk


def draw_np(spec, rng):
    """float32 numpy weights for a port spec: norms near 1, biases small but
    non-zero, weights at their init scale."""
    def draw(p):
        if p.init == "ones":
            return (1 + 0.1 * rng.standard_normal(p.shape)).astype(np.float32)
        if p.init == "zeros":
            return (0.1 * rng.standard_normal(p.shape)).astype(np.float32)
        fan = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        scale = p.scale if p.scale is not None else 1 / np.sqrt(fan)
        return (scale * rng.standard_normal(p.shape)).astype(np.float32)

    return tree_map_p(draw, spec)


def prompt_tokens(rng, cfg, plen: int) -> list:
    """One prompt of ``plen`` tokens.  A ``patch_stub`` model's prompt
    longer than its image starts with the image: ``n_frontend_tokens``
    patch positions, -1, as the config places them; shorter ones are text."""
    toks = [int(x) for x in rng.integers(0, cfg.vocab, plen)]
    if cfg.frontend == "patch_stub" and plen > cfg.n_frontend_tokens:
        toks[:cfg.n_frontend_tokens] = [-1] * cfg.n_frontend_tokens
    return toks


def bucket_extras(cfg, plen: int, rows: int, enc_len: int, normal):
    """The inputs besides the tokens of one bucket's run, drawn by
    ``normal(shape)`` (standard normal): an encoder-decoder's frames
    (rows, enc_len, d) as they are, which the encoder casts to its dtype; a
    ``patch_stub`` model's patch embeddings (rows, plen, d) at the token
    table's scale, 0.02, where the bucket's prompts hold an image (its rows
    at text positions are never read); else None."""
    if cfg.family == "encdec":
        return {"enc": normal((rows, enc_len, cfg.d_model))}
    if cfg.frontend == "patch_stub" and plen > cfg.n_frontend_tokens:
        return {"frontend": 0.02 * normal((rows, plen, cfg.d_model))}
    return None


def forward_inputs(extras, n: int, T: int, batch: int, device) -> dict:
    """``forward``'s keywords for the first ``n`` requests of a run whose
    batches took ``extras`` (request i rode in row i % ``batch``), over
    ``T`` positions: a frontend is padded with zero rows past its prompt."""
    if not extras:
        return {}
    idx = torch.arange(n, device=device) % batch
    if "enc" in extras:
        return {"enc_embeds": torch.as_tensor(extras["enc"], device=device)[idx]}
    fe = torch.as_tensor(extras["frontend"], device=device)[idx]
    return {"frontend": torch.nn.functional.pad(fe, (0, 0, 0, T - fe.shape[1]))}


def upcast_(tree) -> None:
    """Every leaf of a parameter tree to float32, in place, leaf by leaf:
    each bfloat16 leaf is freed as its copy is made, so the peak is the
    float32 tree and one leaf (pixtral-12b: 49 GB, not 73.5)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            upcast_(v)
        else:
            tree[k] = v.float()


def row_config(row: ModelRow, layers: int | None = None):
    """The row's full-width config at its depth (or at ``layers``)."""
    cfg = get_config(row.arch)
    n = layers or row.layers
    return cfg.scaled(n_layers=n) if n else cfg


@contextlib.contextmanager
def recorded_routes():
    """Wrap the MoE router (``models.ffn._route``): each call's router
    probabilities (N, E) and top-k expert indices (N, k), on the card, in
    call order."""
    routes, route = [], ffn._route

    def recording(p, x, cfg):
        out = route(p, x, cfg)
        routes.append((out[0], out[2]))
        return out

    ffn._route = recording
    try:
        yield routes
    finally:
        ffn._route = route


@contextlib.contextmanager
def recorded_hidden():
    """Wrap the serving engine's ``greedy_token``: each call's final-norm
    states x (B, 1, d) of this rank's rows (a prefill's last position, a
    decode step's token), on the card, in call order."""
    states, greedy = [], serve_engine.greedy_token

    def recording(p, x, ctx, cfg):
        states.append(x.detach())
        return greedy(p, x, ctx, cfg)

    serve_engine.greedy_token = recording
    try:
        yield states
    finally:
        serve_engine.greedy_token = greedy


def moe_bytes(cfg, param_bytes: int) -> tuple:
    """(bytes of the weights that are not routed experts, bytes of one
    routed expert's three matrices); (param_bytes, 0) without experts."""
    if not cfg.n_experts:
        return param_bytes, 0
    expert = 3 * cfg.d_model * cfg.moe_d_ff * 2
    n_moe = cfg.n_layers - cfg.n_dense_layers
    return param_bytes - n_moe * cfg.n_experts * expert, expert


def active_non_embedding(cfg, non_embed: int) -> int:
    """Non-embedding parameters a token runs through: all of them, less the
    routed experts its top-k leaves out in every MoE layer."""
    if not cfg.n_experts:
        return non_embed
    n_moe = cfg.n_layers - cfg.n_dense_layers
    return non_embed - n_moe * (cfg.n_experts - cfg.moe_top_k) * 3 * cfg.d_model * cfg.moe_d_ff


def smoke_width_check(rng, row: ModelRow) -> dict:
    """The scheduler at smoke width with one float32 weight set carried to
    the CPU and to the card, one run a prompt length with that length's
    extras (numpy, the same on both): equal ``Completion``s and
    ``ServeStats`` counts, and last-position logits of every prompt within
    ``SMOKE_LOGIT_ATOL``."""
    cfg = get_smoke_config(row.arch)
    if row.smoke_layers:
        cfg = cfg.scaled(n_layers=row.smoke_layers)
    meshes = {"cpu": make_local_mesh(device="cpu"), "card": make_local_mesh()}
    arrays = draw_np(model_spec(cfg, mesh_ctx(meshes["card"])), rng)
    prompts = [prompt_tokens(rng, cfg, n) for n in row.smoke_prompts]
    lengths = sorted(set(row.smoke_prompts))
    extras = {n: bucket_extras(cfg, n, 2, SMOKE_ENC_LEN, lambda shape: rng.standard_normal(
        shape).astype(np.float32)) for n in lengths}
    outs, stats, last = {}, {}, {}
    for name, mesh in meshes.items():
        params = params_from_numpy(arrays, mesh.device)
        sched = BatchScheduler(cfg, mesh, batch=2, max_len=row.smoke_max_len, eos_id=-1,
                               enc_len=SMOKE_ENC_LEN)
        outs[name], stats[name], last[name] = {}, [], []
        for n in lengths:
            reqs = [Request(i, p, 6) for i, p in enumerate(prompts) if len(p) == n]
            out, st = sched.run(params, reqs, extras=extras[n])
            outs[name].update(out)
            stats[name].append(st)
            toks = torch.tensor([r.prompt for r in reqs], dtype=torch.int32, device=mesh.device)
            x = forward(params, toks, mesh_ctx(mesh), cfg,
                        **forward_inputs(extras[n], len(reqs), n, 2, mesh.device))
            last[name].append(vocab_logits(params["embed"], x[:, -1], mesh_ctx(mesh), cfg).cpu())
    for rid, c in outs["cpu"].items():
        g = outs["card"][rid]
        assert (g.tokens, g.finished) == (c.tokens, c.finished), (rid, g, c)
    for f in ("requests", "prefill_tokens", "decode_steps", "batches"):
        for sg, sc in zip(stats["card"], stats["cpu"]):
            assert getattr(sg, f) == getattr(sc, f), f
    err = max(float((g - c).abs().max()) for g, c in zip(last["card"], last["cpu"]))
    assert err <= SMOKE_LOGIT_ATOL, err
    return {"config": f"{row.arch} smoke (n_layers {cfg.n_layers}, d {cfg.d_model}, "
                      f"vocab {cfg.vocab}), float32",
            "prompt_tokens": list(row.smoke_prompts), "requests": len(prompts),
            "runs": len(lengths), "extras": sorted({k for e in extras.values() if e for k in e}),
            "completions_equal": True, "last_logits_max_abs_err": err,
            "tolerance": SMOKE_LOGIT_ATOL}


def device_profile(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: host wall (profiler on),
    the card's busy time (union of its activities) and share of that wall,
    and the device time by kernel name, largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA or getattr(ev, "is_user_annotation", False):
            continue
        busy.append((ev.time_range.start, ev.time_range.end))
        key = ev.name[:90]
        by_name[key] = by_name.get(key, 0.0) + (ev.time_range.end - ev.time_range.start) / 1e3
    busy_ms = union_us(busy) / 1e3
    return {"wall_ms_under_profiler": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms, "device_activities": len(busy),
            "top_device_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:6])}


def chunk_routes(calls, n_moe: int, steps: int) -> torch.Tensor:
    """The sorted top-k expert set of each MoE layer for every token of one
    prefill and ``steps`` decode steps: (B, 1 + steps, n_moe, k).  ``calls``
    are ``recorded_routes``' in order: the prefill's, (B · T, k) a layer,
    whose last position routes token 0, then each decode step's, (B, k) a
    layer."""
    B, k = calls[n_moe][1].shape
    first = torch.stack([c.reshape(B, -1, k)[:, -1] for _, c in calls[:n_moe]], 1)
    rest = [torch.stack([c for _, c in calls[n_moe * (1 + s):n_moe * (2 + s)]], 1)
            for s in range(steps)]
    return torch.stack([first] + rest, 1).sort(-1).values


def forward_routes(calls, n: int, start: int, count: int) -> tuple:
    """Positions ``start .. start + count`` of a forward over ``n`` rows,
    one ``recorded_routes`` call a MoE layer: their sorted top-k sets (n,
    count, n_moe, k) and the forward's k-th less (k+1)-th router
    probability there (n, count, n_moe)."""
    k = calls[0][1].shape[-1]
    sets = torch.stack([c.reshape(n, -1, k)[:, start:start + count] for _, c in calls],
                       2).sort(-1).values
    top = torch.stack([p.reshape(n, -1, p.shape[-1])[:, start:start + count].topk(k + 1).values
                       for p, _ in calls], 2)
    return sets, top[..., k - 1] - top[..., k]


def route_flips(fwd_sets, fwd_gaps, served_sets) -> tuple:
    """Where a decode routed a position to another top-k set than the
    forward: (differs (…, n_moe) by layer, the forward's k-th less (k+1)-th
    probability gap in the first layer that differs (…), +inf where none
    does)."""
    differs = (fwd_sets != served_sets).any(-1)
    first = differs.int().argmax(-1, keepdim=True)
    gap = fwd_gaps.gather(-1, first)[..., 0]
    return differs, torch.where(differs.any(-1), gap, torch.full_like(gap, float("inf")))


def served_routes(calls, requests, n_moe: int) -> dict:
    """{rid: (max_new, n_moe, k)}: each generated token's expert sets in
    a ``BatchScheduler.run`` whose router calls are ``calls`` (buckets by
    prompt length, chunks of ``SERVE_BATCH``, ``SERVE_MAX_NEW - 1`` decode
    steps a chunk)."""
    per_chunk = n_moe * SERVE_MAX_NEW
    out, i = {}, 0
    for plen in sorted({len(r.prompt) for r in requests}):
        reqs = [r for r in requests if len(r.prompt) == plen]
        for lo in range(0, len(reqs), SERVE_BATCH):
            routes = chunk_routes(calls[i:i + per_chunk], n_moe, SERVE_MAX_NEW - 1)
            i += per_chunk
            out.update({r.rid: routes[b] for b, r in enumerate(reqs[lo:lo + SERVE_BATCH])})
    assert i == len(calls), (i, len(calls))
    return out


def forward_check(params, cfg, ctx, out, requests, margin_tol: float, routes=None,
                  extras=None) -> dict:
    """Every generated token against the no-cache ``forward`` over prompt +
    generated tokens (one batched forward a bucket): equal to its argmax
    wherever its top-2 margin exceeds ``margin_tol`` (the checked
    positions).  Also each token's regret, the forward's best logit less
    the decoded token's, whose largest value bounds from below twice the
    logit error between the decode and forward paths.

    With ``routes`` (``served_routes`` of the run, an MoE model) a position
    is left out where a MoE layer's decode routed it to another top-k
    expert set than the forward did and, in the first such layer, the
    forward's k-th and (k+1)-th router probabilities lie within
    ``ROUTE_GAP_TOL``: a near tie flipped by rounding swaps an
    expert's output, which moves the logits by far more than rounding.
    Flips at a wider gap are counted (``route_flips_at_clear_gap``).
    ``extras`` ({prompt length: the bucket's run's extras}) feed the
    forward the same frames or patches as the run."""
    checked = skipped = near_ties = clear_flips = mismatched = unequal = positions = 0
    max_regret, max_flip_gap, by_bucket, flips_by_layer = 0.0, 0.0, {}, 0
    for plen in sorted({len(r.prompt) for r in requests}):
        reqs = [r for r in requests if len(r.prompt) == plen]
        seq = torch.tensor([r.prompt + out[r.rid].tokens[:-1] for r in reqs],
                           dtype=torch.int32, device=DEV)
        kw = forward_inputs((extras or {}).get(plen), len(reqs), seq.shape[1], SERVE_BATCH, DEV)
        with recorded_routes() as calls:
            x = forward(params, seq, ctx, cfg, **kw)[:, plen - 1:]   # (n, max_new, d)
        logits = vocab_logits(params["embed"], x, ctx, cfg)
        gen = torch.tensor([out[r.rid].tokens for r in reqs], device=DEV)
        top2 = logits.topk(2, dim=-1)
        margin = (top2.values[..., 0] - top2.values[..., 1]).cpu()
        regret = (top2.values[..., 0] - logits.gather(-1, gen[..., None].long())[..., 0]).cpu()
        ok, check = (top2.indices[..., 0] == gen).cpu(), margin > margin_tol
        tie, bucket = torch.zeros_like(check), {}
        if routes is not None:
            differs, gap = route_flips(*forward_routes(calls, len(reqs), plen - 1, gen.shape[1]),
                                       torch.stack([routes[r.rid] for r in reqs]))
            differs, gap = differs.cpu(), gap.cpu()
            flips_by_layer = flips_by_layer + differs.sum((0, 1))
            tie = gap <= ROUTE_GAP_TOL
            clear_flips += int((differs.any(-1) & ~tie).sum())
            if differs.any():
                max_flip_gap = max(max_flip_gap, float(gap[differs.any(-1)].max()))
            bucket["route_near_tie"] = int(tie.sum())
        del calls
        near_ties += int((check & tie).sum())
        check &= ~tie
        positions += int(check.numel())
        checked += int(check.sum())
        skipped += int((margin <= margin_tol).sum())
        mismatched += int((check & ~ok).sum())
        unequal += int((~ok).sum())
        max_regret = max(max_regret, float(regret.max()))
        by_bucket[plen] = {"positions": int(check.numel()), "equal": int(ok.sum()),
                           "checked": int(check.sum()), **bucket,
                           "median_margin": float(margin.median())}
        del x, logits, kw
    res = {"positions": positions, "positions_checked": checked,
           "positions_skipped_for_margin": skipped, "checked_mismatches": mismatched,
           "unequal_positions": unequal, "margin_tol": margin_tol, "max_regret": max_regret,
           "by_bucket": by_bucket}
    if routes is not None:
        res.update({"route_gap_tol": ROUTE_GAP_TOL,
                    "positions_skipped_for_route_near_tie": near_ties,
                    "route_flip_max_gap": max_flip_gap,
                    "route_flips_at_clear_gap": clear_flips,
                    "route_flip_share_by_moe_layer": [
                        int(v) / positions for v in flips_by_layer],
                    "route_flip_ceiling": ROUTE_FLIP_CEILING})
    return res


def cache_bytes(caches) -> tuple:
    """(every cache byte, the bytes of its float32 leaves: the recurrent
    states a decode step rewrites whole)."""
    leaves = []
    tree_map(leaves.append, caches)
    tensors = [t for t in leaves if isinstance(t, torch.Tensor)]
    total = sum(t.numel() * t.element_size() for t in tensors)
    states = sum(t.numel() * t.element_size() for t in tensors if t.dtype == torch.float32)
    return total, states


def ssd_prefill_flops(cfg, rows: int, T: int) -> float:
    """The SSD's operations beyond its projections over ``rows`` sequences of
    ``T`` tokens at chunk L, counting what the causal mask leaves: within
    each chunk of l positions the l(l+1)/2 pairs of C·Bᵀ (N terms) and of
    M·x (P terms) a head, 2 operations a term; a position's chunk-state and
    inter-chunk products, 4·N·P a head."""
    if cfg.family != "ssm":
        return 0.0
    H, P, N = cfg.d_model * cfg.ssm_expand // cfg.ssm_headdim, cfg.ssm_headdim, cfg.ssm_state
    L = min(cfg.ssm_chunk, T)
    pairs = (T // L) * L * (L + 1) // 2 + (T % L) * (T % L + 1) // 2
    return cfg.n_layers * rows * H * (2 * pairs * (N + P) + 4 * T * N * P)


def serve_requests(rng, cfg, row: ModelRow) -> list:
    """The row's traffic: one request of ``SERVE_MAX_NEW`` tokens a prompt."""
    requests, rid = [], 0
    for plen, n in row.buckets:
        for _ in range(n):
            requests.append(Request(rid, prompt_tokens(rng, cfg, plen), SERVE_MAX_NEW))
            rid += 1
    return requests


def serve_extras(cfg, row: ModelRow, seed: int) -> dict:
    """{prompt length: its bucket's extras} at full width, drawn on the card
    from ``seed`` + 1 (the weights' generator takes ``seed``)."""
    g = torch.Generator(device=DEV).manual_seed(seed + 1)
    return {plen: bucket_extras(cfg, plen, SERVE_BATCH, row.enc_len, lambda shape: torch.randn(
        shape, generator=g, device=DEV)) for plen, _ in row.buckets}


def serve_run(sched, params, requests, row: ModelRow, cfg, extras) -> tuple:
    """The row's traffic through ``sched``, one ``run`` a bucket with that
    bucket's extras (the reference's contract: one ``extras`` a run), each
    run checked: every request finished with ``SERVE_MAX_NEW`` in-vocab
    tokens, and the run's counts are its bucket's.  Returns (completions,
    the runs' summed counts)."""
    out, total = {}, {"wall_s": 0.0, "prefill_tokens": 0, "decode_steps": 0, "batches": 0}
    for plen, n in sorted(row.buckets):      # the order served_routes reads
        reqs = [r for r in requests if len(r.prompt) == plen]
        got, stats = sched.run(params, reqs, extras=extras[plen])
        assert sorted(got) == [r.rid for r in reqs] and len(reqs) == n
        for r in reqs:
            c = got[r.rid]
            assert len(c.tokens) == SERVE_MAX_NEW and c.finished, (r.rid, c)
            assert all(0 <= t < cfg.vocab for t in c.tokens), (r.rid, c.tokens)
        assert stats.decode_steps == n * (SERVE_MAX_NEW - 1), stats
        assert stats.prefill_tokens == plen * n, stats
        assert stats.batches == -(-n // SERVE_BATCH), stats
        out.update(got)
        for k in total:
            total[k] += getattr(stats, k)
    total["decode_tok_per_s"] = total["decode_steps"] / total["wall_s"]
    return out, total


def encoder_side(params) -> tuple:
    """(parameters, bytes) that run over an encoder's frames only: the
    encoder, and each ``dec`` block's cross-attention K/V projections (run
    over the memory at prefill; decode reads their cache instead); (0, 0)
    without an encoder."""
    if "enc" not in params:
        return 0, 0
    leaves = []
    tree_map(leaves.append, params["enc"])
    for g in params.values():
        if isinstance(g, dict) and "cross" in g:
            leaves += [t for k, t in g["cross"].items() if k in ("wk", "wv", "bk", "bv")]
    return sum(t.numel() for t in leaves), sum(t.numel() * t.element_size() for t in leaves)


def float32_layers_check(args, row: ModelRow, mesh, ctx, requests, extras, out16) -> dict:
    """The token check on a float32 model of ``row.check_float32_layers``
    layers at full width: weights drawn in bfloat16 from the row's seed and
    upcast, the row's traffic through ``BatchScheduler`` (routes recorded
    for an MoE model), every token against its float32 forward.  At the
    row's own depth these are the row's weights, and the share of the
    bfloat16 run's tokens ``out16`` equal to the float32 run's is read."""
    cfg = row_config(row, row.check_float32_layers)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(model_spec(cfg, ctx),
                         torch.Generator(device=DEV).manual_seed(args.seed), mesh.device)
    upcast_(params)
    sched = BatchScheduler(cfg, mesh, batch=SERVE_BATCH, max_len=row.max_len, eos_id=-1,
                           enc_len=row.enc_len)
    with recorded_routes() as calls:
        out, stats = serve_run(sched, params, requests, row, cfg, extras)
    routes = (served_routes(calls, requests, cfg.n_layers - cfg.n_dense_layers)
              if cfg.n_experts else None)
    del calls
    check = {"dtype": "float32", "n_layers": cfg.n_layers,
             "params": count_params(model_spec(cfg, ctx)),
             **forward_check(params, cfg, ctx, out, requests, row.margin_tol, routes, extras),
             "float32_run_wall_s": stats["wall_s"],
             "peak_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    if cfg.n_layers == row_config(row).n_layers:
        pairs = [(a, b) for r in requests for a, b in zip(out16[r.rid].tokens, out[r.rid].tokens)]
        check["bfloat16_tokens_equal_float32"] = sum(a == b for a, b in pairs) / len(pairs)
    del params
    torch.cuda.empty_cache()
    return check


def model_serve_row(args, smi, row: ModelRow) -> None:
    """One model at full width on the card (at the row's depth), weights
    from a seeded ``torch.Generator``: ``BatchScheduler.run`` (prefill /
    decode through ``serve.engine.make_serve_fns``) over the row's traffic,
    every generated token held against the no-cache ``forward`` (or, for a
    row with ``check_float32_layers``, a float32 model's run after the
    timing), then prefill and decode timed with CUDA events beside their
    bounds.  First the cross-device check at smoke width."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    smoke = smoke_width_check(rng, row)

    cfg = row_config(row)
    mesh = make_local_mesh()                      # device=None: the card
    ctx = mesh_ctx(mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    spec = model_spec(cfg, ctx)
    t0 = time.perf_counter()
    params = init_params(spec, torch.Generator(device=DEV).manual_seed(args.seed), mesh.device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = []
    tree_map(leaves.append, params)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    del leaves                                    # no reference may outlive params
    n_params = count_params(spec)
    # an untied unembedding runs at a prefill's last position only (a logit
    # row a sequence), and a decode step reads SERVE_BATCH rows of the
    # untied input table (a tied one is read whole as the unembedding)
    non_embed = n_params - sum(t.numel() for t in params["embed"].values())
    logit_flops = unread_embed_bytes = 0
    if not cfg.tie_embeddings:
        v, d = params["embed"]["tok"].shape
        logit_flops = 2 * d * cfg.vocab * SERVE_BATCH
        unread_embed_bytes = (v - SERVE_BATCH) * d * params["embed"]["tok"].element_size()
    active = active_non_embedding(cfg, non_embed)
    # an encoder runs over its frames, not the prompt's tokens, and its
    # weights are not read by decode, which reads the cross cache instead
    enc_params, enc_bytes = encoder_side(params)

    requests = serve_requests(rng, cfg, row)
    extras = serve_extras(cfg, row, args.seed)
    platform.reset_launch_counts()
    sched = BatchScheduler(cfg, mesh, batch=SERVE_BATCH, max_len=row.max_len, eos_id=-1,
                           enc_len=row.enc_len)
    t0 = time.perf_counter()
    out, stats = serve_run(sched, params, requests, row, cfg, extras)
    run_s = time.perf_counter() - t0
    pbs_launches = platform.launch_counts()
    assert not pbs_launches, pbs_launches      # the model path launches no PBS kernel
    t0 = time.perf_counter()
    check = None
    if not row.check_float32_layers:
        check = {"dtype": "bfloat16", **forward_check(params, cfg, ctx, out, requests,
                                                      row.margin_tol, extras=extras)}
    check_s = time.perf_counter() - t0

    # timing: prefill per bucket, decode per step, on the scheduler's engine
    t0 = time.perf_counter()
    sv = make_serve_fns(cfg, mesh, batch=SERVE_BATCH, max_len=row.max_len, enc_len=row.enc_len)
    prefill, inputs = {}, {}
    for plen, n in row.buckets:
        rows = [r.prompt for r in requests if len(r.prompt) == plen]
        rows += [rows[0]] * (SERVE_BATCH - len(rows))
        inputs[plen] = {"tokens": torch.tensor(rows, dtype=torch.int32, device=DEV),
                        **(extras[plen] or {})}
        ms = float(np.median(times_ms(lambda: sv.prefill(params, inputs[plen]), 3)))
        frames = row.enc_len if enc_params else 0
        flops = (2 * (active - enc_params) * SERVE_BATCH * plen + logit_flops
                 + 2 * enc_params * SERVE_BATCH * frames
                 + ssd_prefill_flops(cfg, SERVE_BATCH, plen))
        bound = flops / PEAK_BF16_FLOPS * 1e3
        prefill[plen] = {"batch_rows": SERVE_BATCH, "real_rows": n, "ms": ms,
                         "tok_per_s": SERVE_BATCH * plen / (ms / 1e3),
                         "real_tok_per_s": n * plen / (ms / 1e3),
                         "bound_flops": flops, "bound_ms": bound, "bound_by": "operations",
                         "bound_share": bound / ms}
    caches, tok = sv.prefill(params, inputs[row.decode_bucket])
    state = {"caches": caches, "tok": tok}

    def step():
        state["tok"], state["caches"] = sv.decode(params, state["caches"], state["tok"][:, None])

    with recorded_routes() as step_routes:           # + 1 warm-up + 4 profiled steps
        step_ms = times_ms(step, SERVE_MAX_NEW - 5)
    decode_ms = float(np.median(step_ms))
    decode_profile = device_profile(lambda: [step() for _ in range(4)])
    prefill_profile = device_profile(lambda: sv.prefill(params, inputs[row.decode_bucket]))
    c_bytes, state_bytes = cache_bytes(state["caches"])
    # read every weight and cache byte once, rewrite the float32 states (a
    # ring's one new row a step is left out: under 0.1 % of these bytes);
    # of the routed experts only those the step's router chose
    fixed_bytes, expert_bytes = moe_bytes(cfg, param_bytes)
    fixed_bytes -= unread_embed_bytes + enc_bytes
    experts = [int(torch.unique(topi).numel()) for _, topi in step_routes]
    steps = len(step_ms) + 1
    experts_per_step = sum(experts) / steps
    decode_bound = (fixed_bytes + experts_per_step * expert_bytes + c_bytes
                    + state_bytes) / HBM_BYTES_PER_S * 1e3
    timing_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    del caches, state, step_routes, inputs
    if row.check_float32_layers:
        del params, sv, sched
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        check = float32_layers_check(args, row, mesh, ctx, requests, extras, out)
        check_s = time.perf_counter() - t0
    emit({"phase": "model_serve", "arch": row.arch, "step": "forward_check", "gpu": smi,
          **check})
    assert check["checked_mismatches"] == 0, check
    assert check["positions_checked"] * 2 >= check["positions"], check
    if "route_flips_at_clear_gap" in check:
        assert check["route_flips_at_clear_gap"] == 0, check
        assert max(check["route_flip_share_by_moe_layer"]) <= ROUTE_FLIP_CEILING, check
    full_layers = get_config(row.arch).n_layers
    decode = {"batch_rows": SERVE_BATCH, "after_prompt_tokens": row.decode_bucket,
              "ms_per_step_median": decode_ms, "ms_per_step_mean": float(np.mean(step_ms)),
              "ms_per_step_min": float(np.min(step_ms)),
              "tok_per_s": SERVE_BATCH / (decode_ms / 1e3),
              "cache_bytes": c_bytes, "state_bytes_rewritten": state_bytes,
              "bound_ms": decode_bound, "bound_by": "bytes",
              "bound_share": decode_bound / decode_ms}
    if cfg.n_experts:
        n_moe = cfg.n_layers - cfg.n_dense_layers
        decode["routed_experts_read"] = {
            "per_step_mean": experts_per_step, "per_layer_mean": experts_per_step / n_moe,
            "per_layer_max": max(experts), "steps": steps, "expert_bytes": expert_bytes,
            "other_weight_bytes": fixed_bytes}
    emit({
        "phase": "model_serve", "arch": row.arch, "gpu": smi,
        "config": {"arch": row.arch, "family": cfg.family, "n_layers": cfg.n_layers,
                   "d_model": cfg.d_model, "vocab": cfg.vocab, "dtype": "bfloat16",
                   "weights": f"torch.Generator seed {args.seed}",
                   "reduced": (f"n_layers {full_layers} -> {cfg.n_layers}, memory of one card"
                               if cfg.n_layers != full_layers else None)},
        "smoke_width_cpu_vs_card": smoke,
        "params": n_params, "n_params_dense": n_params_dense(cfg), "param_bytes": param_bytes,
        "non_embedding_params": non_embed, "active_non_embedding_params": active,
        "encoder_side_params": enc_params,
        "init_s": init_s,
        "traffic": {"buckets": [{"prompt_tokens": p, "requests": n,
                                 "extras": {k: list(v.shape) for k, v in (extras[p] or {}).items()}}
                                for p, n in row.buckets],
                    "max_new": SERVE_MAX_NEW, "batch": SERVE_BATCH, "max_len": row.max_len,
                    **({"enc_len": row.enc_len} if enc_params else {})},
        "run": {"runs": len(row.buckets), **stats},
        "forward_check": check,
        "prefill_by_bucket": prefill,
        "decode": decode,
        "profile": {f"prefill_8x{row.decode_bucket}": prefill_profile,
                    "decode_4_steps": decode_profile},
        "peak_memory_allocated_bytes": peak,
        "pbs_kernel_launches": pbs_launches,
        "seconds": {"scheduler_run": run_s, "forward_check": check_s, "timing": timing_s,
                    "row": time.perf_counter() - t_phase},
    })
    params = None
    torch.cuda.empty_cache()


def model_serve_phase(args, smi, rows=MODEL_ROWS) -> None:
    """Every row of ``MODEL_ROWS`` in turn (``model_serve_row``)."""
    t_phase = time.perf_counter()
    for row in rows:
        model_serve_row(args, smi, row)
    emit({"phase": "model_serve", "models": [r.arch for r in rows],
          "model_serve_phase_s": time.perf_counter() - t_phase})

# ---------------------------------------------------------------------------
# the model scaffold's training path (phase model_train)
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen2-1.5b"
# the reference's train_4k cell (src/repro/launch/cells.py: seq 4 096, batch
# 256), its batch cut to 8 rows, as 2 microbatches of 4, to fit one card
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICROBATCH = 4096, 8, 2
TRAIN_STEPS, TRAIN_COMPRESSED_STEPS = 6, 3
TRAIN_OPT = dict(warmup=2, total_steps=20)     # as the reference's optimizer tests
# stated before the first run on a card (PERF.md, the training prediction): on one
# repeated batch the f32-state run's loss after 5 updates lies at least
# TRAIN_DESCENT below its first; the int8-state run's losses within
# TRAIN_INT8_RTOL of the f32 run's at every step (the reference's own
# tests/test_optim.py tolerance for the same comparison)
TRAIN_DESCENT = 0.5
TRAIN_INT8_RTOL = 5e-3
TRAIN_COMPRESSION = 0.01
# smoke width, float32 weights and states, one bundle.step on the CPU and
# on the card from one carried state (tests/test_torch_train.py's
# tolerances against the reference): metrics within 1e-5 relative,
# parameters and master within 1e-6 absolute, m and v within 1e-4 of the
# leaf's largest entry
SMOKE_TRAIN_RTOL, SMOKE_TRAIN_PARAM_ATOL, SMOKE_TRAIN_STATE_REL = 1e-5, 1e-6, 1e-4
# full width, 2 layers, float32, 1 x 512 tokens: every gradient leaf on the
# card within this share of the leaf's largest CPU entry, the loss within
# SMOKE_TRAIN_RTOL
GRAD_CHECK_LAYERS, GRAD_CHECK_TOKENS, GRAD_CHECK_REL = 2, 512, 1e-4
# examples/train_lm_torch.py on the card: the resumed run's losses within
# this of an uninterrupted run's.  The card gave equal losses run to run;
# the bound leaves room for reordered float sums and sits below the
# median step-to-step change of the loss (a resume off by a step reads the
# largest of those changes)
TWIN_LOSS_ATOL = 1e-3


def flat_leaves(tree, path="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_leaves(v, f"{path}/{k}"))
        return out
    return {path: tree}


def carried_state_(opt, rng) -> None:
    """A carried optimizer state, in place: step 10, m ~ N(0, 1e-3), v in
    [1e-4, 2e-4) — above the squared gradients, so the Adam update is a
    smooth function of the gradient and a float32 difference in a gradient
    moves a parameter by far less than a learning rate."""
    opt["step"].fill_(10)
    for path, t in flat_leaves(opt["leaves"]).items():
        if path.endswith("/m"):
            t.copy_(torch.from_numpy(1e-3 * rng.standard_normal(t.shape)))
        elif path.endswith("/v"):
            t.copy_(torch.from_numpy(1e-4 * (1 + rng.random(t.shape))))


def smoke_train_batch(cfg, rng, B=4, T=48) -> dict:
    """tokens and labels (the first 3 labels -1), with an encoder-decoder's
    frames and a patch frontend's embeddings (its first positions -1)."""
    toks = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    labels[:, :3] = -1
    batch = {"tokens": toks, "labels": labels}
    if cfg.family == "encdec":
        batch["enc"] = rng.standard_normal((B, 24, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "patch_stub":
        toks[:, :cfg.n_frontend_tokens] = -1
        batch["frontend"] = (0.02 * rng.standard_normal((B, T, cfg.d_model))).astype(np.float32)
    return batch


def leaf_errors(got: dict, want: dict) -> dict:
    """Per leaf of two flat trees: (max |a - b|, max |b|), on the CPU."""
    out = {}
    for k, w in want.items():
        a, b = got[k].detach().cpu().float(), w.detach().cpu().float()
        out[k] = (float((a - b).abs().max()) if b.numel() else 0.0,
                  float(b.abs().max()) if b.numel() else 0.0)
    return out


def smoke_train_check(rng, arch: str) -> dict:
    """One ``bundle.step`` (float32 weights and states, microbatch 2) of the
    smoke config on the CPU and on the card from one carried state: the
    metrics, every parameter and every state leaf after the step."""
    cfg = get_smoke_config(arch)
    if arch == "recurrentgemma-2b":
        cfg = cfg.scaled(n_layers=8)        # its unscanned groups run too
    ocfg = OptConfig(**TRAIN_OPT)
    arrays = draw_np(model_spec(cfg, mesh_ctx(make_local_mesh(device="cpu"))), rng)
    batch = smoke_train_batch(cfg, rng)
    state_rng = np.random.default_rng(int(rng.integers(1 << 31)))
    out = {}
    for name, device in (("cpu", "cpu"), ("card", None)):
        mesh = make_local_mesh(device=device)
        bundle = make_train_step(cfg, mesh, ocfg, batch=4, microbatch=2)
        params = params_from_numpy(arrays, mesh.device)
        opt = init_opt_state(params, bundle.plan, ocfg)
        if name == "cpu":
            carried_state_(opt, state_rng)
            carried = {k: v.clone() for k, v in flat_leaves(opt).items()}
        else:
            for k, v in flat_leaves(opt).items():
                v.copy_(carried[k])
        params, opt, m = bundle.step(params, opt, batch)
        out[name] = ({k: float(v) for k, v in m.items()}, flat_leaves(params),
                     flat_leaves(opt))
    (mc, pc, oc), (mg, pg, og) = out["cpu"], out["card"]
    metric_err = {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-30) for k in mc}
    p_err = max(e for e, _ in leaf_errors(pg, pc).values())
    st = leaf_errors(og, oc)
    master_err = max(e for k, (e, _) in st.items() if k.endswith("/master"))
    mv_rel = max(e / max(s, 1e-30) for k, (e, s) in st.items() if k[-2:] in ("/m", "/v"))
    assert all(metric_err[k] <= SMOKE_TRAIN_RTOL for k in ("loss", "aux", "grad_norm", "lr")), \
        (arch, metric_err)
    assert p_err <= SMOKE_TRAIN_PARAM_ATOL and master_err <= SMOKE_TRAIN_PARAM_ATOL, \
        (arch, p_err, master_err)
    assert mv_rel <= SMOKE_TRAIN_STATE_REL, (arch, mv_rel)
    assert int(og["/step"]) == int(oc["/step"]) == 11
    return {"arch": arch, "n_layers": cfg.n_layers, "loss": mc["loss"], "aux": mc["aux"],
            "metric_rel_err": metric_err, "param_max_abs_err": p_err,
            "master_max_abs_err": master_err, "m_v_max_rel_err": mv_rel}


def full_width_grad_check(args) -> dict:
    """qwen2-1.5b at its full width and GRAD_CHECK_LAYERS layers in float32,
    1 x GRAD_CHECK_TOKENS tokens: the objective's gradient (autograd through
    remat and the chunked loss) of every leaf on the card against the
    port's CPU path on the same weights and tokens."""
    cfg = get_config(TRAIN_ARCH).scaled(n_layers=GRAD_CHECK_LAYERS)
    ctx = mesh_ctx(make_local_mesh(device="cpu"))
    spec = model_spec(cfg, ctx)
    params_cpu = init_params(spec, torch.Generator().manual_seed(args.seed), "cpu")
    upcast_(params_cpu)
    gb = global_batch(0, DataConfig(vocab=cfg.vocab, seq_len=GRAD_CHECK_TOKENS, global_batch=1))
    res, secs = {}, {}
    for name, dev in (("cpu", torch.device("cpu")), ("card", DEV)):
        params = params_cpu if name == "cpu" else tree_map(lambda t: t.to(DEV), params_cpu)
        flat = flat_leaves(params)
        for t in flat.values():
            t.requires_grad_(True)
        t0 = time.perf_counter()
        x = forward(params, torch.as_tensor(gb["tokens"], device=dev), ctx, cfg)
        loss = ce_loss(params["embed"], x, torch.as_tensor(gb["labels"], device=dev), ctx, cfg)
        grads = torch.autograd.grad(loss, list(flat.values()))
        if name == "card":
            torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        res[name] = (float(loss.detach()), dict(zip(flat, (g.cpu() for g in grads))))
        for t in flat.values():
            t.requires_grad_(False)
        del params, flat, grads, x, loss
    (lc, gc), (lg, gg) = res["cpu"], res["card"]
    errs = leaf_errors(gg, gc)
    rel = {k: e / max(s, 1e-30) for k, (e, s) in errs.items()}
    worst = max(rel, key=rel.get)
    assert abs(lg - lc) <= SMOKE_TRAIN_RTOL * abs(lc), (lg, lc)
    assert rel[worst] <= GRAD_CHECK_REL, (worst, rel[worst])
    torch.cuda.empty_cache()
    return {"config": f"{TRAIN_ARCH} n_layers {cfg.n_layers}, d {cfg.d_model}, vocab "
                      f"{cfg.vocab}, float32", "tokens": GRAD_CHECK_TOKENS,
            "params": count_params(spec), "leaves": len(errs), "loss_cpu": lc,
            "loss_card": lg, "worst_leaf": worst, "worst_rel_err": rel[worst],
            "tolerance": GRAD_CHECK_REL, "seconds": secs}


def train_bound(cfg, n_params: int, state: str) -> dict:
    """The least time of one step at TRAIN_BATCH x TRAIN_SEQ: the larger of
    the operations — 6 per parameter per token (forward and backward; the
    tied table's unembedding counted once, its lookup none) plus causal
    attention's score and value products, 2 · 2 · B · H · T² / 2 · dh
    forward and twice that backward — at the bf16 tensor rate, and the
    optimizer's bytes at the memory rate: the float32 accumulator read,
    m, v and master read and written (int8: 1-byte codes, float32 scales
    a 256-block), the bf16 parameter written."""
    tokens = TRAIN_BATCH * TRAIN_SEQ
    dh = cfg.resolved_head_dim
    attn = 3 * 2 * TRAIN_BATCH * cfg.n_heads * TRAIN_SEQ ** 2 * dh * cfg.n_layers
    flops = 6 * n_params * tokens + attn
    per = 4 + 2 + 8 + (2 * 2 * (1 + 4 / QBLK) if state == "int8" else 2 * 2 * 4)
    opt_bytes = n_params * per
    f_ms, b_ms = flops / PEAK_BF16_FLOPS * 1e3, opt_bytes / HBM_BYTES_PER_S * 1e3
    return {"flops": flops, "attention_flops": attn, "optimizer_bytes": opt_bytes,
            "flops_ms": f_ms, "optimizer_bytes_ms": b_ms, "bound_ms": max(f_ms, b_ms),
            "bound_by": "operations" if f_ms >= b_ms else "bytes"}


def train_run(args, cfg, spec, name: str, state, steps: int, compression=None,
              profile: bool = False) -> dict:
    """``steps`` of ``bundle.step`` at full width in bfloat16 on one
    repeated batch (``data.global_batch`` step 0), weights from the seed:
    every step timed with CUDA events in its two halves (``bundle.grads``,
    the forward and backward; ``bundle.update``, sync and AdamW — together
    ``bundle.step``) and its loss read.  With ``profile``, one more step
    under ``torch.profiler`` (the card's busy share), and one more under
    ``FlopCounterMode`` (phase dryrun's flops check).  The peak is also
    read above what was allocated when the run began."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated()
    mesh = make_local_mesh()
    ocfg = OptConfig(**TRAIN_OPT, state_dtype=state)
    ccfg = (CompressionConfig(ratio=compression, min_leaf_size=65_536, enabled=True)
            if compression else None)
    bundle = make_train_step(cfg, mesh, ocfg, batch=TRAIN_BATCH, microbatch=TRAIN_MICROBATCH,
                             compression=ccfg)
    params = init_params(spec, torch.Generator(device=DEV).manual_seed(args.seed), DEV)
    opt = init_opt_state(params, bundle.plan, ocfg)
    if ccfg:
        opt["err"] = init_error_state(params, bundle.plan, ccfg)
    gb = global_batch(0, DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH))
    batch = {k: torch.as_tensor(gb[k], device=DEV) for k in ("tokens", "labels")}
    losses, ms, halves = [], [], []
    for _ in range(steps):                  # bundle.step, its two halves timed apart
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        grads, ce, aux = bundle.grads(params, batch)
        marks[1].record()
        params, opt, m = bundle.update(params, opt, grads, ce, aux)
        marks[2].record()
        del grads
        torch.cuda.synchronize()
        ms.append(marks[0].elapsed_time(marks[2]))
        halves.append((marks[0].elapsed_time(marks[1]), marks[1].elapsed_time(marks[2])))
        losses.append(float(m["loss"]))
        assert np.isfinite(losses[-1]), (name, losses)
    out = {"run": name, "state_dtype": str(state), "steps": steps, "losses": losses,
           "step_ms": ms, "step_ms_median_warm": float(np.median(ms[1:])),
           "forward_backward_ms_median_warm": float(np.median([h[0] for h in halves[1:]])),
           "optimizer_ms_median_warm": float(np.median([h[1] for h in halves[1:]])),
           "grad_norm_last": float(m["grad_norm"]), "lr_last": float(m["lr"]),
           "peak_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "peak_above_start_bytes": torch.cuda.max_memory_allocated() - at_start}
    if ccfg:
        err = [t for t in flat_leaves(opt["err"]).values() if t.numel() > 1]
        mass = float(sum(t.abs().sum() for t in err))
        assert err and 0 < mass < 1e9 and np.isfinite(mass), mass
        out["compression"] = {"ratio": compression, "eligible_leaves": len(err),
                              "error_feedback_abs_sum": mass, **bundle.stats["compression_bytes"]}
    if profile:
        holder = {}

        def one_step():
            holder["s"] = bundle.step(params, opt, batch)

        out["profile_one_step"] = device_profile(one_step)
        holder.clear()
        out["counted_step_flops"] = counted_flops(lambda: bundle.step(params, opt, batch))
    del params, opt, bundle
    torch.cuda.empty_cache()
    return out


def train_lm_twin_on_card() -> dict:
    """``examples/train_lm_torch.py`` on the card: killed at step 35, resumed
    from the step-20 checkpoint — the state it resumed with equal to the
    checkpoint bit for bit — then an uninterrupted run; the resumed run's
    losses within TWIN_LOSS_ATOL of the uninterrupted run's."""
    import importlib.util
    import shutil

    path = ROOT / "examples" / "train_lm_torch.py"
    spec = importlib.util.spec_from_file_location("train_lm_torch", path)
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    checked = {}

    def on_resume(params, opt, step):
        tree, saved = restore_checkpoint(checked["dir"], step)
        want = flat_leaves({"params": tree["params"], "opt": tree["opt"]})
        got = flat_leaves({"params": params, "opt": opt})
        assert set(got) == set(want)
        for k, w in want.items():
            g = got[k].detach().cpu()
            w = w if isinstance(w, torch.Tensor) else torch.from_numpy(np.array(w))
            assert g.dtype == w.dtype and torch.equal(
                g.view(torch.int16) if g.dtype == torch.bfloat16 else g,
                w.view(torch.int16) if w.dtype == torch.bfloat16 else w), k
        checked.update(step=step, leaves=len(want))

    root = Path(tempfile.mkdtemp(prefix="train_lm_twin_"))
    checked["dir"] = root / "killed"
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        res = twin.main(kill_at=35, ckpt_dir=str(root / "killed"), on_resume=on_resume)
        whole = twin.main(kill_at=0, ckpt_dir=str(root / "whole"))
    wall = time.perf_counter() - t0
    shutil.rmtree(root, ignore_errors=True)
    tail = {r["step"]: r["loss"] for r in whole["resumed"]["steps"]}
    resumed = res["resumed"]["steps"]
    diff = max(abs(r["loss"] - tail[r["step"]]) for r in resumed)
    # a resume one step off reads the largest of the uninterrupted run's
    # step-to-step loss changes
    shift = [abs(tail[s + 1] - tail[s]) for s in range(20, 59)]
    assert checked.get("step") == 20 and [r["step"] for r in resumed] == list(range(20, 60))
    assert diff <= TWIN_LOSS_ATOL, diff
    return {"resumed_from": checked["step"], "leaves_bit_equal": checked["leaves"],
            "resumed_steps": len(resumed), "max_abs_loss_diff_vs_uninterrupted": diff,
            "tolerance": TWIN_LOSS_ATOL,
            "step_to_step_loss_change": {"median": float(np.median(shift)), "max": max(shift)},
            "last_loss": resumed[-1]["loss"], "wall_s": wall}


def model_train_phase(args, smi) -> None:
    """The training path on the card (``train.make_train_step``,
    ``optim``, ``launch.train`` through its example twin), which launches no
    PBS kernel (the launch counts must read 0): the ten smoke configs'
    CPU = card step, the full-width gradient check, then qwen2-1.5b at full
    width (28 layers, bf16) in three runs — f32 states, int8 states,
    compression — and last the ``train_lm`` twin's kill and resume."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    platform.reset_launch_counts()
    t0 = time.perf_counter()
    smoke = [smoke_train_check(rng, arch) for arch in TRAIN_SMOKE_ARCHS]
    emit({"phase": "model_train", "step": "smoke_width_cpu_vs_card", "configs": smoke,
          "tolerances": {"metrics_rel": SMOKE_TRAIN_RTOL, "params_abs": SMOKE_TRAIN_PARAM_ATOL,
                         "m_v_rel_to_leaf_max": SMOKE_TRAIN_STATE_REL},
          "seconds": time.perf_counter() - t0})
    grad = full_width_grad_check(args)
    emit({"phase": "model_train", "step": "full_width_gradients", **grad})

    cfg = get_config(TRAIN_ARCH)
    spec = model_spec(cfg, mesh_ctx(make_local_mesh()))
    n_params = count_params(spec)
    # phase dryrun's prediction of the f32 run's step, counted on meta tensors
    predicted = dryrun_prediction(TRAIN_ARCH, "train_4k", TRAIN_BATCH,
                                  microbatch=TRAIN_MICROBATCH,
                                  opt_cfg=OptConfig(**TRAIN_OPT, state_dtype=torch.float32))
    runs = {"f32": train_run(args, cfg, spec, "f32", torch.float32, TRAIN_STEPS, profile=True)}
    runs["int8"] = train_run(args, cfg, spec, "int8", "int8", TRAIN_STEPS)
    runs["compression"] = train_run(args, cfg, spec, "compression", torch.float32,
                                    TRAIN_COMPRESSED_STEPS, compression=TRAIN_COMPRESSION)
    f32, int8 = runs["f32"]["losses"], runs["int8"]["losses"]
    descent = f32[0] - f32[-1]
    int8_rel = max(abs(a - b) / abs(b) for a, b in zip(int8, f32))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for name, r in runs.items():
        b = train_bound(cfg, n_params, "int8" if name == "int8" else "f32")
        r.update(b, tokens_per_s=tokens / (r["step_ms_median_warm"] / 1e3),
                 bound_share=b["bound_ms"] / r["step_ms_median_warm"])
        if name == "f32":                    # the counter's flops against the hand count
            r.update(counter_flops=predicted["flops"],
                     counter_over_hand_flops=predicted["flops"] / b["flops"])
        emit({"phase": "model_train", "step": "full_width", "gpu": smi, **r})
    twin = train_lm_twin_on_card()
    emit({"phase": "model_train", "step": "train_lm_twin", **twin})
    pbs = platform.launch_counts()
    assert descent >= TRAIN_DESCENT, f32
    assert int8_rel <= TRAIN_INT8_RTOL, (int8, f32)
    assert not pbs, pbs                      # the training path launches no PBS kernel
    emit({"phase": "model_train", "gpu": smi,
          "config": {"arch": TRAIN_ARCH, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                     "vocab": cfg.vocab, "params": n_params, "dtype": "bfloat16",
                     "weights": f"torch.Generator seed {args.seed}",
                     "batch": f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, microbatch "
                              f"{TRAIN_MICROBATCH} x {TRAIN_BATCH // TRAIN_MICROBATCH}",
                     "reduced": "global batch 256 -> 8 (the reference's train_4k cell), "
                                "memory of one card",
                     "opt": TRAIN_OPT},
          "f32_loss_descent": descent, "descent_required": TRAIN_DESCENT,
          "int8_vs_f32_max_rel": int8_rel, "int8_rtol": TRAIN_INT8_RTOL,
          "step_ms_median_warm": {k: r["step_ms_median_warm"] for k, r in runs.items()},
          "bound_ms": {k: r["bound_ms"] for k, r in runs.items()},
          "peak_memory_allocated_gb": {k: r["peak_memory_allocated_gb"]
                                       for k, r in runs.items()},
          "pbs_kernel_launches": pbs,
          "model_train_phase_s": time.perf_counter() - t_phase})
    return {"prediction": predicted, "run": runs["f32"]}


# ---------------------------------------------------------------------------
# training across ranks (phase multirank)
# ---------------------------------------------------------------------------

# the ranks are processes sharing the one card over gloo, named by the caller
# (launch.ranks.choose_backend: NCCL needs a card a rank); every number of
# the phase is of ranks sharing a card, none an NVLink or scaling figure
MR_BACKEND = "gloo"
# check: qwen2-1.5b at full width, MR_CHECK_LAYERS layers, float32 weights
# and states, MR_CHECK_ROWS x MR_CHECK_SEQ tokens, one step from one carried
# state on each mesh against the one-rank step on the card, with the
# tolerances of tests/test_torch_mesh_train.py (stated there before the
# first chip call): loss and grad_norm within 1e-5 relative, every synced
# gradient leaf within 1e-4 of its largest magnitude, the parameters after
# the step within 1e-6 absolute.  The compressed mesh's one-rank step is
# AdamW on one rank from the mesh's own (gathered) compressed gradient.
MR_CHECK_LAYERS, MR_CHECK_ROWS, MR_CHECK_SEQ = 2, 4, 512
# the MoE family across ranks: deepseek-v2-236b (arXiv:2405.04434), its
# routed experts spread over the whole ('data', 'model') world
MR_MOE_ARCH = "deepseek-v2-236b"
# the MoE check at reduced width: its 160 experts top-6, 2 shared, 128
# heads, kv_lora 512 and vocab, with d_model 1 024, moe_d_ff 512 and 2
# layers (1 dense + 1 MoE).  At full width one MoE layer's 3.78 B expert
# parameters need ~60 GB of float32 weights, gradients and Adam moments
MR_MOE_TRAIN = dict(d_model=1024, moe_d_ff=512, n_layers=2)
# the recurrent families across ranks: recurrentgemma-2b (arXiv:2402.19427;
# the RG-LRU scans each rank's chunk at full width, composed from gathered
# summaries, local attention's ring replicated) and mamba2-780m
# (arXiv:2405.21060; the SSD's heads split over 'model').  Their training
# check runs at full width, reduced depth: one period of recurrentgemma
# (rglru, rglru, attn), two mamba2 layers
MR_REC_ARCHS = ("recurrentgemma-2b", "mamba2-780m")
# the frontend families across ranks: whisper-tiny (arXiv:2212.04356; the
# encoder over each rank's chunk of the frames, its memory gathered whole,
# the cross cache sequence-sharded) and pixtral-12b
# (hf:mistralai/Pixtral-12B-2409; each rank's chunk of the patch rows).
# whisper's training check runs at full width and all its layers, 4 x 448
# tokens beside 1 500 frames; pixtral's at reduced width, MR_FRONT_TRAIN,
# keeping its 32 heads, 8 KV heads of 128, vocab and frontend, 4 x 512 with
# the first 384 positions patches (labels -1), which straddles (1, 2)'s
# chunk boundary at 256.  At full width a 2-layer one-rank float32 step of
# its ~1.87 B parameters needs ~30 GB beside (2, 1)'s two ZeRO-1 ranks of
# ~22 GB each: more than the card
MR_FRONT_ARCHS = ("whisper-tiny", "pixtral-12b")
MR_FRONT_TRAIN = dict(d_model=1024, d_ff=2048, n_layers=2)
# arch: (sequence, frames, patch positions) of its training check's rows
MR_CHECK_SHAPE = {"whisper-tiny": (448, 1500, 0), "pixtral-12b": (512, 0, 384)}
MR_CHECK_CONFIG = {TRAIN_ARCH: dict(n_layers=MR_CHECK_LAYERS), MR_MOE_ARCH: MR_MOE_TRAIN,
                   "recurrentgemma-2b": dict(n_layers=3), "mamba2-780m": dict(n_layers=2),
                   "whisper-tiny": {}, "pixtral-12b": MR_FRONT_TRAIN}
# (arch, mesh, ZeRO-1, compression ratio); the recurrent and frontend
# families leave (2, 2) to the CPU tests
# (tests/test_torch_recurrent_multirank.py, test_torch_frontends_multirank.py)
MR_CHECKS = ((TRAIN_ARCH, (1, 2), False, None), (TRAIN_ARCH, (2, 1), True, None),
             (TRAIN_ARCH, (2, 2), False, TRAIN_COMPRESSION),
             (MR_MOE_ARCH, (1, 2), False, None), (MR_MOE_ARCH, (2, 1), True, None),
             (MR_MOE_ARCH, (2, 2), False, None)) + tuple(
                 (a, mesh, zero1, None) for a in MR_REC_ARCHS + MR_FRONT_ARCHS
                 for mesh, zero1 in (((1, 2), False), ((2, 1), True)))
MR_LOSS_RTOL, MR_GRAD_REL, MR_PARAM_ATOL = 1e-5, 1e-4, 1e-6
# timed: bfloat16 weights, MR_TIMED_LAYERS layers, model_train's train_4k
# rows (TRAIN_BATCH x TRAIN_SEQ, TRAIN_MICROBATCH microbatches), float32
# states, one cold step then MR_TIMED_STEPS warm ones (cut from 4 layers
# and 3 warm steps for the script's budget)
MR_TIMED_LAYERS, MR_TIMED_STEPS = 2, 1
MR_TIMED = (((1, 2), False), ((2, 1), True))
# serving across ranks, in the 2-rank group after its training work:
# qwen2-1.5b at full width and MR_SERVE_LAYERS of its 28 layers, bfloat16
# weights drawn from --seed on every rank (each keeps its shards), batch
# SERVE_BATCH, max_len 2 048, two of model_serve's three buckets and 16 new
# tokens (reductions of its depth and traffic, for the script's budget).  The 1 536-token
# bucket fills both ranks' chunks on (1, 2) (1 024 positions a rank) and
# decodes on rank 1; the 128-token bucket leaves rank 1's chunk empty.
MR_SERVE = ((1, 2), (2, 1))
MR_SERVE_BUCKETS, MR_SERVE_MAX_LEN, MR_SERVE_MAX_NEW = ((128, 8), (1536, 4)), 2048, 16
MR_SERVE_LAYERS = 14
# Token checks, run on rank 0 alone after every mesh's run.  (a) Every
# token of a mesh's bfloat16 run equals the one-rank no-cache forward's
# argmax over the mesh's own sequence wherever that forward's top-2 margin
# exceeds MR_SERVE_MARGIN, qwen2's model_serve margin (decode and forward
# round bfloat16 in other places; the top logits lie in [2, 4), where a
# bfloat16 ulp is 1/64: 4 ulps), at half the positions or more.  (b) A
# float32 model of MR_CHECK_LAYERS layers at full width on the 1 536 x 4
# bucket: each request's tokens equal the one-rank float32 run's up to the
# first position where they differ, which must be a near tie, the one-rank
# forward's top-2 margin there at most MR_SERVE_F32_MARGIN; later tokens
# follow other prompts and are not compared; half the positions or more
# must be.  In float32 the meshes differ from one rank only in summation
# order (~1e-6 relative), which can round a K/V entry to the neighbouring
# bfloat16 value in the cache (2^-8 relative): that moves a logit by far
# less than 1/128.
MR_SERVE_MARGIN, MR_SERVE_F32_MARGIN = 0.0625, 1 / 128
MR_SERVE_F32_BUCKET = 1536
# deepseek-v2-236b served on the same meshes after qwen2, at full width cut to
# MR_MOE_LAYERS of 60 layers (1 mla_dense + 3 mla_moe, bfloat16; the one-card
# row's depth, both cut for the script's budget), with qwen2's multirank traffic
# (MR_SERVE_BUCKETS, MR_SERVE_MAX_NEW): on (1, 2) the 1 536 bucket decodes in
# rank 1's chunk, the 128 bucket leaves that chunk empty.  Each rank draws the
# weights from --seed leaf by leaf and keeps only its shard (``draw_shards``):
# two ranks share the card.  Its token check (b) runs on the one-card row's
# float32 check model (3 layers, 1 dense + 2 MoE, full width) over the 128 x 8
# bucket: every token of every rank equals the one-rank no-cache forward's
# argmax wherever the forward's top-2 margin exceeds MR_MOE_MARGIN (the
# one-card row's margin_tol) and no layer's route flipped, a flip at a router
# gap past ROUTE_GAP_TOL failing (the one-card row's rule, ``forward_check``),
# half the positions or more checked; and each request's tokens equal the
# one-rank float32 run's up to the first difference, which must be a near tie:
# the one-rank forward's top-2 margin there at most MR_SERVE_F32_MARGIN, or
# its k-th and (k+1)-th router probabilities within ROUTE_GAP_TOL in some
# layer.  The checked runs must drop no (token, slot) pair at capacity.
MR_MOE_LAYERS, MR_MOE_CHECK_LAYERS, MR_MOE_CHECK_BUCKET = 4, 3, 128
MR_MOE_MARGIN = 0.125
# recurrentgemma-2b and mamba2-780m served on the same meshes after the MoE
# family, at full width and half their layers (13 of 26, 24 of 48: cut for
# the script's budget when the frontend families joined) in bfloat16, each rank
# drawing the weights leaf by leaf and keeping its shard, with qwen2's
# multirank traffic.  Their tokens are checked by rank 0 after every mesh's
# run on a float32 model of the same layers (TF32 off), weights drawn from
# the same seed, on the 128 x 8 bucket (arch: (layers, buckets, margin)):
# (a) every token equals the one-rank no-cache forward's argmax wherever the
# forward's top-2 margin exceeds the margin, half the positions or more
# checked; (b) each request's tokens equal the one-rank float32 run's up to
# the first difference, which must be a near tie (the one-rank forward's
# top-2 margin there at most MR_SERVE_F32_MARGIN), at half the positions or
# more.  In bfloat16 no fair margin checks half the positions: on (1, 2)
# and (2, 1) recurrentgemma's decode and forward logits part by up to 0.129
# (the top one by 0.061, as on one card), so tokens part below 0.258, which
# checks 35-40 % (calibration on an H100); mamba2's part by up to 2.9 (its
# row).  In
# float32 the margin is at least twice the largest decode-to-forward logit
# difference a run measures (``decode_logit_errors``, in the line):
# mamba2's 1/128 (its row's; 0.0028-0.0031 on the meshes at all 48
# layers), recurrentgemma's 1/64 (0.0050-0.0051 on the meshes at all 26,
# calibration on an H100), which checked 94 % of the positions there.
MR_REC_DEPTH = {"recurrentgemma-2b": 13, "mamba2-780m": 24}
MR_REC_CHECK = {"recurrentgemma-2b": (13, (128,), 1 / 64),
                "mamba2-780m": (24, (128,), 1 / 128)}
# the frontend families served on the same meshes after the recurrent ones,
# bfloat16, each rank drawing the weights leaf by leaf and keeping its
# shard, arch: (layers, None for all, buckets, max_len, enc_len).  whisper-tiny
# at full width and all its layers (4 + 4): a 30 s window's 1 500 stub
# frames (standard normal), its 448-token decoder context, and its
# model_serve row's traffic less the 224 x 4 bucket.  pixtral-12b at full
# width and 8 of its 40 layers (the script's budget): a text-only bucket of
# 128 x 8, and 1 056 x 8, one 1 024-patch image (its rows drawn at the token
# table's scale, 0.02) at the prompt's start, then a 32-token question; on
# (1, 2) the patches fill rank 0's 528 positions and 496 of rank 1's.  The
# recurrent families' entries: MR_REC_DEPTH and MR_SERVE_BUCKETS.
MR_FAMILY_SERVE = {**{a: (MR_REC_DEPTH[a], MR_SERVE_BUCKETS, MR_SERVE_MAX_LEN, 32)
                      for a in MR_REC_ARCHS},
                   "whisper-tiny": (None, ((4, 8), (132, 8)), 448, 1500),
                   "pixtral-12b": (8, ((128, 8), (1056, 8)), 2048, 32)}
# their token checks, as MR_REC_CHECK's, on float32 models (TF32 off): in
# bfloat16 neither has a margin that checks half the positions (their
# model_serve rows).  whisper: all its layers on the 132 x 8 bucket at its
# row's 1/32 (its bfloat16 caches part decode from forward by up to 0.0140
# on one card); pixtral: 4 layers at full width on the 1 056 x 8 bucket at
# its row's 0.125 (up to 0.0446 at 40 layers on one card)
MR_FRONT_CHECK = {"whisper-tiny": (4, (132,), 1 / 32), "pixtral-12b": (4, (1056,), 0.125)}
# Their check (b)'s near tie is wider than MR_SERVE_F32_MARGIN.  Two decodes
# whose logits each lie within e of the forward's can pick different tokens
# only where the forward's top-2 margin is at most 2e, and their bfloat16
# self and cross caches and bfloat16 combines leave e far above the float32
# summation noise: the first call on an H100 read e = 0.0486 for pixtral's
# 4-layer float32 decode (0.0146 for whisper's) and a mesh's first
# difference from the one-rank run at a margin of 0.0104, past 1/128.  So a
# frontend family's first difference must lie within twice the largest
# decode-to-forward logit error the run measured on the mesh (the mesh's e
# standing for the one-rank run's, both decoding over the same caches),
# and never past the family's check-(a) margin
def near_tie_margin(arch, logit_err: float) -> float:
    """Check (b)'s near-tie margin of ``arch`` (see MR_FRONT_CHECK)."""
    if arch not in MR_FRONT_ARCHS:
        return MR_SERVE_F32_MARGIN
    return min(max(MR_SERVE_F32_MARGIN, 2 * logit_err), MR_FRONT_CHECK[arch][2])



MR_FAMILY_CHECK = {**MR_REC_CHECK, **MR_FRONT_CHECK}
# the margins whose share of checked positions the calibration reports
MR_REC_MARGINS = (1 / 128, 1 / 64, 1 / 32, 1 / 16)
# the 2-rank group's join limit: its training checks and timed runs, then
# both families' serving and rank 0's one-rank checks
MR_TIMEOUT_S = 720


def carried_param_space_(opt, bundle, mesh, spec, seed) -> None:
    """``model_train``'s carried state (``carried_state_``: step 10, m ~ N(0, 1e-3),
    v in [1e-4, 2e-4)) drawn in parameter space on the card, leaf by leaf
    in spec order at the unpadded shape from ``seed``, so every mesh and
    the one-rank step hold the same moments: each rank keeps its shard
    (and under ZeRO-1 its 'data' slice) in the state's flat layout."""
    gen = torch.Generator(device=mesh.device).manual_seed(seed)
    opt["step"].fill_(10)
    flat_spec, flat_plan, flat_st = (flat_leaves(spec), flat_leaves(bundle.plan),
                                     flat_leaves(opt["leaves"]))
    for path, p in flat_spec.items():
        pl = flat_plan[path]
        for key, draw in (("m", lambda t: 1e-3 * t.normal_(generator=gen)),
                          ("v", lambda t: 1e-4 * (1 + t.uniform_(generator=gen)))):
            full = draw(torch.empty(p.logical or p.shape, device=mesh.device))
            if p.logical is not None and p.logical != p.shape:
                full = torch.nn.functional.pad(
                    full, [x for a, b in reversed(list(zip(p.shape, p.logical)))
                           for x in (0, a - b)])
            local = shard_params({"x": full}, {"x": p}, mesh)["x"].reshape(-1)
            if pl.scatter:
                D, i = mesh.shape["data"], mesh.index("data")
                local = torch.nn.functional.pad(local, (0, pl.chunk * D - local.numel()))
                local = local[i * pl.chunk:(i + 1) * pl.chunk]
            st = flat_st[f"{path}/{key}"]
            st.zero_()
            st[:local.numel()] = local


def mr_state(cfg, mesh, ocfg, ccfg, batch, seed):
    """A bundle, this rank's float32 parameters (drawn from ``seed`` on the
    card at the global shape, then sharded) and its carried state."""
    bundle = make_train_step(cfg, mesh, ocfg, batch=batch, compression=ccfg)
    spec = bundle.param_spec
    params = init_params(spec, torch.Generator(device=mesh.device).manual_seed(seed),
                         mesh.device)
    upcast_(params)
    if mesh.world > 1:
        params = shard_params(params, spec, mesh)
    opt = init_opt_state(params, bundle.plan, ocfg, mesh)
    carried_param_space_(opt, bundle, mesh, spec, seed + 1)
    if ccfg:
        opt["err"] = init_error_state(params, bundle.plan, ccfg)
    return bundle, params, opt


def mr_check_mesh(dev, arch, data, model, zero1, ratio, seed) -> dict:
    """One step of the f32 check on this rank of a (data, model) mesh, then
    the one-rank step on the card from the same weights and carried state
    (every rank runs it, in turns, so nothing is gathered but a compressed
    gradient): this rank's shards of the loss, the synced gradients and
    the parameters after the step against the same shards of the one-rank
    step's (see MR_CHECKS).  The compressed mesh's one-rank step is AdamW
    from the mesh's own compressed gradient, gathered.  An MoE config's
    check counts the pairs its dispatch drops at capacity."""
    stamps = {"start": time.perf_counter()}
    torch.cuda.reset_peak_memory_stats()        # this check's peak, not an earlier one's
    cfg = get_config(arch).scaled(**MR_CHECK_CONFIG[arch])
    mesh = make_local_mesh(data, model, device=dev)
    ocfg = OptConfig(**TRAIN_OPT, zero1=zero1)
    ccfg = CompressionConfig(ratio=ratio, min_leaf_size=65_536, enabled=True) if ratio else None
    batch = mr_check_batch(arch, cfg, mesh.device, seed)
    bundle, params, opt = mr_state(cfg, mesh, ocfg, ccfg, MR_CHECK_ROWS, seed)
    spec = bundle.param_spec
    torch.cuda.synchronize()
    stamps["setup"] = time.perf_counter()
    grads, ce, aux = bundle.grads(params, batch)
    dispatch = dict(mesh.dispatch)
    torch.cuda.synchronize()
    stamps["grads"] = time.perf_counter()
    plain = build_plan(spec, mesh.axis_names, mesh.shape, OptConfig(**TRAIN_OPT))
    with torch.no_grad():
        synced = tree_zip_plan(lambda g, pl: sync_gradient(g, pl, mesh), grads, plain)
    sent = None
    if ccfg:
        from repro_torch.optim.compression import sync_all
        sent, _, _ = sync_all(grads, opt["err"], bundle.plan, ocfg, ccfg, mesh)
    loss = float(mesh.all_reduce(ce / mesh.world, mesh.axis_names))
    torch.cuda.synchronize()
    stamps["sync"] = time.perf_counter()
    params, opt, met = bundle.update(params, opt, grads, ce, aux)
    torch.cuda.synchronize()
    stamps["update"] = time.perf_counter()
    ledger = {k: dict(v) for k, v in mesh.ledger.items()}
    c_all = None
    if ccfg:        # every rank needs the whole compressed gradient for its one-rank step:
        # it is the same on every data rank, so gathered over 'model' only
        c_all = gather_params(sent, spec, mesh, everywhere=True, axes=("model",))
    del grads, sent, bundle
    stamps["gather"] = time.perf_counter()

    def one_rank():
        """The one-rank step and this rank's shards against it."""
        one = make_local_mesh(device=dev)
        ocfg1 = OptConfig(**TRAIN_OPT)
        b1, p1, o1 = mr_state(cfg, one, ocfg1, None, MR_CHECK_ROWS, seed)
        g1, ce1, aux1 = b1.grads(p1, batch)
        if ccfg:
            _, _, met1 = apply_updates(c_all, p1, o1, b1.plan, ocfg1, presynced=True)
        else:
            _, _, met1 = b1.update(p1, o1, g1, ce1, aux1)
        torch.cuda.synchronize()
        with torch.no_grad():
            g_err = {k: e / max(w, 1e-30)
                     for k, (e, w) in local_errors(synced, g1, spec, mesh).items()}
            p_err = max(e for e, _ in local_errors(params, p1, spec, mesh).values())
        res = float(ce1), float(met1["grad_norm"]), g_err, p_err
        del b1, p1, o1, g1
        torch.cuda.empty_cache()
        return res

    # in turns: four one-rank training states of the MoE check do not fit
    # the card together, nor do two of recurrentgemma's (36-38 GB a rank
    # with its mesh state: its 256 000-wide float32 logits)
    for turn in range(mesh.world):
        torch.distributed.barrier()
        if turn == mesh.rank:
            loss1, norm1, g_err, p_err = one_rank()
    stamps["one_rank"] = time.perf_counter()
    worst = max(g_err, key=g_err.get)
    out = {"arch": arch, "mesh": [data, model], "zero1": zero1, "compression": ratio,
           "rank": mesh.rank, "moe_dispatch": dispatch,
           "loss": loss, "loss_one_rank": loss1, "loss_rel_err": abs(loss - loss1) / abs(loss1),
           "grad_norm": float(met["grad_norm"]),
           "grad_norm_rel_err": abs(float(met["grad_norm"]) - norm1) / norm1,
           "worst_grad_leaf": worst, "worst_grad_rel_err": g_err[worst],
           "param_max_abs_err": p_err, "collectives": ledger,
           "seconds": {k: stamps[k] - prev for (k, prev) in
                       zip(list(stamps)[1:], list(stamps.values())[:-1])},
           "pbs_kernel_launches": platform.launch_counts(),
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    del params, opt, synced, c_all
    torch.cuda.empty_cache()
    return out


def mr_check_batch(arch, cfg, device, seed) -> dict:
    """The check's global batch, the same on every rank: ``MR_CHECK_ROWS``
    rows of the data pipeline's tokens and labels (``MR_CHECK_SEQ`` long,
    or the arch's ``MR_CHECK_SHAPE``), with its frames (standard normal) or
    its patch rows (0.02 times standard normal, the positions' tokens and
    labels -1) drawn on ``device`` from ``seed`` + 2."""
    seq, frames, patches = MR_CHECK_SHAPE.get(arch, (MR_CHECK_SEQ, 0, 0))
    gb = global_batch(0, DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=MR_CHECK_ROWS))
    batch = {k: gb[k].copy() for k in ("tokens", "labels")}
    g = torch.Generator(device=device).manual_seed(seed + 2)
    if frames:
        batch["enc"] = torch.randn((MR_CHECK_ROWS, frames, cfg.d_model), generator=g,
                                   device=device)
    if patches:
        batch["tokens"][:, :patches] = -1
        batch["labels"][:, :patches] = -1
        batch["frontend"] = 0.02 * torch.randn((MR_CHECK_ROWS, seq, cfg.d_model),
                                               generator=g, device=device)
    return batch


def local_errors(local, whole, spec, mesh) -> dict:
    """Per leaf: (max |local - this rank's shard of whole|, max |that
    shard|), on the card."""
    out = {}
    for path, p in flat_leaves(spec).items():
        want = shard_params({"x": flat_leaves(whole)[path]}, {"x": p}, mesh)["x"].float()
        got = flat_leaves(local)[path].float()
        out[path] = (float((got - want).abs().max()) if want.numel() else 0.0,
                     float(want.abs().max()) if want.numel() else 0.0)
    return out


def tree_zip_plan(fn, tree, plan):
    if isinstance(plan, dict):
        return {k: tree_zip_plan(fn, tree[k], plan[k]) for k in plan}
    return fn(tree, plan)


# what the meta count of a step must equal, per op, in a real rank's ledger
LEDGER_CHECKED = ("calls", "bytes", "ring_bytes")


def mr_timed_mesh(dev, data, model, zero1, seed) -> dict:
    """MR_TIMED_STEPS warm steps (after one cold) of qwen2-1.5b at full
    width, MR_TIMED_LAYERS layers, bf16 weights, on this rank of a (data,
    model) mesh whose ranks share the card: each step's wall (host clock
    around the step and a synchronize), the host wall inside the
    collective wrappers (gloo, which copies CUDA tensors through host
    memory itself), this rank's peak memory."""
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH).scaled(n_layers=MR_TIMED_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_local_mesh(data, model, device=dev)
    ocfg = OptConfig(**TRAIN_OPT, zero1=zero1)
    bundle = make_train_step(cfg, mesh, ocfg, batch=TRAIN_BATCH, microbatch=TRAIN_MICROBATCH)
    params = init_params(bundle.param_spec, torch.Generator(device=dev).manual_seed(seed), dev)
    params = shard_params(params, bundle.param_spec, mesh)
    torch.cuda.empty_cache()
    opt = init_opt_state(params, bundle.plan, ocfg, mesh)
    gb = global_batch(0, DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH))
    batch = {k: gb[k] for k in ("tokens", "labels")}
    setup_s = time.perf_counter() - t0
    losses, ms, coll = [], [], []
    for i in range(1 + MR_TIMED_STEPS):
        torch.cuda.synchronize()
        mesh.ledger.clear()
        t0 = time.perf_counter()
        params, opt, m = bundle.step(params, opt, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        coll.append({k: v["seconds"] * 1e3 for k, v in mesh.ledger.items()})
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)), losses
    warm = ms[1:]
    return {"mesh": [data, model], "zero1": zero1, "rank": mesh.rank, "setup_s": setup_s,
            "step_ms": ms, "step_ms_median_warm": float(np.median(warm)),
            "collective_ms_by_op": coll,
            "collective_ms_median_warm": float(np.median([sum(c.values()) for c in coll[1:]])),
            "collective_bytes_a_step": {k: v["bytes"] for k, v in mesh.ledger.items()},
            "ledger_last_step": {k: {f: v[f] for f in LEDGER_CHECKED}
                                 for k, v in mesh.ledger.items()},
            "losses": losses,
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "pbs_kernel_launches": platform.launch_counts()}


def mr_serve_params(cfg, mesh, seed, float32=False):
    """The global weights drawn from ``seed`` on this rank's device (bfloat16,
    upcast with ``float32``), this rank's shards of them kept."""
    spec = model_spec(cfg, mesh_ctx(mesh))
    params = init_params(spec, torch.Generator(device=mesh.device).manual_seed(seed),
                         mesh.device)
    if float32:
        upcast_(params)
    return shard_params(params, spec, mesh) if mesh.world > 1 else params


def mr_serve_requests(seed, buckets=MR_SERVE_BUCKETS, arch=TRAIN_ARCH) -> list:
    """The serving traffic, the same on every rank: ``MR_SERVE_MAX_NEW`` new
    tokens a prompt, ids in ``arch``'s vocab; a ``patch_stub`` model's
    prompt longer than its image starts with it (``n_frontend_tokens``
    patch positions, -1)."""
    rng = np.random.default_rng(seed)
    cfg = get_config(arch)
    out = []
    for rid, plen in enumerate(p for p, n in buckets for _ in range(n)):
        toks = [int(x) for x in rng.integers(0, cfg.vocab, plen)]
        if cfg.frontend == "patch_stub" and plen > cfg.n_frontend_tokens:
            toks[:cfg.n_frontend_tokens] = [-1] * cfg.n_frontend_tokens
        out.append(Request(rid, toks, MR_SERVE_MAX_NEW))
    return out


def mr_serve_extras(cfg, buckets, enc_len: int, seed: int) -> dict:
    """{prompt length: its bucket's extras} (``bucket_extras``: frames or
    patch rows, None for text), drawn on the card from ``seed`` + 1 in
    bucket order, so every rank and the one-rank checks draw the same."""
    g = torch.Generator(device=DEV).manual_seed(seed + 1)
    return {plen: bucket_extras(cfg, plen, SERVE_BATCH, enc_len, lambda shape: torch.randn(
        shape, generator=g, device=DEV)) for plen, _ in buckets}


def mr_serve_run(sched, params, requests, cfg, extras=None) -> dict:
    """``requests`` through ``sched``, one ``run`` a prompt length (as
    model_serve's ``serve_run``) with that length's ``extras``, each
    completion checked: finished with ``MR_SERVE_MAX_NEW`` in-vocab
    tokens.  Returns {rid: tokens}."""
    out = {}
    for plen in sorted({len(r.prompt) for r in requests}):
        reqs = [r for r in requests if len(r.prompt) == plen]
        got, stats = sched.run(params, reqs, extras=(extras or {}).get(plen))
        assert sorted(got) == [r.rid for r in reqs], got.keys()
        for r in reqs:
            c = got[r.rid]
            assert len(c.tokens) == MR_SERVE_MAX_NEW and c.finished, (r.rid, c)
            assert all(0 <= t < cfg.vocab for t in c.tokens), (r.rid, c.tokens)
        assert stats.decode_steps == len(reqs) * (MR_SERVE_MAX_NEW - 1), stats
        out.update({rid: c.tokens for rid, c in got.items()})
    return out


def timed_engine(sched, mesh, log) -> None:
    """Swap ``sched``'s engine for one whose steps are timed (host clock
    around the step and a synchronize; the scheduler reads every token to
    the host anyway): each prefill's (prompt length, ms) and each decode
    step's ms and collectives (the mesh's ledger over the step)."""
    sv = sched._engine

    def prefill(params, inputs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sv.prefill(params, inputs)
        torch.cuda.synchronize()
        log["prefill"].append((int(inputs["tokens"].shape[1]), (time.perf_counter() - t0) * 1e3))
        return out

    def decode(params, caches, tokens):
        torch.cuda.synchronize()
        mesh.ledger.clear()
        t0 = time.perf_counter()
        out = sv.decode(params, caches, tokens)
        torch.cuda.synchronize()
        log["decode"].append({"ms": (time.perf_counter() - t0) * 1e3,
                              **{k: dict(v) for k, v in mesh.ledger.items()}})
        return out

    sched._engine = dataclasses.replace(sv, prefill=prefill, decode=decode)


def serve_log_stats(log) -> dict:
    """A timed run's figures from ``timed_engine``'s log: each prefill's ms
    by prompt length, each decode step's ms and their median, and a step's
    collectives (median calls, bytes and host ms of each, and of them all)."""
    steps = log["decode"]
    ops = sorted({k for st in steps for k in st if k != "ms"})
    return {
        "prefill_ms": {plen: ms for plen, ms in log["prefill"]},
        "decode_ms": [st["ms"] for st in steps],
        "decode_ms_median": float(np.median([st["ms"] for st in steps])),
        "collectives_a_step": {k: {
            "calls": int(np.median([st.get(k, {}).get("calls", 0) for st in steps])),
            "bytes": int(np.median([st.get(k, {}).get("bytes", 0) for st in steps])),
            "host_ms_median": float(np.median([st.get(k, {}).get("seconds", 0.0) * 1e3
                                               for st in steps]))} for k in ops},
        "collective_host_ms_a_step_median": float(np.median(
            [sum(v["seconds"] for k, v in st.items() if k != "ms") * 1e3 for st in steps]))}


def rank_timings(per) -> dict:
    """A serving line's timings of one mesh and model, one entry a rank of
    ``per`` (each rank's ``serve_log_stats``, peak and seconds)."""
    return {"prefill_ms_by_bucket": {str(p): [r["prefill_ms"][p] for r in per]
                                     for p in per[0]["prefill_ms"]},
            "decode_ms_a_step_median": [r["decode_ms_median"] for r in per],
            "decode_steps": len(per[0]["decode_ms"]),
            "collectives_a_step": [r["collectives_a_step"] for r in per],
            "collective_host_ms_a_step_median": [r["collective_host_ms_a_step_median"]
                                                 for r in per],
            "max_memory_allocated_gb": [r["max_memory_allocated_gb"] for r in per],
            "seconds": [r["seconds"] for r in per]}


def mr_serve_mesh(dev, data, model, seed) -> dict:
    """qwen2-1.5b served on this rank of a (data, model) mesh whose ranks
    share the card: the bfloat16 run over ``MR_SERVE_BUCKETS`` through
    ``BatchScheduler`` (its steps timed, ``timed_engine``), then the float32
    ``MR_CHECK_LAYERS``-layer model's run on the ``MR_SERVE_F32_BUCKET`` bucket.  Every
    rank returns the same (global) tokens."""
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH).scaled(n_layers=MR_SERVE_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_local_mesh(data, model, device=dev)
    params = mr_serve_params(cfg, mesh, seed)
    torch.cuda.empty_cache()
    requests = mr_serve_requests(seed)
    sched = BatchScheduler(cfg, mesh, batch=SERVE_BATCH, max_len=MR_SERVE_MAX_LEN, eos_id=-1)
    log = {"prefill": [], "decode": []}
    timed_engine(sched, mesh, log)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tokens = mr_serve_run(sched, params, requests, cfg)
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    del params, sched
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg32 = cfg.scaled(n_layers=MR_CHECK_LAYERS)
    params = mr_serve_params(cfg32, mesh, seed, float32=True)
    sched = BatchScheduler(cfg32, mesh, batch=SERVE_BATCH, max_len=MR_SERVE_MAX_LEN, eos_id=-1)
    tokens32 = mr_serve_run(sched, params, [r for r in requests if len(r.prompt) == MR_SERVE_F32_BUCKET], cfg32)
    f32_s = time.perf_counter() - t0
    del params, sched
    torch.cuda.empty_cache()
    return {"mesh": [data, model], "rank": mesh.rank, "tokens": tokens, "tokens_f32": tokens32,
            **serve_log_stats(log),
            "max_memory_allocated_gb": peak / 1e9,
            "pbs_kernel_launches": platform.launch_counts(),
            "seconds": {"setup": setup_s, "bf16_run": run_s, "f32_check_run": f32_s}}


def mr_serve_one_rank(dev, seed, served) -> dict:
    """On rank 0 alone, after every mesh's run: the one-rank bfloat16 run
    and, for each mesh of ``served``, the token check (a) of MR_SERVE_MARGIN
    (``forward_check`` over the mesh's own sequences) and its tokens'
    agreement with the one-rank run's; then the one-rank float32 run and
    check (b) of each mesh's float32 tokens."""
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH).scaled(n_layers=MR_SERVE_LAYERS)
    mesh = make_local_mesh(device=dev)
    ctx = mesh_ctx(mesh)
    params = mr_serve_params(cfg, mesh, seed)
    requests = mr_serve_requests(seed)
    sched = BatchScheduler(cfg, mesh, batch=SERVE_BATCH, max_len=MR_SERVE_MAX_LEN, eos_id=-1)
    one = mr_serve_run(sched, params, requests, cfg)
    out = {"meshes": []}
    for s in served:
        done = {rid: Completion(rid, toks, True) for rid, toks in s["tokens"].items()}
        check = forward_check(params, cfg, ctx, done, requests, MR_SERVE_MARGIN)
        pairs = [(a, b) for r in requests for a, b in zip(s["tokens"][r.rid], one[r.rid])]
        first = [next((i for i, (a, b) in enumerate(zip(s["tokens"][r.rid], one[r.rid]))
                       if a != b), MR_SERVE_MAX_NEW) for r in requests]
        out["meshes"].append({"mesh": s["mesh"], "forward_check": check,
                              "tokens_equal_one_rank": sum(a == b for a, b in pairs) / len(pairs),
                              "first_difference_by_request": first})
    del params, sched
    torch.cuda.empty_cache()
    cfg32 = cfg.scaled(n_layers=MR_CHECK_LAYERS)
    params = mr_serve_params(cfg32, mesh, seed, float32=True)
    reqs = [r for r in requests if len(r.prompt) == MR_SERVE_F32_BUCKET]
    sched = BatchScheduler(cfg32, mesh, batch=SERVE_BATCH, max_len=MR_SERVE_MAX_LEN, eos_id=-1)
    one32 = mr_serve_run(sched, params, reqs, cfg32)
    seq = torch.tensor([r.prompt + one32[r.rid][:-1] for r in reqs], dtype=torch.int32,
                       device=mesh.device)
    x = forward(params, seq, ctx, cfg32)[:, MR_SERVE_F32_BUCKET - 1:]
    logits = vocab_logits(params["embed"], x, ctx, cfg32)
    top2 = logits.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).cpu()
    for s, res in zip(served, out["meshes"]):
        compared, near = 0, []
        for i, r in enumerate(reqs):
            got, want = s["tokens_f32"][r.rid], one32[r.rid]
            n = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
            if n is None:
                compared += len(want)
            else:
                compared += n
                near.append({"rid": r.rid, "position": n, "margin": float(margin[i, n])})
        res["f32_check"] = {"n_layers": MR_CHECK_LAYERS, "positions": len(reqs) * MR_SERVE_MAX_NEW,
                            "positions_compared": compared, "differences": near,
                            "margin_tol": MR_SERVE_F32_MARGIN,
                            "median_margin": float(margin.median())}
    del params, sched, x, logits
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def draw_shards(spec, seed, mesh, float32=False):
    """``init_params(spec, torch.Generator(...).manual_seed(seed))`` on the
    mesh's device, leaf by leaf in its order, keeping only this rank's shard
    of each leaf (of a leaf drawn in slices, the parts of each slice that
    fall in the shard): the values of drawing the global tree and sharding
    it, without holding the global tree.  With ``float32`` each shard is
    upcast as it is kept."""
    gen = torch.Generator(device=mesh.device).manual_seed(seed)
    at = dict(zip(mesh.axis_names, mesh.coords))

    def leaf(p):
        if p.init == "normal" and np.prod(p.logical or p.shape) > pspec.SLICE_ABOVE:
            x = sliced_shard(p, gen, mesh, at)
        else:
            x = shard_params({"x": init_params({"x": p}, gen, mesh.device)["x"]}, {"x": p},
                             mesh)["x"]
        return x.float() if float32 else x

    return tree_map_p(leaf, spec)


def sliced_shard(p, gen, mesh, at) -> torch.Tensor:
    """``init_params``' draw of a leaf above ``SLICE_ABOVE`` elements (the
    same ``SLICE_ELEMS`` slices of the same stream, each scaled and cast),
    kept only where it falls in this rank's block, which splits at most one
    dimension (a routed expert leaf: its experts)."""
    if p.logical not in (None, p.shape):
        raise ValueError(f"a sliced draw of a padded leaf {p.shape} / {p.logical}")
    blocks = pspec.dim_blocks(p.shape, p.axes, mesh.shape, at)
    split = [i for i, (b, n) in enumerate(zip(blocks, p.shape)) if (b.start, b.stop) != (0, n)]
    if len(split) > 1:
        raise ValueError(f"a sliced draw split over {len(split)} dimensions")
    k = split[0] if split else 0
    a, b = blocks[k].start, blocks[k].stop
    outer, K = int(np.prod(p.shape[:k])), p.shape[k]
    inner = int(np.prod(p.shape[k + 1:]))
    scale = p.scale if p.scale is not None else 1.0 / np.sqrt(max(1, p.shape[-2]))
    local = torch.empty(tuple(x.stop - x.start for x in blocks), dtype=p.dtype,
                        device=mesh.device)
    rows = local.view(outer, (b - a) * inner)
    total = outer * K * inner
    for lo in range(0, total, pspec.SLICE_ELEMS):
        hi = min(lo + pspec.SLICE_ELEMS, total)
        part = torch.randn(hi - lo, generator=gen, dtype=torch.float32,
                           device=mesh.device).mul_(scale)
        for o in range(lo // (K * inner), (hi - 1) // (K * inner) + 1):
            base = o * K * inner + a * inner          # the block's first element in row o
            s0, s1 = max(lo, base), min(hi, base + (b - a) * inner)
            if s0 < s1:
                rows[o, s0 - base:s1 - base] = part[s0 - lo:s1 - lo]
    return local


def mr_moe_serve_mesh(dev, data, model, seed) -> dict:
    """deepseek-v2 served on this rank of a (data, model) mesh whose ranks
    share the card: the bfloat16 run of ``MR_MOE_LAYERS`` layers over
    ``MR_SERVE_BUCKETS`` (steps timed, ``timed_engine``), then the float32
    check model's run on the ``MR_MOE_CHECK_BUCKET`` bucket with its routes
    recorded.  Every rank returns the same (global) tokens; the routes are
    this rank's: its rows over 'data', and a prefill's last position only
    on the last 'model' rank (``route_piece``, None elsewhere)."""
    t0 = time.perf_counter()
    cfg = get_config(MR_MOE_ARCH).scaled(n_layers=MR_MOE_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_local_mesh(data, model, device=dev)
    ctx = mesh_ctx(mesh)
    params = draw_shards(model_spec(cfg, ctx), seed, mesh)
    torch.cuda.empty_cache()
    requests = mr_serve_requests(seed, MR_SERVE_BUCKETS, MR_MOE_ARCH)
    sched = BatchScheduler(cfg, mesh, batch=SERVE_BATCH, max_len=MR_SERVE_MAX_LEN, eos_id=-1)
    log = {"prefill": [], "decode": []}
    timed_engine(sched, mesh, log)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tokens = mr_serve_run(sched, params, requests, cfg)
    dispatch = dict(mesh.dispatch)
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    del params, sched
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg32 = cfg.scaled(n_layers=MR_MOE_CHECK_LAYERS)
    params = draw_shards(model_spec(cfg32, ctx), seed, mesh, float32=True)
    reqs = [r for r in requests if len(r.prompt) == MR_MOE_CHECK_BUCKET]
    sched = BatchScheduler(cfg32, mesh, batch=SERVE_BATCH, max_len=MR_SERVE_MAX_LEN, eos_id=-1)
    mesh.dispatch.clear()
    with recorded_routes() as calls:
        tokens32 = mr_serve_run(sched, params, reqs, cfg32)
    dispatch32 = dict(mesh.dispatch)
    piece = None
    if ctx.midx() == ctx.model_size - 1:          # it holds every prefill's last position
        routes = chunk_routes(calls, cfg32.n_layers - cfg32.n_dense_layers,
                              MR_SERVE_MAX_NEW - 1).cpu()
        lo = mesh.index("data") * routes.shape[0] if sched._engine.batch_ax else 0
        piece = {"rows": [lo, lo + routes.shape[0]], "routes": routes}
    f32_s = time.perf_counter() - t0
    del params, sched, calls
    torch.cuda.empty_cache()
    return {"mesh": [data, model], "rank": mesh.rank, "tokens": tokens, "tokens_f32": tokens32,
            "route_piece": piece, "dispatch": dispatch, "dispatch_f32": dispatch32,
            **serve_log_stats(log),
            "max_memory_allocated_gb": peak / 1e9,
            "pbs_kernel_launches": platform.launch_counts(),
            "seconds": {"setup": setup_s, "bf16_run": run_s, "f32_check_run": f32_s}}


def mr_moe_one_rank(dev, seed, served, pieces) -> dict:
    """On rank 0 alone, after every mesh's run: the one-rank float32 check
    model's run on the ``MR_MOE_CHECK_BUCKET`` bucket, then for each mesh of
    ``served`` its float32 tokens against the one-rank forward
    (``forward_check`` with the mesh's routes, put together from every
    rank's ``pieces``) and against the one-rank run's up to their first
    difference, with the forward's margin and smallest router gap there."""
    t0 = time.perf_counter()
    cfg = get_config(MR_MOE_ARCH).scaled(n_layers=MR_MOE_CHECK_LAYERS)
    n_moe = cfg.n_layers - cfg.n_dense_layers
    mesh = make_local_mesh(device=dev)
    ctx = mesh_ctx(mesh)
    params = init_params(model_spec(cfg, ctx), torch.Generator(device=DEV).manual_seed(seed),
                         mesh.device)
    upcast_(params)
    reqs = [r for r in mr_serve_requests(seed, MR_SERVE_BUCKETS, MR_MOE_ARCH)
            if len(r.prompt) == MR_MOE_CHECK_BUCKET]
    sched = BatchScheduler(cfg, mesh, batch=SERVE_BATCH, max_len=MR_SERVE_MAX_LEN, eos_id=-1)
    one = mr_serve_run(sched, params, reqs, cfg)
    seq = torch.tensor([r.prompt + one[r.rid][:-1] for r in reqs], dtype=torch.int32,
                       device=mesh.device)
    with recorded_routes() as calls:
        x = forward(params, seq, ctx, cfg)[:, MR_MOE_CHECK_BUCKET - 1:]
    margin = vocab_logits(params["embed"], x, ctx, cfg).topk(2, dim=-1).values
    margin = (margin[..., 0] - margin[..., 1]).cpu()
    _, gaps = forward_routes(calls, len(reqs), MR_MOE_CHECK_BUCKET - 1, MR_SERVE_MAX_NEW)
    gap = gaps.min(-1).values.cpu()                  # the smallest over the MoE layers
    del calls, x
    out = {"meshes": []}
    for i, s in enumerate(served):
        routes = torch.empty((SERVE_BATCH, MR_SERVE_MAX_NEW, n_moe, cfg.moe_top_k),
                             dtype=torch.long)
        for rank_pieces in pieces:
            pc = rank_pieces[i]
            if pc is not None:
                routes[pc["rows"][0]:pc["rows"][1]] = pc["routes"]
        done = {rid: Completion(rid, toks, True) for rid, toks in s["tokens_f32"].items()}
        check = forward_check(params, cfg, ctx, done, reqs, MR_MOE_MARGIN,
                              routes={r.rid: routes[b].to(DEV) for b, r in enumerate(reqs)})
        compared, firsts = 0, []
        for b, r in enumerate(reqs):
            got, want = s["tokens_f32"][r.rid], one[r.rid]
            n = next((j for j, (u, v) in enumerate(zip(got, want)) if u != v), None)
            compared += len(want) if n is None else n
            if n is not None:
                firsts.append({"rid": r.rid, "position": n, "margin": float(margin[b, n]),
                               "min_router_gap": float(gap[b, n]),
                               "near_tie": bool(margin[b, n] <= MR_SERVE_F32_MARGIN
                                                or gap[b, n] <= ROUTE_GAP_TOL)})
        out["meshes"].append({"mesh": s["mesh"], "forward_check": check,
                              "one_rank_compare": {
                                  "positions": len(reqs) * MR_SERVE_MAX_NEW,
                                  "positions_compared": compared, "differences": firsts,
                                  "margin_tol": MR_SERVE_F32_MARGIN,
                                  "route_gap_tol": ROUTE_GAP_TOL}})
    del params, sched
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def mr_family_serving(arch):
    """(bfloat16 config, buckets, max_len, enc_len) of ``MR_FAMILY_SERVE``."""
    layers, buckets, max_len, enc_len = MR_FAMILY_SERVE[arch]
    cfg = get_config(arch)
    return (cfg.scaled(n_layers=layers) if layers else cfg), buckets, max_len, enc_len


def mr_family_serve_mesh(dev, data, model, seed, archs) -> dict:
    """The families ``archs`` served on this rank of a (data, model) mesh
    whose ranks share the card, one after the other: the bfloat16 run of
    ``MR_FAMILY_SERVE`` with its frames or patch rows (``mr_serve_extras``;
    steps timed, ``timed_engine``), then the float32 model's run of
    ``MR_FAMILY_CHECK`` (TF32 off), its final-norm states recorded
    (``hidden``: this rank's rows, on the first 'model' rank only, where
    they are replicated).  Every rank returns the same (global) tokens."""
    mesh = make_local_mesh(data, model, device=dev)
    ctx = mesh_ctx(mesh)
    assert not torch.backends.cuda.matmul.allow_tf32
    out = {"mesh": [data, model], "rank": mesh.rank, "archs": {}}
    for arch in archs:
        t0 = time.perf_counter()
        cfg, serve_buckets, max_len, enc_len = mr_family_serving(arch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = draw_shards(model_spec(cfg, ctx), seed, mesh)
        requests = mr_serve_requests(seed, serve_buckets, arch)
        extras = mr_serve_extras(cfg, serve_buckets, enc_len, seed)
        sched = BatchScheduler(cfg, mesh, batch=SERVE_BATCH, max_len=max_len, eos_id=-1,
                               enc_len=enc_len)
        log = {"prefill": [], "decode": []}
        timed_engine(sched, mesh, log)
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tokens = mr_serve_run(sched, params, requests, cfg, extras)
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        del params, sched
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        layers, buckets, _ = MR_FAMILY_CHECK[arch]
        cfg32 = get_config(arch).scaled(n_layers=layers)
        params = draw_shards(model_spec(cfg32, ctx), seed, mesh, float32=True)
        sched = BatchScheduler(cfg32, mesh, batch=SERVE_BATCH, max_len=max_len, eos_id=-1,
                               enc_len=enc_len)
        with recorded_hidden() as states:
            tokens32 = mr_serve_run(sched, params,
                                    [r for r in requests if len(r.prompt) in buckets], cfg32,
                                    extras)
        hidden = None
        if ctx.midx() == 0:
            # a prefill and MR_SERVE_MAX_NEW - 1 steps a bucket, in bucket order
            n, b = MR_SERVE_MAX_NEW, states[0].shape[0]
            lo = mesh.index("data") * b if sched._engine.batch_ax else 0
            hidden = {"rows": [lo, lo + b], "x": {
                plen: torch.cat(states[i * n:(i + 1) * n], 1).cpu()     # (B_local, n, d)
                for i, plen in enumerate(sorted(buckets))}}
        f32_s = time.perf_counter() - t0
        del params, sched, states, extras
        torch.cuda.empty_cache()
        out["archs"][arch] = {
            "tokens": tokens, "tokens_f32": tokens32, "hidden": hidden, **serve_log_stats(log),
            "max_memory_allocated_gb": peak / 1e9,
            "seconds": {"setup": setup_s, "bf16_run": run_s, "f32_check_run": f32_s}}
    out["pbs_kernel_launches"] = platform.launch_counts()
    return out


def first_differences(params, cfg, ctx, reqs, one, runs, extras=None) -> list:
    """Each run of ``runs`` ({rid: tokens}) against the one-rank run ``one``
    up to its first difference, with the one-rank forward's top-2 margin
    there (one forward a bucket over ``one``'s own sequences, fed the
    bucket's ``extras``)."""
    margin = {}
    for plen in sorted({len(r.prompt) for r in reqs}):
        rr = [r for r in reqs if len(r.prompt) == plen]
        seq = torch.tensor([r.prompt + one[r.rid][:-1] for r in rr], dtype=torch.int32,
                           device=DEV)
        kw = forward_inputs((extras or {}).get(plen), len(rr), seq.shape[1], SERVE_BATCH, DEV)
        x = forward(params, seq, ctx, cfg, **kw)[:, plen - 1:]
        top2 = vocab_logits(params["embed"], x, ctx, cfg).topk(2, dim=-1).values
        margin.update(zip((r.rid for r in rr), (top2[..., 0] - top2[..., 1]).cpu()))
        del x, top2
    out = []
    for run in runs:
        compared, near = 0, []
        for r in reqs:
            got, want = run[r.rid], one[r.rid]
            n = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
            compared += len(want) if n is None else n
            if n is not None:
                near.append({"rid": r.rid, "position": n, "margin": float(margin[r.rid][n])})
        out.append({"positions": sum(len(one[r.rid]) for r in reqs),
                    "positions_compared": compared, "differences": near,
                    "margin_tol": MR_SERVE_F32_MARGIN})
    return out


def decode_logit_errors(params, cfg, ctx, requests, tokens, hidden, extras=None) -> dict:
    """A mesh's decode logits (its recorded final-norm states through the
    one-rank unembedding) against the one-rank no-cache forward's over the
    mesh's own sequences (fed each bucket's ``extras``): the largest
    difference over every logit and at the forward's top one, and the
    share of positions each margin of ``MR_REC_MARGINS`` would check (the
    calibration of check (a)'s margin)."""
    err, top, margins = 0.0, 0.0, []
    for plen, x in hidden.items():
        reqs = [r for r in requests if len(r.prompt) == plen]
        seq = torch.tensor([r.prompt + tokens[r.rid][:-1] for r in reqs], dtype=torch.int32,
                           device=DEV)
        kw = forward_inputs((extras or {}).get(plen), len(reqs), seq.shape[1], SERVE_BATCH,
                            DEV)
        want = vocab_logits(params["embed"], forward(params, seq, ctx, cfg, **kw)[:, plen - 1:],
                            ctx, cfg)
        got = vocab_logits(params["embed"], x[:len(reqs)].to(DEV), ctx, cfg)
        err = max(err, float((got - want).abs().max()))
        best = want.argmax(-1, keepdim=True)
        top = max(top, float((got.gather(-1, best) - want.gather(-1, best)).abs().max()))
        top2 = want.topk(2, dim=-1).values
        margins.append((top2[..., 0] - top2[..., 1]).flatten().cpu())
        del want, got
    margins = torch.cat(margins)
    return {"max_abs_logit_err": err, "max_top_logit_err": top,
            "share_checked_by_margin": {str(m): float((margins > m).float().mean())
                                        for m in MR_REC_MARGINS}}


def mr_family_one_rank(dev, seed, served, pieces, archs) -> dict:
    """On rank 0 alone, after every mesh's run, for each family of
    ``archs``: the one-rank float32 run of ``MR_FAMILY_CHECK``, then for
    each mesh of ``served`` check (a) on its float32 tokens
    (``forward_check`` over the mesh's own sequences, one rank, fed the
    same frames or patch rows) with its decode logits against the
    forward's (from every rank's ``pieces`` of recorded states), and check
    (b) against the one-rank run."""
    t0 = time.perf_counter()
    mesh = make_local_mesh(device=dev)
    ctx = mesh_ctx(mesh)
    out = {}
    for arch in archs:
        layers, buckets, margin = MR_FAMILY_CHECK[arch]
        cfg, serve_buckets, max_len, enc_len = mr_family_serving(arch)
        cfg32 = get_config(arch).scaled(n_layers=layers)
        reqs = [r for r in mr_serve_requests(seed, serve_buckets, arch)
                if len(r.prompt) in buckets]
        extras = mr_serve_extras(cfg, serve_buckets, enc_len, seed)
        res = {"meshes": [{"mesh": s["mesh"]} for s in served]}
        params = init_params(model_spec(cfg32, ctx),
                             torch.Generator(device=DEV).manual_seed(seed), mesh.device)
        upcast_(params)
        sched = BatchScheduler(cfg32, mesh, batch=SERVE_BATCH, max_len=max_len, eos_id=-1,
                               enc_len=enc_len)
        one32 = mr_serve_run(sched, params, reqs, cfg32, extras)
        for i, (s, m) in enumerate(zip(served, res["meshes"])):
            toks = s["archs"][arch]["tokens_f32"]
            done = {rid: Completion(rid, t, True) for rid, t in toks.items()}
            m["forward_check"] = forward_check(params, cfg32, ctx, done, reqs, margin,
                                               extras=extras)
            hidden = {}
            for rank_pieces in pieces:
                pc = rank_pieces[i][arch]
                for plen, x in ({} if pc is None else pc["x"]).items():
                    hidden.setdefault(plen, torch.empty((SERVE_BATCH,) + x.shape[1:],
                                                        dtype=x.dtype))
                    hidden[plen][pc["rows"][0]:pc["rows"][1]] = x
            m["decode_logits"] = decode_logit_errors(params, cfg32, ctx, reqs, toks, hidden,
                                                     extras)
        firsts = first_differences(params, cfg32, ctx, reqs, one32,
                                   [s["archs"][arch]["tokens_f32"] for s in served], extras)
        for m, f in zip(res["meshes"], firsts):
            m["f32_check"] = dict(f, n_layers=cfg32.n_layers, margin_tol=near_tie_margin(
                arch, m["decode_logits"]["max_abs_logit_err"]))
        del params, sched, extras
        torch.cuda.empty_cache()
        out[arch] = res
    out["seconds"] = time.perf_counter() - t0
    return out


def mr_rank(dev, checks, timed, seed, wait_for=None, serve=(), moe_serve=(),
            rec_serve=(), front_serve=()) -> dict:
    """A rank of phase multirank: its checks, then its timed runs, then its
    serving runs (``serve``, ``moe_serve``, ``rec_serve``, ``front_serve``:
    meshes), after which rank 0 alone runs the one-rank serving and its
    token checks; with ``wait_for``, only once that file exists (a group
    started early, its start-up beside another group's work)."""
    platform.reset_launch_counts()
    started = time.time()
    while wait_for and not Path(wait_for).exists():
        time.sleep(0.05)
    out = {"started": started,
           "checks": [mr_check_mesh(dev, a, d, m, z, r, seed) for a, (d, m), z, r in checks],
           "timed": [mr_timed_mesh(dev, d, m, z, seed) for (d, m), z in timed],
           "serve": [mr_serve_mesh(dev, d, m, seed) for d, m in serve],
           "moe_serve": [mr_moe_serve_mesh(dev, d, m, seed) for d, m in moe_serve],
           "rec_serve": [mr_family_serve_mesh(dev, d, m, seed, MR_REC_ARCHS)
                         for d, m in rec_serve],
           "front_serve": [mr_family_serve_mesh(dev, d, m, seed, MR_FRONT_ARCHS)
                           for d, m in front_serve]}
    if serve or moe_serve:
        # every rank's route pieces, so rank 0 can put each mesh's routes together
        pieces = [None] * torch.distributed.get_world_size()
        torch.distributed.all_gather_object(pieces, [s.pop("route_piece")
                                                     for s in out["moe_serve"]])
        if torch.distributed.get_rank() == 0:
            if serve:
                out["serve_one_rank"] = mr_serve_one_rank(dev, seed, out["serve"])
            if moe_serve:
                out["moe_one_rank"] = mr_moe_one_rank(dev, seed, out["moe_serve"], pieces)
    for key, archs in (("rec", MR_REC_ARCHS), ("front", MR_FRONT_ARCHS)):
        if not out[f"{key}_serve"]:
            continue
        # every rank's recorded decode states, so rank 0 can read each mesh's logits
        pieces = [None] * torch.distributed.get_world_size()
        torch.distributed.all_gather_object(pieces, [
            {a: s["archs"][a].pop("hidden") for a in archs} for s in out[f"{key}_serve"]])
        if torch.distributed.get_rank() == 0:
            out[f"{key}_one_rank"] = mr_family_one_rank(dev, seed, out[f"{key}_serve"], pieces,
                                                     archs)
    return out


MR_FAMILIES = {"dense": (TRAIN_ARCH,), "moe": (MR_MOE_ARCH,), "recurrent": MR_REC_ARCHS,
               "frontends": MR_FRONT_ARCHS}


def multirank_phase(args, smi, families=tuple(MR_FAMILIES)) -> dict:
    """Training and serving across ranks (``launch.ranks``, ``launch.mesh``,
    the sequence-parallel layers, ZeRO-1, compression, the experts'
    all-to-all), the ranks processes sharing the one card over gloo: two
    ranks for the (1, 2) and (2, 1) checks, timed and serving runs, four for
    the (2, 2) checks.  ``families`` (of ``MR_FAMILIES``) limits the phase
    to the dense, the MoE, the recurrent or the frontend families' runs.
    Returns the timed runs' last-step ledgers, rank by rank: ``{"timed":
    {(mesh, zero1): [ledger, …]}}`` (phase dryrun's ``meta_ledger_check``)."""
    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    root = Path(tempfile.mkdtemp(prefix="multirank_"))
    torch.cuda.empty_cache()
    runs, wall, start_up = {}, {}, {}

    archs = [a for f in families for a in MR_FAMILIES[f]]
    dense = TRAIN_ARCH in archs

    def group(world, wait_for=None):
        checks = [c for c in MR_CHECKS if c[1][0] * c[1][1] == world and c[0] in archs]
        timed = [t for t in MR_TIMED if t[0][0] * t[0][1] == world and dense]
        serve = [m for m in MR_SERVE if m[0] * m[1] == world and dense]
        moe_serve = [m for m in MR_SERVE if m[0] * m[1] == world and MR_MOE_ARCH in archs]
        rec_serve = [m for m in MR_SERVE if m[0] * m[1] == world
                     and set(MR_REC_ARCHS) <= set(archs)]
        front_serve = [m for m in MR_SERVE if m[0] * m[1] == world
                       and set(MR_FRONT_ARCHS) <= set(archs)]
        t0 = time.perf_counter()
        res = run_ranks(mr_rank, world, root / f"w{world}", device=DEV.type,
                        backend=MR_BACKEND,
                        args=(checks, timed, args.seed, wait_for, serve, moe_serve,
                              rec_serve, front_serve),
                        timeout=MR_TIMEOUT_S, threads=None)
        runs[world], wall[world] = res, time.perf_counter() - t0
        start_up[world] = min(r["started"] for r in res) - (time.time() - wall[world])

    # the 4-rank group starts up beside the 2-rank group's work and begins
    # its own once that is done, so the timed runs have the card to themselves
    go = root / "go4"
    with ThreadPoolExecutor(1) as pool:
        four = pool.submit(group, 4, str(go))
        try:
            group(2)
        finally:
            go.touch()
        four.result()
    checks = [r["checks"] for w in (2, 4) for r in runs[w]]
    # every rank checked its own shards: the worst over the ranks of a mesh
    worst = {}
    for per_rank in checks:
        for c in per_rank:
            w = worst.setdefault((c["arch"], tuple(c["mesh"])), dict(c, ranks=0, dropped=0))
            w["dropped"] += c["moe_dispatch"].get("dropped", 0)
            w["ranks"] += 1
            for k in ("loss_rel_err", "grad_norm_rel_err", "param_max_abs_err"):
                w[k] = max(w[k], c[k])
            if c["worst_grad_rel_err"] > w["worst_grad_rel_err"]:
                w.update(worst_grad_rel_err=c["worst_grad_rel_err"],
                         worst_grad_leaf=c["worst_grad_leaf"])
    lead = list(worst.values())
    for c in lead:
        assert c["dropped"] == 0, f"{c['arch']} {c['mesh']} dropped {c['dropped']} pairs"
        assert c["loss_rel_err"] <= MR_LOSS_RTOL, c
        assert c["grad_norm_rel_err"] <= MR_LOSS_RTOL, c
        assert c["worst_grad_rel_err"] <= MR_GRAD_REL, c
        assert c["param_max_abs_err"] <= MR_PARAM_ATOL, c
    pbs = {}
    for w in (2, 4):
        for r in runs[w]:
            for c in (r["checks"] + r["timed"] + r["serve"] + r["moe_serve"] + r["rec_serve"]
                      + r["front_serve"]):
                for k, v in c["pbs_kernel_launches"].items():
                    pbs[k] = pbs.get(k, 0) + v
    assert not pbs, pbs                           # no PBS kernel on this path
    timed = []
    for i, (mesh_, zero1) in enumerate(MR_TIMED if dense else ()):   # two ranks each
        per = [r["timed"][i] for r in runs[2]]
        timed.append({"mesh": list(mesh_), "zero1": zero1,
                      "per_rank": [{k: t[k] for k in (
                          "rank", "setup_s", "step_ms", "step_ms_median_warm",
                          "collective_ms_median_warm",
                          "max_memory_allocated_gb", "losses")} for t in per],
                      "collective_ms_by_op_rank0": per[0]["collective_ms_by_op"],
                      "collective_bytes_a_step_rank0": per[0]["collective_bytes_a_step"],
                      "ledgers": [t["ledger_last_step"] for t in per]})
    if dense:
        serve_report(smi, runs[2], pbs)
    if MR_MOE_ARCH in archs:
        moe_serve_report(smi, runs[2], pbs)
    if set(MR_REC_ARCHS) <= set(archs):
        family_serve_report(smi, runs[2], pbs, MR_REC_ARCHS, "rec", "serve_recurrent")
    if set(MR_FRONT_ARCHS) <= set(archs):
        family_serve_report(smi, runs[2], pbs, MR_FRONT_ARCHS, "front", "serve_frontends")
    emit({"phase": "multirank", "gpu": smi, "backend": MR_BACKEND, "cards": cards,
          "ranks_share_one_card": cards == 1,
          "worlds": {str(w): [[c[0], list(c[1])] for c in MR_CHECKS
                             if c[1][0] * c[1][1] == w and c[0] in archs]
                     for w in (2, 4)},
          "note": "ranks are processes sharing one card over gloo (host memory); no "
                  "collective time here is an NVLink or NCCL figure, no step a scaling one",
          "check": {"configs": {a: dict(MR_CHECK_CONFIG[a], d_model=get_config(a).scaled(
                        **MR_CHECK_CONFIG[a]).d_model) for a in archs},
                    "reduced": {MR_MOE_ARCH: "d_model 5120 -> 1024, moe_d_ff 1536 -> 512, "
                                             "60 -> 2 layers (the float32 training state of "
                                             "one full-width MoE layer is ~60 GB)",
                                TRAIN_ARCH: f"28 -> {MR_CHECK_LAYERS} layers",
                                "recurrentgemma-2b": "26 -> 3 layers (one period)",
                                "mamba2-780m": "48 -> 2 layers",
                                "whisper-tiny": "none: full width, 4 + 4 layers, 4 x 448 "
                                                "tokens beside 1 500 frames",
                                "pixtral-12b": "d_model 5120 -> 1024, d_ff 14336 -> 2048, "
                                               "40 -> 2 layers (a full-width 2-layer "
                                               "one-rank float32 step is ~30 GB beside "
                                               "(2, 1)'s two ZeRO-1 ranks); 4 x 512 with "
                                               "384 patch positions"},
                    "rows_x_seq": [MR_CHECK_ROWS, MR_CHECK_SEQ], "dtype": "float32",
                    "state": "carried",
                    "tolerances": {"loss_rel": MR_LOSS_RTOL, "grad_rel_to_leaf_max": MR_GRAD_REL,
                                   "params_abs": MR_PARAM_ATOL},
                    "meshes": [{k: c[k] for k in (
                        "arch", "mesh", "zero1", "compression", "ranks", "loss", "loss_one_rank",
                        "loss_rel_err", "grad_norm_rel_err", "worst_grad_leaf",
                        "worst_grad_rel_err", "param_max_abs_err", "dropped", "seconds",
                        "collectives")} for c in lead],
                    "max_memory_allocated_gb": {
                        f"{c['arch']} {c['mesh']}": [
                            cc["max_memory_allocated_gb"] for per in checks for cc in per
                            if (cc["arch"], cc["mesh"]) == (c["arch"], c["mesh"])]
                        for c in lead}},
          "timed": {"config": f"{TRAIN_ARCH} {MR_TIMED_LAYERS} layers, bfloat16, "
                              f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, microbatch "
                              f"{TRAIN_MICROBATCH}, float32 states",
                    "runs": timed},
          "ranks_s": wall, "start_up_s": start_up,
          "pbs_kernel_launches": pbs,
          "multirank_phase_s": time.perf_counter() - t_phase})
    return {"timed": {(tuple(t["mesh"]), t["zero1"]): t["ledgers"] for t in timed}}


def moe_serve_report(smi, ranks, pbs) -> None:
    """Phase multirank's MoE serving line, from the 2-rank group's results,
    with its assertions: every rank of a mesh returned the same tokens, the
    float32 runs dropped no pair, check (b) holds (``MR_MOE_MARGIN``, the
    route rule, half the positions; first differences from the one-rank run
    near ties)."""
    one = ranks[0]["moe_one_rank"]
    meshes = []
    for i, mesh_ in enumerate(MR_SERVE):
        per = [r["moe_serve"][i] for r in ranks]
        for p in per[1:]:
            assert p["tokens"] == per[0]["tokens"] and p["tokens_f32"] == per[0]["tokens_f32"]
        dropped32 = sum(p["dispatch_f32"]["dropped"] for p in per)
        assert dropped32 == 0, f"the checked runs dropped {dropped32} pairs at capacity"
        check, cmp = one["meshes"][i]["forward_check"], one["meshes"][i]["one_rank_compare"]
        assert check["checked_mismatches"] == 0, check
        assert check["positions_checked"] * 2 >= check["positions"], check
        assert check["route_flips_at_clear_gap"] == 0, check
        assert max(check["route_flip_share_by_moe_layer"]) <= ROUTE_FLIP_CEILING, check
        assert all(d["near_tie"] for d in cmp["differences"]), cmp
        meshes.append({
            "mesh": list(mesh_), **rank_timings(per),
            "dispatch_bf16_run": [r["dispatch"] for r in per],
            "dispatch_f32_check": [r["dispatch_f32"] for r in per],
            "forward_check": check, "one_rank_compare": cmp})
    bf16 = [m["tokens"] for m in ranks[0]["moe_serve"]]          # (1, 2)'s, (2, 1)'s
    pairs = [(a, b) for rid in bf16[0] for a, b in zip(bf16[0][rid], bf16[1][rid])]
    full = get_config(MR_MOE_ARCH)
    emit({"phase": "multirank", "step": "serve_moe", "gpu": smi, "backend": MR_BACKEND,
          "note": "ranks are processes sharing one card over gloo (host memory); no "
                  "collective time here is an NVLink or NCCL figure",
          "config": {"arch": MR_MOE_ARCH, "n_layers": MR_MOE_LAYERS, "d_model": full.d_model,
                     "n_experts": full.n_experts, "top_k": full.moe_top_k,
                     "n_shared_experts": full.n_shared_experts, "dtype": "bfloat16",
                     "capacity_factor": full.capacity_factor,
                     "weights": "torch.Generator seed --seed, drawn leaf by leaf, each rank "
                                "keeping its shard",
                     "reduced": f"n_layers {full.n_layers} -> {MR_MOE_LAYERS} (the "
                                "script's budget)",
                     "f32_check_layers": MR_MOE_CHECK_LAYERS,
                     "f32_check_bucket": MR_MOE_CHECK_BUCKET},
          "traffic": {"buckets": [{"prompt_tokens": p, "requests": n}
                                  for p, n in MR_SERVE_BUCKETS],
                      "max_new": MR_SERVE_MAX_NEW, "batch": SERVE_BATCH,
                      "max_len": MR_SERVE_MAX_LEN,
                      "reduced": "model_serve's 3 buckets and 32 new tokens -> 2 and 16"},
          "tolerances": {"f32_margin": MR_MOE_MARGIN, "route_gap": ROUTE_GAP_TOL,
                         "route_flip_ceiling": ROUTE_FLIP_CEILING,
                         "near_tie_margin": MR_SERVE_F32_MARGIN},
          "bf16_tokens_equal_across_meshes": sum(a == b for a, b in pairs) / len(pairs),
          "meshes": meshes, "one_rank_s": one["seconds"],
          "pbs_kernel_launches": pbs})


def family_serve_report(smi, ranks, pbs, archs, key, step) -> None:
    """Phase multirank's serving line of the families ``archs`` (the
    recurrent or the frontend ones, ``key`` their results'), from the 2-rank
    group's results, with its assertions: every rank of a mesh returned the
    same tokens, and checks (a) and (b) of ``MR_FAMILY_CHECK`` hold for
    each family on each mesh."""
    one = ranks[0][f"{key}_one_rank"]
    meshes, failed = [], []
    for i, mesh_ in enumerate(MR_SERVE):
        per = [r[f"{key}_serve"][i] for r in ranks]
        row = {"mesh": list(mesh_)}
        for arch in archs:
            pa = [p["archs"][arch] for p in per]
            res = one[arch]["meshes"][i]
            check, f32 = res["forward_check"], res["f32_check"]
            logit_err = res["decode_logits"]["max_abs_logit_err"]
            for what, ok in (
                    ("ranks' tokens", all(p["tokens"] == pa[0]["tokens"]
                                          and p["tokens_f32"] == pa[0]["tokens_f32"]
                                          for p in pa[1:])),
                    ("(a) mismatches", check["checked_mismatches"] == 0),
                    ("(a) margin past twice the logit error",
                     check["margin_tol"] >= 2 * logit_err),
                    ("(a) half the positions", check["positions_checked"] * 2
                     >= check["positions"]),
                    ("(b) near ties", all(d["margin"] <= f32["margin_tol"]
                                          for d in f32["differences"])),
                    ("(b) half the positions", f32["positions_compared"] * 2
                     >= f32["positions"])):
                if not ok:
                    failed.append(f"{arch} {list(mesh_)}: {what}")
            row[arch] = {**rank_timings(pa), "forward_check": check, "f32_check": f32,
                         "decode_logits": res["decode_logits"]}
        meshes.append(row)
    config = {}
    for a in archs:
        cfg, buckets, max_len, enc_len = mr_family_serving(a)
        full = get_config(a)
        config[a] = {"n_layers": cfg.n_layers, "d_model": cfg.d_model, "dtype": "bfloat16",
                     "reduced": (f"n_layers {full.n_layers} -> {cfg.n_layers} (the script's "
                                 "budget)" if cfg.n_layers < full.n_layers else None),
                     "check": dict(zip(("f32_layers", "f32_buckets", "margin"),
                                       MR_FAMILY_CHECK[a])),
                     "traffic": {"buckets": [{"prompt_tokens": p, "requests": n}
                                             for p, n in buckets],
                                 "max_new": MR_SERVE_MAX_NEW, "batch": SERVE_BATCH,
                                 "max_len": max_len,
                                 "enc_len": enc_len if cfg.family == "encdec" else None}}
    emit({"phase": "multirank", "step": step, "gpu": smi, "backend": MR_BACKEND,
          "note": "ranks are processes sharing one card over gloo (host memory); no "
                  "collective time here is an NVLink or NCCL figure",
          "config": config,
          "weights": "torch.Generator seed --seed, drawn leaf by leaf, each rank keeping "
                     "its shard",
          "traffic_reduced": "model_serve's 3 buckets and 32 new tokens -> 2 and 16",
          "tolerances": {"near_tie_margin": {a: "MR_SERVE_F32_MARGIN" if a not in MR_FRONT_ARCHS
                                             else "twice the run's decode logit error"
                                             for a in archs}},
          "meshes": meshes, "failed": failed, "one_rank_s": one["seconds"],
          "pbs_kernel_launches": pbs})
    assert not failed, failed


def serve_report(smi, ranks, pbs) -> None:
    """Phase multirank's serving line (an earlier line than the phase's
    own), from the 2-rank group's results, with its assertions: every rank
    of a mesh returned the same tokens, checks (a) and (b) of
    ``MR_SERVE_MARGIN`` / ``MR_SERVE_F32_MARGIN`` hold, no PBS kernel."""
    one = ranks[0]["serve_one_rank"]
    meshes = []
    for i, mesh_ in enumerate(MR_SERVE):
        per = [r["serve"][i] for r in ranks]
        for p in per[1:]:
            assert p["tokens"] == per[0]["tokens"] and p["tokens_f32"] == per[0]["tokens_f32"]
        check, f32 = one["meshes"][i]["forward_check"], one["meshes"][i]["f32_check"]
        assert check["checked_mismatches"] == 0, check
        assert check["positions_checked"] * 2 >= check["positions"], check
        assert all(d["margin"] <= MR_SERVE_F32_MARGIN for d in f32["differences"]), f32
        assert f32["positions_compared"] * 2 >= f32["positions"], f32
        meshes.append({
            "mesh": list(mesh_), **rank_timings(per),
            "forward_check": check,
            "tokens_equal_one_rank": one["meshes"][i]["tokens_equal_one_rank"],
            "first_difference_by_request": one["meshes"][i]["first_difference_by_request"],
            "f32_check": f32})
    emit({"phase": "multirank", "step": "serve", "gpu": smi, "backend": MR_BACKEND,
          "note": "ranks are processes sharing one card over gloo (host memory); no "
                  "collective time here is an NVLink or NCCL figure",
          "config": {"arch": TRAIN_ARCH, "n_layers": MR_SERVE_LAYERS,
                     "reduced": f"n_layers {get_config(TRAIN_ARCH).n_layers} -> "
                                f"{MR_SERVE_LAYERS} (the script's budget)",
                     "d_model": get_config(TRAIN_ARCH).d_model, "dtype": "bfloat16",
                     "weights": "torch.Generator seed --seed, every rank the same, sharded",
                     "f32_check_layers": MR_CHECK_LAYERS},
          "traffic": {"buckets": [{"prompt_tokens": p, "requests": n}
                                  for p, n in MR_SERVE_BUCKETS],
                      "max_new": MR_SERVE_MAX_NEW, "batch": SERVE_BATCH,
                      "max_len": MR_SERVE_MAX_LEN,
                      "reduced": "model_serve's 3 buckets and 32 new tokens -> 2 and 16"},
          "tolerances": {"bf16_margin": MR_SERVE_MARGIN, "f32_margin": MR_SERVE_F32_MARGIN},
          "meshes": meshes, "one_rank_s": one["seconds"],
          "pbs_kernel_launches": pbs})


TRAIN_SMOKE_ARCHS = ("qwen2-1.5b", "internlm2-1.8b", "qwen3-14b", "command-r-35b",
                     "recurrentgemma-2b", "mamba2-780m", "deepseek-v2-236b",
                     "deepseek-v3-671b", "whisper-tiny", "pixtral-12b")


# ---------------------------------------------------------------------------
# the dry-run grid and its roofline, held against the card (phase dryrun)
# ---------------------------------------------------------------------------

# the whole 40-cell grid on meta tensors (repro_torch.launch.dryrun), and
# DRYRUN_MESH_CELLS on both production meshes, take at most this long
DRYRUN_GRID_BUDGET_S = 120
# one cell a family counted on rank 0 of the meta (16, 16) and (2, 16, 16)
# meshes, beside the one-card grid: one process of the grid's counts them all
# (``MESH_CELLS_JOB``), sharing its warm-up and its memo, started third
DRYRUN_MESH_CELLS = (("qwen2-1.5b", "train_4k"), ("deepseek-v3-671b", "train_4k"),
                     ("deepseek-v2-236b", "decode_32k"), ("mamba2-780m", "long_500k"),
                     ("whisper-tiny", "prefill_32k"), ("pixtral-12b", "decode_32k"))
DRYRUN_MESHES = {"pod": 256, "multipod": 512}
MESH_CELLS_JOB = """
import sys
from pathlib import Path
from repro_torch.launch import dryrun
memo = {}
for arch, shape in %r:
    for multi_pod in (False, True):
        dryrun.run_cell(arch, shape, multi_pod=multi_pod, out_dir=Path(sys.argv[1]),
                        opt_overrides={}, memo=memo)
""" % (DRYRUN_MESH_CELLS,)
# (b): cells at a reduced batch, each predicted on meta tensors and then
# run once for real on the card; (arch, shape, batch, why this one).  The
# fourth, qwen2-1.5b train_4k at TRAIN_BATCH, is phase model_train's f32 run
DRYRUN_CHECKS = (
    ("qwen2-1.5b", "prefill_32k", 1, "the blockwise pair loop at full length"),
    ("qwen2-1.5b", "decode_32k", 8, "a full 32 k cache read"),
    ("mamba2-780m", "long_500k", 1, "the one sub-quadratic decode at 524 288"),
)
DRYRUN_REPS = 3


def counted_flops(step) -> int:
    """The flops ``FlopCounterMode`` counts over one call of ``step``."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        result = step()
    del result
    return counter.get_total_flops()


def dryrun_prediction(arch: str, shape: str, batch: int, memo=None, **build) -> dict:
    """The dry run's count of one cell at ``batch`` rows (meta tensors): its
    flops, bytes and peak, the roofline terms on one card and the model's
    flops over the roofline step (``roofline_fraction``)."""
    info = SHAPES[shape]
    _, roo, times = dryrun.count_cell(arch, shape, make_local_mesh(device="meta"), memo,
                                      batch=batch, **build)
    compute_s = roo["flops_global"] / PEAK_BF16_FLOPS
    memory_s = roo["bytes_global"] / HBM_BYTES_PER_S
    step_s = max(compute_s, memory_s)
    mf = dryrun.model_flops(arch, info["kind"], batch, info["seq"])
    return {"flops": int(roo["flops_global"]), "bytes": roo["bytes_global"],
            "peak_bytes": roo["peak_bytes_per_device"],
            "argument_bytes": roo["argument_bytes_per_device"],
            "compute_s": compute_s, "memory_s": memory_s, "step_s": step_s,
            "bound": "compute_s" if compute_s >= memory_s else "memory_s",
            "model_flops": mf, "roofline_fraction": mf / PEAK_BF16_FLOPS / step_s,
            "count_s": times}


def cell_on_card(arch: str, shape: str, batch: int, seed: int):
    """The cell's step function and a maker of its arguments on the card:
    weights drawn from ``seed`` by the model's init law, random tokens, and
    a decode's zeroed caches at the cell's last position (fresh ``"len"``s a
    call: decode advances them)."""
    cfg = get_config(arch)
    seq = SHAPES[shape]["seq"]
    cell = build_cell(arch, shape, make_local_mesh(device="meta"), batch=batch)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    params = init_params(model_spec(cfg, mesh_ctx(make_local_mesh())), gen, DEV)
    if cell.kind == "prefill":
        tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen, device=DEV,
                               dtype=torch.int32)
        return cell, lambda: (params, {"tokens": tokens})
    caches = init_params(cache_spec(cfg, make_local_mesh(), batch, seq, ENC_LEN), gen, DEV)
    tokens = torch.randint(0, cfg.vocab, (batch, 1), generator=gen, device=DEV,
                           dtype=torch.int32)
    return cell, lambda: (params, at_position(caches, seq - 1), tokens)


def measured_cell(arch: str, shape: str, batch: int, seed: int) -> dict:
    """One cell's step on the card: a warm-up call under ``FlopCounterMode``
    (its flops), then DRYRUN_REPS calls timed with CUDA events, their peak
    read above what was allocated before the arguments were made."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    cell, make_args = cell_on_card(arch, shape, batch, seed)
    flops = counted_flops(lambda: cell.fn(*make_args()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(DRYRUN_REPS):
        args = make_args()
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        marks[0].record()
        out = cell.fn(*args)
        marks[1].record()
        torch.cuda.synchronize()
        ms.append(marks[0].elapsed_time(marks[1]))
        del out, args
    peak = torch.cuda.max_memory_allocated() - before
    del cell, make_args
    torch.cuda.empty_cache()
    return {"step_ms": ms, "step_ms_median": float(np.median(ms)), "peak_bytes": peak,
            "flops": flops}


def dryrun_check(arch: str, shape: str, batch: int, why: str, predicted: dict,
                 measured: dict, reduced: str) -> dict:
    """Prediction against the card: flops equal, the peak within PEAK_RTOL,
    the step no faster than the roofline allows."""
    peak_rel = predicted["peak_bytes"] / measured["peak_bytes"] - 1
    row = {"arch": arch, "shape": shape, "batch": batch, "why": why, "reduced": reduced,
           "predicted": predicted, "measured": measured,
           "flops_equal": predicted["flops"] == measured["flops"],
           "peak_rel_err": peak_rel, "peak_rtol": PEAK_RTOL,
           "roofline_step_ms": predicted["step_s"] * 1e3,
           "roofline_fraction": predicted["roofline_fraction"],
           "bound_share": predicted["step_s"] * 1e3 / measured["step_ms_median"]}
    emit({"phase": "dryrun", "step": "check", **row})
    assert row["flops_equal"], (arch, shape, predicted["flops"], measured["flops"])
    assert abs(peak_rel) <= PEAK_RTOL, (arch, shape, peak_rel)
    assert measured["step_ms_median"] >= row["roofline_step_ms"], (arch, shape, row)
    return row


# processes of the grid at once: every core but the main process's (the
# kernels' three nvcc share them for their first seconds; the grid, not the
# build, is what the first timed phase waits for).  The archs with routed
# experts go first, a process a shape: they take longest
DRYRUN_GRID_PROCS = max(1, (os.cpu_count() or 8) - 1)
DRYRUN_GRID_FIRST = ("deepseek-v3-671b", "deepseek-v2-236b")


def start_dryrun_grid(out_dir: Path) -> dict:
    """Start the 40-cell grid: ``python -m repro_torch.launch.dryrun --arch
    <arch> --out out_dir``, one process an arch (a shape, for
    DRYRUN_GRID_FIRST), and DRYRUN_MESH_CELLS on both production meshes in
    one more (``MESH_CELLS_JOB``, ``run_cell`` as ``--both-meshes`` runs
    it), at most DRYRUN_GRID_PROCS at once, the card hidden from them
    (``CUDA_VISIBLE_DEVICES`` empty: the dry run needs none).  They count
    on the host while the kernels build and their sweeps run, which
    nothing times; ``dryrun_grid`` waits for them before the first timed
    phase.  Each one's lines go to ``out_dir/<job>.log``;
    ``stop_dryrun_grid`` ends them."""
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = list(dict.fromkeys(arch for arch, _ in all_cells()))
    for arch, shape in all_cells():
        (out_dir / f"{arch}__{shape}__card.json").unlink(missing_ok=True)
    for arch, shape in DRYRUN_MESH_CELLS:
        for mesh in DRYRUN_MESHES:
            (out_dir / f"{arch}__{shape}__{mesh}.json").unlink(missing_ok=True)
    grid_cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--out", str(out_dir)]
    # the archs with routed experts a process a shape, the mesh cells next,
    # then the rest an arch a process
    jobs = [(f"{arch}__{shape}", grid_cmd + ["--arch", arch, "--shape", shape])
            for arch in DRYRUN_GRID_FIRST for shape in SHAPES]
    jobs.append(("mesh_cells", [sys.executable, "-c", MESH_CELLS_JOB, str(out_dir)]))
    jobs += [(arch, grid_cmd + ["--arch", arch]) for arch in archs
             if arch not in DRYRUN_GRID_FIRST]
    path = [str(ROOT / "src")] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(path)}
    grid = {"out_dir": out_dir, "jobs": [name for name, _ in jobs], "logs": {}, "procs": {},
            "stop": False, "lock": threading.Lock(), "t0": time.perf_counter()}

    def run():
        for name, argv in jobs:
            while sum(p.poll() is None for p in grid["procs"].values()) >= DRYRUN_GRID_PROCS:
                time.sleep(0.05)
            with grid["lock"]:
                if grid["stop"]:
                    return
                grid["logs"][name] = open(out_dir / f"{name}.log", "w")
                grid["procs"][name] = subprocess.Popen(
                    argv, stdout=grid["logs"][name], stderr=subprocess.STDOUT, env=env,
                    cwd=ROOT)
        for proc in grid["procs"].values():
            proc.wait()
        grid["wall_s"] = time.perf_counter() - grid["t0"]

    grid["waiter"] = threading.Thread(target=run, daemon=True)
    grid["waiter"].start()
    return grid


def stop_dryrun_grid(grid: dict) -> None:
    with grid["lock"]:
        grid["stop"] = True
    for proc in grid["procs"].values():
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    for log in grid["logs"].values():
        log.close()


def dryrun_grid(grid: dict) -> dict:
    """Wait for the grid ``start_dryrun_grid`` started (its wall from the
    first start to the last exit, torch's imports included, at most
    DRYRUN_GRID_BUDGET_S) and read its 40 records and the production
    meshes' records of DRYRUN_MESH_CELLS: each ``ok`` on its mesh's world,
    with a collective term."""
    grid["waiter"].join(max(0.0, grid["t0"] + DRYRUN_GRID_BUDGET_S - time.perf_counter()))
    if grid["waiter"].is_alive():
        stop_dryrun_grid(grid)
        raise AssertionError(f"the dry-run grid ran past {DRYRUN_GRID_BUDGET_S} s")
    stop_dryrun_grid(grid)
    assert list(grid["procs"]) == grid["jobs"], (list(grid["procs"]), grid["jobs"])
    for name, proc in grid["procs"].items():
        log = (grid["out_dir"] / f"{name}.log").read_text()
        assert proc.returncode == 0, (name, proc.returncode, log[-4000:])
    grid_s = grid["wall_s"]
    recs = [json.loads((grid["out_dir"] / f"{arch}__{shape}__card.json").read_text())
            for arch, shape in all_cells()]
    rows = []
    for r in recs:
        row = {"arch": r["arch"], "shape": r["shape"], "status": r["status"]}
        if r["status"] == "ok":
            roo = r["roofline"]
            row.update(flops=r["hlo"]["flops_global"], bytes=r["hlo"]["bytes_global"],
                       peak_gb=r["memory"]["peak_bytes_per_device"] / 1e9,
                       compute_s=roo["compute_s"], memory_s=roo["memory_s"],
                       collective_s=roo["collective_s"], bound=roo["bound"],
                       seconds=r["times"]["build"] + r["times"]["count"])
        rows.append(row)
    status = [r["status"] for r in recs]
    mesh_cells = []
    for arch, shape in DRYRUN_MESH_CELLS:
        for mesh, chips in DRYRUN_MESHES.items():
            r = json.loads((grid["out_dir"] / f"{arch}__{shape}__{mesh}.json").read_text())
            assert (r["status"], r["chips"]) == ("ok", chips), (arch, shape, mesh, r)
            roo, disp = r["roofline"], r["meta"].get("moe_dispatch", {})
            mesh_cells.append({
                "arch": arch, "shape": shape, "mesh": mesh, "chips": chips,
                "compute_s": roo["compute_s"], "memory_s": roo["memory_s"],
                "collective_s": roo["collective_s"], "bound": roo["bound"],
                "peak_gb": r["memory"]["peak_bytes_per_device"] / 1e9,
                "fits_h100": r["memory"]["fits_h100"],
                "collective_by_op": r["hlo"]["collective_by_op_per_device"],
                "pairs": disp.get("pairs", 0), "dropped": disp.get("dropped", 0),
                "seconds": r["times"]["build"] + r["times"]["count"]})
            assert roo["collective_s"] > 0, (arch, shape, mesh, roo)
    emit({"phase": "dryrun", "step": "grid", "cells": rows, "grid_s": grid_s,
          "cells_s": sum(r.get("seconds", 0.0) for r in rows),
          "mesh_cells": mesh_cells,
          "budget_s": DRYRUN_GRID_BUDGET_S, "ok": status.count("ok"),
          "skipped": status.count("skipped"), "records": str(grid["out_dir"])})
    assert status.count("ok") == 32 and status.count("skipped") == 8, status
    assert grid_s <= DRYRUN_GRID_BUDGET_S, grid_s
    return {"grid_s": grid_s, "mesh_cells": mesh_cells}


def meta_ledger_check(timed: dict) -> dict:
    """The meta count of phase multirank's timed (1, 2) training step (no
    ZeRO-1), at its shapes, rank by rank, against the ledger its two real
    ranks recorded on the card (``timed``: multirank_phase's ledgers of
    each timed mesh): per op, calls, bytes in and ring bytes equal."""
    t0 = time.perf_counter()
    real = timed[((1, 2), False)]
    cfg = get_config(TRAIN_ARCH).scaled(n_layers=MR_TIMED_LAYERS)
    per_rank = []
    for rank, got in enumerate(real):
        mesh = make_local_mesh(1, 2, device="meta", rank=rank)
        cell = build_cell(TRAIN_ARCH, "train_4k", mesh, cfg=cfg, batch=TRAIN_BATCH,
                          seq=TRAIN_SEQ, microbatch=TRAIN_MICROBATCH,
                          opt_cfg=OptConfig(**TRAIN_OPT, zero1=False))
        analyze_step(cell.fn, cell.args, mesh=mesh, host=cell.host)
        meta = {k: {f: v[f] for f in LEDGER_CHECKED} for k, v in mesh.ledger.items()}
        per_rank.append({"rank": rank, "meta": meta, "card": got, "equal": meta == got})
    row = {"arch": TRAIN_ARCH, "mesh": [1, 2], "layers": MR_TIMED_LAYERS,
           "batch_x_seq": [TRAIN_BATCH, TRAIN_SEQ], "microbatch": TRAIN_MICROBATCH,
           "ranks": per_rank, "seconds": time.perf_counter() - t0}
    emit({"phase": "dryrun", "step": "meta_ledger", **row})
    for r in per_rank:
        assert r["equal"], r
    return row


def mr_timed_ledgers(seed: int) -> dict:
    """Phase multirank's timed (1, 2) training step alone (two ranks
    sharing the card over gloo): its ledgers, as ``multirank_phase``
    returns them."""
    root = Path(tempfile.mkdtemp(prefix="timed_"))
    res = run_ranks(mr_rank, 2, root / "w2", device=DEV.type, backend=MR_BACKEND,
                    args=([], [((1, 2), False)], seed), timeout=MR_TIMEOUT_S, threads=None)
    return {((1, 2), False): [r["timed"][0]["ledger_last_step"] for r in res]}


def dryrun_phase(args, smi, train, grid, timed) -> None:
    """The dry run on the card's host, and its predictions held against the
    card: (a) the 40-cell grid on meta tensors and DRYRUN_MESH_CELLS on the
    production meshes (``grid``: ``dryrun_grid``'s result, read before the
    paths ran); (b) the cells of DRYRUN_CHECKS, and phase model_train's f32
    run (``train``), each predicted at its reduced batch and run for real;
    (c) the meta count of phase multirank's timed (1, 2) step against its
    ranks' ledgers (``timed``, ``meta_ledger_check``).  No PBS kernel
    launches (the launch counts must read 0)."""
    t_phase = time.perf_counter()
    platform.reset_launch_counts()
    total = torch.cuda.get_device_properties(0).total_memory
    assert 0.95 * HBM_BYTES <= total <= HBM_BYTES, (total, HBM_BYTES)
    memo: dict = {}
    run = train["run"]
    rows = [dryrun_check(
        TRAIN_ARCH, "train_4k", TRAIN_BATCH, "phase model_train's f32 run, re-used",
        train["prediction"],
        {"step_ms": run["step_ms"][1:], "step_ms_median": run["step_ms_median_warm"],
         "peak_bytes": run["peak_above_start_bytes"], "flops": run["counted_step_flops"]},
        f"batch 256 -> {TRAIN_BATCH}, microbatch {TRAIN_MICROBATCH}")]
    for arch, shape, batch, why in DRYRUN_CHECKS:
        predicted = dryrun_prediction(arch, shape, batch, memo)
        measured = measured_cell(arch, shape, batch, args.seed)
        full = SHAPES[shape]["batch"]
        rows.append(dryrun_check(arch, shape, batch, why, predicted, measured,
                                 f"batch {full} -> {batch}" if batch != full else "none"))
    ledger = meta_ledger_check(timed)
    pbs = platform.launch_counts()
    assert not pbs, pbs                      # the dry run launches no PBS kernel
    emit({"phase": "dryrun", "gpu": smi, "grid_s": grid["grid_s"],
          "mesh_cells": [{k: c[k] for k in (
              "arch", "shape", "mesh", "compute_s", "memory_s", "collective_s", "bound",
              "peak_gb", "dropped")} for c in grid["mesh_cells"]],
          "meta_ledger_equal": all(r["equal"] for r in ledger["ranks"]),
          "total_memory": total, "hbm_bytes": HBM_BYTES,
          "checks": [{k: r[k] for k in ("arch", "shape", "batch", "flops_equal",
                                        "peak_rel_err", "roofline_step_ms",
                                        "roofline_fraction", "bound_share")}
                     for r in rows],
          "pbs_kernel_launches": pbs, "dryrun_phase_s": time.perf_counter() - t_phase})


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

    grid_run = None
    if not args.kernels_only:       # the dry-run grid counts beside the build and sweeps
        grid_run = start_dryrun_grid(ROOT / "chiprun_out" / "dryrun")
        atexit.register(stop_dryrun_grid, grid_run)
    t0 = time.perf_counter()
    libs = platform.build_kernels(verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(p.name for p in libs.values())})
    sass = {**sass_inner_loops(libs["tow_sketch"]), **sass_inner_loops(libs["bin_xorsum"])}
    emit({"phase": "sass", "tow_sketch_inner_loops": [
        {"kernel": k, "NS": ns, **v}
        for (k, ns), v in sorted(i for i in sass.items() if i[0][0].startswith("tow_"))],
        "bin_parity_xorsum_inner_loops": [
            {"kernel": k, "table": t, **v} for (k, t), v in sass.items()
            if not k.startswith("tow_")]})

    kernel_sweeps(rng)
    if not args.kernels_only:
        grid = dryrun_grid(grid_run)
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
            launches["obs"], launched["obs"] = obs_phase(sessions, serve_results)
            launches["examples"], launched["examples"] = examples_phase()
        del sessions, serve_results, trees
        model_serve_phase(args, smi)
        train = model_train_phase(args, smi)
        multirank = multirank_phase(args, smi)
        dryrun_phase(args, smi, train, grid, multirank["timed"])
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
