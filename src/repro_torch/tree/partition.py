"""Recursive range-partition front end for unknown/adversarial d (§15).

PBS needs a sane d̂; a cold-start peer, a replica returning after long
downtime, or an adversarially divergent one (d ≈ |A|) sits outside the
ToW-estimator operating regime (``EstimateOutOfRange``).  Following the
divide-and-conquer family of tree reconciliation algorithms, the front end
splits the 32-bit key space into a binary range tree and walks it level by
level: each frontier range gets a cheap digest — element count, 32-bit
checksum, and a small-ℓ ToW sketch — and the per-range verdict is

* ``TREE_PRUNE``   — digests agree: no symmetric difference in the range,
* ``TREE_LEAF``    — divergent with small residual d̂: hand the range to
  PBS as an ordinary known-d session,
* ``TREE_RECURSE`` — divergent and still hot: split in half and go deeper.

A whole level's digests are one batched ``tree_digest`` kernel sweep (rows
and row length keyed at ``pow2_bucket`` shapes so the variant ledger stays
warm across frontiers, DESIGN.md §12): the in-process walk stacks
both sides into a single launch per level, the wire peers run one launch
per side.  Residual d̂ per range reuses the phase-0 estimator algebra
(numerator Σ(ΔY)², ``planned_d`` inflation) capped by the range's total
element count, which also guarantees termination: once a range's width —
halved every level — drops under ``leaf_d``, its count bound forces a leaf
verdict, so depth never exceeds ``KEY_BITS - floor(log2(leaf_d))`` even
for adversarially clustered keys (uniform pairs leaf out around
``log2(gamma * d / leaf_d)`` levels).  Byte accounting mirrors the wire:
``digest_bytes`` is the exact framed size of the ``MSG_TREE`` digest +
verdict exchange — transport-side overhead, split from the PBS Formula-(1)
ledger bits the leaf sessions report.

On the device: ``range_bounds``, the checksums and the verdicts stay numpy
on the host — keys live on the device as int32 bit patterns, whose signed
order is not the uint32 order, so no search or sort runs there.  Each side's
sorted keys are uploaded once per walk, and every level hands the ranges'
``(lo, count)`` host arrays to ``kernels.tree_digest_ranges``: on the card
its ragged kernel reads only the ranges' keys, with no padded level matrix;
on the CPU it packs the reference's padded ``(2·rows, width)`` matrix
(``_range_rows``) and runs the plain version.  Either way the launch and
variant ledgers read as the reference's, keyed by the padded shape: one
``tree_digest`` launch per level, ``retraces == 0`` on a warm re-walk.
``device=None`` means the CUDA card and raises without one.
"""
from __future__ import annotations

from dataclasses import dataclass, replace as _dc_replace

import numpy as np
import torch

from ..core.hashing import derive_seed
from ..core.pbs import KEY_BITS, PBSConfig
from ..core.sets import unique_keys
from ..core.tow import GAMMA, planned_d, tow_seeds, tow_sketches
from ..kernels.platform import pow2_bucket, resolve_device, retrace_count, upload
from ..kernels.tree_digest import range_rows as _range_rows  # noqa: F401 (the padded gather)
from ..kernels.tree_digest import tree_digest_ranges
from ..obs.trace import NULL_TRACER
from ..recon.server import ReconcileServer
from ..wire import frames as wf

SPAN = 1 << KEY_BITS
_TREE_SEED_TAG = 0x7EE  # domain-separates tree digests from phase-0 ToW


@dataclass(frozen=True)
class TreeConfig:
    """Tree-phase parameters; both peers must hold identical values
    (positional contract, like ``PBSConfig``/``d_known`` on sessions).

    ``ell`` is the per-range sketch length (small: range digests only need
    a coarse residual d̂, not phase-0 precision); ``leaf_d`` is the planned
    d̂ at or below which a divergent range goes to PBS; ``max_depth`` hard-
    caps recursion (any still-divergent range leafs out there).
    """

    ell: int = 32
    leaf_d: int = 48
    gamma: float = GAMMA
    max_depth: int = KEY_BITS
    seed: int = 0
    row_floor: int = 8     # pow2_bucket floor for frontier rows
    tile: int = 512        # kernel element-tile (and row-length floor)


@dataclass(frozen=True)
class TreeLeaf:
    """One divergent range handed to PBS: ``[lo, hi)`` with planned d."""

    lo: int
    hi: int
    d_plan: int


@dataclass
class TreeStats:
    """Walk ledger: one entry per ``partition_pair``/tree phase."""

    levels: int = 0         # digest-exchange barriers executed
    depth: int = 0          # deepest level index reached (root = 0)
    leaves: int = 0
    pruned: int = 0
    recursed: int = 0
    max_frontier: int = 0
    digest_bytes: int = 0   # framed MSG_TREE digest + verdict bytes
    launches: int = 0       # tree_digest kernel launches
    retraces: int = 0       # new executor variants during the walk

    def as_dict(self) -> dict:
        return {
            "tree_levels": self.levels,
            "tree_leaves": self.leaves,
            "tree_digest_bytes": self.digest_bytes,
        }


def tree_seeds(tcfg: TreeConfig) -> np.ndarray:
    """The walk's shared ToW seed family (distinct from phase 0's)."""
    return tow_seeds(derive_seed(tcfg.seed, _TREE_SEED_TAG), tcfg.ell)


def split_ranges(frontier, verdicts) -> list[tuple[int, int]]:
    """Next level's frontier: every ``TREE_RECURSE`` range halved, in
    range order — the deterministic rule both peers apply to stay
    frontier-aligned without ever shipping range bounds."""
    nxt: list[tuple[int, int]] = []
    for (lo, hi), v in zip(frontier, verdicts):
        if v == wf.TREE_RECURSE:
            mid = (lo + hi) // 2
            nxt.append((lo, mid))
            nxt.append((mid, hi))
    return nxt


def range_bounds(elems: np.ndarray, frontier) -> tuple[np.ndarray, np.ndarray]:
    """(lo_idx, hi_idx) slice bounds of each frontier range in a sorted
    key array (int64 search: ``hi`` may be 2**32)."""
    los = np.array([lo for lo, _ in frontier], dtype=np.int64)
    his = np.array([hi for _, hi in frontier], dtype=np.int64)
    return np.searchsorted(elems, los), np.searchsorted(elems, his)


def _checksums(prefix: np.ndarray, lo_idx, hi_idx) -> np.ndarray:
    """Per-range ``core.pbs.checksum`` (sum mod 2**32) from a prefix-sum."""
    return ((prefix[hi_idx] - prefix[lo_idx]) & np.uint64(0xFFFFFFFF)).astype(
        np.int64
    )


def _checksum_prefix(elems: np.ndarray) -> np.ndarray:
    return np.concatenate(
        [np.zeros(1, np.uint64), np.cumsum(elems, dtype=np.uint64)]
    )


def level_digests(
    elems: np.ndarray,
    frontier,
    tcfg: TreeConfig,
    *,
    device=None,
    launches: dict | None = None,
    prefix: np.ndarray | None = None,
):
    """One side's frontier digests: (counts, checksums, (R, ell) sketches).

    One ``tree_digest`` launch for the whole frontier, keyed at
    ``pow2_bucket`` rows and row length so repeat walks meet no new variant
    (``stats["retraces"] == 0`` after warmup).
    """
    dev = resolve_device(device)
    lo_idx, hi_idx = range_bounds(elems, frontier)
    counts = (hi_idx - lo_idx).astype(np.int64)
    if prefix is None:
        prefix = _checksum_prefix(elems)
    csums = _checksums(prefix, lo_idx, hi_idx)
    n_r = len(frontier)
    rows = pow2_bucket(n_r, tcfg.row_floor)
    width = pow2_bucket(max(int(counts.max()) if n_r else 1, 1), tcfg.tile)
    lo = np.zeros(rows, dtype=np.int64)
    cnt = np.zeros(rows, dtype=np.int64)
    lo[:n_r], cnt[:n_r] = lo_idx, counts
    sk = tree_digest_ranges(
        upload(np.asarray(elems, dtype=np.uint32), dev), lo, cnt,
        upload(tree_seeds(tcfg), dev), ell=tcfg.ell, width=width, tile=tcfg.tile,
    )
    if launches is not None:
        launches["kernel_launches"] = launches.get("kernel_launches", 0) + 1
    return counts, csums, sk[:n_r].cpu().numpy().astype(np.int64)


def level_digests_ref(elems: np.ndarray, frontier, tcfg: TreeConfig):
    """Pure-host oracle of ``level_digests`` (per-range ``tow_sketches``
    loop) — the differential baseline of tests/test_torch_tree.py."""
    lo_idx, hi_idx = range_bounds(elems, frontier)
    counts = (hi_idx - lo_idx).astype(np.int64)
    csums = _checksums(_checksum_prefix(elems), lo_idx, hi_idx)
    seed = derive_seed(tcfg.seed, _TREE_SEED_TAG)
    sk = np.zeros((len(frontier), tcfg.ell), dtype=np.int64)
    for r in range(len(frontier)):
        sk[r] = tow_sketches(elems[lo_idx[r] : hi_idx[r]], seed, tcfg.ell)
    return counts, csums, sk


def level_verdicts(
    level: int,
    cnt_a, cs_a, sk_a,
    cnt_b, cs_b, sk_b,
    tcfg: TreeConfig,
):
    """Per-range verdicts + leaf d plans, deterministic from both digest
    sets — the responder computes this and ships it in a ``TREE_VERDICT``
    frame; the in-process walk calls it directly.

    The planned leaf d is the phase-0 estimator algebra at tree ℓ
    (``planned_d(Σ(ΔY)²/ℓ, gamma)``) clamped to ``[1, cnt_a + cnt_b]`` —
    the clamp both tightens trivially-small ranges and forces every range
    to leaf out once halving shrinks its element count under ``leaf_d``.
    """
    cnt_a = np.asarray(cnt_a, dtype=np.int64)
    cnt_b = np.asarray(cnt_b, dtype=np.int64)
    num = np.sum((np.asarray(sk_a) - np.asarray(sk_b)) ** 2, axis=1)
    equal = (cnt_a == cnt_b) & (np.asarray(cs_a) == np.asarray(cs_b)) & (num == 0)
    d_plan = np.array(
        [planned_d(n / tcfg.ell, tcfg.gamma) for n in num], dtype=np.int64
    )
    d_plan = np.maximum(np.minimum(d_plan, cnt_a + cnt_b), 1)
    width = SPAN >> level
    at_floor = level >= tcfg.max_depth or width <= 1
    leaf = ~equal & (at_floor | (d_plan <= tcfg.leaf_d))
    verdicts = np.full(len(num), wf.TREE_RECURSE, dtype=np.int64)
    verdicts[equal] = wf.TREE_PRUNE
    verdicts[leaf] = wf.TREE_LEAF
    return verdicts, d_plan[leaf]


def partition_pair(
    set_a: np.ndarray,
    set_b: np.ndarray,
    tree: TreeConfig | None = None,
    *,
    device=None,
    tracer=None,
) -> tuple[list[TreeLeaf], TreeStats]:
    """In-process tree walk over both sides -> (PBS leaves, stats).

    Both sides' frontier digests ride ONE stacked kernel launch per level
    (wire peers run one launch per side, ≤ 2 per level either way); the
    ``digest_bytes`` ledger is the exact framed ``MSG_TREE`` exchange the
    wire flow would ship for the same pair.
    """
    dev = resolve_device(device)
    tcfg = tree or TreeConfig()
    tracer = tracer if tracer is not None else NULL_TRACER
    a = unique_keys(np.asarray(set_a, dtype=np.uint32))
    b = unique_keys(np.asarray(set_b, dtype=np.uint32))
    stats = TreeStats()
    retrace_mark = retrace_count()
    prefix_a, prefix_b = _checksum_prefix(a), _checksum_prefix(b)
    seeds = upload(tree_seeds(tcfg), dev)
    keys = upload(np.concatenate([a, b]), dev)    # b's keys start at len(a)
    frontier: list[tuple[int, int]] = [(0, SPAN)]
    leaves: list[TreeLeaf] = []
    level = 0
    while frontier:
        stats.levels += 1
        stats.depth = level
        stats.max_frontier = max(stats.max_frontier, len(frontier))
        n_r = len(frontier)
        with tracer.span("tree.level.dispatch", level=level, ranges=n_r):
            lo_a, hi_a = range_bounds(a, frontier)
            lo_b, hi_b = range_bounds(b, frontier)
            cnt_a = (hi_a - lo_a).astype(np.int64)
            cnt_b = (hi_b - lo_b).astype(np.int64)
            rows = pow2_bucket(n_r, tcfg.row_floor)
            width = pow2_bucket(
                max(int(max(cnt_a.max(), cnt_b.max())) if n_r else 1, 1),
                tcfg.tile,
            )
            lo = np.zeros(2 * rows, dtype=np.int64)
            cnt = np.zeros(2 * rows, dtype=np.int64)
            lo[:n_r], cnt[:n_r] = lo_a, cnt_a
            lo[rows : rows + n_r], cnt[rows : rows + n_r] = lo_b + len(a), cnt_b
            sk = tree_digest_ranges(  # one launch: both sides stacked
                keys, lo, cnt, seeds, ell=tcfg.ell, width=width, tile=tcfg.tile
            )
            stats.launches += 1
        with tracer.span("tree.level.collect", level=level, ranges=n_r):
            sk = sk.cpu().numpy().astype(np.int64)
            sk_a, sk_b = sk[:n_r], sk[rows : rows + n_r]
            cs_a = _checksums(prefix_a, lo_a, hi_a)
            cs_b = _checksums(prefix_b, lo_b, hi_b)
            verdicts, leaf_ds = level_verdicts(
                level, cnt_a, cs_a, sk_a, cnt_b, cs_b, sk_b, tcfg
            )
            # ledger: the framed exchange the wire peers would ship
            stats.digest_bytes += len(
                wf.encode_tree_digest(level, cnt_a, cs_a, sk_a)
            ) + len(wf.encode_tree_verdict(level, verdicts, leaf_ds))
            for (lo, hi), v, dp in _iter_leaves(frontier, verdicts, leaf_ds):
                leaves.append(TreeLeaf(lo=lo, hi=hi, d_plan=int(dp)))
            stats.pruned += int(np.sum(verdicts == wf.TREE_PRUNE))
            stats.recursed += int(np.sum(verdicts == wf.TREE_RECURSE))
            frontier = split_ranges(frontier, verdicts)
        level += 1
    stats.leaves = len(leaves)
    stats.retraces = retrace_count() - retrace_mark
    return leaves, stats


def _iter_leaves(frontier, verdicts, leaf_ds):
    """Yield ((lo, hi), verdict, d_plan) for each TREE_LEAF in range order."""
    li = 0
    for (lo, hi), v in zip(frontier, verdicts):
        if v == wf.TREE_LEAF:
            yield (lo, hi), v, leaf_ds[li]
            li += 1


def leaf_slices(elems: np.ndarray, leaves) -> list[np.ndarray]:
    """Each leaf range's slice of a sorted key array, leaf order."""
    lo_idx, hi_idx = range_bounds(
        elems, [(leaf.lo, leaf.hi) for leaf in leaves]
    )
    return [elems[lo_idx[i] : hi_idx[i]] for i in range(len(leaves))]


@dataclass
class TreeResult:
    """Outcome of a full tree+PBS reconciliation (``tree_reconcile``).

    ``diff`` is the union of every leaf session's recovered symmetric
    difference — the same set ``core.pbs.reconcile`` reports for the whole
    pair.  ``tree_bytes`` (framed ``MSG_TREE`` exchange) is transport-side;
    ``pbs_bytes`` is the leaf sessions' Formula-(1) ledger sum.
    """

    diff: set
    success: bool
    leaves: list[TreeLeaf]
    stats: TreeStats
    results: dict
    tree_bytes: int
    pbs_bytes: int

    @property
    def total_bytes(self) -> int:
        return self.tree_bytes + self.pbs_bytes

    def bytes_per_diff(self) -> float:
        return self.total_bytes / max(1, len(self.diff))


def tree_reconcile(
    set_a: np.ndarray,
    set_b: np.ndarray,
    cfg: PBSConfig | None = None,
    tree: TreeConfig | None = None,
    *,
    device=None,
    rateless: bool = False,
    recorder=None,
    tracer=None,
) -> TreeResult:
    """Full cold-start reconciliation: tree front end, then every leaf as
    an ordinary known-d PBS session fused into one ``ReconcileServer``
    batch (graceful degradation on, so an underestimated leaf escalates
    instead of failing).  ``rateless=True`` arms the ``MSG_PARITY``
    recovery ladder (DESIGN.md §16) on every leaf session: a leaf whose
    tree-estimated d̂ undershot recovers in-round by extending its BCH
    sketches instead of burning a doubled-d̂ re-plan — degradation stays
    on as the fallback past the extension cap.  Publishes the
    ``server.tree_*`` metrics.
    """
    dev = resolve_device(device)
    cfg = cfg or PBSConfig()
    if rateless and not cfg.rateless:
        cfg = _dc_replace(cfg, rateless=True)
    a = unique_keys(np.asarray(set_a, dtype=np.uint32))
    b = unique_keys(np.asarray(set_b, dtype=np.uint32))
    leaves, stats = partition_pair(a, b, tree, device=dev, tracer=tracer)
    server = ReconcileServer(
        device=dev, degrade=True, recorder=recorder, tracer=tracer
    )
    results: dict = {}
    diff: set = set()
    success = True
    pbs_bytes = 0
    if leaves:
        for a_sub, b_sub, leaf in zip(
            leaf_slices(a, leaves), leaf_slices(b, leaves), leaves
        ):
            server.submit(a_sub, b_sub, cfg, d_known=leaf.d_plan)
        results = server.run()
        for res in results.values():
            diff |= res.diff
            success = success and res.success
            pbs_bytes += res.bytes_sent
    server.recorder.publish(
        "server",
        dict(
            stats.as_dict(),
            tree_bytes_per_diff=(stats.digest_bytes + pbs_bytes)
            / max(1, len(diff)),
        ),
    )
    return TreeResult(
        diff=diff,
        success=success,
        leaves=leaves,
        stats=stats,
        results=results,
        tree_bytes=stats.digest_bytes,
        pbs_bytes=pbs_bytes,
    )
