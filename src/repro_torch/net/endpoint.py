"""Alice/Bob PBS endpoints: the wire-separated halves of the protocol,
ported from the reference package's ``net.endpoint`` onto the port's
device pipeline (each endpoint's stores, encodes and decodes live on its
``device``: None = the CUDA card, which raises without one).

Each endpoint owns exactly one side's data and device pipeline:

* ``AliceEndpoint`` holds the A sets, runs phase 0 (ToW sketch out, d_hat
  numerator back), encodes her per-unit BCH sketches each round through the
  single-side cohort executor (``recon.engine.encode_side`` over her
  device-resident ``SessionBatch(sides=("a",))`` stores), applies the
  shared ``core.pbs.apply_round_outcomes`` to Bob's reply frames, and ships
  the checksum verdicts back as outcome frames.
* ``BobEndpoint`` mirrors the session/unit state machine from the frames
  alone: his own decode failures drive ``queue_split`` exactly like
  Alice's, and her outcome frames supply the checksum-settled flags he
  cannot compute (he never sees A).  His side batches the same way —
  encode his sketches per cohort, XOR with the frame-decoded sketches,
  ``bch_decode_batched`` for every unit of a cohort in one call.

Byte ledgers are *measured*: every ``bytes_per_round`` entry an endpoint
reports is derived from the frames that crossed the transport (via the
``repro_torch.wire`` ledger-bit helpers on decoded content), then asserted equal
to the Formula-(1) accounting the in-process oracle computes — so
``ReconcileResult.bytes_sent`` from this path is a wire measurement that
happens to equal ``core.pbs.reconcile``'s ledger exactly.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..core.hashing import derive_seed
from ..core.sets import unique_keys
from ..core.pbs import (
    MAX_PARITY_EXTENSIONS,
    PBSConfig,
    ReconcileResult,
    apply_round_outcomes,
    checksum,
    effective_set,
    finalize_result,
    new_session_state,
    parity_extension_t,
    plan_from_d_known,
    plan_from_estimate,
    queue_split,
)
from ..core.tow import (
    ESTIMATE_LIMIT_FRAC,
    check_estimate,
    estimate_numerator,
    planned_d,
    tow_sketches,
)
from ..kernels.ops import bch_decode_batched
from ..kernels.platform import resolve_device, upload
from ..obs import NULL_TRACER, Recorder
from ..recon.engine import encode_side, encode_side_ext
from ..recon.session import (
    CohortRoundPlan,
    ReconSession,
    SessionBatch,
    advance_session,
    apply_churn,
    degrade_exhausted,
)
from ..tree.partition import (
    SPAN,
    TreeConfig,
    TreeLeaf,
    leaf_slices,
    level_digests,
    level_verdicts,
    split_ranges,
)
from ..wire import frames as wf
from ..wire.frames import ReplyUnit, WireError
from ..wire.varint import framed_len

from .transport import FrameStream, Transport

_EMPTY = np.zeros(0, dtype=np.uint32)

_ROUND_ARRAY_KEYS = (
    "row_map", "unit_valid", "seeds", "removed", "removed_cnt",
    "added", "added_cnt", "fseeds", "fbins", "fcnt",
)


@dataclass
class _SessionRows:
    """One live session's slice of its cohort's device outputs this round."""

    sess: ReconSession
    active: list
    bin_seed: int
    sk: np.ndarray        # (U, t) int32 syndromes
    xors: np.ndarray      # (U, n) uint32 bin XOR folds
    csum: np.ndarray      # (U,) uint32 unit checksums
    plan: CohortRoundPlan


def _upload_arrays(plan: CohortRoundPlan, device: torch.device) -> list:
    """One host->device copy per round-plan array, in executor order."""
    return [upload(plan.arrays[k], device) for k in _ROUND_ARRAY_KEYS]


def encode_round_rows(
    plans: list[CohortRoundPlan],
    side: str,
    device: torch.device,
    launches: dict | None = None,
) -> dict[int, _SessionRows]:
    """Dispatch every cohort's single-side executor, then collect per-session
    row slices (every cohort is enqueued on the stream before the first
    readback, so cohorts overlap).  ``device`` is where the stores live.
    Shared by the pair endpoints and the multi-peer hub — the hub's
    ``plans`` span all peers' sessions, so the two launches per cohort are
    fused across peers.

    ``launches`` (if given) is bumped at the dispatch site — one
    ``encode_side`` call is one bin-kernel launch plus one sketch matmul —
    so the hub's fusion stats measure dispatches, not planner bookkeeping.
    """
    inflight = []
    for plan in plans:
        store = plan.store
        ss = store.sides[side]
        sk, xors, csum = encode_side(
            ss.flat, ss.start, ss.cnt,
            *_upload_arrays(plan, device),
            n=store.n,
            t=store.t,
            width=plan.width_a if side == "a" else plan.width_b,
        )
        if launches is not None:
            launches["kernel_launches"] = launches.get("kernel_launches", 0) + 2
        # sketches, XOR folds and checksums are all int32 and row-aligned:
        # one packed device->host copy per cohort at collect time
        inflight.append((plan, torch.cat([sk, xors, csum[:, None]], dim=1)))
    per: dict[int, _SessionRows] = {}
    for plan, packed in inflight:
        t, n = plan.store.t, plan.store.n
        host = packed.cpu().numpy()
        sk = np.ascontiguousarray(host[:, :t])
        # XOR folds and checksums are int32 bit patterns of uint32 values
        xors = np.ascontiguousarray(host[:, t : t + n]).view(np.uint32)
        csum = np.ascontiguousarray(host[:, t + n]).view(np.uint32)
        for sess, base, active, bin_seed in plan.members:
            rows = slice(base, base + len(active))
            per[sess.sid] = _SessionRows(
                sess, active, bin_seed, sk[rows], xors[rows], csum[rows], plan
            )
    return per


def encode_round_rows_ext(
    plans: list[CohortRoundPlan],
    side: str,
    level: int,
    device: torch.device,
    launches: dict | None = None,
) -> dict[int, tuple]:
    """Dispatch every cohort's *incremental* single-side executor for one
    rateless ladder level (DESIGN.md §16) and collect per-session slices.

    Per cohort the syndrome matmul covers only columns
    [t_{level-1}·m, t_level·m) of the (n, t_level) code — the
    ``MSG_PARITY`` payload.  Cohorts whose t-ladder cannot grow at this
    level (the (n-1)//2 code cap) are skipped.  Shared by the pair
    endpoints and the multi-peer hub, which passes plans spanning all
    peers so the two launches per cohort stay fused across peers.

    Returns sid -> (inc (U, t1-t0) int array, t0, t1).
    """
    inflight = []
    for plan in plans:
        store = plan.store
        n, t = store.n, store.t
        t0 = parity_extension_t(t, level - 1, n)
        t1 = parity_extension_t(t, level, n)
        if t1 <= t0:
            continue
        ss = store.sides[side]
        out = encode_side_ext(
            ss.flat, ss.start, ss.cnt,
            *_upload_arrays(plan, device),
            n=n, t0=t0, t1=t1,
            width=plan.width_a if side == "a" else plan.width_b,
        )
        if launches is not None:
            launches["kernel_launches"] = launches.get("kernel_launches", 0) + 2
        inflight.append((plan, t0, t1, out))
    per: dict[int, tuple] = {}
    for plan, t0, t1, out in inflight:
        inc = out.cpu().numpy()
        for sess, base, active, _ in plan.members:
            per[sess.sid] = (inc[base : base + len(active)], t0, t1)
    return per


def round_schema(per: dict[int, _SessionRows], live: list[int]):
    """The frame schema for the given sids, in the given order: both wire
    sides derive it from the same deterministic round state, so frames ship
    no redundant structure (DESIGN.md §9)."""
    return [
        (len(per[sid].active), per[sid].plan.store.t, per[sid].plan.store.m)
        for sid in live
    ]


def serve_phase0(payload: bytes, set_b, cfg: PBSConfig,
                 limit_frac: float | None = ESTIMATE_LIMIT_FRAC):
    """Answer one peer's phase-0 ToW sketch frame (the serving side).

    Returns (d_hat reply frame, the pinned ProtocolPlan, estimator ledger
    bytes covering both framed messages).  Raises ``EstimateOutOfRange``
    when the planned d̂ leaves the PBS operating regime for the pair's
    size (``limit_frac=None`` disables — the legacy burn-the-budget
    behavior); the tree front end (§15) is the route for such pairs.
    Shared by ``BobEndpoint`` and the multi-peer hub so the two serving
    paths cannot drift.
    """
    set_size_a, sk_a = wf.decode_tow_sketch(payload)
    if len(sk_a) != cfg.ell:
        raise WireError(
            f"peer sent {len(sk_a)} ToW sketches, cfg.ell={cfg.ell}"
        )
    sk_b = tow_sketches(set_b, derive_seed(cfg.seed, 0x70), cfg.ell)
    num = estimate_numerator(sk_a, sk_b)
    reply = wf.encode_dhat(num)
    est_bytes = _framed_len(payload) + len(reply)
    plan = plan_from_estimate(cfg, num, set_size_a)
    check_estimate(
        planned_d(plan.d_est, cfg.gamma), set_size_a + len(set_b), limit_frac
    )
    return reply, plan, est_bytes


def tree_walk_state(elems, cfg: PBSConfig, tcfg: TreeConfig) -> dict:
    """Fresh serving-side tree-walk state (§15): the staged set plus the
    root frontier, the level clock, and the leaf accumulator."""
    return {
        "elems": elems, "cfg": cfg, "tcfg": tcfg,
        "frontier": [(0, SPAN)], "level": 0, "leaves": [], "bytes": 0,
    }


def serve_tree_frame(payload: bytes, walk: dict, stream, tally: dict,
                     tracer, device, launches: dict | None = None) -> bool:
    """Serve one inbound ``MSG_TREE`` digest frame (the serving side's half
    of one tree-walk level, §15); returns True when the walk completed.

    Digest our own frontier — one ``tree_digest_ranges`` launch on
    ``device``, ledgered in ``launches`` if given — compute
    the verdicts (the serving side holds both digest sets), ship them back,
    and advance the frontier by the shared deterministic split rule.
    Accumulates ``TREE_LEAF`` ranges into ``walk["leaves"]`` and the framed
    exchange bytes into both ``tally["tree"]`` and ``walk["bytes"]``.
    Shared by ``BobEndpoint`` and the multi-peer hub so the two serving
    paths cannot drift.
    """
    elems, tcfg, frontier = walk["elems"], walk["tcfg"], walk["frontier"]
    level, ell, cnt_a, cs_a, sk_a = wf.decode_tree_digest(payload)
    if level != walk["level"]:
        raise WireError(
            f"tree digest for level {level} at level {walk['level']}"
        )
    if ell != tcfg.ell:
        raise WireError(f"tree digest ell {ell}, configured {tcfg.ell}")
    if len(cnt_a) != len(frontier):
        raise WireError(
            f"tree digest covers {len(cnt_a)} ranges, "
            f"frontier has {len(frontier)}"
        )
    tally["tree"] += _framed_len(payload)
    walk["bytes"] += _framed_len(payload)
    with tracer.span("tree.level.dispatch", cat="device",
                     level=level, ranges=len(frontier)):
        cnt_b, cs_b, sk_b = level_digests(
            elems, frontier, tcfg, device=device, launches=launches
        )
    with tracer.span("tree.level.collect", cat="wire",
                     level=level, ranges=len(frontier)):
        verdicts, leaf_ds = level_verdicts(
            level, cnt_a, cs_a, sk_a, cnt_b, cs_b, sk_b, tcfg
        )
        reply = wf.encode_tree_verdict(level, verdicts, leaf_ds)
        stream.send(reply)
        tally["tree"] += len(reply)
        walk["bytes"] += len(reply)
        li = 0
        for (lo, hi), v in zip(frontier, verdicts):
            if v == wf.TREE_LEAF:
                walk["leaves"].append(
                    TreeLeaf(lo=lo, hi=hi, d_plan=int(leaf_ds[li]))
                )
                li += 1
        walk["frontier"] = split_ranges(frontier, verdicts)
        walk["level"] = level + 1
    return not walk["frontier"]


def serve_epoch_frame(payload: bytes, expected_epoch: int, pending: dict,
                      plans: dict, cfg_of, stream, tally: dict,
                      limit_frac: float | None = ESTIMATE_LIMIT_FRAC) -> bool:
    """Serve one inbound ``MSG_EPOCH`` frame (the serving side's half of
    the epoch handshake, DESIGN.md §11); returns True when the peer owes
    no more epoch frames.

    ``pending`` maps sid -> (staged set, d convention) for the staged
    epoch; estimator sids (convention None) are served in sorted order —
    the same positional contract as ``submit`` — each wrapped ToW sketch
    answered with a wrapped d̂ reply through the shared ``serve_phase0``,
    recording the plan in ``plans``.  A bare epoch-open is only legal
    when nothing re-estimates, and is answered bare.  Ledger mirrors
    ``MSG_MUX``: inner phase-0 bits to the estimator tally, envelope
    bytes to the epoch tally.  Shared by ``BobEndpoint`` and the hub so
    the two serving paths cannot drift.
    """
    e, ity, ipayload = wf.decode_epoch(payload)
    if e != expected_epoch:
        raise WireError(f"epoch frame for epoch {e}, expected {expected_epoch}")
    est = [
        sid for sid in sorted(pending)
        if pending[sid][1] is None and sid not in plans
    ]
    if ity is None:
        if est:
            raise WireError("bare epoch-open with estimator sessions pending")
        reply = wf.encode_epoch(e)
        stream.send(reply)
        tally["epoch"] += _framed_len(payload) + len(reply)
        return True
    if ity != wf.MSG_TOW_SKETCH:
        raise WireError(f"unexpected epoch inner frame type 0x{ity:02x}")
    if not est:
        raise WireError("epoch ToW frame with no estimator session pending")
    sid = est[0]
    elems, _ = pending[sid]
    inner_reply, plan, est_bytes = serve_phase0(
        ipayload, elems, cfg_of(sid), limit_frac
    )
    reply = wf.encode_epoch(e, inner_reply)
    stream.send(reply)
    tally["estimator"] += est_bytes
    tally["epoch"] += (
        _framed_len(payload) - framed_len(len(ipayload))
        + len(reply) - len(inner_reply)
    )
    plans[sid] = plan
    return len(est) == 1


def decode_side_b_round(
    plans,
    per: dict[int, _SessionRows],
    sk_a_of: dict,
    launches: dict | None = None,
):
    """The serving side's round completion: place each session's
    frame-decoded sketches at its cohort rows, XOR with the resident side,
    run ONE ``bch_decode_batched`` launch per cohort, and build every
    session's reply entry.

    ``sk_a_of`` maps sid -> (U, t) frame sketches; sessions absent from it
    (an evicted hub peer) keep zero rows — padding decodes trivially-ok and
    they are skipped in the result.  The decode runs where the cohort's
    store lives.  Returns (results: sid -> (ok, units),
    ctx: sid -> (sess, active, ok, bin_seed)) — ``ctx`` is what the
    outcome-frame mirror needs.  Shared by ``BobEndpoint`` and the hub; in
    the hub's case ``plans`` span every peer, so the decode launch is fused
    across peers.
    """
    inflight = []
    for plan in plans:
        u_pad = plan.arrays["row_map"].shape[0]
        sk_a = np.zeros((u_pad, plan.store.t), dtype=np.int32)
        sk_b = np.zeros((u_pad, plan.store.t), dtype=np.int32)
        for sess, base, active, _ in plan.members:
            if sess.sid not in sk_a_of:
                continue
            rows = slice(base, base + len(active))
            sk_a[rows] = sk_a_of[sess.sid]
            sk_b[rows] = per[sess.sid].sk
        # the store's device: a serving endpoint holds exactly one side
        device = next(iter(plan.store.sides.values())).flat.device
        out = _decode_packed(sk_a ^ sk_b, plan.store.n, plan.store.t, device)
        if launches is not None:
            launches["decode_launches"] = launches.get("decode_launches", 0) + 1
        inflight.append((plan, out))
    results: dict[int, tuple] = {}
    ctx: dict[int, tuple] = {}
    for plan, out in inflight:
        # ok_pad is a fresh writable array: the rateless ladder merges
        # extension verdicts into the per-session ok views in place (§16)
        ok_pad, pos_pad, cnt_pad = _unpack_decode(out, plan.store.t)
        for sess, base, active, bin_seed in plan.members:
            if sess.sid not in sk_a_of:
                continue
            rows = slice(base, base + len(active))
            row = per[sess.sid]
            ok = ok_pad[rows]
            pos, cnt = pos_pad[rows], cnt_pad[rows]
            units: list[ReplyUnit | None] = []
            for slot in range(len(active)):
                if not ok[slot]:
                    units.append(None)
                    continue
                k = int(cnt[slot])
                p = pos[slot, :k].astype(np.int64)
                units.append(
                    ReplyUnit(
                        positions=p,
                        xors=row.xors[slot, p],
                        csum=int(row.csum[slot]),
                    )
                )
            results[sess.sid] = (ok, units)
            ctx[sess.sid] = (sess, active, ok, bin_seed)
    return results, ctx


def _decode_packed(sk: np.ndarray, n: int, t: int, device) -> torch.Tensor:
    """Enqueue one ``bch_decode_batched`` over the (U, t) difference
    sketches ``sk`` (values below 2^m, sent up as int32); the outcomes are
    packed on the device into one (U, t + 2) int32 tensor — ok, count,
    positions — so the readback is a single device->host copy."""
    ok, pos, cnt = bch_decode_batched(
        upload(np.asarray(sk, dtype=np.int32), device), n=n, t=t
    )
    return torch.cat([ok.to(torch.int32)[:, None], cnt[:, None], pos], dim=1)


def _unpack_decode(packed: torch.Tensor, t: int):
    """Block on one packed decode: (ok bool, positions (U, t), counts)."""
    host = packed.cpu().numpy()
    return host[:, 0] != 0, host[:, 2 : 2 + t], host[:, 1]


def verify_ack_entries(payload: bytes, sessions):
    """Decode a VERIFY frame and compute the serving side's verdicts:
    the peer claims success AND c(A △ D̂) equals our c(B).  Returns
    (ack frame, flags).  Shared by ``BobEndpoint`` and the hub."""
    entries = wf.decode_verify(payload, len(sessions))
    flags = [
        bool(success) and csum_eff == checksum(sess.state.b)
        for sess, (success, csum_eff) in zip(sessions, entries)
    ]
    return wf.encode_verify_ack(flags), flags


def stream_wire_stats(
    stream: FrameStream, tally: dict, carry: dict | None = None
) -> dict:
    """Measured wire traffic of one stream: exact framed bytes by category
    plus the transport totals (which additionally see ARQ and mux-envelope
    overhead, if any).  ``retransmits``/``rto_ms`` surface the ARQ layer's
    adaptive-retry state when the transport has one (DESIGN.md §13);
    ``resume_frame_bytes`` is the resumption tally — handshake, replayed
    frames, and any aborted partial round, all transport overhead, never
    Formula-(1) bits.  ``carry`` adds the transport byte totals of streams
    torn down by earlier resumptions so the counters stay cumulative."""
    t = stream.transport
    carry = carry or {}
    return {
        "frames_out": stream.frames_out,
        "frames_in": stream.frames_in,
        "frame_bytes_out": stream.bytes_out,
        "frame_bytes_in": stream.bytes_in,
        "transport_bytes_out": t.bytes_out + carry.get("transport_bytes_out", 0),
        "transport_bytes_in": t.bytes_in + carry.get("transport_bytes_in", 0),
        "mux_bytes_out": stream.mux_bytes_out,
        "mux_bytes_in": stream.mux_bytes_in,
        "estimator_frame_bytes": tally["estimator"],
        "protocol_frame_bytes": tally["protocol"],
        "verify_frame_bytes": tally["verify"],
        "epoch_envelope_bytes": tally.get("epoch", 0),
        "resume_frame_bytes": tally.get("resume", 0),
        "tree_frame_bytes": tally.get("tree", 0),
        "retransmits": getattr(t, "retransmits", 0) + carry.get("retransmits", 0),
        "rto_ms": getattr(t, "rto_ms", None),
    }


class _Endpoint:
    """Shared plumbing: submissions, cohort batch, side encode, tallies."""

    side: str

    def __init__(
        self,
        transport: Transport,
        *,
        device=None,
        channel: int | None = None,
        continuous: bool = False,
        degrade: bool = False,
        estimate_limit: float | None = ESTIMATE_LIMIT_FRAC,
        recorder: Recorder | None = None,
        tracer=None,
    ):
        self._stream = FrameStream(transport, channel=channel)
        # where this side's stores, encodes and decodes live: None = the
        # CUDA card (raises without one); nothing falls back to the CPU
        self.device = resolve_device(device)
        # launches this side dispatched: ``kernel_launches`` (2 per cohort
        # encode — bin kernel + sketch matmul — and 1 per tree level),
        # ``decode_launches`` (1 per cohort decode)
        self.launches: dict = {"kernel_launches": 0, "decode_launches": 0}
        # telemetry (DESIGN.md §14): wire_stats derives from the recorder's
        # wire.* rows; spans/instants go through the tracer (NULL_TRACER =
        # disabled, free)
        self.recorder = recorder if recorder is not None else Recorder()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._continuous = continuous
        self._degrade = degrade
        # phase-0 operating-regime guard (§15): planned d̂ beyond this
        # fraction of |A| + |B| raises EstimateOutOfRange; None disables
        self._estimate_limit = estimate_limit
        self._sessions: list[ReconSession | None] = []
        self._est_queue: list[int] = []     # sids awaiting phase 0, in order
        self._batch: SessionBatch | None = None
        self._tally = {
            "estimator": 0, "protocol": 0, "verify": 0, "epoch": 0,
            "resume": 0, "tree": 0,
        }
        # tree front end (§15): staged (elems, cfg, tcfg) awaiting the walk,
        # the serving side's in-flight walk state, and the outcome summary
        self._tree: tuple | None = None
        self._tree_walk: dict | None = None
        self.tree_depth = 0
        self.tree_leaves: int | None = None
        self._d_known: dict[int, int | None] = {}
        self._epoch = 0
        self._epoch_pending: dict[int, tuple] | None = None  # sid -> (set, dk)
        self._carry: dict = {}              # totals of resumed-away streams
        self.sessions_degraded = 0          # degradation-ladder escalations
        self.parity_extensions = 0          # rateless ladder levels applied
        self.verified: list[bool] | None = None

    # -- submission ------------------------------------------------------

    def _submit(self, elems, cfg: PBSConfig | None, d_known: int | None):
        cfg = cfg or PBSConfig()
        elems = unique_keys(np.asarray(elems, dtype=np.uint32))
        sid = len(self._sessions)
        self._d_known[sid] = d_known
        if d_known is not None:
            self._install(sid, elems, plan_from_d_known(cfg, d_known), append=True)
        else:
            self._sessions.append(None)
            self._est_queue.append(sid)
            self._pending_store(sid, elems, cfg)
        return sid

    def _install(self, sid, elems, plan, *, append: bool):
        a, b = (elems, _EMPTY) if self.side == "a" else (_EMPTY, elems)
        sess = ReconSession(sid=sid, plan=plan, state=new_session_state(a, b, plan))
        if append:
            self._sessions.append(sess)
        else:
            self._sessions[sid] = sess
        return sess

    def _pending_store(self, sid, elems, cfg):
        raise NotImplementedError

    # -- tree front end (DESIGN.md §15) ----------------------------------

    def submit_tree(self, elems, cfg: PBSConfig | None = None,
                    tree: TreeConfig | None = None) -> None:
        """Stage this endpoint's side of a tree-phase cold start: the walk
        runs before phase 0, and every divergent leaf range becomes an
        ordinary known-d session appended after all regular submits — so
        the peer must ``submit_tree`` its matching side with the same
        ``cfg``/``tree`` (positional contract, like ``submit``)."""
        if self._tree is not None or self._tree_walk is not None:
            raise RuntimeError("a tree phase is already staged")
        if self._batch is not None:
            raise RuntimeError("tree staging after the session batch formed")
        self._tree = (
            unique_keys(np.asarray(elems, dtype=np.uint32)),
            cfg or PBSConfig(),
            tree or TreeConfig(),
        )

    def _collect_leaves(self, frontier, verdicts, leaf_ds, leaves) -> None:
        li = 0
        for (lo, hi), v in zip(frontier, verdicts):
            if v == wf.TREE_LEAF:
                leaves.append(TreeLeaf(lo=lo, hi=hi, d_plan=int(leaf_ds[li])))
                li += 1

    def _install_tree_leaves(self, elems, cfg, leaves, depth: int) -> None:
        self.tree_depth = depth
        self.tree_leaves = len(leaves)
        for sub, leaf in zip(leaf_slices(elems, leaves), leaves):
            self._submit(sub, cfg, d_known=leaf.d_plan)

    # -- round machinery -------------------------------------------------

    def _ensure_batch(self) -> SessionBatch:
        if self._tree is not None or self._tree_walk is not None:
            raise WireError("round traffic before the tree phase completed")
        if self._est_queue:
            raise WireError("round traffic before phase 0 completed")
        if self._batch is None:
            self._batch = SessionBatch(
                self._sessions, sides=(self.side,),
                mutable=self._continuous, tracer=self.tracer,
                device=self.device,
            )
        return self._batch

    # -- continuous sync (DESIGN.md §11) ---------------------------------

    def advance_epoch(self, mutations: dict | None = None, *,
                      d_known: dict | None = None) -> int:
        """Stage the next epoch's sets: the initiating side folds its
        learned diff (replica convergence), then this side's local churn
        from ``mutations`` (sid -> (added, removed)) applies.  ``d_known``
        (sid -> int | None) *rebinds* a session's d convention from this
        epoch on — an int pins d for this and later epochs, ``None``
        returns the session to re-running the d̂ handshake over the wire;
        sessions not mentioned keep their current convention (initially
        the submit-time one).  The epoch itself runs on the next
        ``run_epoch``/``serve_epoch``, which patches the resident stores
        with the net delta in place.  Requires ``continuous=True`` (stores
        packed with mutation lanes).
        """
        if not self._continuous:
            raise RuntimeError("advance_epoch needs continuous=True")
        if self._est_queue or any(s is None for s in self._sessions):
            raise RuntimeError("advance_epoch before the admission epoch ran")
        if self._epoch_pending is not None:
            raise RuntimeError(f"epoch {self._epoch} is already staged")
        muts = mutations or {}
        unknown = (set(muts) | set(d_known or {})) - set(range(len(self._sessions)))
        if unknown:
            # a typo'd sid must not silently drop the caller's churn
            raise KeyError(f"unknown sid(s) {sorted(unknown)} in epoch advance")
        if d_known:
            self._d_known.update(d_known)
        self._epoch += 1
        pending: dict[int, tuple] = {}
        for s in self._sessions:
            added, removed = muts.get(s.sid, (_EMPTY, _EMPTY))
            pending[s.sid] = (
                apply_churn(self._epoch_base(s), added, removed),
                self._d_known[s.sid],
            )
        self._epoch_pending = pending
        return self._epoch

    def _epoch_base(self, sess: ReconSession) -> np.ndarray:
        """This side's set going into the next epoch, before local churn."""
        raise NotImplementedError

    def _encode_round(self, plans: list[CohortRoundPlan]) -> dict[int, _SessionRows]:
        return encode_round_rows(plans, self.side, self.device, self.launches)

    @staticmethod
    def _schema(per: dict[int, _SessionRows], live: list[int]):
        return round_schema(per, live)

    def _expect(self, msg_type: int) -> bytes:
        got, payload = self._stream.recv()
        if got != msg_type:
            raise WireError(f"expected message 0x{msg_type:02x}, got 0x{got:02x}")
        return payload

    @property
    def sessions(self) -> list[ReconSession]:
        return self._sessions

    def _degrade_after(self, rnd: int) -> None:
        """Post-barrier degradation hook: escalate any session whose round
        budget just ran out (both endpoints call this at the same round
        with mirrored state, so their escalations agree; DESIGN.md §13)."""
        if self._degrade:
            escalated = degrade_exhausted(self._ensure_batch(), rnd)
            if escalated:
                self.sessions_degraded += len(escalated)
                self.tracer.instant("endpoint.degrade", round=rnd,
                                    sessions=len(escalated))

    @property
    def wire_stats(self) -> dict:
        """Measured wire traffic: exact framed bytes by category plus the
        transport totals (which additionally see ARQ overhead, if any).

        A derived snapshot of the ``wire.*`` metrics in the recorder —
        same keys and values as the pre-obs ad-hoc dict (DESIGN.md §14).
        """
        self.recorder.publish(
            "wire", stream_wire_stats(self._stream, self._tally, self._carry)
        )
        self.recorder.set("endpoint.resumes", getattr(self, "resumes", 0))
        self.recorder.set("endpoint.sessions_degraded", self.sessions_degraded)
        self.recorder.set("endpoint.parity_extensions", self.parity_extensions)
        return self.recorder.view("wire")


class AliceEndpoint(_Endpoint):
    """The initiating endpoint; learns A △ B for every submitted session."""

    side = "a"

    def __init__(
        self,
        transport: Transport,
        *,
        device=None,
        channel: int | None = None,
        continuous: bool = False,
        degrade: bool = False,
        estimate_limit: float | None = ESTIMATE_LIMIT_FRAC,
        recorder: Recorder | None = None,
        tracer=None,
    ):
        super().__init__(transport, device=device, channel=channel,
                         continuous=continuous, degrade=degrade,
                         estimate_limit=estimate_limit,
                         recorder=recorder, tracer=tracer)
        self._pending: dict[int, tuple] = {}   # sid -> (a, cfg)
        self._fold_diff = True
        # resumption state (DESIGN.md §13): the last completed local round
        # barrier, the rolling transcript digests at that barrier and the
        # one before, the framed outcome bytes of the last barrier (replayed
        # when the hub missed them), and the per-category tally marks the
        # partial-round rollback restores on resume.
        self._rnd = 0
        self._digest = wf.transcript_digest0(0)
        self._digest_prev = self._digest
        self._last_outcome: bytes | None = None
        self._marks = {"protocol": 0, "verify": 0}
        self.resumes = 0

    def _pending_store(self, sid, elems, cfg):
        self._pending[sid] = (elems, cfg)

    def submit(self, set_a, cfg: PBSConfig | None = None, d_known: int | None = None) -> int:
        """Enqueue one session (this endpoint holds ``set_a``); the peer
        must ``submit`` the matching ``set_b`` with the same cfg/d_known in
        the same order — session identity is positional, like the paper's
        out-of-band-agreed hash functions."""
        return self._submit(set_a, cfg, d_known)

    def advance_epoch(self, mutations: dict | None = None, *,
                      d_known: dict | None = None,
                      fold_diff: bool = True) -> int:
        """Stage the next epoch (see ``_Endpoint.advance_epoch``); with
        ``fold_diff`` (the default) each session first folds its learned
        diff into A — replica convergence: A ← A △ D̂ = B — before this
        side's local churn applies."""
        self._fold_diff = fold_diff
        return super().advance_epoch(mutations, d_known=d_known)

    def _epoch_base(self, sess: ReconSession) -> np.ndarray:
        st = sess.state
        return effective_set(st.a, st.diff) if self._fold_diff else st.a

    def run_epoch(self) -> dict[int, ReconcileResult]:
        """Drive one staged epoch over the wire: the ``MSG_EPOCH``
        handshake (epoch id + d̂ re-estimation through the phase-0 codecs),
        an in-place delta patch of the resident stores, then the same
        round/verify machinery as ``run`` — per-epoch results are
        byte-identical to a fresh session over the epoch's sets."""
        if self._epoch_pending is None:
            raise RuntimeError("no epoch staged: call advance_epoch first")
        pending, self._epoch_pending = self._epoch_pending, None
        e = self._epoch
        self.tracer.instant("epoch.open", epoch=e)
        batch = self._ensure_batch()

        est_sids = [sid for sid in sorted(pending) if pending[sid][1] is None]
        sent = {}
        if est_sids:
            for sid in est_sids:
                elems, _ = pending[sid]
                cfg = self._sessions[sid].plan.cfg
                sk = tow_sketches(elems, derive_seed(cfg.seed, 0x70), cfg.ell)
                inner = wf.encode_tow_sketch(sk, len(elems))
                f = wf.encode_epoch(e, inner)
                self._stream.send(f)
                self._tally["epoch"] += len(f) - len(inner)
                sent[sid] = len(inner)
        else:
            f = wf.encode_epoch(e)
            self._stream.send(f)
            self._tally["epoch"] += len(f)

        plans = {}
        for sid in est_sids:
            payload = self._expect(wf.MSG_EPOCH)
            got_e, ity, ipayload = wf.decode_epoch(payload)
            if got_e != e:
                raise WireError(f"epoch frame for epoch {got_e} during epoch {e}")
            if ity != wf.MSG_DHAT:
                raise WireError(
                    f"expected d_hat inside the epoch reply, got {ity}"
                )
            inner_len = framed_len(len(ipayload))
            self._tally["epoch"] += _framed_len(payload) - inner_len
            est_frames = sent[sid] + inner_len
            self._tally["estimator"] += est_frames
            elems, _ = pending[sid]
            plan = plan_from_estimate(
                self._sessions[sid].plan.cfg, wf.decode_dhat(ipayload), len(elems)
            )
            if plan.est_bytes != est_frames:
                raise WireError(
                    f"sid {sid}: epoch estimator frames measure {est_frames} B, "
                    f"accounted {plan.est_bytes} B"
                )
            plans[sid] = plan
        if not est_sids:
            payload = self._expect(wf.MSG_EPOCH)
            got_e, ity, _ = wf.decode_epoch(payload)
            if got_e != e or ity is not None:
                raise WireError(f"bad epoch-open ack for epoch {e}")
            self._tally["epoch"] += _framed_len(payload)

        for sid in sorted(pending):
            elems, dk = pending[sid]
            sess = self._sessions[sid]
            plan = plans.get(sid) or plan_from_d_known(sess.plan.cfg, dk)
            advance_session(batch, sess, plan, new_a=elems, rnd0=0)
        self._reset_rounds()
        return self._run_rounds()

    def run(self) -> dict[int, ReconcileResult]:
        """Drive every session to completion over the wire; sid -> result."""
        if self._epoch_pending is not None:
            raise RuntimeError(
                f"epoch {self._epoch} is staged: call run_epoch, not run"
            )
        self._tree_phase()
        self._phase0()
        self._ensure_batch()
        self._reset_rounds()
        return self._run_rounds()

    def _tree_phase(self) -> None:
        """Drive the staged tree walk (§15): one digest->verdict barrier
        per level — one batched ``tree_digest`` launch a side — then
        install every divergent leaf range as an ordinary known-d session.
        The serving peer mirrors the frontier from the same deterministic
        split rule, so frames never ship range bounds."""
        if self._tree is None:
            return
        elems, cfg, tcfg = self._tree
        self._tree = None
        frontier: list[tuple[int, int]] = [(0, SPAN)]
        leaves: list[TreeLeaf] = []
        level = 0
        while frontier:
            with self.tracer.span("tree.level.dispatch", cat="device",
                                  level=level, ranges=len(frontier)):
                cnt, cs, sk = level_digests(
                    elems, frontier, tcfg, device=self.device,
                    launches=self.launches,
                )
                f = wf.encode_tree_digest(level, cnt, cs, sk)
                self._stream.send(f)
                self._tally["tree"] += len(f)
            with self.tracer.span("tree.level.collect", cat="wire",
                                  level=level, ranges=len(frontier)):
                payload = self._expect(wf.MSG_TREE)
                self._tally["tree"] += _framed_len(payload)
                got, verdicts, leaf_ds = wf.decode_tree_verdict(payload)
                if got != level:
                    raise WireError(
                        f"tree verdict for level {got} at level {level}"
                    )
                if len(verdicts) != len(frontier):
                    raise WireError(
                        f"tree verdict covers {len(verdicts)} ranges, "
                        f"frontier has {len(frontier)}"
                    )
                self._collect_leaves(frontier, verdicts, leaf_ds, leaves)
                frontier = split_ranges(frontier, verdicts)
            level += 1
        self._install_tree_leaves(elems, cfg, leaves, max(level - 1, 0))

    def _reset_rounds(self) -> None:
        """Re-arm the round loop and resumption state for a fresh epoch."""
        self._rnd = 0
        self._digest = wf.transcript_digest0(self._epoch)
        self._digest_prev = self._digest
        self._last_outcome = None
        self._marks = {k: self._tally[k] for k in self._marks}

    def _run_rounds(self) -> dict[int, ReconcileResult]:
        batch = self._ensure_batch()
        tracer = self.tracer
        while True:
            rnd = self._rnd + 1
            plans = batch.plan_round(rnd)
            if not plans:
                break
            with tracer.span("round.encode", cat="device", round=rnd,
                             cohorts=len(plans)):
                per = self._encode_round(plans)
            live = sorted(per)
            schema = self._schema(per, live)

            sk_frame = wf.encode_round_sketches(
                rnd, [(per[sid].sk, per[sid].plan.store.m) for sid in live]
            )
            self._stream.send(sk_frame)
            self._tally["protocol"] += len(sk_frame)

            with tracer.span("round.reply_wait", cat="wire", round=rnd,
                             sessions=len(live)):
                payload = self._expect(wf.MSG_ROUND_REPLY)
            self._tally["protocol"] += _framed_len(payload)
            got_rnd, entries = wf.decode_round_reply(payload, schema)
            if got_rnd != rnd:
                raise WireError(f"reply for round {got_rnd} during round {rnd}")

            # the measured main-reply ledger is snapshotted BEFORE the
            # rateless ladder merges extension outcomes into the entries:
            # an ext-recovered unit's positions are measured once, from the
            # extension reply that actually carried them
            measured_of = {}
            ent_of = {}
            for sid, (ok, units) in zip(live, entries):
                row = per[sid]
                u_cnt = len(row.active)
                t_, m_ = row.plan.store.t, row.plan.store.m
                measured_of[sid] = (
                    wf.sketches_ledger_bits(u_cnt, t_, m_)
                    + wf.reply_ledger_bits(ok, units, m_)
                )
                ent_of[sid] = [np.asarray(ok, dtype=bool).copy(), list(units)]
            ext_bits_of, measured_ext = self._rateless_ladder(
                rnd, plans, per, live, ent_of
            )

            done_lists = []
            for sid in live:
                ok, units = ent_of[sid]
                row = per[sid]
                st, plan = row.sess.state, row.sess.plan
                rloc = rnd - row.sess.rnd0   # local protocol round
                u_cnt = len(row.active)
                n, t, m = plan.n, plan.t, plan.m
                xors_b = np.zeros((u_cnt, n), dtype=np.uint32)
                csum_b = np.zeros(u_cnt, dtype=np.uint64)
                positions = []
                for slot in range(u_cnt):
                    unit = units[slot]
                    if unit is None:
                        positions.append(np.zeros(0, dtype=np.int64))
                        continue
                    positions.append(unit.positions)
                    xors_b[slot, unit.positions] = unit.xors
                    csum_b[slot] = unit.csum
                reply_bits, done = apply_round_outcomes(
                    st, row.active, ok, positions,
                    row.xors, xors_b, row.csum, csum_b,
                    plan=plan, bin_seed=row.bin_seed, rnd=rloc,
                )
                # the measured ledger: sketch bits from what we framed,
                # reply + parity bits from what the frames actually carried
                # — must land exactly on the Formula-(1) accounting
                measured = measured_of[sid] + measured_ext[sid]
                accounted = u_cnt * (t * m + 1) + reply_bits + ext_bits_of[sid]
                if measured != accounted:
                    raise WireError(
                        f"sid {sid} round {rnd}: measured {measured} bits != "
                        f"accounted {accounted}"
                    )
                st.bytes_per_round.append((measured + 7) // 8)
                st.rounds = rloc
                done_lists.append(done)

            out_frame = wf.encode_round_outcome(rnd, done_lists)
            # commit the barrier BEFORE the send: local state is complete, so
            # a transport failure from here on resumes by replaying this
            # frame instead of re-running the round (DESIGN.md §13)
            self._digest_prev = self._digest
            self._digest = wf.fold_transcript(self._digest, rnd, out_frame)
            self._last_outcome = out_frame
            self._rnd = rnd
            self._tally["protocol"] += len(out_frame)
            self._marks = {k: self._tally[k] for k in self._marks}
            self._stream.send(out_frame)
            tracer.instant("round.barrier", round=rnd, epoch=self._epoch)
            self._degrade_after(rnd)

        with tracer.span("verify", sessions=len(self._sessions)):
            self._verify()
        # lossy-channel tail: keep ACKing the peer's retransmits until quiet
        self._stream.transport.linger()
        results = {
            s.sid: finalize_result(s.state, s.plan) for s in self._sessions
        }
        if tracer.enabled:
            # per-session attribution for trace_report: bytes/diff/rounds
            # against the plan's (n, t, d_est) for the Markov comparison
            for sid, r in results.items():
                p = self._sessions[sid].plan
                tracer.instant(
                    "session.result", sid=sid, rounds=r.rounds,
                    diff=len(r.diff), bytes=r.bytes_sent, success=r.success,
                    n=p.n, t=p.t, g=p.g, d_est=p.d_est,
                    channel=self._stream.channel,
                )
        return results

    def _rateless_ladder(self, rnd, plans, per, live, ent_of):
        """Drive the ``MSG_PARITY`` recovery ladder for one round (§16).

        While any rateless session has units whose BCH decode failed and
        its cohort's t can still grow, ship only the incremental syndrome
        columns for the failing units and fold Bob's extension replies
        into ``ent_of`` in place — the merged entries drive the single
        ``apply_round_outcomes`` downstream, so settled units are never
        re-sent and split seeds still derive from this round.  Returns
        per-sid (accounted ext bits, measured ext bits); both stay zero on
        the honest path, which therefore remains byte-identical to the
        ``rateless=False`` wire format.
        """
        ext_bits = {sid: 0 for sid in live}
        measured = {sid: 0 for sid in live}
        fail: dict[int, list[int]] = {}
        for sid in live:
            row = per[sid]
            if not row.sess.plan.cfg.rateless:
                continue
            bad = [s for s in range(len(row.active)) if not ent_of[sid][0][s]]
            if bad:
                fail[sid] = bad
        for level in range(1, MAX_PARITY_EXTENSIONS + 1):
            if not fail:
                break
            part_plans = [
                plan for plan in plans
                if any(sess.sid in fail for sess, *_ in plan.members)
            ]
            inc_of = encode_round_rows_ext(
                part_plans, self.side, level, self.device, self.launches
            )
            parts = [sid for sid in live if sid in fail and sid in inc_of]
            if not parts:
                break  # every failing cohort hit the (n-1)//2 code cap
            blocks = []
            reply_schema = []
            for sid in parts:
                inc, t0, t1 = inc_of[sid]
                m = per[sid].plan.store.m
                blocks.append((inc[fail[sid]], m))
                reply_schema.append((len(fail[sid]), t1, m))
            pf = wf.encode_parity(rnd, level, blocks)
            self._stream.send(pf)
            self._tally["protocol"] += len(pf)
            payload = self._expect(wf.MSG_ROUND_REPLY)
            self._tally["protocol"] += _framed_len(payload)
            got_rnd, ext_entries = wf.decode_round_reply(payload, reply_schema)
            if got_rnd != rnd:
                raise WireError(
                    f"extension reply for round {got_rnd} during round {rnd}"
                )
            for sid, (ok_e, units_e) in zip(parts, ext_entries):
                _, t0, t1 = inc_of[sid]
                m = per[sid].plan.store.m
                slots = fail[sid]
                ext_bits[sid] += len(slots) * ((t1 - t0) * m + 1)
                measured[sid] += wf.parity_ledger_bits(len(slots), t1 - t0, m)
                measured[sid] += wf.reply_ledger_bits(ok_e, units_e, m)
                self.parity_extensions += 1
                self.tracer.instant(
                    "endpoint.parity_extension", sid=sid, round=rnd,
                    level=level, units=len(slots), t=t1,
                )
                ok_m, units_m = ent_of[sid]
                still = []
                for i, slot in enumerate(slots):
                    if ok_e[i]:
                        ok_m[slot] = True
                        units_m[slot] = units_e[i]
                    else:
                        still.append(slot)
                if still:
                    fail[sid] = still
                else:
                    del fail[sid]
        return ext_bits, measured

    def resume(self, transport: Transport) -> None:
        """Reconnect to the hub over a fresh transport after a failure and
        re-align at the last completed round barrier (DESIGN.md §13).

        Rolls any partial-round frame bytes out of the protocol/verify
        tallies into the resume tally (the aborted attempt re-runs, so the
        Formula-(1) ledger must count it exactly once), then runs the
        ``MSG_RESUME`` handshake: we announce our last completed barrier
        and transcript digests; the hub answers with its mirror's barrier.
        Equal barriers must agree on ``digest``; a hub exactly one barrier
        behind (our last outcome frame died in flight) must agree on
        ``digest_prev`` and gets that frame replayed — it applies it
        idempotently from its retained round context.  Anything else means
        divergence or an unresumable peer and raises.  Follow with
        ``resume_run()`` to drive the protocol to completion.
        """
        if self._stream.channel is None:
            raise RuntimeError("resume needs a hub channel-tagged stream")
        if self._last_outcome is None and self._rnd:
            raise RuntimeError("resume before any round barrier completed")
        with self.tracer.span("resume", channel=self._stream.channel,
                              epoch=self._epoch, barrier=self._rnd):
            self._resume(transport)

    def _resume(self, transport: Transport) -> None:
        for cat, mark in self._marks.items():
            spill = self._tally[cat] - mark
            if spill:
                self._tally[cat] = mark
                self._tally["resume"] += spill
        old = self._stream
        t_old = old.transport
        self._carry = {
            "transport_bytes_out": t_old.bytes_out
            + self._carry.get("transport_bytes_out", 0),
            "transport_bytes_in": t_old.bytes_in
            + self._carry.get("transport_bytes_in", 0),
            "retransmits": getattr(t_old, "retransmits", 0)
            + self._carry.get("retransmits", 0),
        }
        stream = FrameStream(transport, channel=old.channel)
        stream.frames_out, stream.frames_in = old.frames_out, old.frames_in
        stream.bytes_out, stream.bytes_in = old.bytes_out, old.bytes_in
        stream.mux_bytes_out = old.mux_bytes_out
        stream.mux_bytes_in = old.mux_bytes_in
        self._stream = stream

        f = wf.encode_resume(
            stream.channel, self._epoch, self._rnd,
            self._digest, self._digest_prev,
        )
        self._stream.send(f)
        payload = self._expect(wf.MSG_RESUME)
        self._tally["resume"] += len(f) + _framed_len(payload)
        ch, epoch, hub_rnd, hub_digest, _ = wf.decode_resume(payload)
        if ch != stream.channel or epoch != self._epoch:
            raise WireError(
                f"resume answer for channel {ch} epoch {epoch}, "
                f"expected channel {stream.channel} epoch {self._epoch}"
            )
        if hub_rnd == self._rnd:
            if hub_digest != self._digest:
                raise WireError("resume transcript diverged at equal barriers")
        elif hub_rnd == self._rnd - 1 and self._last_outcome is not None:
            if hub_digest != self._digest_prev:
                raise WireError("resume transcript diverged one barrier back")
            # the hub missed our last outcome barrier: replay it verbatim
            self._stream.send(self._last_outcome)
            self._tally["resume"] += len(self._last_outcome)
        else:
            raise WireError(
                f"unresumable: hub barrier {hub_rnd}, ours {self._rnd}"
            )
        self.resumes += 1

    def resume_run(self) -> dict[int, ReconcileResult]:
        """Continue a resumed protocol from the re-aligned barrier to
        completion — the round loop picks up at ``self._rnd + 1`` over the
        intact session states and cohort stores."""
        return self._run_rounds()

    def _phase0(self):
        if not self._est_queue:
            return
        with self.tracer.span("phase0", sessions=len(self._est_queue)):
            self._phase0_exchange()

    def _phase0_exchange(self):
        sent = {}
        for sid in self._est_queue:
            a, cfg = self._pending[sid]
            sk = tow_sketches(a, derive_seed(cfg.seed, 0x70), cfg.ell)
            f = wf.encode_tow_sketch(sk, len(a))
            self._stream.send(f)
            sent[sid] = len(f)
        for sid in list(self._est_queue):
            a, cfg = self._pending.pop(sid)
            payload = self._expect(wf.MSG_DHAT)
            num = wf.decode_dhat(payload)
            est_frames = sent[sid] + _framed_len(payload)
            self._tally["estimator"] += est_frames
            plan = plan_from_estimate(cfg, num, len(a))
            if plan.est_bytes != est_frames:
                raise WireError(
                    f"sid {sid}: estimator frames measure {est_frames} B, "
                    f"accounted {plan.est_bytes} B"
                )
            self._install(sid, a, plan, append=False)
        self._est_queue.clear()

    def _verify(self):
        entries = []
        for s in self._sessions:
            success = all(u.done for u in s.state.units)
            entries.append(
                (success, checksum(effective_set(s.state.a, s.state.diff)))
            )
        f = wf.encode_verify(entries)
        self._stream.send(f)
        self._tally["verify"] += len(f)
        payload = self._expect(wf.MSG_VERIFY_ACK)
        self._tally["verify"] += _framed_len(payload)
        self.verified = wf.decode_verify_ack(payload, len(self._sessions))


class BobEndpoint(_Endpoint):
    """The serving endpoint; holds the B sets and answers frames until the
    final verification exchange, mirroring every session's unit queue."""

    side = "b"

    def __init__(
        self,
        transport: Transport,
        *,
        device=None,
        channel: int | None = None,
        continuous: bool = False,
        degrade: bool = False,
        estimate_limit: float | None = ESTIMATE_LIMIT_FRAC,
        recorder: Recorder | None = None,
        tracer=None,
    ):
        super().__init__(transport, device=device, channel=channel,
                         continuous=continuous, degrade=degrade,
                         estimate_limit=estimate_limit,
                         recorder=recorder, tracer=tracer)
        self._pending: dict[int, tuple] = {}   # sid -> (b, cfg)
        self._rnd = 0                          # rounds whose sketches arrived
        self._ctx = None                       # current round's (live, per-sid)
        self._epoch_plans: dict[int, object] = {}

    def _pending_store(self, sid, elems, cfg):
        self._pending[sid] = (elems, cfg)

    def _epoch_base(self, sess: ReconSession) -> np.ndarray:
        return sess.state.b

    def submit(self, set_b, cfg: PBSConfig | None = None, d_known: int | None = None) -> int:
        """Enqueue this endpoint's side of the next session (positional
        pairing with the peer's ``submit`` order)."""
        return self._submit(set_b, cfg, d_known)

    def serve_epoch(self) -> None:
        """Serve one staged epoch: the peer's ``MSG_EPOCH`` handshake
        (validated against the locally staged epoch id), the in-place
        store delta patch, then frames until the epoch's verification
        exchange completes."""
        if self._epoch_pending is None:
            raise RuntimeError("no epoch staged: call advance_epoch first")
        self.serve()

    def serve(self) -> None:
        """Answer frames until the verification exchange completes."""
        while True:
            msg_type, payload = self._stream.recv()
            if msg_type == wf.MSG_TREE:
                self._handle_tree(payload)
            elif msg_type == wf.MSG_TOW_SKETCH:
                self._handle_tow(payload)
            elif msg_type == wf.MSG_EPOCH:
                self._handle_epoch(payload)
            elif msg_type == wf.MSG_ROUND_SKETCHES:
                self._handle_sketches(payload)
            elif msg_type == wf.MSG_PARITY:
                self._handle_parity(payload)
            elif msg_type == wf.MSG_ROUND_OUTCOME:
                self._handle_outcome(payload)
            elif msg_type == wf.MSG_VERIFY:
                self._handle_verify(payload)
                return
            else:
                raise WireError(f"unexpected message type 0x{msg_type:02x}")

    def _handle_tree(self, payload: bytes) -> None:
        """Answer one level of the peer's tree walk (§15) through the
        shared ``serve_tree_frame``; when the deterministic split rule
        empties the frontier, install the accumulated leaf sessions."""
        if self._tree_walk is None:
            if self._tree is None:
                raise WireError("tree frame with no tree phase staged")
            elems, cfg, tcfg = self._tree
            self._tree = None
            self._tree_walk = tree_walk_state(elems, cfg, tcfg)
        w = self._tree_walk
        if serve_tree_frame(payload, w, self._stream, self._tally,
                            self.tracer, self.device, self.launches):
            self._tree_walk = None
            self._install_tree_leaves(
                w["elems"], w["cfg"], w["leaves"], w["level"] - 1
            )

    def _handle_epoch(self, payload: bytes) -> None:
        """One step of the peer's epoch handshake (the shared
        ``serve_epoch_frame`` state machine); once every staged session
        has its plan, fold the epoch in: delta-patch the resident store
        and reset the round state machine."""
        if self._epoch_pending is None:
            raise WireError("epoch frame with no epoch advance staged")
        done = serve_epoch_frame(
            payload, self._epoch, self._epoch_pending, self._epoch_plans,
            lambda sid: self._sessions[sid].plan.cfg,
            self._stream, self._tally, self._estimate_limit,
        )
        if done:
            self._install_epoch()

    def _install_epoch(self) -> None:
        batch = self._ensure_batch()
        pending, self._epoch_pending = self._epoch_pending, None
        for sid in sorted(pending):
            elems, dk = pending[sid]
            sess = self._sessions[sid]
            plan = self._epoch_plans.get(sid) or plan_from_d_known(
                sess.plan.cfg, dk
            )
            advance_session(batch, sess, plan, new_b=elems, rnd0=0)
        self._epoch_plans = {}
        self._rnd = 0
        self._ctx = None

    def _handle_tow(self, payload: bytes) -> None:
        if not self._est_queue:
            raise WireError("ToW sketch frame with no estimator session pending")
        sid = self._est_queue.pop(0)
        b, cfg = self._pending.pop(sid)
        reply, plan, est_bytes = serve_phase0(
            payload, b, cfg, self._estimate_limit
        )
        self._stream.send(reply)
        self._tally["estimator"] += est_bytes
        self._install(sid, b, plan, append=False)

    def _handle_sketches(self, payload: bytes) -> None:
        if self._ctx is not None:
            raise WireError("sketch frame while a round outcome is pending")
        if self._epoch_pending is not None:
            raise WireError("round traffic before the staged epoch handshake")
        batch = self._ensure_batch()
        rnd = self._rnd + 1
        plans = batch.plan_round(rnd)
        with self.tracer.span("round.encode", cat="device", round=rnd,
                              cohorts=len(plans)):
            per = self._encode_round(plans)
        live = sorted(per)
        schema = self._schema(per, live)
        got_rnd, blocks = wf.decode_round_sketches(payload, schema)
        if got_rnd != rnd:
            raise WireError(f"sketch frame for round {got_rnd}, expected {rnd}")
        self._rnd = rnd
        self._tally["protocol"] += _framed_len(payload)

        # per cohort: place each session's frame sketches at its row slice,
        # XOR with our device-resident side, decode every unit at once
        # (padding rows carry zero sketches on both sides: trivially ok)
        with self.tracer.span("round.decode", cat="device", round=rnd,
                              sessions=len(live)):
            results, ctx = decode_side_b_round(
                plans, per, dict(zip(live, blocks)), self.launches
            )
        reply = wf.encode_round_reply(rnd, [results[sid] for sid in live], schema)
        self._stream.send(reply)
        self._tally["protocol"] += len(reply)
        # rateless ladder state (§16): the failing slots of every rateless
        # session, plus everything a MSG_PARITY extension needs to re-decode
        # this round's bitmaps at a wider t — cached frame sketches (the
        # prefix), our row slices, and the cohort plans.
        fail: dict[int, list[int]] = {}
        for sid in live:
            sess, active, ok, _ = ctx[sid]
            if not sess.plan.cfg.rateless:
                continue
            bad = [s for s in range(len(active)) if not ok[s]]
            if bad:
                fail[sid] = bad
        self._ctx = {
            "live": live, "ctx": ctx, "per": per, "plans": plans,
            "sk_a": dict(zip(live, blocks)), "fail": fail, "level": 0,
            "acc": {},
        }

    def _handle_parity(self, payload: bytes) -> None:
        """Serve one ``MSG_PARITY`` rateless extension (DESIGN.md §16).

        XOR Alice's incremental syndrome columns with our own side's, grow
        each failing unit's cached round-diff prefix, re-decode per cohort
        in one batched launch at the extended t, and reply with the
        extension outcomes through the ordinary round-reply codec.  The
        round context's ``ok`` arrays are merged in place, so the outcome
        frame (and any resume replay) sees the post-ladder verdicts.
        """
        c = self._ctx
        if c is None:
            raise WireError("parity frame with no round in flight")
        fail = c["fail"]
        level = c["level"] + 1
        if level > MAX_PARITY_EXTENSIONS:
            raise WireError(f"parity frame beyond the level-{level - 1} cap")
        part_plans = [
            plan for plan in c["plans"]
            if any(sess.sid in fail for sess, *_ in plan.members)
        ]
        inc_of = encode_round_rows_ext(
            part_plans, self.side, level, self.device, self.launches
        )
        parts = [sid for sid in c["live"] if sid in fail and sid in inc_of]
        if not parts:
            raise WireError("unexpected parity frame: no extension pending")
        schema = [
            (len(fail[sid]), inc_of[sid][2] - inc_of[sid][1],
             c["per"][sid].plan.store.m)
            for sid in parts
        ]
        # reply schema before the merge loop mutates ``fail``: the ext
        # reply covers every unit that was failing at this level, at t1
        reply_schema = [
            (len(fail[sid]), inc_of[sid][2], c["per"][sid].plan.store.m)
            for sid in parts
        ]
        got_rnd, got_level, blocks = wf.decode_parity(payload, schema)
        if got_rnd != self._rnd:
            raise WireError(
                f"parity frame for round {got_rnd}, expected {self._rnd}"
            )
        if got_level != level:
            raise WireError(
                f"parity frame at level {got_level}, expected {level}"
            )
        self._tally["protocol"] += _framed_len(payload)

        # grow each failing unit's accumulated diff syndromes: prefix
        # (frame sketch ^ our sketch, cached at decode time) + increments
        acc = c["acc"]
        for sid, inc_a in zip(parts, blocks):
            inc_b = inc_of[sid][0]
            prefix_a = c["sk_a"][sid]
            sk_b = c["per"][sid].sk
            slot_acc = acc.setdefault(sid, {})
            for i, slot in enumerate(fail[sid]):
                prev = slot_acc.get(slot)
                if prev is None:
                    prev = np.asarray(prefix_a[slot], dtype=np.int64) ^ np.asarray(
                        sk_b[slot], dtype=np.int64
                    )
                d = np.asarray(inc_a[i], dtype=np.int64) ^ np.asarray(
                    inc_b[slot], dtype=np.int64
                )
                slot_acc[slot] = np.concatenate([prev, d])

        # one batched decode per cohort: failing rows scattered into a
        # padded buffer, settled rows stay zero (trivially ok, ignored)
        entries: dict[int, tuple] = {}
        for plan in part_plans:
            n, t = plan.store.n, plan.store.t
            t1 = parity_extension_t(t, level, n)
            if t1 <= parity_extension_t(t, level - 1, n):
                continue
            u_pad = plan.arrays["row_map"].shape[0]
            buf = np.zeros((u_pad, t1), dtype=np.int64)
            hit = False
            for sess, base, active, _ in plan.members:
                if sess.sid not in parts:
                    continue
                for slot in fail[sess.sid]:
                    buf[base + slot] = acc[sess.sid][slot]
                    hit = True
            if not hit:
                continue
            # field elements below 2^m: int64 on the host, int32 on the card
            ok_p, pos_p, cnt_p = _unpack_decode(
                _decode_packed(buf, n, t1, self.device), t1
            )
            self.launches["decode_launches"] += 1
            for sess, base, active, _ in plan.members:
                sid = sess.sid
                if sid not in parts:
                    continue
                row = c["per"][sid]
                ok_m = c["ctx"][sid][2]
                ok_e, units, still = [], [], []
                for slot in fail[sid]:
                    if ok_p[base + slot]:
                        k = int(cnt_p[base + slot])
                        p = pos_p[base + slot, :k].astype(np.int64)
                        units.append(
                            ReplyUnit(
                                positions=p,
                                xors=row.xors[slot, p],
                                csum=int(row.csum[slot]),
                            )
                        )
                        ok_e.append(True)
                        ok_m[slot] = True   # in-place: outcome/resume see it
                    else:
                        units.append(None)
                        ok_e.append(False)
                        still.append(slot)
                entries[sid] = (ok_e, units)
                if still:
                    fail[sid] = still
                else:
                    del fail[sid]
                self.parity_extensions += 1
        c["level"] = level
        reply = wf.encode_round_reply(
            self._rnd, [entries[sid] for sid in parts], reply_schema
        )
        self._stream.send(reply)
        self._tally["protocol"] += len(reply)

    def _handle_outcome(self, payload: bytes) -> None:
        if self._ctx is None:
            raise WireError("outcome frame with no round in flight")
        live, ctx = self._ctx["live"], self._ctx["ctx"]
        self._ctx = None
        rnd = self._rnd
        got_rnd, done_lists = wf.decode_round_outcome(
            payload, [len(ctx[sid][1]) for sid in live]
        )
        if got_rnd != rnd:
            raise WireError(f"outcome frame for round {got_rnd}, expected {rnd}")
        self._tally["protocol"] += _framed_len(payload)
        for sid, done in zip(live, done_lists):
            sess, active, ok, _ = ctx[sid]
            rloc = rnd - sess.rnd0       # local protocol round
            for slot, u in enumerate(active):
                if not ok[slot]:
                    # our decode failed: mirror Alice's 3-way split verbatim
                    queue_split(sess.state, u, rloc, sess.plan.cfg.seed)
                elif done[slot]:
                    u.done = True
            sess.state.rounds = rloc
        self._degrade_after(rnd)

    def _handle_verify(self, payload: bytes) -> None:
        # Alice's A △ D̂ must sum to our B when she really learned A △ B
        ack, flags = verify_ack_entries(payload, self._sessions)
        self._tally["verify"] += _framed_len(payload)
        self._stream.send(ack)
        self._tally["verify"] += len(ack)
        self.verified = flags


def _framed_len(payload: bytes) -> int:
    """Exact framed size of a received payload (envelope + type + body)."""
    return framed_len(len(payload))


def _drive_pair(alice, bob, alice_call, bob_call) -> dict[int, ReconcileResult]:
    """Run one Alice step against one Bob step on a worker thread, with
    Bob's root-cause exception taking precedence (see ``run_pair``)."""
    err: list[BaseException] = []

    def _serve():
        try:
            bob_call()
        except BaseException as e:  # noqa: BLE001 - relayed to the caller
            err.append(e)
            bob._stream.transport.close()  # unblock the peer's recv

    th = threading.Thread(target=_serve, name="bob-endpoint", daemon=True)
    th.start()
    try:
        results = alice_call()
    except BaseException:
        th.join(timeout=5.0)
        if err:
            raise err[0]  # Bob's failure is the root cause, not Alice's
        raise
    th.join(timeout=60.0)
    if err:
        raise err[0]
    return results


def run_pair(alice: AliceEndpoint, bob: BobEndpoint) -> dict[int, ReconcileResult]:
    """Drive a connected endpoint pair to completion: Bob serves on a
    worker thread, Alice runs on the caller's; Bob's exceptions re-raise.

    A failing serve() closes Bob's transport so a blocked Alice fails fast
    instead of sitting out her recv timeout, and Bob's root-cause exception
    takes precedence over the secondary transport error Alice then sees.
    """
    return _drive_pair(alice, bob, alice.run, bob.serve)


def run_pair_epoch(alice: AliceEndpoint, bob: BobEndpoint) -> dict[int, ReconcileResult]:
    """Drive one staged continuous-sync epoch over a connected pair (both
    sides must have called ``advance_epoch``); same threading and error
    semantics as ``run_pair``."""
    return _drive_pair(alice, bob, alice.run_epoch, bob.serve_epoch)
