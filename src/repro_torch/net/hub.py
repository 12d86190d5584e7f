"""Multi-peer reconciliation hub: one endpoint serving N peers (DESIGN.md §10),
ported from the reference package's ``net.hub`` onto the port's device
pipeline (the shared cohort stores, encodes and decodes live on the hub's
``device``: None = the CUDA card, which raises without one).

``HubEndpoint`` is the serving (Bob) side of N concurrent PBS sessions'
worth of peers: every peer connects over its own ``Transport``, is assigned
a **channel id**, and exchanges ``repro_torch.wire`` frames wrapped in the
``MSG_MUX`` envelope tagged with that id — a frame carrying any other id
(unknown, stale, zero, or unwrapped) is rejected and fails only that peer.
Peers run stock ``AliceEndpoint``s constructed with ``channel=``; their
protocol, ledgers, and results are byte-identical to the pair path.

The point of the hub is *fusion*: all peers' sessions feed **one shared**
``SessionBatch(sides=("b",))``, so a global round packs every peer's active
units into the same per-code cohorts — one ``encode_side`` (one
``bin_parity_xorsum_units`` launch + one GF(2) sketch matmul) and one
``bch_decode_batched`` launch per cohort, shared across all N peers,
instead of N independent pipelines.

Scenario diversity the pair path never sees (all exercised in
tests/test_hub.py and tests/test_protocol_conformance.py):

* **peers joining between global rounds** — a session admitted after global
  round k carries ``rnd0 = k``; all protocol-visible round arithmetic (bin
  seeds, budget, frame round numbers) uses its *local* round, so a late
  joiner is byte-identical to a pair that started alone;
* **stragglers** — the round barrier polls every peer with a per-peer
  deadline from barrier start; a peer whose frame does not arrive in time
  is evicted (its sessions fail with the deadline ``TransportError``) and
  the round proceeds with the survivors;
* **mid-protocol disconnect** — any non-timeout transport failure or
  malformed frame evicts just that peer, surfacing as a clean per-peer
  error in its ``PeerOutcome`` while every other peer completes untouched;
* **mixed known-d and estimator peers** — estimator sessions run their
  phase-0 ToW exchange at admission, then share cohorts with known-d
  sessions as usual;
* **continuous epochs** (``continuous=True``, DESIGN.md §11) — after every
  peer's epoch settles, ``advance_epoch`` stages each side's churn, the
  next ``serve`` opens with a ``MSG_EPOCH`` handshake barrier (epoch id +
  per-estimator-session d̂ re-estimation), and the shared cohort stores
  take an in-place O(churn) delta patch instead of a rebuild — sessions,
  channels, and device residency all survive across epochs
  (tests/test_sync_churn.py soaks ≥20 epochs against the oracle).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np

from ..core.tow import ESTIMATE_LIMIT_FRAC, EstimateOutOfRange
from ..core.pbs import (
    MAX_PARITY_EXTENSIONS,
    PBSConfig,
    ReconcileResult,
    new_session_state,
    parity_extension_t,
    plan_from_d_known,
    queue_split,
    session_live,
)
from ..recon.session import (
    ReconSession,
    SessionBatch,
    advance_session,
    apply_churn,
    degrade_exhausted,
)
from ..kernels.platform import (
    resolve_device,
    retrace_count,
    retrace_counts,
)
from ..obs import NULL_TRACER, Recorder
from ..wire import frames as wf
from ..wire.frames import ReplyUnit, WireError
from ..wire.varint import framed_len

from ..tree.partition import TreeConfig, leaf_slices

from .endpoint import (
    AliceEndpoint,
    _decode_packed,
    _unpack_decode,
    decode_side_b_round,
    encode_round_rows,
    encode_round_rows_ext,
    round_schema,
    serve_epoch_frame,
    serve_phase0,
    serve_tree_frame,
    stream_wire_stats,
    tree_walk_state,
    verify_ack_entries,
)
from .resilience import PeerDeadline, classify_error
from .transport import FrameStream, Transport, TransportError, TransportTimeout

_EMPTY = np.zeros(0, dtype=np.uint32)
_POLL_S = 0.02  # barrier round-robin slice: bounds one sweep over N peers


@dataclass
class PeerOutcome:
    """One peer's final disposition after ``serve``."""

    channel: int
    ok: bool                            # verify exchange completed
    verified: list[bool] | None         # per-session verdicts (ok peers)
    error: BaseException | None         # eviction cause (failed peers)
    sessions: list[ReconSession]        # the hub's mirrored session states
    wire_stats: dict
    # typed failure taxonomy (DESIGN.md §13): "deadline" / "estimate" /
    # "wire" / "transport" / "error" for failed peers; "resumed" /
    # "degraded" for ok peers that took the recovery paths; None for a
    # clean untouched run
    error_kind: str | None = None
    # tree front end (§15): deepest level the peer's walk reached and the
    # leaf sessions it admitted; (0, None) for peers that ran no tree phase
    tree_depth: int = 0
    tree_leaves: int | None = None


class _Peer:
    """Hub-side connection state for one channel."""

    def __init__(self, channel: int, transport: Transport, label: str | None):
        self.channel = channel
        self.label = label or f"peer{channel}"
        self.transport = transport
        self.stream = FrameStream(transport, channel=channel)
        self.pending: list[tuple] = []      # (set_b, cfg, d_known) pre-admission
        self.sessions: list[ReconSession] = []  # local-sid order
        self.admitted = False
        self.retired = False
        self.verified: list[bool] | None = None
        self.error: BaseException | None = None
        self.tally = {
            "estimator": 0, "protocol": 0, "verify": 0, "epoch": 0,
            "resume": 0, "tree": 0,
        }
        self.d_known: list[int | None] = []     # per local sid, epoch default
        # tree front end (§15): staged (set_b, cfg, tcfg) awaiting the
        # walk, the in-flight walk state, and the outcome summary
        self.tree_pending: tuple | None = None
        self.tree_walk: dict | None = None
        self.tree_depth = 0
        self.tree_leaves: int | None = None
        self.epoch_pending: dict[int, tuple] | None = None  # sid -> (set_b, dk)
        self.epoch_plans: dict[int, object] = {}
        # -- resumption record (DESIGN.md §13), bounded: one retained round
        # context + two 64-bit digests + the frame-numbering offset
        self.rnd0 = 0                   # global round of this peer's admission
        self.rounds_done = 0            # local barriers applied (peer's clock)
        # the hub's global epoch at this peer's admission: a mid-life
        # joiner (tree cold start, §15) opens at local epoch 0 while the
        # hub's counter is already at E — every protocol-visible epoch for
        # this peer (MSG_EPOCH ids, transcript seeds, resume frames) is
        # the local ``hub epoch - epoch_base``
        self.epoch_base = 0
        self.digest = wf.transcript_digest0(0)
        self.digest_prev = self.digest
        self.inflight_ctx: tuple | None = None  # (live_g, ctx) awaiting outcome
        self.suspended = False
        self.suspend_at = 0.0           # monotonic expiry of the resume window
        self.suspend_err: BaseException | None = None
        self.resumes = 0
        self.marks = {"protocol": 0, "verify": 0}   # tallies at last barrier
        self.carry: dict = {}           # totals of resumed-away transports
        # per-peer registry: wire_stats routes through it so every key is
        # schema-declared and the dict is a derived snapshot (DESIGN.md §14)
        self.recorder = Recorder()

    def wire_stats(self) -> dict:
        self.recorder.publish(
            "wire", stream_wire_stats(self.stream, self.tally, self.carry)
        )
        return self.recorder.view("wire")


class HubEndpoint:
    """One serving endpoint reconciling against N peers concurrently.

    Usage::

        hub = HubEndpoint()
        ch = hub.add_peer(transport)          # one Transport per peer
        hub.submit(ch, set_b, cfg=cfg, d_known=d)   # positional, like a pair
        outcomes = hub.serve()                # dict channel -> PeerOutcome

    ``add_peer``/``submit`` may also be called while ``serve`` runs (from
    another thread, or from the ``on_barrier`` hook): the peer is admitted
    at the next global-round barrier with ``rnd0`` = the completed round.
    ``recv_deadline`` is the per-peer barrier deadline; ``on_barrier`` (if
    set) is called with the just-completed global round number — the
    deterministic injection point tests use for mid-run joins.
    """

    side = "b"

    def __init__(
        self,
        *,
        device=None,
        recv_deadline: float = 60.0,
        on_barrier=None,
        continuous: bool = False,
        resume_window: float = 0.0,
        degrade: bool = False,
        estimate_limit: float | None = ESTIMATE_LIMIT_FRAC,
        recorder: Recorder | None = None,
        tracer=None,
    ):
        # where the shared cohort stores, encodes and decodes live: None =
        # the CUDA card (raises without one); nothing falls back to the CPU
        self.device = resolve_device(device)
        # telemetry (DESIGN.md §14): the `stats` view derives from the
        # recorder's hub.* rows; every barrier/eviction/resume goes through
        # the tracer (NULL_TRACER = disabled, free)
        self.recorder = recorder if recorder is not None else Recorder()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._deadline = recv_deadline
        self.on_barrier = on_barrier
        self._continuous = continuous
        # resume_window > 0 turns mid-round transport failures of admitted
        # peers into *suspensions* (DESIGN.md §13): the peer's sessions and
        # store rows stay resident and ``resume_peer`` may re-attach it for
        # that many seconds before the suspension hardens into an eviction.
        # 0 keeps the historical evict-immediately behavior.
        self._resume_window = resume_window
        # degrade=True escalates decode-budget-exhausted sessions (doubled
        # d̂ re-plan, counted in ``sessions_degraded``) instead of letting
        # them run out the round budget into ``failed=True``; peers must
        # run matching ``degrade=True`` endpoints.
        self._degrade = degrade
        # phase-0 operating-regime guard (§15): a joiner whose planned d̂
        # exceeds this fraction of |A| + |B| is evicted with
        # error_kind="estimate" (the pair belongs to the tree front end);
        # None restores the unguarded legacy behaviour
        self._estimate_limit = estimate_limit
        self._lock = threading.Lock()
        self._peers: dict[int, _Peer] = {}
        self._order: list[int] = []         # admission order of channels
        self._joiners: list[int] = []       # added but not yet admitted
        self._next_channel = 1
        self.stale_channels: set[int] = set()
        self._sessions: list[ReconSession] = []
        self._batch = SessionBatch(
            self._sessions, sides=(self.side,), mutable=continuous,
            tracer=self.tracer, device=self.device,
        )
        self._stats: dict = {}
        self._epoch = 0
        self._epoch_open = False
        self._rnd = 0               # current global round (serve loop clock)

    # -- registration ----------------------------------------------------

    def add_peer(self, transport: Transport, *, label: str | None = None) -> int:
        """Register a peer connection; returns its channel id (never 0,
        never reused — a retired channel's id stays stale forever)."""
        with self._lock:
            ch = self._next_channel
            self._next_channel += 1
            self._peers[ch] = _Peer(ch, transport, label)
            self._joiners.append(ch)
        return ch

    def submit(
        self,
        channel: int,
        set_b,
        cfg: PBSConfig | None = None,
        d_known: int | None = None,
    ) -> int:
        """Enqueue this hub's side of the peer's next session (positional
        pairing with the peer's ``submit`` order, like the pair path);
        returns the peer-local sid.  Must precede the peer's admission."""
        peer = self._peers[channel]
        elems = np.unique(np.asarray(set_b, dtype=np.uint32))
        with self._lock:
            if peer.admitted:
                raise RuntimeError(
                    f"channel {channel} already admitted; submit before serve "
                    "or from the on_barrier hook for late joiners"
                )
            peer.pending.append((elems, cfg or PBSConfig(), d_known))
            peer.d_known.append(d_known)
            return len(peer.pending) - 1

    def submit_tree(
        self,
        channel: int,
        set_b,
        cfg: PBSConfig | None = None,
        tree: TreeConfig | None = None,
    ) -> None:
        """Stage the hub's side of the peer's tree-phase cold start (§15):
        the walk runs at the peer's admission, before phase 0, under the
        same per-peer deadline — a peer that goes silent mid-walk is
        evicted cleanly (nothing was admitted yet) and may reconnect and
        re-stage from scratch.  Every divergent leaf range becomes an
        ordinary known-d session appended after the peer's regular
        ``submit``s; the peer must ``submit_tree`` its matching side with
        the same ``cfg``/``tree`` (positional contract)."""
        peer = self._peers[channel]
        with self._lock:
            if peer.admitted:
                raise RuntimeError(
                    f"channel {channel} already admitted; stage the tree "
                    "before serve"
                )
            if peer.tree_pending is not None or peer.tree_walk is not None:
                raise RuntimeError(
                    f"channel {channel} already has a tree phase staged"
                )
            peer.tree_pending = (
                np.unique(np.asarray(set_b, dtype=np.uint32)),
                cfg or PBSConfig(),
                tree or TreeConfig(),
            )

    # -- eviction / retirement -------------------------------------------

    def _evict(self, peer: _Peer, err: BaseException) -> None:
        """Fail one peer: mark its sessions failed (they never plan again),
        retire its channel as stale, and close its transport so a blocked
        peer fails fast instead of hanging."""
        peer.retired = True
        peer.suspended = False
        if isinstance(err, TransportError):
            peer.error = err
        else:
            peer.error = TransportError(f"{peer.label}: {err}")
            peer.error.__cause__ = err
        for sess in peer.sessions:
            sess.failed = True
            sess.suspended = False
        self.stale_channels.add(peer.channel)
        self._stats["peers_failed"] = self._stats.get("peers_failed", 0) + 1
        kind = classify_error(peer.error)
        by_kind = self._stats.setdefault("peers_failed_by_kind", {})
        by_kind[kind] = by_kind.get(kind, 0) + 1
        self.tracer.instant("peer.evict", channel=peer.channel,
                            peer=peer.label, kind=kind)
        try:
            peer.transport.close()
        except Exception:
            pass

    def _fail(self, peer: _Peer, err: BaseException, *, resumable: bool) -> None:
        """Route one peer failure: a transport-level failure of an admitted,
        mid-round peer suspends (resumable, DESIGN.md §13) when a resume
        window is configured; protocol violations (``WireError``) and
        pre-admission failures always evict permanently."""
        if (
            resumable
            and self._resume_window > 0.0
            and peer.admitted
            and isinstance(err, TransportError)
        ):
            self._suspend(peer, err)
        else:
            self._evict(peer, err)

    def _suspend(self, peer: _Peer, err: BaseException) -> None:
        """Park one peer in the resumable state: its sessions stop planning
        (``suspended``, NOT ``failed`` — cohort-store membership survives,
        so resumption rebuilds nothing), its channel stays valid, and the
        recovery record (``rounds_done``/``digest``/``inflight_ctx``) waits
        for ``resume_peer`` until the resume window expires."""
        peer.retired = True
        peer.suspended = True
        peer.suspend_err = err
        peer.suspend_at = time.monotonic() + self._resume_window
        self.tracer.instant("peer.suspend", channel=peer.channel,
                            peer=peer.label, barrier=peer.rounds_done)
        for sess in peer.sessions:
            sess.suspended = True
        try:
            peer.transport.close()
        except Exception:
            pass

    def _expire_overdue(self) -> None:
        """Harden every suspension whose resume window has lapsed into a
        permanent eviction carrying the original failure as its cause."""
        now = time.monotonic()
        for peer in self._peers.values():
            if not peer.suspended or now < peer.suspend_at:
                continue
            cause = peer.suspend_err
            err = type(cause)(
                f"{peer.label}: resume window ({self._resume_window}s) "
                "expired"
            ) if isinstance(cause, TransportError) else TransportError(
                f"{peer.label}: resume window expired"
            )
            err.__cause__ = cause
            self._evict(peer, err)

    # -- resumption (DESIGN.md §13) ----------------------------------------

    def resume_peer(
        self,
        channel: int,
        transport: Transport,
        *,
        timeout: float | None = None,
    ) -> None:
        """Re-attach a suspended peer over a fresh transport.

        Call while ``serve`` is between barriers (the ``on_barrier`` hook is
        the deterministic spot) with the hub side of the peer's replacement
        connection; the peer drives ``AliceEndpoint.resume`` concurrently.
        Runs the ``MSG_RESUME`` handshake against the peer's recovery
        record: equal barriers must agree on ``digest``; a peer exactly one
        barrier ahead (her outcome frame died in flight) must agree on
        ``digest_prev`` and replays that one frame, applied idempotently
        from the retained round context and ledgered as
        ``resume_replay_bytes`` (transport overhead — never Formula-(1)
        bits).  The peer's sessions then re-bind at the current global
        round via an ``rnd0`` shift — no re-admission, no store rebuild —
        and the next barrier serves her like any live peer.  A failed
        handshake (divergent transcript, wrong epoch, dead transport)
        hardens the suspension into a permanent eviction and re-raises.
        """
        peer = self._peers.get(channel)
        if peer is None:
            raise KeyError(f"unknown channel {channel}")
        with self.tracer.span("peer.resume", channel=channel,
                              peer=peer.label, barrier=peer.rounds_done):
            self._resume_peer(peer, channel, transport, timeout)

    def _resume_peer(
        self,
        peer: _Peer,
        channel: int,
        transport: Transport,
        timeout: float | None,
    ) -> None:
        with self._lock:
            if not peer.suspended:
                raise RuntimeError(
                    f"channel {channel} is not suspended (nothing to resume)"
                )
        old = peer.stream
        t_old = old.transport
        peer.carry = {
            "transport_bytes_out": t_old.bytes_out
            + peer.carry.get("transport_bytes_out", 0),
            "transport_bytes_in": t_old.bytes_in
            + peer.carry.get("transport_bytes_in", 0),
            "retransmits": getattr(t_old, "retransmits", 0)
            + peer.carry.get("retransmits", 0),
        }
        stream = FrameStream(transport, channel=channel)
        stream.frames_out, stream.frames_in = old.frames_out, old.frames_in
        stream.bytes_out, stream.bytes_in = old.bytes_out, old.bytes_in
        stream.mux_bytes_out = old.mux_bytes_out
        stream.mux_bytes_in = old.mux_bytes_in
        peer.transport = transport
        peer.stream = stream
        wait = self._deadline if timeout is None else timeout
        try:
            msg_type, payload = stream.recv(timeout=wait)
            if msg_type != wf.MSG_RESUME:
                raise WireError(
                    f"expected message 0x{wf.MSG_RESUME:02x}, "
                    f"got 0x{msg_type:02x}"
                )
            ch, epoch, a_rnd, a_digest, a_digest_prev = wf.decode_resume(
                payload
            )
            if ch != channel or epoch != self._epoch - peer.epoch_base:
                raise WireError(
                    f"resume for channel {ch} epoch {epoch}, expected "
                    f"channel {channel} epoch {self._epoch - peer.epoch_base}"
                )
            replay = False
            if a_rnd == peer.rounds_done:
                if a_digest != peer.digest:
                    raise WireError(
                        "resume transcript diverged at equal barriers"
                    )
                # any in-flight context is from an aborted attempt that
                # will re-run in full — drop it
                peer.inflight_ctx = None
            elif a_rnd == peer.rounds_done + 1 and peer.inflight_ctx:
                if a_digest_prev != peer.digest:
                    raise WireError(
                        "resume transcript diverged one barrier back"
                    )
                replay = True
            else:
                raise WireError(
                    f"unresumable: peer barrier {a_rnd}, "
                    f"ours {peer.rounds_done}"
                )
            reply = wf.encode_resume(
                channel, self._epoch - peer.epoch_base, peer.rounds_done,
                peer.digest, peer.digest_prev,
            )
            stream.send(reply)
            peer.tally["resume"] += framed_len(len(payload)) + len(reply)
            if replay:
                mt, opayload = stream.recv(timeout=wait)
                if mt != wf.MSG_ROUND_OUTCOME:
                    raise WireError(
                        f"expected replayed message "
                        f"0x{wf.MSG_ROUND_OUTCOME:02x}, got 0x{mt:02x}"
                    )
                live_g, ctx = peer.inflight_ctx
                glob = peer.rnd0 + peer.rounds_done + 1
                self._apply_outcome(
                    peer, glob, opayload, live_g, ctx, replay=True
                )
                if peer.error is not None:
                    raise WireError(
                        "replayed outcome frame rejected"
                    ) from peer.error
            else:
                # the aborted partial attempt re-runs: its frame bytes move
                # to the resume tally so Formula-(1) categories count the
                # re-run exactly once (mirrors AliceEndpoint.resume)
                for k, mark in peer.marks.items():
                    spill = peer.tally[k] - mark
                    if spill:
                        peer.tally[k] = mark
                        peer.tally["resume"] += spill
        except (TransportError, WireError) as e:
            if peer.error is None:      # replay rejection already evicted
                self._evict(peer, e)
            raise
        with self._lock:
            # re-bind the peer's local round clock to the hub's: her next
            # local round (rounds_done + 1) must land on the next global
            # round, so every session's rnd0 shifts by the same delta
            # (escalated sessions keep their relative offsets)
            new_rnd0 = self._rnd - peer.rounds_done
            delta = new_rnd0 - peer.rnd0
            for sess in peer.sessions:
                sess.rnd0 += delta
                sess.suspended = False
            peer.rnd0 = new_rnd0
            peer.suspended = False
            peer.retired = False
            peer.suspend_err = None
            peer.resumes += 1
            self._stats["peers_resumed"] = (
                self._stats.get("peers_resumed", 0) + 1
            )

    def _finish_peer(self, peer: _Peer, payload: bytes) -> None:
        """The final verification exchange (peer has no live work left)."""
        try:
            ack, flags = verify_ack_entries(payload, peer.sessions)
            peer.tally["verify"] += framed_len(len(payload))
            peer.stream.send(ack)
            peer.tally["verify"] += len(ack)
        except WireError as e:
            self._evict(peer, e)
            return
        except TransportError as e:
            # ack send died: the exchange is re-runnable after a resume
            # (the peer re-sends MSG_VERIFY; verify_ack_entries is pure)
            self._fail(peer, e, resumable=True)
            return
        peer.marks = {k: peer.tally[k] for k in peer.marks}
        peer.verified = flags
        peer.retired = True
        if not self._continuous:
            # a continuous-sync peer comes back next epoch; only one-shot
            # completion retires the channel id for good
            self.stale_channels.add(peer.channel)

    # -- the shared peer poller -------------------------------------------

    def _poll_peers(self, handlers: dict, phase: str) -> None:
        """Round-robin-poll every peer in ``handlers`` (channel -> frame
        handler) under ONE deadline from call start, so no single silent
        peer can stall the others.  A handler receives each inbound
        (peer, msg_type, payload), returns True when its peer needs no more
        frames, and may raise ``WireError``/``TransportError`` to evict.
        ``TransportTimeout`` on a poll slice keeps waiting; any other
        transport failure evicts immediately; peers still pending when the
        deadline passes with no progress are evicted with a deadline error.
        This one loop carries the straggler semantics of both the admission
        phase and the round barriers (DESIGN.md §10).
        """
        resumable = phase == "round-barrier"
        deadline_at = time.monotonic() + self._deadline
        pending = dict(handlers)
        while pending:
            progressed = False
            for ch in list(pending):
                peer = self._peers[ch]
                try:
                    msg_type, payload = peer.stream.recv(timeout=_POLL_S)
                except TransportTimeout:
                    continue
                except (TransportError, WireError) as e:
                    self._fail(peer, e, resumable=resumable)
                    del pending[ch]
                    continue
                progressed = True
                try:
                    if pending[ch](peer, msg_type, payload):
                        del pending[ch]
                except (EstimateOutOfRange, TransportError, WireError) as e:
                    self._fail(peer, e, resumable=resumable)
                    del pending[ch]
            if pending and not progressed and time.monotonic() >= deadline_at:
                for ch in pending:
                    self._fail(self._peers[ch], PeerDeadline(
                        f"{self._peers[ch].label}: no frame within the "
                        f"{self._deadline}s {phase} deadline"
                    ), resumable=resumable)
                break

    # -- tree front end (DESIGN.md §15) -----------------------------------

    def _tree_handler(self, ch: int):
        """Frame handler driving one tree-staged joiner's walk through the
        shared poller: each inbound digest frame is one level served via
        ``serve_tree_frame``; walk completion appends the leaf sessions to
        the peer's pending queue and returns True."""
        def handle(peer, msg_type, payload):
            if msg_type != wf.MSG_TREE:
                raise WireError(
                    f"expected message 0x{wf.MSG_TREE:02x}, "
                    f"got 0x{msg_type:02x}"
                )
            if peer.tree_walk is None:
                elems, cfg, tcfg = peer.tree_pending
                peer.tree_pending = None
                peer.tree_walk = tree_walk_state(elems, cfg, tcfg)
            w = peer.tree_walk
            if not serve_tree_frame(payload, w, peer.stream, peer.tally,
                                    self.tracer, self.device):
                return False
            peer.tree_walk = None
            peer.tree_depth = w["level"] - 1
            peer.tree_leaves = len(w["leaves"])
            with self._lock:
                for sub, leaf in zip(
                    leaf_slices(w["elems"], w["leaves"]), w["leaves"]
                ):
                    peer.pending.append((sub, w["cfg"], leaf.d_plan))
                    peer.d_known.append(leaf.d_plan)
            st = self._stats
            st["tree_levels"] = max(st.get("tree_levels", 0), w["level"])
            st["tree_digest_bytes"] = (
                st.get("tree_digest_bytes", 0) + w["bytes"]
            )
            st["tree_leaves"] = st.get("tree_leaves", 0) + len(w["leaves"])
            self.tracer.instant(
                "peer.tree_done", channel=ch, peer=peer.label,
                levels=w["level"], leaves=len(w["leaves"]), bytes=w["bytes"],
            )
            return True
        return handle

    # -- admission (phase 0) ---------------------------------------------

    def _admit(self, rnd: int) -> bool:
        """Admit at round offset ``rnd`` every registered peer that has at
        least one submitted session: pin known-d plans immediately, drive
        the estimator sessions' phase-0 ToW exchanges through the shared
        round-robin poller (one silent joiner cannot stall the others'
        admission past the deadline), then join the survivors' sessions to
        the shared batch.  A peer whose ``submit`` has not landed yet stays
        queued for the next barrier — ``add_peer`` then ``submit`` from
        another thread can never admit a session-less peer by racing the
        barrier.  Returns True iff any peer was admitted."""
        with self._lock:
            joiners = [
                ch for ch in self._joiners
                if self._peers[ch].pending
                or self._peers[ch].tree_pending is not None
            ]
            self._joiners = [ch for ch in self._joiners if ch not in joiners]
        if not joiners:
            return False
        # tree phase (§15): drive every tree-staged joiner's whole walk —
        # one digest->verdict barrier per level, same deadline semantics —
        # before phase 0; its leaf sessions join the pending queue as
        # known-d submits, appended after the peer's regular ones
        tree_chs = [
            ch for ch in joiners
            if self._peers[ch].tree_pending is not None
        ]
        if tree_chs:
            # a tree-staged joiner enters the protocol here: register it
            # for outcome reporting NOW so a mid-walk eviction still
            # surfaces as a (failed) PeerOutcome instead of vanishing
            with self._lock:
                for ch in tree_chs:
                    if ch not in self._order:
                        self._order.append(ch)
                        self._stats["peers"] = (
                            self._stats.get("peers", 0) + 1
                        )
            with self.tracer.span("hub.tree_phase", peers=len(tree_chs)):
                self._poll_peers(
                    {ch: self._tree_handler(ch) for ch in tree_chs},
                    phase="tree",
                )
            joiners = [ch for ch in joiners if not self._peers[ch].retired]
            if not joiners:
                return False
        with self._lock:
            pending_of = {ch: list(self._peers[ch].pending) for ch in joiners}
        plans: dict[int, list] = {}
        est_idx: dict[int, list[int]] = {}      # ch -> indices awaiting ToW
        for ch in joiners:
            peer = self._peers[ch]
            if ch not in self._order:           # re-queued leftover submits
                self._order.append(ch)
                self._stats["peers"] = self._stats.get("peers", 0) + 1
            plans[ch] = [
                None if dk is None else plan_from_d_known(cfg, dk)
                for _, cfg, dk in pending_of[ch]
            ]
            idxs = [i for i, p in enumerate(plans[ch]) if p is None]
            if idxs:
                est_idx[ch] = idxs

        def _phase0_handler(ch):
            def handle(peer, msg_type, payload):
                if msg_type != wf.MSG_TOW_SKETCH:
                    raise WireError(
                        f"expected message 0x{wf.MSG_TOW_SKETCH:02x}, "
                        f"got 0x{msg_type:02x}"
                    )
                idx = est_idx[ch][0]
                set_b, cfg, _ = pending_of[ch][idx]
                reply, plan, est_bytes = serve_phase0(
                    payload, set_b, cfg, self._estimate_limit
                )
                peer.stream.send(reply)
                peer.tally["estimator"] += est_bytes
                plans[ch][idx] = plan
                est_idx[ch].pop(0)
                return not est_idx[ch]
            return handle

        self._poll_peers(
            {ch: _phase0_handler(ch) for ch in est_idx}, phase="admission"
        )

        for ch in joiners:
            peer = self._peers[ch]
            if peer.retired:
                continue
            new = [
                ReconSession(
                    sid=len(self._sessions) + i,
                    plan=plan,
                    state=new_session_state(_EMPTY, set_b, plan),
                    rnd0=rnd,
                )
                for i, (plan, (set_b, _, _)) in enumerate(
                    zip(plans[ch], pending_of[ch])
                )
            ]
            with self._lock:
                # a submit that raced in after the snapshot stays pending
                # and admits at the next barrier (its own rnd0)
                peer.pending = peer.pending[len(pending_of[ch]):]
                peer.admitted = True
                if peer.pending:
                    self._joiners.append(ch)
            if not peer.sessions:
                # first admission arms the resumption record: the frame
                # numbering base and a transcript opened at this epoch —
                # which is the peer's LOCAL epoch 0 even when the hub's
                # counter is mid-life (tree cold-start joiners, §15)
                peer.rnd0 = rnd
                peer.rounds_done = 0
                peer.epoch_base = self._epoch
                peer.digest = wf.transcript_digest0(0)
                peer.digest_prev = peer.digest
                peer.inflight_ctx = None
                peer.marks = {k: peer.tally[k] for k in peer.marks}
            peer.sessions.extend(new)
            self._batch.add_sessions(new)   # appends to self._sessions
        return True

    # -- continuous sync (DESIGN.md §11) ----------------------------------

    def advance_epoch(self, mutations: dict | None = None, *,
                      d_known: dict | None = None) -> int:
        """Open the next epoch for every surviving peer; returns its number.

        ``mutations``: channel -> {local sid: (added, removed)} — this
        side's per-session churn on B (the hub never folds a diff; B is
        the canonical replica its peers converge to).  ``d_known``:
        channel -> {local sid: d | None} *rebinds* a session's d
        convention from this epoch on (an int pins d for this and later
        epochs, ``None`` returns it to estimation); unmentioned sessions
        keep their current convention (initially the submit-time one), so
        estimator sessions re-run the d̂ handshake when their peer opens
        the epoch.
        Evicted peers stay retired; everyone else un-retires and the next
        ``serve`` starts with the ``MSG_EPOCH`` handshake barrier, patches
        the resident stores in place, and drives the epoch's rounds.
        Requires ``HubEndpoint(continuous=True)``.
        """
        if not self._continuous:
            raise RuntimeError("advance_epoch needs HubEndpoint(continuous=True)")
        if self._epoch_open:
            raise RuntimeError(
                f"epoch {self._epoch} is already staged; serve it first"
            )
        muts = mutations or {}
        dks = d_known or {}
        # a typo'd channel or local sid must not silently drop churn
        for name, by_ch in (("mutations", muts), ("d_known", dks)):
            for ch, per_sid in by_ch.items():
                if ch not in self._peers:
                    raise KeyError(f"unknown channel {ch} in epoch {name}")
                bad = set(per_sid or {}) - set(
                    range(len(self._peers[ch].sessions))
                )
                if bad:
                    raise KeyError(
                        f"unknown sid(s) {sorted(bad)} for channel {ch} "
                        f"in epoch {name}"
                    )
        self._epoch += 1
        self._epoch_open = True
        for ch in self._order:
            peer = self._peers[ch]
            if peer.error is not None:
                continue                    # evicted peers never come back
            for i, dk in (dks.get(ch) or {}).items():
                peer.d_known[i] = dk
            pend = {}
            for i, sess in enumerate(peer.sessions):
                added, removed = (muts.get(ch) or {}).get(i, (_EMPTY, _EMPTY))
                pend[i] = (
                    apply_churn(sess.state.b, added, removed),
                    peer.d_known[i],
                )
            peer.epoch_pending = pend
            peer.epoch_plans = {}
            peer.retired = False
            peer.verified = None
        return self._epoch

    def _epoch_handshake(self) -> None:
        """The epoch-open barrier: every surviving peer owes its
        ``MSG_EPOCH`` frames — one wrapped ToW sketch per estimator
        session (answered with a wrapped d̂ reply through the shared
        ``serve_phase0``), or a single bare epoch-open when the peer has
        none — under the usual per-peer deadline; a silent peer is evicted
        here exactly like at a round barrier.  Survivors' sessions then
        fold the epoch in: fresh plans and round states, resident stores
        delta-patched in place (zero rebuilds on the pure delta path).
        """
        self._epoch_open = False
        active = [
            self._peers[ch] for ch in self._order
            if not self._peers[ch].retired and self._peers[ch].epoch_pending
        ]

        def _handler(ch):
            def handle(peer, msg_type, payload):
                if msg_type != wf.MSG_EPOCH:
                    raise WireError(
                        f"expected message 0x{wf.MSG_EPOCH:02x}, "
                        f"got 0x{msg_type:02x}"
                    )
                return serve_epoch_frame(
                    payload, self._epoch - peer.epoch_base,
                    peer.epoch_pending,
                    peer.epoch_plans,
                    lambda i: peer.sessions[i].plan.cfg,
                    peer.stream, peer.tally, self._estimate_limit,
                )
            return handle

        self._poll_peers(
            {p.channel: _handler(p.channel) for p in active},
            phase="epoch-handshake",
        )
        for peer in active:
            if peer.retired:                # evicted during the handshake
                peer.epoch_pending = None
                continue
            pend, peer.epoch_pending = peer.epoch_pending, None
            for i in sorted(pend):
                set_b, dk = pend[i]
                sess = peer.sessions[i]
                plan = peer.epoch_plans.get(i) or plan_from_d_known(
                    sess.plan.cfg, dk
                )
                advance_session(self._batch, sess, plan, new_b=set_b, rnd0=0)
            peer.epoch_plans = {}
            # re-arm the resumption record for the fresh epoch, mirroring
            # the peer endpoint's _reset_rounds (rnd0 back to 0)
            peer.rnd0 = 0
            peer.rounds_done = 0
            peer.digest = wf.transcript_digest0(self._epoch - peer.epoch_base)
            peer.digest_prev = peer.digest
            peer.inflight_ctx = None
            peer.marks = {k: peer.tally[k] for k in peer.marks}

    # -- the round barrier ------------------------------------------------

    def _collect(self, expect: dict[int, int]) -> dict[int, bytes]:
        """One frame from each peer in ``expect`` (channel -> msg type) via
        the shared poller; timed-out, disconnected, or misbehaving peers
        are evicted and simply absent from the result."""
        got: dict[int, bytes] = {}

        def _handler(ch, want):
            def handle(peer, msg_type, payload):
                if msg_type != want:
                    raise WireError(
                        f"expected message 0x{want:02x}, got 0x{msg_type:02x}"
                    )
                got[ch] = payload
                return True
            return handle

        self._poll_peers(
            {ch: _handler(ch, want) for ch, want in expect.items()},
            phase="round-barrier",
        )
        return got

    def _peer_live(self, peer: _Peer, rnd: int) -> bool:
        """Mirror of the peer's own ``plan_round(local) != []`` check."""
        return any(
            not s.failed and session_live(s.state, s.plan.cfg, rnd - s.rnd0)
            for s in peer.sessions
        )

    # -- serve -------------------------------------------------------------

    def serve(self) -> dict[int, PeerOutcome]:
        """Drive every peer's sessions to completion; channel -> outcome."""
        st = self._stats = {
            "epoch": self._epoch,
            "rounds": 0, "cohort_rounds": 0,
            "kernel_launches": 0, "decode_launches": 0,
            "h2d_round_bytes": 0,
            "peers": self._stats.get("peers", 0),
            "peers_failed": self._stats.get("peers_failed", 0),
            "peers_failed_by_kind": self._stats.get("peers_failed_by_kind", {}),
            "peers_resumed": self._stats.get("peers_resumed", 0),
            "resume_replay_bytes": self._stats.get("resume_replay_bytes", 0),
            "sessions_degraded": self._stats.get("sessions_degraded", 0),
            "parity_extensions": self._stats.get("parity_extensions", 0),
            "tree_levels": 0, "tree_digest_bytes": 0, "tree_leaves": 0,
        }
        prior = self._batch.counters()
        retrace_mark = retrace_count()
        rnd = self._rnd = 0
        hook_fired_at = -1
        tracer = self.tracer
        tracer.instant("hub.serve", epoch=self._epoch)
        if self._epoch_open:
            with tracer.span("hub.epoch_handshake", epoch=self._epoch):
                self._epoch_handshake()
        self._admit(rnd)
        while True:
            self._expire_overdue()
            active = [
                self._peers[ch] for ch in self._order
                if not self._peers[ch].retired
            ]
            if not active:
                suspended = any(
                    p.suspended for p in self._peers.values()
                )
                # fire the barrier hook at most once per round number, even
                # when the round-end firing below already covered this rnd —
                # UNLESS suspended peers are waiting, in which case it
                # re-fires each wait slice so a driver can resume them
                if self.on_barrier is not None and (
                    hook_fired_at != rnd or suspended
                ):
                    hook_fired_at = rnd
                    self.on_barrier(rnd)
                if self._admit(rnd):
                    continue
                if any(
                    not self._peers[ch].retired for ch in self._order
                ):
                    continue                # a resume re-activated a peer
                if any(p.suspended for p in self._peers.values()):
                    time.sleep(_POLL_S)     # wait out the resume window
                    continue
                break
            rnd = self._rnd = rnd + 1

            # barrier phase 1: live peers owe ROUND_SKETCHES, finished
            # peers owe VERIFY — collect both in one round-robin sweep
            expect = {
                p.channel: (
                    wf.MSG_ROUND_SKETCHES if self._peer_live(p, rnd)
                    else wf.MSG_VERIFY
                )
                for p in active
            }
            with tracer.span("hub.collect_sketches", cat="wire", round=rnd,
                             peers=len(expect)):
                frames = self._collect(expect)
            for ch, payload in list(frames.items()):
                if expect[ch] == wf.MSG_VERIFY:
                    self._finish_peer(self._peers[ch], payload)
                    del frames[ch]

            # shared plan over every surviving live session (evictions
            # above already marked their sessions failed), then the fused
            # single-side encode: 2 kernel launches per cohort, all peers
            plans = self._batch.plan_round(rnd)
            # launch counters are bumped at the dispatch sites inside the
            # helpers, so the fusion stats measure dispatches — one encode
            # and one decode per cohort regardless of peer count — rather
            # than echoing the planner's own bookkeeping
            with tracer.span("hub.encode", cat="device", round=rnd,
                             cohorts=len(plans)):
                per = encode_round_rows(plans, self.side, self.device,
                                        launches=st)
            if plans:
                st["rounds"] = rnd
            st["cohort_rounds"] += len(plans)
            st["h2d_round_bytes"] += sum(p.h2d_bytes for p in plans)

            round_ctx = self._apply_sketches(rnd, frames, plans, per)

            # barrier phase 2: the per-peer checksum-outcome frames
            with tracer.span("hub.collect_outcomes", cat="wire", round=rnd,
                             peers=len(round_ctx)):
                outcomes = self._collect({
                    ch: wf.MSG_ROUND_OUTCOME for ch in round_ctx
                })
            for ch, payload in outcomes.items():
                with tracer.span("peer.round.outcome", round=rnd, channel=ch,
                                 peer=self._peers[ch].label):
                    self._apply_outcome(self._peers[ch], rnd, payload,
                                        *round_ctx[ch])
            tracer.instant("hub.barrier", round=rnd, epoch=self._epoch,
                           peers=len(active))

            if self._degrade:
                # graceful degradation (DESIGN.md §13): any session one
                # round from exhausting its budget with work left re-plans
                # at a doubled d̂; both sides run this at the same barrier
                st["sessions_degraded"] += len(
                    degrade_exhausted(self._batch, rnd)
                )

            if self.on_barrier is not None:
                hook_fired_at = rnd
                self.on_barrier(rnd)
            self._admit(rnd)

        st["store_uploads"] = self._batch.store_builds
        # per-serve continuous-sync ledger: store uploads, rebuilds, and
        # delta-patch bytes THIS epoch paid for (DESIGN.md §11) — a
        # zero-rebuild epoch shows store_builds == 0, zero store bytes,
        # and only O(churn) delta bytes (store_uploads stays cumulative:
        # the one-per-cohort fusion contract the acceptance test asserts)
        delta = {
            k: v - prior[k] for k, v in self._batch.counters().items()
        }
        st["h2d_store_bytes"] = delta["store_build_bytes"]
        st["store_builds"] = delta["store_builds"]
        st["store_compactions"] = delta["store_compactions"]
        st["h2d_delta_bytes"] = delta["store_delta_bytes"]
        st["h2d_bytes"] = (
            st["h2d_store_bytes"] + st["h2d_round_bytes"]
            + st["h2d_delta_bytes"]
        )
        # jit cache-miss ledger (DESIGN.md §12): compilations THIS serve
        # triggered across every kernel entry point — a warm hub epoch
        # re-uses the pow2-bucketed signatures and reports 0
        st["retraces"] = retrace_count() - retrace_mark
        # the freeze point is the publish point: the legacy `stats` view
        # derives back from these registry rows (DESIGN.md §14)
        self.recorder.publish("hub", st)
        self.recorder.publish("store", self._batch.counters())
        self.recorder.set("kernels.retraces_total", retrace_count())
        self.recorder.set("kernels.retraces_by_fn", retrace_counts())
        if tracer.enabled:
            for ch in self._order:
                p = self._peers[ch]
                tracer.instant(
                    "peer.result", channel=ch, peer=p.label,
                    ok=p.error is None, kind=self._peer_kind(p),
                    rounds=p.rounds_done, resumes=p.resumes,
                    protocol_bytes=p.tally["protocol"],
                    resume_bytes=p.tally["resume"],
                )
        return {
            ch: PeerOutcome(
                channel=ch,
                ok=self._peers[ch].error is None,
                verified=self._peers[ch].verified,
                error=self._peers[ch].error,
                sessions=self._peers[ch].sessions,
                wire_stats=self._peers[ch].wire_stats(),
                error_kind=self._peer_kind(self._peers[ch]),
                tree_depth=self._peers[ch].tree_depth,
                tree_leaves=self._peers[ch].tree_leaves,
            )
            for ch in self._order
        }

    def _peer_kind(self, peer: _Peer) -> str | None:
        """The ``PeerOutcome.error_kind`` taxonomy value for one peer:
        failures classify by root cause; successful peers report which
        recovery path they took (``resumed`` wins over ``degraded`` when
        both fired), or None for a clean run."""
        if peer.error is not None:
            return classify_error(peer.error)
        if peer.resumes:
            return "resumed"
        if any(s.escalations for s in peer.sessions):
            return "degraded"
        return None

    @property
    def stats(self) -> dict:
        """Fusion ledger of the last ``serve``: global rounds, cohort
        rounds, kernel/decode launches (2 + 1 per cohort-round, shared
        across all peers), and the store-upload accounting.

        A derived snapshot of the ``hub.*`` metrics in the recorder: the
        working ledger is re-published on read (mid-serve mutations like
        evictions land immediately) and the dict rebuilds from the
        registry rows — same keys and values as the pre-obs ad-hoc dict
        (DESIGN.md §14)."""
        st = dict(self._stats)
        self.recorder.publish("hub", st)
        view = self.recorder.view("hub")
        return {k: view[k] for k in st}

    # -- round internals ---------------------------------------------------

    def _apply_sketches(self, rnd: int, frames: dict[int, bytes], plans, per):
        """Decode every peer's sketch frame against its schema, run ONE
        batched BCH decode per cohort across all peers' units, and send
        each surviving peer its reply frame.  Returns the per-peer outcome
        context for barrier phase 2."""
        # per peer: her live sessions in local-sid order + decoded blocks
        sk_a_of: dict[int, np.ndarray] = {}     # global sid -> (U, t)
        peer_live: dict[int, list[int]] = {}    # channel -> global sids
        for ch, payload in frames.items():
            peer = self._peers[ch]
            live_g = [s.sid for s in peer.sessions if s.sid in per]
            try:
                got_rnd, blocks = wf.decode_round_sketches(
                    payload, round_schema(per, live_g)
                )
                local = rnd - peer.rnd0
                if got_rnd != local:
                    raise WireError(
                        f"sketch frame for round {got_rnd}, expected {local}"
                    )
            except WireError as e:
                self._evict(peer, e)
                continue
            peer.tally["protocol"] += framed_len(len(payload))
            peer_live[ch] = live_g
            sk_a_of.update(zip(live_g, blocks))

        # one decode launch per cohort, all peers' units stacked; sessions
        # of peers evicted after planning keep zero rows and are skipped
        with self.tracer.span("hub.decode", cat="device", round=rnd,
                              cohorts=len(plans)):
            results, ctx = decode_side_b_round(plans, per, sk_a_of,
                                               launches=self._stats)

        round_ctx: dict[int, tuple] = {}
        for ch, live_g in peer_live.items():
            peer = self._peers[ch]
            local = rnd - peer.rnd0
            with self.tracer.span("peer.round.reply", round=rnd, channel=ch,
                                  peer=peer.label, sessions=len(live_g)):
                reply = wf.encode_round_reply(
                    local, [results[g] for g in live_g],
                    round_schema(per, live_g),
                )
                # the reply may reach the peer even when its send raises (a
                # lost ACK, a corrupted inbound datagram met while waiting
                # for it), and she may then complete the round on her side:
                # retain the outcome context BEFORE the send, so a resume
                # one barrier ahead replays her outcome frame (DESIGN.md
                # §13) instead of failing as unresumable
                peer.inflight_ctx = (live_g, ctx)
                try:
                    peer.stream.send(reply)
                except TransportError as e:
                    self._fail(peer, e, resumable=True)
                    continue
            peer.tally["protocol"] += len(reply)
            round_ctx[ch] = (live_g, ctx)
        if round_ctx:
            self._rateless_phase(rnd, plans, per, sk_a_of, round_ctx)
        return round_ctx

    def _rateless_phase(self, rnd, plans, per, sk_a_of, round_ctx) -> None:
        """Serve the rateless recovery ladder (DESIGN.md §16) between the
        reply send and the outcome barrier.

        Every peer with failing rateless units owes one ``MSG_PARITY``
        frame per ladder level, collected through the shared poller; the
        hub answers each level with ONE incremental encode dispatch and
        ONE extended decode per cohort, shared across all peers, and
        merges recovered verdicts into the retained round contexts in
        place — the outcome frames (and any resume replay from
        ``inflight_ctx``, which aliases the same ``ctx`` tuples) see the
        post-ladder verdicts.  Peers that fail mid-ladder drop out of
        ``round_ctx`` so the outcome barrier never polls them; a
        suspended peer's re-run starts the round (and its ladder) from
        scratch, so partial merges never leak into session state."""
        fail: dict[int, dict[int, list[int]]] = {}      # ch -> sid -> slots
        for ch, (live_g, ctx) in round_ctx.items():
            bad = {}
            for sid in live_g:
                sess, active, ok, _ = ctx[sid]
                if not sess.plan.cfg.rateless:
                    continue
                slots = [s for s in range(len(active)) if not ok[s]]
                if slots:
                    bad[sid] = slots
            if bad:
                fail[ch] = bad
        if not fail:
            return
        st = self._stats
        acc: dict[int, dict[int, np.ndarray]] = {}      # sid -> slot -> syn
        for level in range(1, MAX_PARITY_EXTENSIONS + 1):
            if not fail:
                return
            failing = {sid for bad in fail.values() for sid in bad}
            part_plans = [
                plan for plan in plans
                if any(sess.sid in failing for sess, *_ in plan.members)
            ]
            with self.tracer.span("hub.parity_encode", cat="device",
                                  round=rnd, level=level,
                                  cohorts=len(part_plans)):
                inc_of = encode_round_rows_ext(
                    part_plans, self.side, level, self.device,
                    launches=st,
                )
            # mirror of each peer's own participation check: failing
            # sessions whose cohort t still grows at this level
            need: dict[int, list[int]] = {}
            for ch, bad in fail.items():
                parts = [
                    sid for sid in round_ctx[ch][0]
                    if sid in bad and sid in inc_of
                ]
                if parts:
                    need[ch] = parts
            if not need:
                return
            with self.tracer.span("hub.collect_parity", cat="wire",
                                  round=rnd, level=level, peers=len(need)):
                frames = self._collect({
                    ch: wf.MSG_PARITY for ch in need
                })
            for ch in list(need):
                if ch not in frames:    # evicted/suspended at the barrier
                    del need[ch]
                    fail.pop(ch, None)
                    round_ctx.pop(ch, None)
            # fold each peer's incremental columns into its failing
            # units' accumulated diff syndromes (prefix cached at decode)
            for ch, payload in frames.items():
                peer = self._peers[ch]
                bad = fail[ch]
                parts = need[ch]
                schema = [
                    (len(bad[sid]), inc_of[sid][2] - inc_of[sid][1],
                     per[sid].plan.store.m)
                    for sid in parts
                ]
                try:
                    got_rnd, got_level, blocks = wf.decode_parity(
                        payload, schema
                    )
                    local = rnd - peer.rnd0
                    if got_rnd != local:
                        raise WireError(
                            f"parity frame for round {got_rnd}, "
                            f"expected {local}"
                        )
                    if got_level != level:
                        raise WireError(
                            f"parity frame at level {got_level}, "
                            f"expected {level}"
                        )
                except WireError as e:
                    self._evict(peer, e)
                    del need[ch]
                    del fail[ch]
                    round_ctx.pop(ch, None)
                    continue
                peer.tally["protocol"] += framed_len(len(payload))
                for sid, inc_a in zip(parts, blocks):
                    inc_b = inc_of[sid][0]
                    prefix_a = sk_a_of[sid]
                    sk_b = per[sid].sk
                    slot_acc = acc.setdefault(sid, {})
                    for i, slot in enumerate(bad[sid]):
                        prev = slot_acc.get(slot)
                        if prev is None:
                            prev = np.asarray(
                                prefix_a[slot], dtype=np.int64
                            ) ^ np.asarray(sk_b[slot], dtype=np.int64)
                        d = np.asarray(
                            inc_a[i], dtype=np.int64
                        ) ^ np.asarray(inc_b[slot], dtype=np.int64)
                        slot_acc[slot] = np.concatenate([prev, d])
            if not need:
                continue
            # reply schemas before the merge loop mutates ``fail``: each
            # ext reply covers every unit failing at this level, at t1
            reply_schema = {
                ch: [
                    (len(fail[ch][sid]), inc_of[sid][2],
                     per[sid].plan.store.m)
                    for sid in parts
                ]
                for ch, parts in need.items()
            }
            ch_of = {sid: ch for ch, parts in need.items() for sid in parts}
            entries: dict[int, tuple] = {}
            with self.tracer.span("hub.parity_decode", cat="device",
                                  round=rnd, level=level):
                for plan in part_plans:
                    n, t = plan.store.n, plan.store.t
                    t1 = parity_extension_t(t, level, n)
                    if t1 <= parity_extension_t(t, level - 1, n):
                        continue
                    u_pad = plan.arrays["row_map"].shape[0]
                    buf = np.zeros((u_pad, t1), dtype=np.int64)
                    hit = False
                    for sess, base, active, _ in plan.members:
                        ch = ch_of.get(sess.sid)
                        if ch is None:
                            continue
                        for slot in fail[ch][sess.sid]:
                            buf[base + slot] = acc[sess.sid][slot]
                            hit = True
                    if not hit:
                        continue
                    # field elements below 2^m: int64 on the host, int32 on
                    # the card; ok_p is a fresh writable array
                    ok_p, pos_p, cnt_p = _unpack_decode(
                        _decode_packed(buf, n, t1, self.device), t1
                    )
                    st["decode_launches"] = st.get("decode_launches", 0) + 1
                    for sess, base, active, _ in plan.members:
                        sid = sess.sid
                        ch = ch_of.get(sid)
                        if ch is None:
                            continue
                        row = per[sid]
                        ok_m = round_ctx[ch][1][sid][2]
                        ok_e, units, still = [], [], []
                        for slot in fail[ch][sid]:
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
                                ok_m[slot] = True   # in place: outcome +
                                # resume replay see the ladder verdict
                            else:
                                units.append(None)
                                ok_e.append(False)
                                still.append(slot)
                        entries[sid] = (ok_e, units)
                        if still:
                            fail[ch][sid] = still
                        else:
                            del fail[ch][sid]
                        st["parity_extensions"] = (
                            st.get("parity_extensions", 0) + 1
                        )
                        self.tracer.instant(
                            "hub.parity_extension", channel=ch, sid=sid,
                            round=rnd, level=level,
                            units=len(ok_e), t=t1,
                        )
            for ch, parts in need.items():
                peer = self._peers[ch]
                reply = wf.encode_round_reply(
                    rnd - peer.rnd0,
                    [entries[sid] for sid in parts],
                    reply_schema[ch],
                )
                try:
                    peer.stream.send(reply)
                except TransportError as e:
                    self._fail(peer, e, resumable=True)
                    fail.pop(ch, None)
                    round_ctx.pop(ch, None)
                    continue
                peer.tally["protocol"] += len(reply)
                if not fail.get(ch):
                    fail.pop(ch, None)

    def _apply_outcome(self, peer: _Peer, rnd: int, payload: bytes,
                       live_g: list[int], ctx: dict[int, tuple],
                       *, replay: bool = False) -> None:
        """Mirror one peer's unit-queue evolution from her outcome frame:
        our decode failures drive the same deterministic 3-way split, her
        flags settle the checksums we cannot compute (we never see A).
        Applying the frame commits the peer's round barrier: the transcript
        digest folds the exact framed bytes she folded, the recovery record
        advances, and the tally marks snapshot — the state ``resume_peer``
        validates against.  ``replay=True`` routes the frame's bytes to the
        resume tally (transport overhead, never Formula-(1) bits)."""
        try:
            got_rnd, done_lists = wf.decode_round_outcome(
                payload, [len(ctx[g][1]) for g in live_g]
            )
            local = rnd - peer.rnd0
            if got_rnd != local:
                raise WireError(
                    f"outcome frame for round {got_rnd}, expected {local}"
                )
        except WireError as e:
            self._evict(peer, e)
            return
        if replay:
            peer.tally["resume"] += framed_len(len(payload))
            self._stats["resume_replay_bytes"] = (
                self._stats.get("resume_replay_bytes", 0)
                + framed_len(len(payload))
            )
        else:
            peer.tally["protocol"] += framed_len(len(payload))
        for g, done in zip(live_g, done_lists):
            sess, active, ok, _ = ctx[g]
            sloc = rnd - sess.rnd0
            for slot, u in enumerate(active):
                if not ok[slot]:
                    queue_split(sess.state, u, sloc, sess.plan.cfg.seed)
                elif done[slot]:
                    u.done = True
            sess.state.rounds = sloc
        # barrier committed: fold the same bytes the peer folded (her frame
        # numbering is our local round) and advance the recovery record
        peer.digest_prev = peer.digest
        peer.digest = wf.fold_transcript(
            peer.digest, local, wf.frame(wf.MSG_ROUND_OUTCOME, payload)
        )
        peer.rounds_done = local
        peer.inflight_ctx = None
        peer.marks = {k: peer.tally[k] for k in peer.marks}


def _drive_hub(
    hub: HubEndpoint,
    peer_calls: dict[int, object],
    join_timeout: float,
):
    """Run one hub ``serve`` against one callable per peer channel."""
    results: dict[int, dict[int, ReconcileResult]] = {}
    errors: dict[int, BaseException] = {}

    def _drive(ch: int, call):
        try:
            results[ch] = call()
        except BaseException as e:  # noqa: BLE001 - reported per peer
            errors[ch] = e

    threads = [
        threading.Thread(target=_drive, args=(ch, call),
                         name=f"peer-{ch}", daemon=True)
        for ch, call in peer_calls.items()
    ]
    for th in threads:
        th.start()
    outcomes = hub.serve()
    for th in threads:
        th.join(timeout=join_timeout)
    return outcomes, results, errors


def run_hub(
    hub: HubEndpoint,
    alices: dict[int, AliceEndpoint],
    *,
    join_timeout: float = 120.0,
):
    """Drive a hub and its connected peers concurrently: each Alice on a
    worker thread, the hub on the caller's thread.

    Returns ``(outcomes, results, errors)``: the hub's per-channel
    ``PeerOutcome``s, per-channel Alice results (``sid -> ReconcileResult``)
    for peers whose ``run`` completed, and per-channel exceptions for peers
    whose ``run`` raised (evicted stragglers see their transport closed, so
    they fail fast with ``TransportError`` instead of hanging).
    """
    return _drive_hub(
        hub, {ch: ep.run for ch, ep in alices.items()}, join_timeout
    )


def run_hub_epoch(
    hub: HubEndpoint,
    alices: dict[int, AliceEndpoint],
    *,
    join_timeout: float = 120.0,
):
    """Drive one staged continuous-sync epoch (DESIGN.md §11): the hub and
    every surviving peer must have called ``advance_epoch``; each Alice
    runs ``run_epoch`` on a worker thread against one hub ``serve``.  Same
    return shape and per-peer error semantics as ``run_hub``.
    """
    return _drive_hub(
        hub, {ch: ep.run_epoch for ch, ep in alices.items()}, join_timeout
    )
