"""Multi-session planning: cohort stores, round overlays, and SessionBatch.

One ``ReconSession`` is one Alice↔Bob pair running the full PBS protocol with
its own parameters, seeds, and byte ledger.  The planner's job (DESIGN.md §5)
is to turn S concurrent sessions into dense accelerator work each round while
keeping host↔device traffic off the steady-state path.  The planner is
numpy on the host; only the store upload and the delta patches touch the
device:

1. sessions are bucketed into **cohorts** by BCH code (n, t) — cohort
   membership is fixed at submit time, since phase 0 pins every session's
   code before the first round;
2. at the start of ``run`` each cohort builds its **element store** once:
   both sides' elements packed row-per-group in a padded ``(G, W)`` device
   matrix (grouping is round-invariant — the group hash seed never changes),
   uploaded a single time for the whole protocol;
3. per round the planner emits only small index/overlay arrays — the
   unit→store-row gather map, per-unit bin seeds, Alice's diff overlay
   (removed = A ∩ D̂, added = D̂ \\ A per unit), and the 3-way-split filter
   chains — and the fused executor rebuilds each unit's element rows *on
   device* from the resident store.

Every dynamic dimension (unit rows, store widths, overlay widths, filter
depth) is bucketed to a power of two at or above the hardware alignment
(``pow2_bucket``), so a serving loop converges to a bounded set of compiled
executor variants per cohort code.

The per-unit element *sets* the executor reconstructs are exactly the
``slot_assignment`` sets of the single-session oracle (parity/XOR/checksum
reductions are permutation-invariant), which is what keeps the batched
engine unit-for-unit identical to ``core.pbs.reconcile``.

Stores are built per *side*: the in-process server batches both sides; a
wire endpoint passes ``sides=("a",)`` or ``("b",)`` and gets
the identical round plans over only its own resident elements
(DESIGN.md §9).

A **mutable** batch (``SessionBatch(mutable=True)``, DESIGN.md §11) is the
continuous-sync variant: rows are packed with per-row capacity slack, and
``apply_mutations`` patches the device-resident CSR *in place* between
epochs — removals back-fill each hole with the row's tail element (a
tombstone immediately reclaimed), additions append into the row's free
lane — shipping only O(churn) scatter indices/values instead of rebuilding
and re-uploading the whole store.  A row that outgrows its lane triggers a
compaction (one counted cohort rebuild with fresh slack).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

import torch

from ..core.bch import bch_code
from ..core.hashing import derive_seed_seeded, hash_to_range_seeded
from ..core.sets import setdiff_keys, unique_keys
from ..core.pbs import (
    MAX_ESCALATIONS,
    ProtocolPlan,
    SessionState,
    diff_overlay,
    escalated_plan,
    group_view,
    new_session_state,
    session_live,
)
from ..kernels.platform import ceil_to as _ceil_to
from ..kernels.platform import pow2_bucket, resolve_device, upload
from ..obs.trace import NULL_TRACER


class StoreCapacityError(RuntimeError):
    """A delta mutation would overflow a row's capacity lane: the caller
    must compact (rebuild the cohort store with fresh slack)."""


@dataclass
class ReconSession:
    """One submitted Alice↔Bob pair: its plan (phase 0) + mutable round state.

    ``rnd0`` is the session's global-round offset: a hub peer admitted
    between global rounds runs its *local* protocol rounds 1, 2, … at global
    rounds ``rnd0 + 1, rnd0 + 2, …`` (DESIGN.md §10).  All protocol-visible
    round arithmetic — bin seeds, the round budget, frame round numbers —
    uses the local round, so a late joiner is byte-identical to a pair that
    started alone.  ``failed`` excludes a session from all future planning
    (hub eviction: straggler deadline or peer disconnect) without touching
    its cohort's device-resident store.

    ``suspended`` (DESIGN.md §13) parks a session whose peer disconnected
    but is still *resumable*: it plans no rounds while parked, but — unlike
    ``failed`` — it keeps its cohort-store membership, so a store rebuilt
    during the outage still carries its rows and resumption needs zero
    store work.  ``escalations`` counts the degradation-ladder rungs this
    session has climbed (``escalate_session``).
    """

    sid: int
    plan: ProtocolPlan
    state: SessionState
    rnd0: int = 0
    failed: bool = False
    suspended: bool = False
    escalations: int = 0

    @property
    def code_key(self) -> tuple[int, int]:
        return (self.plan.n, self.plan.t)


@dataclass
class SideStore:
    """One side's slice of a cohort store: CSR flat elements + row extents.

    A both-sides batch (the in-process ``ReconcileServer``) holds an "a" and
    a "b" SideStore per cohort; a wire endpoint holds only its own
    side — Alice never materializes Bob's elements and vice versa.

    Mutable stores (continuous sync, DESIGN.md §11) additionally keep host
    mirrors: ``flat_host`` (the element lanes), ``cap_host`` (each row's
    allocated lane capacity, ``cnt_host <= cap_host``).  The executor never
    sees the lanes — it gathers ``offs < cnt`` exactly as for a one-shot
    store, so delta mutations change *no* device code path.
    """

    flat: torch.Tensor             # (E_total,) int32 bit patterns of the
                                   #   uint32 keys, device-resident
    start: torch.Tensor            # (G,) int32 row offsets into flat
    cnt: torch.Tensor              # (G,) int32 row element counts
    cnt_host: np.ndarray           # host copy: gather widths + accounting
    h2d_bytes: int                 # one-time upload cost of this side
    start_host: np.ndarray | None = None
    flat_host: np.ndarray | None = None   # mutable stores only
    cap_host: np.ndarray | None = None    # mutable stores only


@dataclass
class CohortStore:
    """One cohort's device-resident element store, uploaded once per run.

    CSR layout — one flat element array per resident side plus per-row
    (start, count) — so the one-time upload is the raw element bytes with no
    padding waste.  Row ``row_of[(sid, group)]`` is that session group's
    slice; the executor gathers ``flat[start + iota]`` into padded unit rows
    *on device* and derives the valid mask from the counts, so neither
    padded element matrices nor valid matrices ever cross the host↔device
    boundary.  ``sides`` holds the resident ``SideStore``s: both for the
    in-process server, exactly one for a wire endpoint.
    """

    n: int
    t: int
    m: int
    row_of: dict                   # (sid, group) -> store row index
    sides: dict                    # "a"/"b" -> SideStore
    generation: int = 0            # bumped per in-place delta patch
    # rows are contiguous per member session (row_of[(sid, g)] == base + g);
    # the vectorized planner turns S×g dict lookups into one add over this
    row_base: dict = field(default_factory=dict)   # sid -> first store row

    @property
    def a(self) -> SideStore:
        return self.sides["a"]

    @property
    def b(self) -> SideStore:
        return self.sides["b"]

    @property
    def h2d_bytes(self) -> int:
        return sum(s.h2d_bytes for s in self.sides.values())

    def apply_side_mutations(self, side: str, row_updates: dict) -> int:
        """Patch one side's CSR rows in place; returns the delta-H2D bytes.

        ``row_updates`` maps store row -> (added values, removed values),
        both duplicate-free and disjoint from each other.  Removals
        back-fill each hole with an element from the row's live tail (a
        tombstone reclaimed in the same pass), additions append into the
        row's free lane, so the live elements stay a ``[start, start+cnt)``
        prefix and the executor's gather mask needs no changes.  The device
        update is two in-place scatters into the resident tensors (flat
        slots, row counts), ordered on the stream behind any round still
        reading them; only their index and value arrays cross the
        host↔device boundary.

        Raises ``StoreCapacityError`` (capacity overflow, the compaction
        trigger) or ``ValueError`` (removing a non-resident element) —
        both checked up front, before any mirror or device state changes.
        """
        ss = self.sides[side]
        if ss.flat_host is None or ss.cap_host is None:
            raise StoreCapacityError("store was built without mutation lanes")
        for row, (added, removed) in row_updates.items():
            if ss.cnt_host[row] - len(removed) + len(added) > ss.cap_host[row]:
                raise StoreCapacityError(
                    f"row {row}: {ss.cnt_host[row]} - {len(removed)} + "
                    f"{len(added)} elements exceed the {ss.cap_host[row]} lane"
                )
            if removed:
                seg = ss.flat_host[
                    ss.start_host[row] : ss.start_host[row] + ss.cnt_host[row]
                ]
                missing = len(removed) - int(np.isin(seg, removed).sum())
                if missing:
                    raise ValueError(
                        f"row {row}: {missing} removed elements not resident"
                    )
        idx_out: list[int] = []
        val_out: list[int] = []
        rows_out: list[int] = []
        cnt_out: list[int] = []
        for row in sorted(row_updates):
            added, removed = row_updates[row]
            s, c = int(ss.start_host[row]), int(ss.cnt_host[row])
            if len(removed):
                seg = ss.flat_host[s : s + c]
                hole = np.isin(seg, removed)
                k = len(removed)
                # holes below the new extent take the tail's live elements
                dst = np.nonzero(hole[: c - k])[0]
                src = seg[c - k :][~hole[c - k :]]
                for p, v in zip(dst, src):
                    ss.flat_host[s + p] = v
                    idx_out.append(s + int(p))
                    val_out.append(int(v))
                c -= k
            for v in added:
                ss.flat_host[s + c] = v
                idx_out.append(s + c)
                val_out.append(int(v))
                c += 1
            if c != int(ss.cnt_host[row]):
                ss.cnt_host[row] = c
                rows_out.append(row)
                cnt_out.append(c)
        delta = 0
        if idx_out:
            idx = np.asarray(idx_out, dtype=np.int32)
            val = np.asarray(val_out, dtype=np.uint32)
            dev = ss.flat.device
            ss.flat.index_copy_(
                0, upload(idx, dev).to(torch.int64), upload(val, dev)
            )
            delta += idx.nbytes + val.nbytes
        if rows_out:
            rows = np.asarray(rows_out, dtype=np.int32)
            cnts = np.asarray(cnt_out, dtype=np.int32)
            dev = ss.cnt.device
            ss.cnt.index_copy_(
                0, upload(rows, dev).to(torch.int64), upload(cnts, dev)
            )
            delta += rows.nbytes + cnts.nbytes
        self.generation += 1
        return delta


@dataclass
class CohortRoundPlan:
    """One cohort's host-side work order for one round: small arrays only.

    ``members`` maps each session to its slot range in the packed unit axis:
    (session, slot_base, active_units, bin_seed).  Unit u of session s lives
    at row ``slot_base + u`` of every per-unit array.  Rows past the true
    unit count have ``unit_valid == 0``: the executor masks them to empty,
    they sketch to zero, decode as trivially-ok, and are never mapped back.
    """

    store: CohortStore
    members: list
    units: int                     # true (unpadded) unit count
    width_a: int = 0               # this round's gather widths (pow2-bucketed
    width_b: int = 0               #   max row count among gathered units)
    arrays: dict = field(default_factory=dict)
    h2d_bytes: int = 0             # this round's overlay upload
    legacy_h2d_bytes: int = 0      # what the re-pack-per-round path would ship


def _group_overlay(parts, per_sess, g_of, gseed_of, row_key, gmax):
    """Batch-wide overlay grouping: ``_by_group`` for S sessions in one pass.

    ``parts`` holds each session's overlay values (diff_overlay output
    order), ``per_sess`` their lengths.  Group ids come from the seeded
    multiply-shift hash (exactly ``hash_to_range`` per element), and one
    stable lexsort on (session, group) reproduces every session's stable
    ``group_view`` ordering at once.  Returns ``(row_len, fill)``: row_len
    is each unit row's overlay length (0 when its (session, group) segment
    is empty — the scalar planner's ``None``), and ``fill(target)``
    scatters the grouped values into the padded overlay matrix with one
    fancy-index assignment; ``fill`` is None when no session has overlay
    values (DESIGN.md §12).
    """
    nrows = len(row_key)
    row_len = np.zeros(nrows, dtype=np.int64)
    if not int(per_sess.sum()):
        return row_len, None
    vals = np.concatenate([p for p in parts if len(p)])
    vsess = np.repeat(np.arange(len(per_sess)), per_sess)
    grp = hash_to_range_seeded(vals, g_of[vsess], gseed_of[vsess])
    order = np.lexsort((grp, vsess))  # stable: in-order within (sess, group)
    sv = vals[order]
    key = vsess[order] * gmax + grp[order]
    change = np.empty(len(key), dtype=bool)
    change[0] = True
    np.not_equal(key[1:], key[:-1], out=change[1:])
    seg_at = np.nonzero(change)[0]               # segment starts into sv
    seg_key = key[seg_at]                        # ascending by construction
    seg_len = np.diff(np.append(seg_at, len(key)))
    pos = np.searchsorted(seg_key, row_key)
    pc = np.minimum(pos, len(seg_key) - 1)
    has = seg_key[pc] == row_key
    row_len[has] = seg_len[pc[has]]
    row_src = np.where(has, seg_at[pc], 0)

    def fill(target: np.ndarray) -> None:
        rows_rep = np.repeat(np.arange(nrows), row_len)
        within = np.arange(int(row_len.sum())) - np.repeat(
            np.cumsum(row_len) - row_len, row_len
        )
        target[rows_rep, within] = sv[np.repeat(row_src, row_len) + within]

    return row_len, fill


def _by_group(vals: np.ndarray, g: int, seed_groups: int) -> dict:
    """Partition a small value array by its (round-invariant) group id,
    through the same canonical ``group_view`` the oracle partitions with."""
    if not len(vals):
        return {}
    _, order, bounds = group_view(vals, g, seed_groups)
    sv = vals[order]
    return {
        gi: sv[bounds[gi] : bounds[gi + 1]]
        for gi in range(g)
        if bounds[gi + 1] > bounds[gi]
    }


def pack_csr(
    rows: list, col_align: int, slack: bool = False
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pack variable-length rows into (flat, start, cnt, cap) CSR arrays.

    Lane-pads the flat tail only: the device gather clamps past-end reads.
    (No pow2 bucket — the store shape is fixed for the whole run, so it
    costs one executor compile per cohort, not one per round; only
    round-varying dims need bucketing.)

    With ``slack`` (mutable stores, DESIGN.md §11) each row's allocated
    capacity ``cap`` exceeds its element count by ~25% plus an 8-slot
    floor, leaving a free lane that in-place delta mutations append into;
    without it ``cap == cnt`` and the layout is byte-identical to the
    one-shot path.
    """
    cnt = np.array([len(r) for r in rows], dtype=np.int32)
    vals = (
        np.concatenate(rows).astype(np.uint32)
        if rows else np.zeros(0, dtype=np.uint32)
    )
    return _csr_layout(vals, cnt, col_align, slack)


def _csr_layout(
    vals: np.ndarray, cnt: np.ndarray, col_align: int, slack: bool
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """``pack_csr`` over pre-concatenated row values (``vals`` holds every
    row's elements back to back, ``cnt`` the per-row lengths) — the whole
    layout, including the slack-lane scatter, is numpy passes with no
    per-row Python (DESIGN.md §12)."""
    cnt = np.asarray(cnt, dtype=np.int32)
    cap = _ceil_to(cnt + (cnt >> 2) + 8, 8).astype(np.int32) if slack else cnt
    start = np.zeros(len(cnt), dtype=np.int32)
    np.cumsum(cap[:-1], out=start[1:])
    total = int(cap.sum())
    flat = np.zeros(_ceil_to(max(total, 1), col_align), dtype=np.uint32)
    if slack:
        if len(vals):
            # scatter each row's values into its lane: start[row] + offset
            within = np.arange(len(vals)) - np.repeat(
                np.cumsum(cnt) - cnt, cnt
            )
            flat[np.repeat(start, cnt) + within] = vals
    else:
        # tight layout (cap == cnt): rows are contiguous, one vectorized fill
        flat[: len(vals)] = vals
    return flat, start, cnt, cap


class SessionBatch:
    """Plans per-code cohorts: one resident store, small overlays per round.

    ``sides`` selects which element stores this batch materializes: the
    in-process server batches both ("a", "b"); a wire endpoint passes only
    its own side, and the same planner then emits the same round arrays
    minus the other side's store/widths.

    ``mutable`` (continuous sync, DESIGN.md §11) packs stores with per-row
    capacity slack so ``apply_mutations`` can patch them in place between
    epochs; one-shot batches keep the exact tight layout.
    """

    # alignment floors of the packed layouts: unit rows to the sublane unit,
    # element widths to the lane unit; pow2_bucket rounds up from there.
    ROW_ALIGN = 8
    COL_ALIGN = 128
    OVERLAY_ALIGN = 8              # diff-overlay widths (removed/added cols)

    def __init__(
        self,
        sessions: list[ReconSession],
        sides: tuple = ("a", "b"),
        mutable: bool = False,
        tracer=None,
        device=None,
    ):
        # where the cohort stores live: None = the CUDA card (raises
        # without one); the planner itself is numpy on the host
        self.device = resolve_device(device)
        self.sessions = sessions
        self.sides = tuple(sides)
        self.mutable = mutable
        self._stores: dict[tuple[int, int], CohortStore] = {}
        self.store_builds = 0          # cohort-store builds incl. rebuilds
        self.store_build_bytes = 0     # cumulative H2D bytes of those builds
        self.store_delta_bytes = 0     # cumulative delta-patch H2D bytes
        self.store_patches = 0         # apply_mutations calls that patched
        self.store_compactions = 0     # capacity overflows -> forced rebuilds
        # store-lifecycle timeline (DESIGN.md §14): builds span, compactions
        # mark instants; NULL_TRACER (the default) makes both free
        self.tracer = tracer if tracer is not None else NULL_TRACER

    # ---- upload-once element store -------------------------------------

    def store_upload_bytes(self) -> int:
        """One-time H2D cost of the stores built so far (0 if none yet) —
        accounting only, never forces a build."""
        return sum(s.h2d_bytes for s in self._stores.values())

    def counters(self) -> dict:
        """Snapshot of the cumulative store-ledger counters.  Diff two
        snapshots to attribute builds/compactions/delta bytes to one run —
        the shared mechanism behind ``ReconcileServer.stats`` and
        ``HubEndpoint.stats`` per-epoch ledgers (DESIGN.md §11)."""
        return {
            "store_builds": self.store_builds,
            "store_compactions": self.store_compactions,
            "store_delta_bytes": self.store_delta_bytes,
            "store_build_bytes": self.store_build_bytes,
        }

    def add_sessions(self, new: list[ReconSession]) -> None:
        """Admit sessions mid-run (hub peers joining between global rounds).

        Appends to the shared session list and invalidates the cohort
        stores of the affected code keys: those cohorts rebuild (and
        re-upload) on next live use with the union of old live and new
        members.  Untouched cohorts keep their resident stores.
        """
        keys = {s.code_key for s in new}
        self.sessions.extend(new)
        for key in keys:
            self._stores.pop(key, None)

    def store_for(self, key: tuple[int, int], live=None) -> CohortStore:
        """This code's store, built (and uploaded) on first live use only.

        Members are the sessions of this code that still have live units at
        build time, so a rebuilt batch never re-uploads elements for
        sessions that already finished; within one epoch sessions only ever
        *finish*, so every later round's live set is a subset of the rows
        built here.  A continuous-sync epoch *resurrects* finished
        sessions, so ``live`` (the sessions about to plan against the
        store) guards membership: a resident store missing any of them —
        e.g. a session whose plan migrated into this cohort between epochs
        — is discarded and rebuilt with the union.
        """
        store = self._stores.get(key)
        if store is not None and live is not None and any(
            (s.sid, 0) not in store.row_of for s in live
        ):
            self._stores.pop(key)
            store = None
        if store is None:
            members = [
                s for s in self.sessions
                if s.code_key == key and not s.failed and s.state.active_units()
            ]
            store = self._stores[key] = self._build_store(*key, members)
        return store

    def apply_mutations(self, sess: ReconSession, side: str, added, removed):
        """Patch one session's side of its resident cohort store in place.

        ``added``/``removed`` are the *net* element changes of that side's
        set (disjoint; ``removed`` ⊆ the resident elements).  Partitions
        them by the session's round-invariant groups, patches the affected
        CSR rows through ``CohortStore.apply_side_mutations`` (O(churn)
        H2D scatter bytes, ledgered in ``store_delta_bytes``), and bumps
        the store generation — ``_build_store`` is never on this path.  A
        capacity overflow discards the store instead (a **compaction**:
        the next live use rebuilds it, with fresh slack, from the session
        states — which the caller is about to refresh).  No-op when the
        cohort store isn't resident yet.
        """
        if side not in self.sides or not (len(added) or len(removed)):
            return
        store = self._stores.get(sess.code_key)
        if store is None:
            return                      # next store_for builds from state
        if (sess.sid, 0) not in store.row_of:
            # session not in the resident build (joined after it): compact
            self._stores.pop(sess.code_key)
            self.store_compactions += 1
            self.tracer.instant("store.compact", sid=sess.sid,
                                n=sess.code_key[0], t=sess.code_key[1],
                                reason="late-join")
            return
        plan = sess.plan
        updates: dict[int, tuple[list, list]] = {}
        for vals, lane in ((added, 0), (removed, 1)):
            grouped = _by_group(
                np.asarray(vals, dtype=np.uint32), plan.g, plan.seed_groups
            )
            for grp, gv in grouped.items():
                row = store.row_of[(sess.sid, grp)]
                updates.setdefault(row, ([], []))[lane].extend(int(v) for v in gv)
        try:
            self.store_delta_bytes += store.apply_side_mutations(side, updates)
            self.store_patches += 1
        except StoreCapacityError:
            self._stores.pop(sess.code_key, None)
            self.store_compactions += 1
            self.tracer.instant("store.compact", sid=sess.sid,
                                n=sess.code_key[0], t=sess.code_key[1],
                                reason="capacity")

    def _build_store(self, n: int, t: int, members: list[ReconSession]) -> CohortStore:
        with self.tracer.span("store.build", n=n, t=t, members=len(members)):
            return self._build_store_cold(n, t, members)

    def _build_store_cold(self, n: int, t: int, members: list[ReconSession]) -> CohortStore:
        # per member, per side: ONE gather puts the session's elements in
        # group-sorted slot order (the cached group view's stable argsort),
        # and the per-row counts are the view's bound diffs — the
        # group-by-group slicing of the scalar build collapses into a
        # concatenation (byte-identical rows: elems[order] is exactly the
        # per-group segments back to back)
        vals: dict[str, list[np.ndarray]] = {side: [] for side in self.sides}
        cnts: dict[str, list[np.ndarray]] = {side: [] for side in self.sides}
        row_of: dict = {}
        row_base: dict = {}
        nrows = 0
        for s in members:
            st, plan = s.state, s.plan
            row_base[s.sid] = nrows
            row_of.update(((s.sid, grp), nrows + grp) for grp in range(plan.g))
            nrows += plan.g
            for side in self.sides:
                elems, order, bounds = (
                    (st.a, st.order_a, st.bounds_a) if side == "a"
                    else (st.b, st.order_b, st.bounds_b)
                )
                vals[side].append(elems[order].astype(np.uint32))
                cnts[side].append(np.diff(bounds))

        sides: dict[str, SideStore] = {}
        for side in self.sides:
            flat, start, cnt, cap = _csr_layout(
                np.concatenate(vals[side]) if vals[side]
                else np.zeros(0, dtype=np.uint32),
                np.concatenate(cnts[side]) if cnts[side]
                else np.zeros(0, dtype=np.int64),
                self.COL_ALIGN, slack=self.mutable,
            )
            sides[side] = SideStore(
                flat=upload(flat, self.device), start=upload(start, self.device),
                cnt=upload(cnt, self.device), cnt_host=cnt,
                h2d_bytes=flat.nbytes + start.nbytes + cnt.nbytes,
                start_host=start,
                flat_host=flat if self.mutable else None,
                cap_host=cap if self.mutable else None,
            )
        store = CohortStore(
            n=n, t=t, m=bch_code(n, t).m,
            row_of=row_of, sides=sides, row_base=row_base,
        )
        self.store_builds += 1
        self.store_build_bytes += store.h2d_bytes
        return store

    # ---- per-round overlay planning ------------------------------------

    def plan_round(self, rnd: int) -> list[CohortRoundPlan]:
        """All cohorts with live work in global round ``rnd`` (empty = done).

        Liveness is the shared ``core.pbs.session_live`` predicate — the
        same rule both wire endpoints apply, so their cohort plans (and
        frame schemas) line up without any membership negotiation.  Each
        session is evaluated at its *local* round ``rnd - rnd0`` (non-hub
        batches have ``rnd0 == 0`` everywhere, so local == global); failed
        (hub-evicted) sessions never plan again.
        """
        live: dict[tuple[int, int], list] = {}
        for s in self.sessions:
            if s.failed or s.suspended or rnd <= s.rnd0:
                continue  # evicted/parked, or not yet admitted at this round
            if not session_live(s.state, s.plan.cfg, rnd - s.rnd0):
                continue  # budget exhausted (reported failed) or finished
            live.setdefault(s.code_key, []).append((s, s.state.active_units()))
        return [
            self._plan_cohort(
                self.store_for(key, live=[s for s, _ in members]), members, rnd
            )
            for key, members in sorted(live.items())
        ]

    def plan_cohort(
        self, key: tuple[int, int], sessions, rnd: int
    ) -> CohortRoundPlan | None:
        """One cohort's plan for round ``rnd`` over its candidate sessions,
        or None when none of them are live — the per-cohort entry the
        pipelined server drives so cohort X's round r+1 can be planned and
        dispatched while other cohorts' round-r work is still on the device
        (DESIGN.md §12).  ``plan_cohort`` over a full code partition of the
        batch emits exactly the plans ``plan_round`` would."""
        members = [
            (s, s.state.active_units())
            for s in sessions
            if not s.failed and not s.suspended and rnd > s.rnd0
            and session_live(s.state, s.plan.cfg, rnd - s.rnd0)
        ]
        if not members:
            return None
        return self._plan_cohort(
            self.store_for(key, live=[s for s, _ in members]), members, rnd
        )

    def sessions_by_code(self) -> dict:
        """Current sessions partitioned by cohort code, in session order —
        the fixed cohort membership the pipelined server iterates."""
        by: dict[tuple[int, int], list] = {}
        for s in self.sessions:
            by.setdefault(s.code_key, []).append(s)
        return by

    def _plan_cohort(self, store: CohortStore, members, rnd: int) -> CohortRoundPlan:
        """Vectorized cohort planning (DESIGN.md §12): every per-unit array
        is built by whole-batch numpy passes — per-session hash chains via
        the seeded ``mix32`` forms, overlay grouping via one stable lexsort
        over (session, group) composite keys, row fills via repeat/arange
        scatters.  Byte-identical to the scalar reference planner
        (tests/_planner_reference.py, asserted by the differential suite)."""
        S = len(members)
        counts = np.fromiter(
            (len(active) for _, active in members), np.int64, count=S
        )
        total = int(counts.sum())
        u_pad = pow2_bucket(total, self.ROW_ALIGN)
        bases = np.zeros(S, dtype=np.int64)
        np.cumsum(counts[:-1], out=bases[1:])

        # per-session scalars, one derive_seed chain for the whole cohort
        cfg_seeds = np.fromiter(
            (s.plan.cfg.seed for s, _ in members), np.uint32, count=S
        )
        rloc = np.fromiter((rnd - s.rnd0 for s, _ in members), np.uint32, count=S)
        bin_seeds = derive_seed_seeded(
            cfg_seeds, np.full(S, 2, dtype=np.uint32), rloc
        )

        # per-unit metadata (one cheap attribute pass; everything numeric
        # downstream of it is vectorized)
        groups = np.fromiter(
            (u.group for _, active in members for u in active),
            np.int64, count=total,
        )
        filters_rows = [
            (int(base) + slot, u.filters)
            for (_, active), base in zip(members, bases)
            for slot, u in enumerate(active)
            if u.filters
        ]

        row_map = np.zeros(u_pad, dtype=np.int32)
        unit_valid = np.zeros(u_pad, dtype=np.int32)
        seeds = np.zeros(u_pad, dtype=np.uint32)
        sbase = np.fromiter(
            (store.row_base[s.sid] for s, _ in members), np.int64, count=S
        )
        row_map[:total] = np.repeat(sbase, counts) + groups
        unit_valid[:total] = 1
        seeds[:total] = np.repeat(bin_seeds, counts)

        # diff overlays: tiny per-session arrays, grouped/scattered batch-wide
        rem_parts, add_parts = [], []
        rem_per_s = np.zeros(S, dtype=np.int64)
        add_per_s = np.zeros(S, dtype=np.int64)
        for i, (s, _) in enumerate(members):
            removed, added = diff_overlay(s.state)
            rem_parts.append(removed)
            add_parts.append(added)
            rem_per_s[i] = len(removed)
            add_per_s[i] = len(added)
        g_of = np.fromiter((s.plan.g for s, _ in members), np.int64, count=S)
        gseed_of = np.fromiter(
            (s.plan.seed_groups for s, _ in members), np.uint32, count=S
        )
        gmax = int(g_of.max()) + 1
        row_key = np.repeat(np.arange(S), counts) * gmax + groups
        rem_len, rem_fill = _group_overlay(
            rem_parts, rem_per_s, g_of, gseed_of, row_key, gmax
        )
        add_len, add_fill = _group_overlay(
            add_parts, add_per_s, g_of, gseed_of, row_key, gmax
        )

        # Overlay widths: a Bob-side batch (no "a" side) can never carry a
        # diff overlay — zero width makes the executor's overlay ops vanish
        # entirely.  An Alice-side batch keeps the aligned floor even in
        # round 1 (empty overlay), so every round shares one executor shape
        # per (U, Wa, Wb, F) instead of compiling a round-1-only variant.
        if "a" in self.sides:
            r_w = pow2_bucket(int(rem_len.max(initial=0)), self.OVERLAY_ALIGN)
            x_w = pow2_bucket(int(add_len.max(initial=0)), self.OVERLAY_ALIGN)
        else:
            r_w = x_w = 0
        # zero-width when no unit carries a split filter: the executor's
        # statically-unrolled filter loop then vanishes for the common
        # no-split round instead of hashing both (U, W) sides for nothing
        max_f = max((len(f) for _, f in filters_rows), default=0)
        f_w = pow2_bucket(max_f, 1) if max_f else 0

        removed_arr = np.zeros((u_pad, r_w), dtype=np.uint32)
        removed_cnt = np.zeros(u_pad, dtype=np.int32)
        removed_cnt[:total] = rem_len
        if rem_fill is not None:
            rem_fill(removed_arr)
        added_arr = np.zeros((u_pad, x_w), dtype=np.uint32)
        added_cnt = np.zeros(u_pad, dtype=np.int32)
        added_cnt[:total] = add_len
        if add_fill is not None:
            add_fill(added_arr)
        fseeds = np.zeros((u_pad, f_w), dtype=np.uint32)
        fbins = np.zeros((u_pad, f_w), dtype=np.int32)
        fcnt = np.zeros(u_pad, dtype=np.int32)
        for row, flt in filters_rows:  # splits are rare: sparse scalar fills
            fseeds[row, : len(flt)] = [fs for fs, _ in flt]
            fbins[row, : len(flt)] = [fi for _, fi in flt]
            fcnt[row] = len(flt)

        packed = [
            (s, int(base), active, int(bin_seed))
            for (s, active), base, bin_seed in zip(members, bases, bin_seeds)
        ]

        arrays = {
            "row_map": row_map,
            "unit_valid": unit_valid,
            "seeds": seeds,
            "removed": removed_arr,
            "removed_cnt": removed_cnt,
            "added": added_arr,
            "added_cnt": added_cnt,
            "fseeds": fseeds,
            "fbins": fbins,
            "fcnt": fcnt,
        }
        live_rows = row_map[:total]

        def width(side: str) -> int:
            if side not in store.sides:
                return 0
            return pow2_bucket(
                int(store.sides[side].cnt_host[live_rows].max(initial=0)),
                self.COL_ALIGN,
            )

        plan = CohortRoundPlan(
            store=store,
            members=packed,
            units=total,
            width_a=width("a"),
            width_b=width("b"),
            arrays=arrays,
            h2d_bytes=sum(a.nbytes for a in arrays.values()),
            legacy_h2d_bytes=(
                self._legacy_round_bytes(
                    store, row_map[:total], removed_cnt[:total],
                    added_cnt[:total], fcnt[:total],
                )
                if {"a", "b"} <= set(store.sides)
                else 0
            ),
        )
        return plan

    def _legacy_round_bytes(self, store, row_map, removed_cnt, added_cnt, fcnt):
        """H2D bytes the re-pack-per-round layout would ship this round.

        That path re-uploaded per round, per side, a padded uint32 element
        matrix *and* an equally-sized int32 valid matrix plus per-unit seeds.
        Per-unit element counts are exact for plain units (store count minus
        removed plus added); split descendants hold ~count/3^depth of their
        parent — an estimate, but splits are rare and small.
        """
        if not len(row_map):
            return 0
        shrink = np.power(3.0, fcnt.astype(np.float64))
        na = (store.a.cnt_host[row_map] - removed_cnt + added_cnt) / shrink
        nb = store.b.cnt_host[row_map] / shrink
        u_old = max(self.ROW_ALIGN, _ceil_to(len(row_map), self.ROW_ALIGN))
        wa_old = max(self.COL_ALIGN, _ceil_to(int(na.max()), self.COL_ALIGN))
        wb_old = max(self.COL_ALIGN, _ceil_to(int(nb.max()), self.COL_ALIGN))
        # elems (4B) + valid (4B) per cell, both sides, + uint32 seeds
        return u_old * (wa_old + wb_old) * 8 + u_old * 4


# ---------------------------------------------------------------------------
# Continuous-sync epoch helpers (DESIGN.md §11)
# ---------------------------------------------------------------------------


def apply_churn(base: np.ndarray, added, removed) -> np.ndarray:
    """One side's next-epoch set: ``(base \\ removed) ∪ added``, unique and
    sorted like every other element array in the stack.  Removing an absent
    element or re-adding a present one is a no-op, matching set semantics."""
    out = setdiff_keys(
        np.asarray(base, dtype=np.uint32), np.asarray(removed, dtype=np.uint32)
    )
    return unique_keys(
        np.concatenate([out, np.asarray(added, dtype=np.uint32)])
    )


def advance_session(
    batch: SessionBatch,
    sess: ReconSession,
    plan: ProtocolPlan,
    *,
    new_a: np.ndarray | None = None,
    new_b: np.ndarray | None = None,
    rnd0: int = 0,
) -> ReconSession:
    """Move one session into its next epoch over the same resident store.

    Installs the epoch's plan and a fresh round state (units reset, diff
    empty — byte-identical to a session freshly submitted with the new
    sets), and delta-patches the batch's resident cohort store with each
    changed side's *net* element changes instead of rebuilding it.  When
    the new plan's store layout differs — (n, t), g, or the group seed
    changed, so the CSR grouping itself moved — the resident store can't be
    patched: the session's old cohort is invalidated (when the key is
    unchanged) and the next live use rebuilds, which the batch counts as a
    build, keeping the zero-rebuild assertion of the pure delta path
    honest.  ``new_a``/``new_b`` = None keeps that side's set unchanged.
    """
    old = sess.plan
    a = sess.state.a if new_a is None else unique_keys(
        np.asarray(new_a, dtype=np.uint32)
    )
    b = sess.state.b if new_b is None else unique_keys(
        np.asarray(new_b, dtype=np.uint32)
    )
    layout_same = (plan.n, plan.t, plan.g, plan.seed_groups) == (
        old.n, old.t, old.g, old.seed_groups
    )
    if layout_same:
        for side, new, cur in (("a", new_a, sess.state.a),
                               ("b", new_b, sess.state.b)):
            if new is None:
                continue
            arr = a if side == "a" else b
            batch.apply_mutations(
                sess, side, setdiff_keys(arr, cur), setdiff_keys(cur, arr)
            )
    else:
        # the row layout moved: the session's resident rows are stale in
        # BOTH cohorts it touches.  Drop the old key (its rows hold the
        # previous epoch's elements — a later migration back would
        # otherwise pass store_for's membership guard and reconcile over
        # them) and the new key (a resident target store has no rows for
        # this session, or stale ones from an earlier stint); both rebuild
        # on next live use from the refreshed states, as counted builds.
        batch._stores.pop((old.n, old.t), None)
        batch._stores.pop((plan.n, plan.t), None)
    sess.plan = plan
    sess.state = new_session_state(a, b, plan)
    sess.rnd0 = rnd0
    return sess


# ---------------------------------------------------------------------------
# Graceful degradation on decode exhaustion (DESIGN.md §13)
# ---------------------------------------------------------------------------


def escalate_session(
    batch: SessionBatch, sess: ReconSession, *, rnd0: int
) -> ReconSession:
    """Climb one degradation-ladder rung: install ``escalated_plan`` (d̂
    doubled again, groups reseeded) with a fresh round state over the
    session's current sets, restarting its local protocol at global round
    ``rnd0 + 1``.  The reshuffled group seed always moves the store
    layout, so — exactly like an epoch-advance layout change — both
    affected cohort keys are invalidated and rebuild on next live use as
    counted builds.  Settled progress carries over: the recovered diff
    (Alice-side; Bob's mirror never holds one) and the accumulated byte
    ledger and counters transfer into the fresh state, so elements already
    recovered are never re-transmitted — any new group whose differences
    were all settled has equal effective sets, a zero difference sketch,
    and settles in round 1 with an empty position payload.  Both endpoints
    stay byte-identical with no negotiation: the carried diff only shapes
    Alice's effective set, which Bob observes through the sketches exactly
    like any other round.  (Regression-tested: no settled unit's bits are
    ledgered twice across an escalation.)
    """
    level = sess.escalations + 1
    plan = escalated_plan(sess.plan, level)
    old_plan, old_state = sess.plan, sess.state
    batch._stores.pop((old_plan.n, old_plan.t), None)
    batch._stores.pop((plan.n, plan.t), None)
    sess.plan = plan
    sess.state = new_session_state(old_state.a, old_state.b, plan)
    sess.state.diff = old_state.diff
    sess.state.bytes_per_round = old_state.bytes_per_round
    sess.state.decode_failures = old_state.decode_failures
    sess.state.fake_rejections = old_state.fake_rejections
    sess.rnd0 = rnd0
    sess.escalations = level
    return sess


def degrade_exhausted(
    batch: SessionBatch, rnd: int, *, max_escalations: int = MAX_ESCALATIONS
) -> list[ReconSession]:
    """Escalate every session whose round budget just ran out with groups
    still undone, instead of letting it report failure (DESIGN.md §13).

    Called after global round ``rnd``'s outcomes are applied; a session is
    exhausted when its *next* local round would exceed ``cfg.max_rounds``
    while units remain undone.  Both endpoints evaluate this at the same
    global round with identical state, so they derive identical rungs with
    zero coordination traffic.  Suspended (resumable) sessions are skipped
    — their local clock is parked, not running out.  A session that has
    already climbed ``max_escalations`` rungs is left alone and fails
    exactly as it would have before degradation existed.
    """
    out: list[ReconSession] = []
    for s in batch.sessions:
        if s.failed or s.suspended or rnd <= s.rnd0:
            continue
        if s.escalations >= max_escalations:
            continue
        if rnd + 1 - s.rnd0 <= s.plan.cfg.max_rounds:
            continue                    # round budget not exhausted yet
        if not s.state.active_units():
            continue                    # finished cleanly
        out.append(escalate_session(batch, s, rnd0=rnd))
    return out


# ---------------------------------------------------------------------------
# Carrying a store across from host arrays
# ---------------------------------------------------------------------------


def cohort_store_from_numpy(
    *, n: int, t: int, m: int, row_of: dict, row_base: dict, sides: dict, device
) -> CohortStore:
    """Build a resident ``CohortStore`` on ``device`` from host arrays.

    ``sides`` maps "a"/"b" to ``(flat uint32, start int32, cnt int32)`` numpy
    arrays in the CSR layout of ``pack_csr``.  The differential tests use
    this to run the executors over a store identical to another
    implementation's, element for element.
    """
    dev = resolve_device(device)
    built = {}
    for side, (flat, start, cnt) in sides.items():
        flat = np.array(flat, dtype=np.uint32)      # private, writable copies
        start = np.array(start, dtype=np.int32)
        cnt = np.array(cnt, dtype=np.int32)
        built[side] = SideStore(
            flat=upload(flat, dev), start=upload(start, dev), cnt=upload(cnt, dev),
            cnt_host=cnt.copy(),
            h2d_bytes=flat.nbytes + start.nbytes + cnt.nbytes,
            start_host=start.copy(),
        )
    return CohortStore(
        n=n, t=t, m=m, row_of=dict(row_of), sides=built, row_base=dict(row_base)
    )
