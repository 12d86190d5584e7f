"""ReconcileServer: the traffic-serving facade over the batched engine.

``submit`` any number of Alice↔Bob pairs, then ``run`` drives every session's
full PBS protocol concurrently.  Estimator sessions (unknown d) defer phase 0
to ``run``, which batches every pending ToW estimate through the
``tow_sketch`` kernel in one enqueue-then-read sweep (bit-identical to the
host mirror — same hash family).  Before round 1, each cohort's element store
uploads to the device once; each global round the SessionBatch planner emits
only small gather/overlay arrays, **all cohorts are enqueued on the stream
before the first readback** (the host plans while the device works), and the
host applies the per-unit outcomes — recovery, fake rejection, checksum gating,
and the 3-way-split re-queue — through the *same* ``core.pbs`` state-machine
functions as the single-session oracle.  Decoded bin positions come back as
one vectorized unpack per cohort (no per-unit Python slicing).

Byte accounting is per session and identical to ``core.pbs.ReconcileResult``:
the sketch/flag upload counts each session's own active units, and the
Bob→Alice reply bits come from the shared ``apply_round_outcomes``, so
``run()[sid].bytes_sent`` equals what ``core.pbs.reconcile`` reports for the
same pair, seed for seed (asserted in tests/test_recon_batch.py).

``stats`` (after ``run``) reports the transfer/launch ledger the device-
resident pipeline is optimizing: actual H2D bytes (store once + overlays per
round) against the legacy re-pack-per-round equivalent, kernel launches per
round (fused two-side encode = 2 vs 4), and the host-ms vs device-ms split.
"""
from __future__ import annotations

import time
from collections import deque

import numpy as np

import torch

from ..core.hashing import derive_seed
from ..core.sets import unique_keys
from ..core.pbs import (
    MAX_ESCALATIONS,
    MAX_PARITY_EXTENSIONS,
    PBSConfig,
    ReconcileResult,
    apply_round_outcomes,
    effective_set,
    finalize_result,
    new_session_state,
    parity_extension_t,
    plan_from_d_known,
    plan_from_estimate,
)
from ..core.tow import (
    ESTIMATE_LIMIT_FRAC,
    EstimateOutOfRange,
    check_estimate,
    planned_d,
    tow_seeds,
)
from ..kernels.ops import bch_decode_batched
from ..kernels.platform import (
    pow2_bucket,
    resolve_device,
    retrace_count,
    retrace_counts,
    upload,
)
from ..kernels.tow_sketch import tow_sketch
from ..obs import NULL_TRACER, Recorder

from .engine import execute_round, execute_round_ext
from .session import (
    CohortRoundPlan,
    ReconSession,
    SessionBatch,
    advance_session,
    apply_churn,
    escalate_session,
)

_EMPTY = np.zeros(0, dtype=np.uint32)


_TOW_FLOOR = 2048  # the phase-0 shape-bucket floor

# the per-round plan arrays, in the executors' positional order
_PLAN_KEYS = (
    "row_map", "unit_valid", "seeds", "removed", "removed_cnt",
    "added", "added_cnt", "fseeds", "fbins", "fcnt",
)


def _tow_bucketed(elems, seeds_t, device):
    """One set's ToW sketch dispatch at a warm shape bucket (DESIGN.md §12).

    Pads the set to ``pow2_bucket(|S|, floor)`` with an explicit valid
    mask, so the executor variant depends on the shape *bucket* instead of
    the exact set size, and the padding lanes contribute nothing to the
    sums.
    """
    e = np.asarray(elems, dtype=np.uint32)
    ep = pow2_bucket(len(e), _TOW_FLOOR)
    buf = np.zeros(ep, dtype=np.uint32)
    buf[: len(e)] = e
    valid = np.zeros(ep, dtype=np.bool_)
    valid[: len(e)] = True
    return tow_sketch(
        upload(buf, device), seeds_t, upload(valid, device),
        ell=seeds_t.shape[0],
    )


def phase0_dispatch(pairs, seeds_list, *, device=None) -> list:
    """Enqueue every (A, B) pair's ToW sketch kernels; returns the in-flight
    device tensors.  Split from the readback so callers can overlap host
    work — epoch staging, known-d session advances — with the device sweep
    (the cross-epoch half of the DESIGN.md §12 overlap pipeline)."""
    device = resolve_device(device)
    inflight = []
    for (a, b), seeds in zip(pairs, seeds_list):
        st = upload(np.asarray(seeds, dtype=np.uint32), device)
        inflight.append(
            (
                _tow_bucketed(a, st, device),
                _tow_bucketed(b, st, device),
            )
        )
    return inflight


def phase0_collect(inflight) -> list[int]:
    """Block on the in-flight sketches and reduce the exact integer
    numerators sum((Y_A - Y_B)^2) on the host."""
    out = []
    for ya, yb in inflight:
        diff = ya.cpu().numpy().astype(np.int64) - yb.cpu().numpy().astype(
            np.int64
        )
        out.append(int(np.sum(diff * diff)))
    return out


def phase0_numerators(pairs, seeds_list, *, device=None) -> list[int]:
    """Batched phase-0 d_hat numerators through the ToW kernel.

    ``device=None`` means the CUDA card (raises without one).  Enqueues
    every (A, B) pair's sketch kernels before the first readback, then
    reduces the exact
    integer numerator sum((Y_A - Y_B)^2) on the host.  Bit-identical to
    ``core.tow.tow_sketches`` + ``estimate_numerator`` — same hash family,
    and the shape-bucket padding is masked out — so routing estimation
    through the device changes nothing downstream.
    """
    return phase0_collect(phase0_dispatch(pairs, seeds_list, device=device))


class ReconcileServer:
    """Batched multi-session PBS reconciliation (DESIGN.md §5).

    ``device=None`` means the CUDA card, and raises when there is none;
    the server never carries on on the CPU by itself.  ``device="cpu"`` runs
    every stage through the kernels' plain PyTorch versions.
    """

    def __init__(
        self,
        *,
        device=None,
        continuous: bool = False,
        degrade: bool = False,
        recorder: Recorder | None = None,
        tracer=None,
        estimate_limit: float | None = ESTIMATE_LIMIT_FRAC,
    ):
        self.device = resolve_device(device)
        self._continuous = continuous
        # estimator sessions whose planned d̂ exceeds this fraction of the
        # pair's total elements raise EstimateOutOfRange instead of burning
        # the round budget (None disables; d_known sessions never raise) —
        # such pairs belong to the tree front end (§15)
        self._estimate_limit = estimate_limit
        # degrade=True: a session that exhausts its round budget with work
        # left re-plans at a doubled d̂ (graceful degradation, DESIGN.md §13)
        # instead of finishing with success=False; counted per escalation
        # in stats["sessions_degraded"].
        self._degrade = degrade
        self._sessions: list[ReconSession | None] = []
        self._pending: dict[int, tuple] = {}   # sid -> (a, b, cfg), d unknown
        self._d_known: dict[int, int | None] = {}
        self._batch: SessionBatch | None = None
        self._stats: dict = {}
        self._phase0_s = 0.0                   # accrued until the next run()
        self._epoch = 0
        # telemetry (DESIGN.md §14): all run ledgers publish into the
        # recorder (the `stats` view derives from it) and every phase
        # boundary is spanned through the tracer (NULL_TRACER = disabled).
        self.recorder = recorder if recorder is not None else Recorder()
        self.tracer = tracer if tracer is not None else NULL_TRACER

    def submit(
        self,
        set_a: np.ndarray,
        set_b: np.ndarray,
        cfg: PBSConfig | None = None,
        d_known: int | None = None,
    ) -> int:
        """Enqueue one session (Alice holds ``set_a``); returns its sid.

        Known-d sessions pin their (n, t, g) immediately; estimator
        sessions defer phase 0 so ``run`` can batch every pending ToW
        sketch through the kernel in one enqueue-then-read sweep
        instead of a per-session host loop over ell hash functions.
        """
        cfg = cfg or PBSConfig()
        a = unique_keys(np.asarray(set_a, dtype=np.uint32))
        b = unique_keys(np.asarray(set_b, dtype=np.uint32))
        sid = len(self._sessions)
        if d_known is not None:
            plan = plan_from_d_known(cfg, d_known)
            self._sessions.append(
                ReconSession(sid=sid, plan=plan, state=new_session_state(a, b, plan))
            )
        else:
            self._sessions.append(None)        # placeholder until phase 0
            self._pending[sid] = (a, b, cfg)
        self._d_known[sid] = d_known
        self._batch = None  # new member: cohort stores must be rebuilt
        # the discarded batch's counters die with it: drop the recorder's
        # store mark so the next run's per-epoch ledger diffs against the
        # new batch's zeros, not a dead batch's cumulative counters
        self.recorder.drop_mark("store")
        return sid

    def _flush_phase0(self) -> None:
        """Run deferred phase 0 for every estimator session (device-batched).

        Wall time accrues into the ``phase0_s`` stat of the *next* ``run``,
        so reading ``sessions`` early never drops the cost from the ledger.
        """
        if not self._pending:
            return
        t0 = time.perf_counter()
        items = sorted(self._pending.items())
        with self.tracer.span("server.phase0", sessions=len(items)):
            pairs = [(a, b) for _, (a, b, _) in items]
            seeds_list = [
                tow_seeds(derive_seed(cfg.seed, 0x70), cfg.ell)
                for _, (_, _, cfg) in items
            ]
            nums = phase0_numerators(pairs, seeds_list, device=self.device)
            for (sid, (a, b, cfg)), num in zip(items, nums):
                plan = plan_from_estimate(cfg, num, len(a))
                check_estimate(
                    planned_d(plan.d_est, cfg.gamma),
                    len(a) + len(b), self._estimate_limit, sid=sid,
                )
                self._sessions[sid] = ReconSession(
                    sid=sid, plan=plan, state=new_session_state(a, b, plan)
                )
            self._pending.clear()
        self._phase0_s += time.perf_counter() - t0

    @property
    def sessions(self) -> list[ReconSession]:
        self._flush_phase0()
        return self._sessions

    @property
    def stats(self) -> dict:
        """Transfer/launch/time ledger of the last ``run`` (DESIGN.md §5).

        A derived snapshot of the ``server.*`` metrics in the recorder —
        same keys and values as the pre-obs ad-hoc dict (DESIGN.md §14).
        """
        return self.recorder.view("server")

    def run(self) -> dict[int, ReconcileResult]:
        """Drive every submitted session to completion; sid -> result.

        The SessionBatch (and its device-resident stores) is kept across
        ``run`` calls: a second ``run`` with no new sessions re-uploads
        nothing, and stores only build when a cohort has live work.

        The round loop is a per-cohort software pipeline (DESIGN.md §12):
        each cohort's round r+1 depends only on its *own* round-r outcomes
        (cohort membership is fixed for the run and all round state is
        session-local), so as soon as cohort X's outcomes are applied, its
        next round is planned and dispatched — while the other cohorts'
        rounds are still executing on the device.  Host planning of round
        r+1 thus overlaps device execution of round r, extending the
        enqueue-before-readback pattern across rounds.
        """
        t_run = time.perf_counter()
        retrace_mark = retrace_count()
        self._flush_phase0()
        phase0_s, self._phase0_s = self._phase0_s, 0.0
        if self._batch is None:
            self._batch = SessionBatch(
                self._sessions, mutable=self._continuous, tracer=self.tracer,
                device=self.device,
            )
        batch = self._batch
        prior_store_bytes = batch.store_upload_bytes()
        st = {
            "epoch": self._epoch,
            "phase0_s": phase0_s,
            "rounds": 0,
            "cohort_rounds": 0,
            "h2d_round_bytes": 0,
            "legacy_h2d_round_bytes": 0,
            "kernel_launches": 0,
            "legacy_kernel_launches": 0,
            "sessions_degraded": 0,
            "parity_extensions": 0,
            "device_s": 0.0,
        }
        by_code = batch.sessions_by_code()
        tracer = self.tracer
        while True:
            # prime the pipeline: every cohort's round 1, dispatched before
            # the first readback (kernel launches return before they finish)
            inflight: deque = deque()
            for key in sorted(by_code):
                with tracer.span("cohort.plan_dispatch", n=key[0], t=key[1], round=1):
                    plan = batch.plan_cohort(key, by_code[key], 1)
                    if plan is not None:
                        inflight.append((key, 1, plan, self._dispatch(plan)))
            while inflight:
                key, rnd, plan, fut = inflight.popleft()
                t0 = time.perf_counter()
                with tracer.span("cohort.collect", cat="device",
                                 n=key[0], t=key[1], round=rnd):
                    out = self._collect(plan, fut)
                st["device_s"] += time.perf_counter() - t0
                with tracer.span("cohort.apply", n=key[0], t=key[1], round=rnd,
                                 units=len(plan.arrays["row_map"])):
                    ext = self._apply_cohort(plan, out, rnd)
                st["rounds"] = max(st["rounds"], rnd)
                st["cohort_rounds"] += 1
                st["h2d_round_bytes"] += plan.h2d_bytes
                st["legacy_h2d_round_bytes"] += plan.legacy_h2d_bytes
                st["kernel_launches"] += 2   # fused bin launch + sketch matmul
                st["kernel_launches"] += ext["kernel_launches"]
                st["parity_extensions"] += ext["parity_extensions"]
                st["legacy_kernel_launches"] += 4  # 2x bin + 2x sketch, per side
                with tracer.span("cohort.plan_dispatch", n=key[0], t=key[1],
                                 round=rnd + 1):
                    nxt = batch.plan_cohort(key, by_code[key], rnd + 1)
                    if nxt is not None:
                        inflight.append((key, rnd + 1, nxt, self._dispatch(nxt)))
            if not self._degrade:
                break
            # graceful degradation (DESIGN.md §13): any session that drained
            # its round budget with units left re-plans at a doubled d̂ and
            # re-enters the pipeline under its new code key; escalation is
            # capped, so a hopeless session still converges to failed=True
            escalated = self._escalate_exhausted()
            if not escalated:
                break
            for s in escalated:
                tracer.instant("server.degrade", sid=s.sid,
                               escalations=s.escalations)
            st["sessions_degraded"] += len(escalated)
            by_code = batch.sessions_by_code()

        # stores built during *this* run (cached ones re-upload nothing);
        # the delta ledger additionally covers the advance_epoch patches
        # applied since the previous run — the epoch they paid for is this
        # one, so zero-rebuild epochs show store_builds == 0 and only their
        # O(churn) scatter bytes (DESIGN.md §11)
        st["h2d_store_bytes"] = batch.store_upload_bytes() - prior_store_bytes
        counters = batch.counters()
        delta = self.recorder.delta_since_mark("store", counters)
        st["store_builds"] = delta["store_builds"]
        st["store_compactions"] = delta["store_compactions"]
        st["h2d_delta_bytes"] = delta["store_delta_bytes"]
        self.recorder.mark("store", counters)
        st["h2d_bytes"] = (
            st["h2d_store_bytes"] + st["h2d_round_bytes"] + st["h2d_delta_bytes"]
        )
        st["legacy_h2d_bytes"] = st["legacy_h2d_round_bytes"]
        rounds = max(1, st["rounds"])
        st["h2d_bytes_per_round"] = st["h2d_bytes"] / rounds
        st["legacy_h2d_bytes_per_round"] = st["legacy_h2d_bytes"] / rounds
        st["h2d_ratio"] = st["legacy_h2d_bytes"] / max(1, st["h2d_bytes"])
        st["total_s"] = time.perf_counter() - t_run
        st["host_s"] = st["total_s"] - st["device_s"]
        # new executor variants met in this run: 0 once the shape buckets are
        # warm — the assertable warm-cache contract (DESIGN.md §12)
        st["retraces"] = retrace_count() - retrace_mark
        if st["rounds"] or not self._stats:
            # an idempotent re-run that did no work keeps the meaningful
            # ledger of the run that actually drove rounds
            self._stats = st
            # the freeze point is the publish point: the legacy `stats`
            # view derives back from these registry rows (DESIGN.md §14)
            self.recorder.publish("server", st)
            self.recorder.publish("store", counters)
            self.recorder.set("kernels.retraces_total", retrace_count())
            self.recorder.set("kernels.retraces_by_fn", retrace_counts())
        results = {s.sid: finalize_result(s.state, s.plan) for s in self._sessions}
        if tracer.enabled:
            # per-session attribution for trace_report: bytes/diff/rounds
            # against the plan's (n, t, d_est) for the Markov comparison
            for sid, r in results.items():
                p = self._sessions[sid].plan
                tracer.instant(
                    "session.result", sid=sid, rounds=r.rounds,
                    diff=len(r.diff), bytes=r.bytes_sent, success=r.success,
                    n=p.n, t=p.t, g=p.g, d_est=p.d_est,
                )
        return results

    def advance_epoch(
        self,
        mutations: dict | None = None,
        *,
        d_known: dict | None = None,
        fold_diff: bool = True,
    ) -> int:
        """Open the next reconciliation epoch over the same resident stores
        (continuous sync, DESIGN.md §11); returns the new epoch number.

        Per session: Alice folds the learned diff into her set (replica
        convergence, A ← A △ D̂; ``fold_diff=False`` keeps A), then both
        sides apply the caller's local churn from ``mutations`` —
        sid -> (added_a, removed_a, added_b, removed_b).  Sessions whose d
        is pinned re-plan with that d; estimator sessions re-run phase 0
        through the same batched ToW kernel sweep submit-time estimation
        uses.  ``d_known`` (sid -> int | None) *rebinds* a session's
        convention from this epoch on — an int pins d for this and later
        epochs, ``None`` returns it to estimation; unmentioned sessions
        keep their current convention (initially the submit-time one).
        Each changed side's *net* element delta is patched into the
        device-resident cohort stores in place — the next ``run`` drives
        the epoch with zero store rebuilds (``stats["store_builds"]``) and
        only O(churn) delta-H2D bytes (``stats["h2d_delta_bytes"]``).

        Requires ``ReconcileServer(continuous=True)`` — one-shot batches
        pack their stores without the mutation lanes the delta path
        patches into.
        """
        if not self._continuous:
            raise RuntimeError(
                "advance_epoch needs ReconcileServer(continuous=True)"
            )
        self._flush_phase0()
        if self._batch is None:
            self._batch = SessionBatch(
                self._sessions, mutable=True, tracer=self.tracer,
                device=self.device,
            )
        muts = mutations or {}
        dk_over = d_known or {}
        unknown = (set(muts) | set(dk_over)) - set(range(len(self._sessions)))
        if unknown:
            # a typo'd sid must not silently drop the caller's churn
            raise KeyError(f"unknown sid(s) {sorted(unknown)} in epoch advance")
        self._epoch += 1
        self.tracer.instant("server.epoch_advance", epoch=self._epoch,
                            mutated=len(muts))

        new_sets: dict[int, tuple] = {}
        for s in self._sessions:
            st = s.state
            base_a = effective_set(st.a, st.diff) if fold_diff else st.a
            aa, ra, ab, rb = muts.get(s.sid, (_EMPTY,) * 4)
            new_sets[s.sid] = (
                apply_churn(base_a, aa, ra), apply_churn(st.b, ab, rb)
            )

        if dk_over:
            self._d_known.update(dk_over)
        est = [s for s in self._sessions if self._d_known[s.sid] is None]
        plans = {
            s.sid: plan_from_d_known(s.plan.cfg, self._d_known[s.sid])
            for s in self._sessions
            if self._d_known[s.sid] is not None
        }
        # cross-epoch overlap (DESIGN.md §12): dispatch the estimator ToW
        # sweep first, advance every pinned session while those kernels run
        # on the device, then collect the numerators and advance the rest.
        inflight = None
        if est:
            t0 = time.perf_counter()
            inflight = phase0_dispatch(
                [new_sets[s.sid] for s in est],
                [
                    tow_seeds(derive_seed(s.plan.cfg.seed, 0x70), s.plan.cfg.ell)
                    for s in est
                ],
                device=self.device,
            )
            self._phase0_s += time.perf_counter() - t0

        est_sids = {s.sid for s in est}
        for s in self._sessions:
            if s.sid in est_sids:
                continue
            new_a, new_b = new_sets[s.sid]
            advance_session(
                self._batch, s, plans[s.sid], new_a=new_a, new_b=new_b, rnd0=0
            )

        if est:
            t0 = time.perf_counter()
            nums = phase0_collect(inflight)
            for s, num in zip(est, nums):
                plans[s.sid] = plan_from_estimate(
                    s.plan.cfg, num, len(new_sets[s.sid][0])
                )
                check_estimate(
                    planned_d(plans[s.sid].d_est, s.plan.cfg.gamma),
                    len(new_sets[s.sid][0]) + len(new_sets[s.sid][1]),
                    self._estimate_limit, sid=s.sid,
                )
            self._phase0_s += time.perf_counter() - t0
            for s in est:
                new_a, new_b = new_sets[s.sid]
                advance_session(
                    self._batch, s, plans[s.sid], new_a=new_a, new_b=new_b, rnd0=0
                )
        return self._epoch

    def _escalate_exhausted(
        self, max_escalations: int = MAX_ESCALATIONS
    ) -> list[ReconSession]:
        """Escalate every budget-exhausted session one degradation rung
        (doubled d̂ re-plan from scratch, ``escalate_session``); returns the
        escalated sessions.  Exhausted means the round budget is spent with
        active units left — the state ``finalize_result`` would report as
        ``success=False``."""
        out = []
        for s in self._sessions:
            if s is None or s.failed or s.suspended:
                continue
            if s.escalations >= max_escalations:
                continue
            if s.state.rounds < s.plan.cfg.max_rounds:
                continue
            if not s.state.active_units():
                continue
            out.append(escalate_session(self._batch, s, rnd0=0))
        return out

    def _upload_plan(self, plan: CohortRoundPlan) -> tuple:
        """One host→device copy per plan array, in executor order."""
        return tuple(upload(plan.arrays[k], self.device) for k in _PLAN_KEYS)

    def _dispatch(self, plan: CohortRoundPlan) -> torch.Tensor:
        """Enqueue one cohort's fused round executor on the current stream.

        The eight outputs are all 32-bit and row-aligned, so they are packed
        on the device into one (U, 2n + 2t + 4) int32 tensor: the readback
        at collect time is then a single device→host copy per cohort.
        """
        store = plan.store
        xors_a, xors_b, ok, pos, cnt, csum_a, csum_b, sk_diff = execute_round(
            store.a.flat,
            store.a.start,
            store.a.cnt,
            store.b.flat,
            store.b.start,
            store.b.cnt,
            *self._upload_plan(plan),
            n=store.n,
            t=store.t,
            width_a=plan.width_a,
            width_b=plan.width_b,
        )
        return torch.cat(
            [
                xors_a, xors_b, pos, sk_diff,
                ok.to(torch.int32)[:, None], cnt[:, None],
                csum_a[:, None], csum_b[:, None],
            ],
            dim=1,
        )

    def _collect(self, plan: CohortRoundPlan, packed: torch.Tensor) -> tuple:
        """Block on one cohort's packed outcomes (the one device→host copy)
        and split them into the numpy arrays ``apply_round_outcomes`` takes:
        XOR folds and checksums as uint32, positions padded −1, ok bool."""
        n, t = plan.store.n, plan.store.t
        host = packed.cpu().numpy()
        xors_a, xors_b, pos, sk_diff, tail = np.split(
            host, np.cumsum([n, n, t, t]), axis=1
        )
        ok, cnt, csum_a, csum_b = (tail[:, i] for i in range(4))
        return (
            np.ascontiguousarray(xors_a).view(np.uint32),
            np.ascontiguousarray(xors_b).view(np.uint32),
            ok != 0, pos, cnt,
            np.ascontiguousarray(csum_a).view(np.uint32),
            np.ascontiguousarray(csum_b).view(np.uint32),
            sk_diff,
        )

    def _apply_cohort(self, plan: CohortRoundPlan, out, rnd: int) -> dict:
        xors_a, xors_b, ok, pos, cnt, csum_a, csum_b, sk_diff = out
        # one vectorized unpack of the (U, t) padded position rows: valid
        # entries are left-justified, so a masked flatten + split by the
        # per-unit counts yields every unit's decoded bins at once.
        cnt = np.asarray(cnt, dtype=np.int64)
        pos = np.asarray(pos)
        positions = list(
            np.split(pos[pos >= 0].astype(np.int64), np.cumsum(cnt)[:-1])
        )
        ok = np.asarray(ok).copy()
        ext = {"parity_extensions": 0, "kernel_launches": 0}
        ext_bits = self._extend_cohort(plan, ok, positions, sk_diff, ext)

        sketch_bits = plan.store.t * plan.store.m + 1  # per-unit sketch + ok flag
        for idx, (sess, base, active, bin_seed) in enumerate(plan.members):
            k = len(active)
            rows = slice(base, base + k)
            reply_bits, _ = apply_round_outcomes(
                sess.state,
                active,
                ok[rows],
                positions[rows],
                xors_a[rows],
                xors_b[rows],
                csum_a[rows],
                csum_b[rows],
                plan=sess.plan,
                bin_seed=bin_seed,
                rnd=rnd,
            )
            round_bits = k * sketch_bits + reply_bits + ext_bits.get(idx, 0)
            sess.state.bytes_per_round.append((round_bits + 7) // 8)
            sess.state.rounds = rnd
        return ext

    def _extend_cohort(
        self, plan: CohortRoundPlan, ok, positions, sk_diff, ext
    ) -> dict[int, int]:
        """Rateless recovery ladder for one cohort round (DESIGN.md §16).

        Instead of surrendering a failed BCH decode to the 3-way split (or,
        round budget permitting none, to a from-scratch degradation re-plan),
        every failing unit of a ``rateless`` session re-decodes the *same*
        round bitmap at t' = t·2^level: ``execute_round_ext`` emits only the
        incremental syndromes S_{2t+1}..S_{2t'-1}, the host concatenates
        them onto the cached round-diff prefix, and one batched decode at t'
        recovers everything the wider code can reach — zero re-sent sketch
        bits, zero store rebuilds.  ``ok``/``positions`` are merged in place
        so the single ``apply_round_outcomes`` call downstream sees the
        post-ladder outcome (split seeds therefore still derive from this
        round, deterministically on both wire sides).  Returns per-member
        Formula-(1) ledger bits: sum over levels of U_e·(Δt_e·m + 1) —
        exactly what the ``MSG_PARITY`` frame plus its extension reply
        measure on the wire path.
        """
        ext_bits: dict[int, int] = {}
        rateless = np.zeros(len(ok), dtype=bool)
        for sess, base, active, _ in plan.members:
            if sess.plan.cfg.rateless:
                rateless[base : base + len(active)] = True
        fail = rateless & ~ok
        if not fail.any():
            return ext_bits
        store = plan.store
        n, t, m = store.n, store.t, store.m
        arrays = self._upload_plan(plan)
        acc = np.asarray(sk_diff)
        t_prev = t
        for level in range(1, MAX_PARITY_EXTENSIONS + 1):
            t_e = parity_extension_t(t, level, n)
            if t_e <= t_prev:
                break  # code cap (n-1)//2 reached: the ladder is exhausted
            inc = execute_round_ext(
                store.a.flat, store.a.start, store.a.cnt,
                store.b.flat, store.b.start, store.b.cnt,
                *arrays,
                n=n, t0=t_prev, t1=t_e,
                width_a=plan.width_a, width_b=plan.width_b,
            )
            ext["kernel_launches"] += 2  # bin rebuild + incremental matmul
            acc = np.concatenate([acc, inc.cpu().numpy()], axis=1)
            # only failing rateless rows carry content: settled/foreign rows
            # decode trivially as zero sketches and are never touched
            masked = np.where(fail[:, None], acc, 0)
            ok_e, pos_e, _ = bch_decode_batched(
                upload(masked, self.device), n=n, t=t_e
            )
            ok_e, pos_e = ok_e.cpu().numpy(), pos_e.cpu().numpy()
            dt = t_e - t_prev
            for idx, (sess, base, active, _) in enumerate(plan.members):
                u_e = int(fail[base : base + len(active)].sum())
                if u_e:
                    ext_bits[idx] = ext_bits.get(idx, 0) + u_e * (dt * m + 1)
                    ext["parity_extensions"] += 1
                    self.tracer.instant(
                        "server.parity_extension", sid=sess.sid,
                        level=level, units=u_e, t=t_e,
                    )
            recovered = np.flatnonzero(fail & ok_e)
            for row in recovered:
                ok[row] = True
                r = pos_e[row]
                positions[row] = r[r >= 0].astype(np.int64)
            fail &= ~ok_e
            t_prev = t_e
            if not fail.any():
                break
        return ext_bits


def reconcile_batch(
    pairs,
    cfgs=None,
    d_knowns=None,
    *,
    device=None,
) -> list[ReconcileResult]:
    """One-shot convenience: reconcile a list of (set_a, set_b) pairs.

    ``cfgs``/``d_knowns`` may be None, a single value applied to every pair,
    or a per-pair sequence.  Results come back in submission order.
    ``device=None`` means the CUDA card (raises without one).
    """
    npairs = len(pairs)

    def _broadcast(x, name):
        # scalars (None, a PBSConfig, an int d) broadcast; any sized
        # non-string container is per-pair and must match the pair count
        if x is None or isinstance(x, str) or not hasattr(x, "__len__"):
            return [x] * npairs
        if len(x) != npairs:
            raise ValueError(f"{name} has {len(x)} entries for {npairs} pairs")
        return list(x)

    server = ReconcileServer(device=device)
    for (a, b), cfg, dk in zip(
        pairs, _broadcast(cfgs, "cfgs"), _broadcast(d_knowns, "d_knowns")
    ):
        server.submit(a, b, cfg=cfg, d_known=dk)
    results = server.run()
    return [results[i] for i in range(npairs)]
