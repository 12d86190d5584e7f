"""The PBS set-reconciliation protocol (paper §2–§3), byte-accounted.

Unidirectional reconciliation: Alice learns A △ B.  Faithful to the paper:

* hash-partition into g = d/δ **groups** (fixed across rounds, §3) and, per
  round, into n **bins** with a fresh per-round hash (§2.4);
* per group, Alice sends the t·m-bit **BCH syndrome sketch** of her parity
  bitmap; Bob decodes the XOR of sketches to locate differing bins and replies
  with bin indices + his bin XOR sums + his group checksum (Procedure 2);
* Alice recovers one element per located bin via the XOR trick (Procedure 1),
  discards fakes with the sub-universe check (Procedure 3), and gates the
  group on the sum-mod-2^|key| checksum (§2.2.3);
* BCH decoding failures (> t differing bins) trigger the **3-way split**
  (§3.2); unreconciled groups re-run with fresh hashes (§2.4).

Every message is byte-accounted with the paper's accounting (Formula (1)),
so the benchmarks reproduce Fig. 1b/2b/3b directly.  All per-round bin
algebra is vectorized across *all* active units at once (segmented scatters +
the batched BM/Chien decoder) — the numpy mirror of the TPU formulation in
`repro_torch.kernels`.

The round state machine is factored into pure pieces — ``plan_protocol`` /
``SessionState`` / ``group_view`` / ``slot_assignment`` / ``unit_tables`` /
``apply_round_outcomes`` / ``finalize_result`` — shared verbatim by the
batched multi-session engine in ``repro_torch.recon`` (DESIGN.md §5), which swaps
only the numpy bin/sketch/decode tables for the accelerator kernels.
``reconcile`` below is the single-session composition of those pieces and is
the oracle the batched engine is validated against unit-for-unit.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

from .bch import (
    BCHCode,
    batched_decode,
    bch_code,
    decode_sketch,
    sketch_from_positions,
)
from .hashing import derive_seed, hash_to_range
from .markov import optimize_parameters
from .sets import setdiff_keys, unique_keys
from .tow import (
    ELL_DEFAULT,
    GAMMA,
    dhat_bytes,
    estimate_numerator,
    planned_d,
    sketch_bytes,
    tow_sketches,
)

KEY_BITS = 32
_MOD = np.uint64(1) << np.uint64(KEY_BITS)

# Degradation-ladder caps (DESIGN.md §13/§16) — the single source of truth
# threaded through session/server/endpoint/hub as keyword defaults, so the
# wire-separated sides can never drift on when a session stops escalating.
#
# MAX_ESCALATIONS caps the legacy from-scratch re-plan ladder (doubled d̂
# per rung).  MAX_PARITY_EXTENSIONS caps the in-round rateless ladder:
# level e extends a unit's BCH capacity to min(t << e, (n-1)//2), so four
# levels reach 16t — enough headroom for a 10x-underestimated d̂ before
# the legacy ladder is consulted at all.
MAX_ESCALATIONS = 3
MAX_PARITY_EXTENSIONS = 4


def parity_extension_t(t: int, level: int, n: int) -> int:
    """Extended BCH capacity at rateless-extension level ``level`` (0 = the
    round's base sketch).  Deterministic from the cohort's (n, t) alone —
    both wire sides derive the identical t-ladder with zero negotiation.
    Doubling per level telescopes: a unit that decodes at level e has
    shipped exactly t_e * m syndrome bits total (prefix + increments ==
    the fresh (n, t_e) sketch), so no parity byte is ever wasted on a unit
    that eventually decodes.  Capped at (n-1)//2, where BM decoding runs
    out of syndrome equations; a level where the cap stops growth is the
    ladder's exhaustion signal.
    """
    return min(t << level, (n - 1) // 2)


def checksum(elems: np.ndarray) -> int:
    """c(S) = sum of elements mod 2^|key| (paper §2.2.3)."""
    return int(np.asarray(elems, dtype=np.uint64).sum() % _MOD)


@dataclass
class PBSConfig:
    delta: float = 5.0
    r_target: int = 3
    p0: float = 0.99
    ell: int = ELL_DEFAULT
    gamma: float = GAMMA
    max_rounds: int = 12          # hard stop far beyond the r=3 design point
    seed: int = 0
    convention: str = "split"     # parameter-optimizer convention
    n_override: int | None = None  # pin (n, t) instead of optimizing
    t_override: int | None = None
    g_override: int | None = None
    # rateless recovery (DESIGN.md §16): on BCH overload, extend the unit's
    # sketch in-round with incremental MSG_PARITY syndromes (prefix-
    # compatible, zero re-sent bits) before falling back to the 3-way
    # split.  Off by default: every success path stays byte-identical to
    # the paper's accounting, and overload handling matches §3.2 verbatim.
    rateless: bool = False


@dataclass
class Unit:
    """An active reconciliation unit: a group, or a split descendant of one."""

    uid: int
    group: int
    filters: tuple = ()  # ((seed, idx3), ...) from 3-way splits
    done: bool = False


@dataclass
class ReconcileResult:
    diff: set
    rounds: int
    success: bool
    bytes_sent: int               # protocol bytes (paper convention: sans estimator)
    estimator_bytes: int
    bytes_per_round: list = field(default_factory=list)
    n: int = 0
    t: int = 0
    g: int = 0
    d_est: float = 0.0
    decode_failures: int = 0
    fake_rejections: int = 0


# ---------------------------------------------------------------------------
# Pure protocol pieces (shared with the batched engine in repro_torch.recon)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ProtocolPlan:
    """Everything phase 0 pins down for one Alice↔Bob session: the estimated
    difference, the optimized (n, t, g), and the derived hash seeds."""

    cfg: PBSConfig
    n: int
    t: int
    g: int
    d_est: float
    est_bytes: int
    seed_groups: int

    @property
    def code(self) -> BCHCode:
        return BCHCode(self.n, self.t)

    @property
    def m(self) -> int:
        return self.code.m


def _mk_plan(cfg: PBSConfig, d_est: float, d_plan: int, est_bytes: int) -> ProtocolPlan:
    g = cfg.g_override or max(1, round(d_plan / cfg.delta))
    if cfg.n_override is not None:
        n, t = cfg.n_override, cfg.t_override
    else:
        n, t, _, _ = optimize_parameters(
            d_plan, cfg.delta, cfg.r_target, cfg.p0, KEY_BITS, convention=cfg.convention
        )
    return ProtocolPlan(
        cfg=cfg, n=n, t=t, g=g, d_est=d_est, est_bytes=est_bytes,
        seed_groups=derive_seed(cfg.seed, 1),
    )


def plan_from_estimate(cfg: PBSConfig, numerator: int, set_size_a: int) -> ProtocolPlan:
    """Pin (n, t, g) from the phase-0 exchange: the d_hat numerator (what the
    MSG_DHAT reply carries — d_hat = numerator / ell) and Alice's set size
    (which sizes the sketch frame).  Both endpoints call this with identical
    inputs, so both derive the identical plan; est_bytes is the framed
    length of the two phase-0 messages."""
    d_est = numerator / cfg.ell
    est_bytes = sketch_bytes(set_size_a, cfg.ell) + dhat_bytes(numerator)
    return _mk_plan(cfg, d_est, planned_d(d_est, cfg.gamma), est_bytes)


def plan_from_d_known(cfg: PBSConfig, d_known: int) -> ProtocolPlan:
    """Pin (n, t, g) when d is known out-of-band (no estimator traffic)."""
    return _mk_plan(cfg, float(d_known), max(1, d_known), 0)


def escalated_plan(plan: ProtocolPlan, level: int = 1) -> ProtocolPlan:
    """Degradation-ladder rung ``level`` for a session whose round budget
    ran out with groups still undone (DESIGN.md §13): re-plan at the
    difference estimate doubled ``level`` times, with group seeds freshly
    derived per rung so the bin assignment that starved the decoder is
    reshuffled rather than replayed.  Deterministic from (plan, level) —
    both endpoints derive the identical rung with zero coordination
    traffic.  Each doubling shrinks the expected per-group difference
    d̂/g toward δ, so a rung exists where every group decodes; in the
    limit the ladder converges on the verify-everything exchange (the
    checksum/verify pass transfers any stragglers), which is why
    escalation terminates instead of looping.
    """
    if level < 1:
        raise ValueError(f"escalation level {level} out of range (must be >= 1)")
    cfg = plan.cfg
    d_est = max(float(plan.d_est), 1.0) * (1 << level)
    base = _mk_plan(cfg, d_est, planned_d(d_est, cfg.gamma), plan.est_bytes)
    return replace(base, seed_groups=derive_seed(cfg.seed, 0xE5, level))


def plan_protocol(
    a: np.ndarray, b: np.ndarray, cfg: PBSConfig, d_known: int | None = None
) -> ProtocolPlan:
    """Phase 0: estimate d with ToW unless known (§6.2), then optimize (n, t, g)."""
    if d_known is not None:
        return plan_from_d_known(cfg, d_known)
    seed_tow = derive_seed(cfg.seed, 0x70)
    sk_a = tow_sketches(a, seed_tow, cfg.ell)
    sk_b = tow_sketches(b, seed_tow, cfg.ell)
    return plan_from_estimate(cfg, estimate_numerator(sk_a, sk_b), len(a))


@dataclass
class SessionState:
    """Mutable per-session protocol state threaded through the rounds."""

    a: np.ndarray
    b: np.ndarray
    a_set: set
    diff: set
    units: list
    next_uid: int
    group_b: np.ndarray           # Bob's group ids (fixed across rounds)
    order_b: np.ndarray
    bounds_b: np.ndarray
    group_a: np.ndarray           # Alice's group ids over the *base* set A
    order_a: np.ndarray           # (fixed across rounds — grouping is round-
    bounds_a: np.ndarray          #  invariant; only diff membership changes)
    bytes_per_round: list = field(default_factory=list)
    rounds: int = 0
    decode_failures: int = 0
    fake_rejections: int = 0

    def active_units(self) -> list:
        return [u for u in self.units if not u.done]


def group_view(elems: np.ndarray, g: int, seed_groups: int):
    """Group ids + stable order + group boundaries for one element array."""
    grp = hash_to_range(elems, g, seed_groups)
    order = np.argsort(grp, kind="stable")
    bounds = np.searchsorted(grp[order], np.arange(g + 1))
    return grp, order, bounds


def new_session_state(a: np.ndarray, b: np.ndarray, plan: ProtocolPlan) -> SessionState:
    grp_b, order_b, bounds_b = group_view(b, plan.g, plan.seed_groups)
    grp_a, order_a, bounds_a = group_view(a, plan.g, plan.seed_groups)
    return SessionState(
        a=a, b=b, a_set=set(a.tolist()), diff=set(),
        units=[Unit(uid=i, group=i) for i in range(plan.g)], next_uid=plan.g,
        group_b=grp_b, order_b=order_b, bounds_b=bounds_b,
        group_a=grp_a, order_a=order_a, bounds_a=bounds_a,
    )


def effective_set(a: np.ndarray, diff: set) -> np.ndarray:
    """Alice's effective set A △ D̂ for the next round (§2.4)."""
    if not diff:
        return a
    diff_arr = np.fromiter(diff, dtype=np.uint32, count=len(diff))
    return np.concatenate([setdiff_keys(a, diff_arr), setdiff_keys(diff_arr, a)])


def diff_overlay(st: SessionState) -> tuple[np.ndarray, np.ndarray]:
    """Alice's effective set as a delta against her base set A.

    A △ D̂ = (A \\ removed) ∪ added with ``removed = A ∩ D̂`` (elements Alice
    must drop this round) and ``added = D̂ \\ A`` (recovered elements she must
    inject).  Both are tiny (≤ |D̂| ≤ d) — this is what lets the batched
    engine keep A device-resident and ship only the overlay per round
    (DESIGN.md §5) instead of materializing ``effective_set``.
    """
    if not st.diff:
        empty = np.zeros(0, dtype=np.uint32)
        return empty, empty
    d = np.fromiter(st.diff, dtype=np.uint32, count=len(st.diff))
    # membership via the session's resident a_set: same split as
    # np.isin(d, st.a) without re-sorting |A| elements every round
    in_a = np.fromiter((int(v) in st.a_set for v in d), dtype=bool, count=len(d))
    return d[in_a], d[~in_a]


def session_live(st: SessionState, cfg: PBSConfig, rnd: int) -> bool:
    """Does this session participate in round ``rnd``?  Shared by the
    batched planner and both ``repro_torch.net`` endpoints — the two sides of the
    wire must agree on liveness to parse each other's round frames."""
    return rnd <= cfg.max_rounds and any(not u.done for u in st.units)


def queue_split(st: SessionState, u: Unit, rnd: int, cfg_seed: int) -> None:
    """BCH overload: retire ``u`` and enqueue its 3-way split (§3.2).

    The split seed and child uids are derived deterministically from
    (cfg seed, round, parent uid), so Alice and a wire-separated Bob that
    both observe the decode failure enqueue identical descendants.
    """
    st.decode_failures += 1
    split_seed = derive_seed(cfg_seed, 3, rnd, u.uid)
    u.done = True
    for k in range(3):
        st.units.append(
            Unit(uid=st.next_uid, group=u.group, filters=u.filters + ((split_seed, k),))
        )
        st.next_uid += 1


def slot_assignment(elems, group_of, units, group_order, group_bounds):
    """Map every element participating this round to its active-unit slot.

    Plain units (no filters) are resolved with one LUT gather; split units
    (rare) are resolved on their parent group's slice only.
    Returns (element_indices, slot_ids).
    """
    g = len(group_bounds) - 1
    lut = np.full(g, -1, dtype=np.int64)
    sel_idx: list[np.ndarray] = []
    sel_slot: list[np.ndarray] = []
    for slot, u in enumerate(units):
        if not u.filters:
            lut[u.group] = slot
        else:
            lo, hi = group_bounds[u.group], group_bounds[u.group + 1]
            idx = group_order[lo:hi]
            vals = elems[idx]
            mask = np.ones(len(idx), dtype=bool)
            for fs, fi in u.filters:
                mask &= hash_to_range(vals, 3, fs) == fi
            sel_idx.append(idx[mask])
            sel_slot.append(np.full(int(mask.sum()), slot, dtype=np.int64))
    plain_slot = lut[group_of]
    plain_sel = plain_slot >= 0
    sel_idx.append(np.nonzero(plain_sel)[0])
    sel_slot.append(plain_slot[plain_sel])
    return np.concatenate(sel_idx), np.concatenate(sel_slot)


def unit_tables(elems, idx, slots, n_units, n, bin_seed):
    """Per-(unit, bin) parity positions, XOR folds, and per-unit checksums.

    Returns (parity_slot, parity_pos, xors (n_units, n) uint32, csums (n_units,)).
    """
    vals = elems[idx]
    bins = hash_to_range(vals, n, bin_seed)
    flat = slots * n + bins
    counts = np.zeros(n_units * n, dtype=np.int64)
    np.add.at(counts, flat, 1)
    xors = np.zeros(n_units * n, dtype=np.uint32)
    np.bitwise_xor.at(xors, flat, vals.astype(np.uint32))
    csums = np.zeros(n_units, dtype=np.uint64)
    np.add.at(csums, slots, vals.astype(np.uint64))
    csums %= _MOD
    odd = np.nonzero(counts & 1)[0]
    return odd // n, odd % n, xors.reshape(n_units, n), csums


def segmented_sketches(code, slot_of_pos, positions, n_units):
    """BCH sketches for all units at once (segmented XOR over bit positions)."""
    out = np.zeros((n_units, code.t), dtype=np.int64)
    if len(positions):
        gf = code.field
        j = np.arange(code.t, dtype=np.int64)[None, :]
        vals = gf.pow_alpha(positions[:, None] * (2 * j + 1))  # (P, t)
        np.bitwise_xor.at(out, slot_of_pos, vals)
    return out


def segmented_sketches_range(code, t0, slot_of_pos, positions, n_units):
    """Incremental BCH syndromes S_{2*t0+1}..S_{2t-1} for all units at once.

    The ``[t0, code.t)`` column slice of ``segmented_sketches`` — the prefix
    property (``gf2m.syndrome_matrix_range``) makes concatenating this onto
    a cached ``segmented_sketches`` prefix bit-identical to sketching at
    ``code.t`` directly.  This is the oracle's ``MSG_PARITY`` payload
    (DESIGN.md §16)."""
    out = np.zeros((n_units, code.t - t0), dtype=np.int64)
    if len(positions):
        gf = code.field
        j = np.arange(t0, code.t, dtype=np.int64)[None, :]
        vals = gf.pow_alpha(positions[:, None] * (2 * j + 1))  # (P, t-t0)
        np.bitwise_xor.at(out, slot_of_pos, vals)
    return out


def rateless_extend(n, t, m, sk_diff, ok, positions, incremental):
    """In-round rateless recovery ladder (DESIGN.md §16), the shared oracle.

    Instead of surrendering every failed BCH decode to the 3-way split,
    level e = 1.. re-decodes the *same* round bitmaps at
    t_e = ``parity_extension_t(t, e, n)``: ``incremental(t0, t1)`` supplies
    the (U, t1-t0) incremental *diff* syndromes S_{2*t0+1}..S_{2*t1-1} for
    every unit, which concatenate onto the cached prefix — zero re-sent
    sketch bits.  The ladder stops when nothing fails, the level cap is
    reached, or the code cap (n-1)//2 stops t from growing.

    Returns (ok, positions, ext_bits, levels): merged outcomes plus the
    Formula-(1) ledger bits — per level, U_e failing units pay
    U_e * (Δt_e·m + 1), exactly what ``MSG_PARITY`` and its extension reply
    measure on the wire (repro_torch.wire.parity_ledger_bits + the reply flags).
    """
    ok = np.asarray(ok, dtype=bool).copy()
    positions = list(positions)
    fail = ~ok
    if not fail.any():
        return ok, positions, 0, 0
    acc = np.asarray(sk_diff)
    ext_bits = 0
    levels = 0
    t_prev = t
    for level in range(1, MAX_PARITY_EXTENSIONS + 1):
        t_e = parity_extension_t(t, level, n)
        if t_e <= t_prev:
            break  # code cap reached: ladder exhausted, splits take over
        acc = np.concatenate([acc, incremental(t_prev, t_e)], axis=1)
        ext_bits += int(fail.sum()) * ((t_e - t_prev) * m + 1)
        levels += 1
        code_e = bch_code(n, t_e)
        for slot in np.flatnonzero(fail):
            ok_e, pos_e = decode_sketch(code_e, acc[slot])
            if ok_e:
                ok[slot] = True
                positions[slot] = pos_e.astype(np.int64)
                fail[slot] = False
        t_prev = t_e
        if not fail.any():
            break
    return ok, positions, ext_bits, levels


def apply_round_outcomes(
    st: SessionState,
    active: list,
    ok,
    positions,
    xors_a: np.ndarray,
    xors_b: np.ndarray,
    csum_a: np.ndarray,
    csum_b: np.ndarray,
    *,
    plan: ProtocolPlan,
    bin_seed: int,
    rnd: int,
) -> tuple[int, list[bool]]:
    """Alice's per-unit endgame for one round: recovery via the XOR trick
    (Procedure 1), fake rejection (Procedure 3), checksum gating (§2.2.3),
    and the 3-way-split re-queue on BCH overload (§3.2).

    All arrays are indexed by the unit's position (slot) in ``active``:
    ``positions[slot]`` is the decoded bin index array, ``xors_*[slot]`` the
    (n,) per-bin XOR folds, ``csum_*[slot]`` the unit checksums.  Mutates
    ``st`` (diff, unit queue, counters) and returns (bits, done): the
    Bob->Alice bits this round adds to Formula (1) — the caller accounts
    the Alice->Bob sketches — and the per-slot checksum-settled flags that
    the endpoint path ships to Bob as the round-outcome frame so he can
    mirror the unit queue.
    """
    cfg, n, g, m = plan.cfg, plan.n, plan.g, plan.m
    bits = 0
    done = [False] * len(active)
    for slot, u in enumerate(active):
        if not ok[slot]:
            queue_split(st, u, rnd, cfg.seed)
            continue
        pos = positions[slot]
        # Bob -> Alice: bin indices, his XOR sums, his checksum (Formula 1).
        bits += len(pos) * (m + KEY_BITS) + KEY_BITS
        delta_sum = 0
        newly = []
        for p in pos:
            s = int(xors_a[slot, int(p)] ^ xors_b[slot, int(p)])
            if s == 0:
                st.fake_rejections += 1
                continue
            sx = np.array([s], dtype=np.uint32)
            # Procedure 3: s must belong to this unit's sub-universe.
            if (
                int(hash_to_range(sx, n, bin_seed)[0]) != int(p)
                or int(hash_to_range(sx, g, plan.seed_groups)[0]) != u.group
                or any(int(hash_to_range(sx, 3, fs)[0]) != fk for fs, fk in u.filters)
            ):
                st.fake_rejections += 1
                continue
            newly.append(s)
            in_eff = (s in st.a_set) ^ (s in st.diff)
            delta_sum += -s if in_eff else s
        for s in newly:
            st.diff.symmetric_difference_update((s,))
        new_csum = int((int(csum_a[slot]) + delta_sum) % (1 << KEY_BITS))
        if new_csum == int(csum_b[slot]):
            u.done = True
            done[slot] = True
    return bits, done


def finalize_result(st: SessionState, plan: ProtocolPlan) -> ReconcileResult:
    return ReconcileResult(
        diff=st.diff,
        rounds=st.rounds,
        success=all(u.done for u in st.units),
        bytes_sent=sum(st.bytes_per_round),
        estimator_bytes=plan.est_bytes,
        bytes_per_round=st.bytes_per_round,
        n=plan.n,
        t=plan.t,
        g=plan.g,
        d_est=plan.d_est,
        decode_failures=st.decode_failures,
        fake_rejections=st.fake_rejections,
    )


# ---------------------------------------------------------------------------
# Single-session protocol loop (the numpy oracle)
# ---------------------------------------------------------------------------


def reconcile(
    set_a: np.ndarray,
    set_b: np.ndarray,
    cfg: PBSConfig | None = None,
    d_known: int | None = None,
) -> ReconcileResult:
    """Run the full PBS protocol; Alice (holding A) learns A △ B."""
    cfg = cfg or PBSConfig()
    a = unique_keys(np.asarray(set_a, dtype=np.uint32))
    b = unique_keys(np.asarray(set_b, dtype=np.uint32))

    plan = plan_protocol(a, b, cfg, d_known)
    code = plan.code
    n, t, g, m = plan.n, plan.t, plan.g, plan.m
    st = new_session_state(a, b, plan)

    for rnd in range(1, cfg.max_rounds + 1):
        active = st.active_units()
        if not active:
            break
        st.rounds = rnd
        bin_seed = derive_seed(cfg.seed, 2, rnd)
        n_units = len(active)

        eff_a = effective_set(a, st.diff)
        group_eff, order_a, bounds_a = group_view(eff_a, g, plan.seed_groups)

        idx_a, slot_a = slot_assignment(eff_a, group_eff, active, order_a, bounds_a)
        idx_b, slot_b = slot_assignment(b, st.group_b, active, st.order_b, st.bounds_b)

        pslot_a, ppos_a, xors_a, csum_a = unit_tables(eff_a, idx_a, slot_a, n_units, n, bin_seed)
        pslot_b, ppos_b, xors_b, csum_b = unit_tables(b, idx_b, slot_b, n_units, n, bin_seed)

        sk_a_all = segmented_sketches(code, pslot_a, ppos_a, n_units)
        sk_b_all = segmented_sketches(code, pslot_b, ppos_b, n_units)
        round_bits = n_units * (t * m + 1)  # Alice->Bob sketches + ok flags

        sk_diff = sk_a_all ^ sk_b_all
        ok, err_positions = batched_decode(code, sk_diff)
        if cfg.rateless and not np.asarray(ok, dtype=bool).all():

            def _inc(t0, t1):
                code_e = bch_code(n, t1)
                return segmented_sketches_range(
                    code_e, t0, pslot_a, ppos_a, n_units
                ) ^ segmented_sketches_range(code_e, t0, pslot_b, ppos_b, n_units)

            ok, err_positions, ext_bits, _ = rateless_extend(
                n, t, m, sk_diff, ok, err_positions, _inc
            )
            round_bits += ext_bits

        reply_bits, _ = apply_round_outcomes(
            st, active, ok, err_positions, xors_a, xors_b, csum_a, csum_b,
            plan=plan, bin_seed=bin_seed, rnd=rnd,
        )
        st.bytes_per_round.append((round_bits + reply_bits + 7) // 8)

    return finalize_result(st, plan)


def reconcile_small(
    set_a: np.ndarray, set_b: np.ndarray, n: int, t: int, seed: int = 0, max_rounds: int = 12
) -> ReconcileResult:
    """PBS-for-small-d (§2): a single group pair with pinned (n, t)."""
    cfg = PBSConfig(
        seed=seed, n_override=n, t_override=t, g_override=1, max_rounds=max_rounds
    )
    return reconcile(set_a, set_b, cfg, d_known=max(1, t // 2))


def true_diff(set_a: np.ndarray, set_b: np.ndarray) -> set:
    a = set(int(x) for x in np.asarray(set_a).ravel())
    b = set(int(x) for x in np.asarray(set_b).ravel())
    return a ^ b
