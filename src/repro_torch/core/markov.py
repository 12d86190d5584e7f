"""The paper's analytical framework (§4, §5, App. D/E/F/G/H).

* ``transition_matrix(n, t)`` — the Markov chain over the number of "bad balls"
  (unreconciled distinct elements) in one group, computed with the App. E
  dynamic program over sub-states (i, j, k) in O(t^3).
* ``success_prob(x, r)`` — Pr[x ⇝ 0 within r rounds] = (M^r)(x, 0).
* ``alpha(n, t, d, g, r)`` — per-group success prob under X ~ Binomial(d, 1/g),
  truncated at x ≤ t (App. F's deliberate slight underestimate).
* ``overall_lower_bound`` — 1 − 2(1 − alpha^g)  (App. F, via [29] Cor 5.11).
* ``optimize_parameters`` — §5.1: minimize (t + delta)·log2(n) s.t. bound ≥ p0.
* ``expected_round_fractions`` — §5.3 / App. G piecewise-reconciliability.
"""
from __future__ import annotations

import functools
import math

import numpy as np

N_CHOICES = (63, 127, 255, 511, 1023, 2047)


@functools.lru_cache(maxsize=None)
def _mtilde(n: int, t: int) -> np.ndarray:
    """M~(i, j, k): throwing i balls into n bins leaves j bad balls in k bad bins.

    App. E recurrence, rendered "in slow motion" one ball at a time:
      M~(i,j,k) = (i-j+1)/n * M~(i-1, j-2, k-1)     # ball joins a good-ball bin
                +  k/n      * M~(i-1, j-1, k)       # ball joins a bad bin
                + (1 - (i-1-j+k)/n) * M~(i-1, j, k) # ball lands in an empty bin
    """
    size = t + 1
    Mt = np.zeros((size + 1, size + 1, size + 1), dtype=np.float64)
    Mt[0, 0, 0] = 1.0
    for i in range(1, size + 1):
        for j in range(0, i + 1):
            for k in range(0, j // 2 + 1):
                acc = 0.0
                # joins a bin holding exactly one good ball; good balls = (i-1)-(j-2)
                if j >= 2 and k >= 1 and (i - j + 1) > 0:
                    acc += (i - j + 1) / n * Mt[i - 1, j - 2, k - 1]
                # joins one of the k existing bad bins
                if k >= 1 and j >= 1:
                    acc += k / n * Mt[i - 1, j - 1, k]
                # lands in an empty bin: empty = n - ((i-1-j) good bins + k bad bins)
                empt = 1.0 - (i - 1 - j + k) / n
                if empt > 0:
                    acc += empt * Mt[i - 1, j, k]
                Mt[i, j, k] = acc
    return Mt


@functools.lru_cache(maxsize=None)
def transition_matrix(n: int, t: int) -> np.ndarray:
    """M(i, j) = Pr[i bad balls thrown -> j remain bad], i, j in [0, t]."""
    Mt = _mtilde(n, t)
    M = Mt[: t + 1, : t + 1].sum(axis=2)
    # rows must be stochastic (within fp error) — the DP covers all j <= i
    np.testing.assert_allclose(M.sum(axis=1), 1.0, atol=1e-9)
    return M


@functools.lru_cache(maxsize=None)
def _matrix_power(n: int, t: int, r: int) -> np.ndarray:
    return np.linalg.matrix_power(transition_matrix(n, t), r)


def success_prob(n: int, t: int, x: int, r: int) -> float:
    """Pr[x ⇝ 0 within r rounds] (Eq. 2).  x > t -> 0 by App. D convention."""
    if x == 0:
        return 1.0
    if x > t:
        return 0.0
    return float(_matrix_power(n, t, r)[x, 0])


@functools.lru_cache(maxsize=None)
def success_prob_with_split(n: int, t: int, x: int, r: int) -> float:
    """Pr[x ⇝ 0 within r rounds], modeling the §3.2 3-way split for x > t.

    The paper's App. D sets Pr = 0 for x > t ("to our disadvantage") but its
    own Table 1 is inconsistent with that convention at small t (see
    EXPERIMENTS.md §Paper-validation).  This variant models the documented
    recovery mechanism instead: a BCH decoding failure consumes the round and
    hash-partitions the group 3 ways; each sub-group (Multinomial(x, 1/3))
    reconciles independently in the remaining r-1 rounds, recursively.
    """
    if x == 0:
        return 1.0
    if r <= 0:
        return 0.0
    if x <= t:
        return float(_matrix_power(n, t, r)[x, 0])
    if r == 1:
        return 0.0
    tot = 0.0
    log3 = math.log(3.0)
    for y1 in range(x + 1):
        p1 = success_prob_with_split(n, t, y1, r - 1)
        if p1 == 0.0 and y1 > 0:
            continue
        for y2 in range(x - y1 + 1):
            y3 = x - y1 - y2
            logp = (
                math.lgamma(x + 1)
                - math.lgamma(y1 + 1)
                - math.lgamma(y2 + 1)
                - math.lgamma(y3 + 1)
                - x * log3
            )
            tot += (
                math.exp(logp)
                * p1
                * success_prob_with_split(n, t, y2, r - 1)
                * success_prob_with_split(n, t, y3, r - 1)
            )
    return tot


def _binom_pmf(d: int, p: float, xs: np.ndarray) -> np.ndarray:
    """Binomial(d, p) pmf, computed stably in log space (no scipy available)."""
    xs = np.asarray(xs)
    if p >= 1.0:  # degenerate: all mass at x = d (single-group case)
        return (xs == d).astype(np.float64)
    logp = (
        np.array([math.lgamma(d + 1) - math.lgamma(x + 1) - math.lgamma(d - x + 1) for x in xs])
        + xs * math.log(p)
        + (d - xs) * math.log1p(-p)
    )
    return np.exp(logp)


def alpha(n: int, t: int, d: int, g: int, r: int, convention: str = "truncate") -> float:
    """Per-group success probability under X ~ Binomial(d, 1/g).

    convention='truncate': the paper's stated App. D/F model (x > t fails).
    convention='split':    models the §3.2 3-way split recovery for x > t.
    """
    if convention == "truncate":
        xs = np.arange(0, min(t, d) + 1)
        pmf = _binom_pmf(d, 1.0 / g, xs)
        probs = np.array([success_prob(n, t, int(x), r) for x in xs])
    elif convention == "split":
        xmax = min(d, max(3 * t, 48))
        xs = np.arange(0, xmax + 1)
        pmf = _binom_pmf(d, 1.0 / g, xs)
        probs = np.array([success_prob_with_split(n, t, int(x), r) for x in xs])
    else:
        raise ValueError(convention)
    return float(np.sum(pmf * probs))


def overall_lower_bound(
    n: int, t: int, d: int, g: int, r: int, convention: str = "truncate"
) -> float:
    """Rigorous lower bound on Pr[R <= r]: 1 - 2(1 - alpha^g)."""
    a = alpha(n, t, d, g, r, convention)
    return 1.0 - 2.0 * (1.0 - a**g)


def comm_bits_per_group(n: int, t: int, delta: float, key_bits: int = 32) -> float:
    """Formula (1): t·log n + delta·log n + delta·|key| + |key| (first round)."""
    m = int(math.log2(n + 1))
    return t * m + delta * m + delta * key_bits + key_bits


def optimize_parameters(
    d: int,
    delta: float = 5.0,
    r: int = 3,
    p0: float = 0.99,
    key_bits: int = 32,
    t_range=None,
    n_choices=N_CHOICES,
    convention: str = "split",
):
    """§5.1 grid optimization: feasible (n, t) minimizing the objective.

    Returns (n, t, bound, comm_bits_per_group).  t sweeps 1.5δ..3.5δ by
    default; widened once if the box is infeasible.  Default convention is
    'split' because the runnable protocol *does* recover via the 3-way split,
    so 'truncate' over-provisions t (see EXPERIMENTS.md §Paper-validation).
    """
    g = max(1, round(d / delta))
    widened = t_range is not None
    if t_range is None:
        t_range = range(max(1, int(1.5 * delta)), int(3.5 * delta) + 1)
    best = None
    for n in n_choices:
        m = int(math.log2(n + 1))
        for t in t_range:
            obj = (t + delta) * m
            if best is not None and obj >= best[0]:
                continue  # cannot win; skip the expensive bound
            lb = overall_lower_bound(n, t, d, g, r, convention)
            if lb >= p0:
                best = (obj, n, t, lb)
    if best is None:
        if widened:
            raise ValueError(
                f"no feasible (n, t) for d={d}, r={r}, p0={p0} ({convention})"
            )
        # Small r (e.g. r=1) needs n = Omega(d^2/group): the ideal case must
        # happen almost surely in one shot — widen both t and the bitmap sizes
        # beyond the "practical" set (the paper's r=1 point implies n = 2^19-1).
        wide_t = range(max(1, int(1.5 * delta)), int(12 * delta))
        wide_n = tuple((1 << m) - 1 for m in range(6, 21))
        return optimize_parameters(
            d, delta, r, p0, key_bits, wide_t, wide_n, convention
        )
    obj, n, t, lb = best
    return n, t, lb, comm_bits_per_group(n, t, delta, key_bits)


def bound_table(
    d: int, delta: float, r: int, t_values, n_values=N_CHOICES, convention="truncate"
):
    """Table 1: lower-bound values for a grid of (n, t)."""
    g = max(1, round(d / delta))
    return {
        (n, t): overall_lower_bound(n, t, d, g, r, convention)
        for n in n_values
        for t in t_values
    }


def expected_round_fractions(n: int, t: int, d: int, g: int, kmax: int = 4) -> list[float]:
    """§5.3: expected fraction of the d distinct elements reconciled in round k.

    E[Z_1+..+Z_k | x] = x − E[D_k | D_0 = x]; average over X ~ Binomial(d, 1/g)
    (truncated at t, matching the framework's convention), normalize by E[X].
    """
    xs = np.arange(0, min(t, d) + 1)
    pmf = _binom_pmf(d, 1.0 / g, xs)
    pmf /= pmf.sum()
    ex = float(np.sum(pmf * xs))
    cum = []
    for k in range(1, kmax + 1):
        Mk = _matrix_power(n, t, k)
        # E[D_k | D_0 = x] = sum_y y * (M^k)(x, y)
        ed = np.array([np.sum(np.arange(t + 1) * Mk[x]) for x in xs])
        cum.append(float(np.sum(pmf * (xs - ed))) / ex)
    fracs = [cum[0]] + [cum[k] - cum[k - 1] for k in range(1, kmax)]
    return fracs
