"""Algorithm 2 — latency-constrained model allocation.

Solves the pipelined multiple-choice knapsack of paper section IV-C:
assign exactly one model (or "skip", model index 0) to each predicted
SRoI so that the summed weighted accuracy is maximised while the
*pipelined* analysis latency stays within the budget T.

The pipelined latency recurrence (paper Fig. 6): if the previous SRoIs
finish preprocessing at t^P and finish inference at t, choosing model i
for the next SRoI gives

    cur_t  = max(t^P + d_{i,j},  t + d^I_{i,j})      (d = d^P + d^I)
    cur_tP = t^P + d^P_{i,j}

The DP keeps, per prefix length j, the set of *non-dominated* feasible
plans (v, t^P, t, m_list); a plan dominates another iff v >= v',
t^P <= t'^P and t <= t' (eq. 4), so dominated plans can never become
part of an optimum and are pruned.

``allocate`` is exact for a fixed SRoI processing order; the paper
approximates the global optimum by running it on one (random) order —
our serving loop does the same, and ``tests/test_allocation.py``
verifies exactness against brute force on small instances.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable

import numpy as np

# (i, j, d_pre_ij, d_inf_ij) -> (d_pre_ij, d_inf_ij): reprices model i
# on SRoI j before the DP sees it.  The pod-level allocator
# (repro.serving.pod_allocation) injects tick-coupled batched costs
# through this; with no hook the solver is byte-for-byte the legacy
# per-stream knapsack.
CostHook = Callable[[int, int, float, float], tuple[float, float]]


def apply_cost_hook(
    hook: CostHook, d_pre: np.ndarray, d_inf: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Materialise the hooked (d_pre, d_inf) matrices.

    Shared by :func:`allocate` / :func:`allocate_bruteforce` and by
    callers that need the same repriced matrices outside the DP (e.g.
    to re-price an incumbent plan via :func:`plan_latency`), so the
    hook semantics cannot drift between them.
    """
    m, r = d_pre.shape
    out_pre = np.empty_like(d_pre, dtype=np.float64)
    out_inf = np.empty_like(d_inf, dtype=np.float64)
    for i in range(m):
        for j in range(r):
            out_pre[i, j], out_inf[i, j] = hook(
                i, j, float(d_pre[i, j]), float(d_inf[i, j]))
    return out_pre, out_inf


@dataclasses.dataclass(frozen=True)
class Plan:
    """One feasible execution plan (the DP quaternion)."""

    value: float  # cumulative weighted accuracy v
    t_pre: float  # preprocessing completion time t^P
    t_done: float  # processing completion time t
    models: tuple[int, ...]  # allocated model index per SRoI (0 = skip)


def _prune_dominated(plans: list[Plan]) -> list[Plan]:
    """Remove plans dominated per eq. (4).

    Sort by (-value, t_pre, t_done); sweep keeping the Pareto frontier
    over (t_pre, t_done) among plans with >= value.  O(n log n + n*k)
    with k = frontier size, fine for the handfuls of SRoIs per frame.
    """
    plans.sort(key=lambda p: (-p.value, p.t_pre, p.t_done))
    kept: list[Plan] = []
    for p in plans:
        dominated = False
        for q in kept:
            if q.value >= p.value and q.t_pre <= p.t_pre and q.t_done <= p.t_done:
                dominated = True
                break
        if not dominated:
            kept.append(p)
    return kept


def allocate(
    acc: np.ndarray,
    d_pre: np.ndarray,
    d_inf: np.ndarray,
    budget: float,
    *,
    cost_hook: CostHook | None = None,
) -> Plan | None:
    """Algorithm 2.

    ``acc``:   (M, R) weighted accuracies A_{i,j}; row 0 must be "skip".
    ``d_pre``: (M, R) preprocessing delays d^P_{i,j} (skip row = 0).
    ``d_inf``: (M, R) inference delays d^I_{i,j} (skip row = 0).
    ``budget``: analysis latency budget T (seconds).
    ``cost_hook``: optional :data:`CostHook` repricing each (model,
    SRoI) delay pair before the DP runs (the pod-level coupling entry
    point); with ``None`` the input matrices are used untouched, so
    legacy plans stay bit-identical.

    Returns the best feasible plan for SRoIs processed in column order,
    or ``None`` when even skipping everything violates the budget
    (cannot happen with zero-cost skip, but kept for defensiveness).
    """
    m, r = acc.shape
    if r == 0:
        return Plan(0.0, 0.0, 0.0, ())
    if cost_hook is not None:
        d_pre, d_inf = apply_cost_hook(cost_hook, d_pre, d_inf)
    d_tot = d_pre + d_inf

    frontier: list[Plan] = []
    for i in range(m):
        if d_tot[i, 0] <= budget:
            frontier.append(Plan(float(acc[i, 0]), float(d_pre[i, 0]), float(d_tot[i, 0]), (i,)))
    frontier = _prune_dominated(frontier)

    for j in range(1, r):
        nxt: list[Plan] = []
        for p in frontier:
            for i in range(m):
                cur_t = max(p.t_pre + d_tot[i, j], p.t_done + d_inf[i, j])
                if cur_t <= budget:
                    nxt.append(
                        Plan(
                            p.value + float(acc[i, j]),
                            p.t_pre + float(d_pre[i, j]),
                            cur_t,
                            p.models + (i,),
                        )
                    )
        frontier = _prune_dominated(nxt)
        if not frontier:
            return None

    return max(frontier, key=lambda p: p.value)


def allocate_bruteforce(
    acc: np.ndarray,
    d_pre: np.ndarray,
    d_inf: np.ndarray,
    budget: float,
    *,
    cost_hook: CostHook | None = None,
) -> Plan | None:
    """Exhaustive oracle (M^R enumeration) for tests; same semantics."""
    m, r = acc.shape
    if cost_hook is not None:
        d_pre, d_inf = apply_cost_hook(cost_hook, d_pre, d_inf)
    d_tot = d_pre + d_inf
    best: Plan | None = None
    for models in itertools.product(range(m), repeat=r):
        t_pre = 0.0
        t_done = 0.0
        value = 0.0
        feasible = True
        for j, i in enumerate(models):
            t_done = max(t_pre + d_tot[i, j], t_done + d_inf[i, j])
            t_pre += d_pre[i, j]
            value += float(acc[i, j])
            if t_done > budget:
                feasible = False
                break
        if feasible and (best is None or value > best.value):
            best = Plan(value, t_pre, t_done, tuple(models))
    return best


def plan_latency(
    models: tuple[int, ...], d_pre: np.ndarray, d_inf: np.ndarray
) -> float:
    """Pipelined analysis latency L(X) of a fixed plan (paper eq. 3)."""
    t_pre = 0.0
    t_done = 0.0
    for j, i in enumerate(models):
        t_done = max(t_pre + d_pre[i, j] + d_inf[i, j], t_done + d_inf[i, j])
        t_pre += d_pre[i, j]
    return t_done
