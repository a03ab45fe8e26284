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

The frontier is held as float64 arrays (v, t^P, t) with, per column,
each plan's parent in the previous frontier and its model; the models
of the chosen plan are read back along those pointers once, at the end.
A column's candidates are one broadcast over (frontier x models) and
the prune is a staircase sweep (:func:`_prune_dominated`), O(n log k)
for n candidates and k kept.  Both do the scalar recurrence's float64
operations in its order and keep its plans in its order, so the plan
returned is the one the per-plan loop of ``repro.core.allocation``
returns, bit for bit.

``allocate`` is exact for a fixed SRoI processing order; the paper
approximates the global optimum by running it on one (random) order —
our serving loop does the same, and ``tests/test_allocation.py``
verifies exactness against brute force on small instances.
"""

from __future__ import annotations

import bisect
import dataclasses
import itertools
from typing import Callable

import numpy as np

from repro_torch import tracing

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


def _prune_dominated(v: np.ndarray, t_pre: np.ndarray,
                     t_done: np.ndarray) -> np.ndarray:
    """Indices of the plans (v, t_pre, t_done) that survive eq. (4), in
    the order (-value, t_pre, t_done) with ties in input order.

    One sweep in that order keeps a plan unless an earlier one has
    t_pre and t_done no larger: every earlier plan has a value no
    smaller, and dominance is transitive, so a plan dominated by an
    earlier dropped plan is dominated by an earlier kept one, and the
    kept set is the one the quadratic check against every kept plan
    gives (an identical triple goes after its first occurrence).  The
    earlier plans are summed up by their staircase: the kept points not
    covered by another, t_pre ascending and t_done strictly descending.
    The point with the largest t_pre <= the plan's has the least t_done
    among all with t_pre <= the plan's, so one bisection decides; a kept
    plan replaces the points it covers.  O(n log k) for n plans and k
    kept, against O(n k) for the check against every kept plan.
    """
    order = np.lexsort((t_done, t_pre, -v))
    # sentinels: a first point that dominates nothing, a last one that
    # covers nothing
    stair_pre = [-np.inf, np.inf]
    stair_done = [np.inf, -np.inf]
    kept: list[int] = []
    for idx, x, y in zip(order.tolist(), t_pre[order].tolist(),
                         t_done[order].tolist()):
        i = bisect.bisect_right(stair_pre, x)
        if stair_done[i - 1] <= y:
            continue
        lo = i - 1 if stair_pre[i - 1] == x else i
        hi = lo
        while stair_done[hi] >= y:
            hi += 1
        stair_pre[lo:hi] = (x,)
        stair_done[lo:hi] = (y,)
        kept.append(idx)
    return np.array(kept, dtype=np.intp)


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

    The DP runs in float64.  Every caller in the port passes float64
    matrices (the loop's accuracy matrix and the latency model's delays,
    or :func:`apply_cost_hook`'s), on which the plan is the scalar
    recurrence's bit for bit.  Other dtypes are widened to float64
    first; the scalar recurrence added float32 delays in float32 (a
    Python float and a NumPy float32 scalar make a float32 under NumPy
    2), so on float32 delays the two may differ in the last bit.

    Returns the best feasible plan for SRoIs processed in column order
    (the first of the greatest value in the frontier's order), or
    ``None`` when even skipping everything violates the budget (cannot
    happen with zero-cost skip, but kept for defensiveness; on a single
    column the per-plan loop raised ``ValueError`` there).  Counts the
    feasible candidates the DP prunes as ``alloc.candidates``
    (:mod:`repro_torch.tracing`).
    """
    r = acc.shape[1]
    if r == 0:
        return Plan(0.0, 0.0, 0.0, ())
    if cost_hook is not None:
        d_pre, d_inf = apply_cost_hook(cost_hook, d_pre, d_inf)
    acc = np.asarray(acc, dtype=np.float64)
    d_pre = np.asarray(d_pre, dtype=np.float64)
    d_inf = np.asarray(d_inf, dtype=np.float64)
    d_tot = d_pre + d_inf

    # column 0: one plan a feasible model, in model order
    model = np.nonzero(d_tot[:, 0] <= budget)[0]
    v, t_pre, t_done = acc[model, 0], d_pre[model, 0], d_tot[model, 0]
    n_cand = len(model)
    keep = _prune_dominated(v, t_pre, t_done)
    v, t_pre, t_done = v[keep], t_pre[keep], t_done[keep]
    back = [(None, model[keep])]
    for j in range(1, r):
        # every (plan, model) pair in the scalar loop's order: plan-major
        a = t_pre[:, None] + d_tot[:, j]
        b = t_done[:, None] + d_inf[:, j]
        cur = np.where(b > a, b, a)  # Python's max(a, b), NaN and all
        parent, model = np.nonzero(cur <= budget)
        n_cand += len(parent)
        v = v[parent] + acc[model, j]
        t_pre = t_pre[parent] + d_pre[model, j]
        t_done = cur[parent, model]
        keep = _prune_dominated(v, t_pre, t_done)
        v, t_pre, t_done = v[keep], t_pre[keep], t_done[keep]
        back.append((parent[keep], model[keep]))
    tracing.count("alloc.candidates", n_cand)
    if not len(v):
        return None

    # the frontier's first plan is the reference's max(frontier, key=value)
    idx = 0
    models = [0] * r
    for j in range(r - 1, -1, -1):
        parent, model = back[j]
        models[j] = int(model[idx])
        if parent is not None:
            idx = int(parent[idx])
    return Plan(float(v[0]), float(t_pre[0]), float(t_done[0]),
                tuple(models))


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
