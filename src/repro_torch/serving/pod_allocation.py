"""Pod-level allocation: couple the per-stream knapsacks.

Algorithm 2 (``repro.core.allocation``) prices every inference request
as if the stream had the edge to itself, but at pod scale the true
marginal cost of a variant depends on how many co-streams pick it this
tick (the batched forward amortizes the fixed dispatch cost,
``OmniSenseLatencyModel.batched_inference_delay``) and on which replica
group serves it (dispatches within a group serialise; groups run
concurrently — ``repro.serving.placement``).  A stream planning alone
therefore both OVERPAYS for popular variants (it ignores the batching
discount it would share) and cannot see idle replica groups.

``solve_pod`` closes the loop with a capacity-enveloped best-response
fixed point:

  1. round 0 solves every stream's knapsack on its own base matrices —
     byte-identical to the uncoupled path.  These plans are the
     incumbents, and their projected device load defines the tick
     CAPACITY ENVELOPE ``T_cap`` (max over replica groups of the
     chunked drain cost, :func:`projected_tick` — the exact curve
     ``OmniSenseLatencyModel.tick_schedule_delay`` prices);
  2. each later round sweeps the streams in index order (Gauss–Seidel:
     the pod counts update as each stream re-plans).  Stream ``s``
     re-prices its ``d_inf`` rows against the co-stream demand —
     for variant ``v``:

         coupled = (d_inf * amort(v, 1 + co_v) + qw * wait_v)
                   * (1 + uw * utilisation[group(v)])

     where ``co_v`` is the co-stream demand for ``v``, ``amort`` is
     the per-request share of the chunked tick drain relative to the
     b=1 forward (``OmniSenseLatencyModel.pod_amortization``; == 1.0
     exactly at ``co_v == 0`` on one device, so a lone stream
     reproduces its uncoupled plan bit-for-bit), ``wait_v`` is the
     co-stream queue depth of OTHER variants sharing ``v``'s replica
     group (seconds, ``variant_queue_cost``) and ``utilisation`` is
     the observed cross-tick busy fraction of the group
     (``ServeStats.group_utilisation``), steering demand toward idle
     groups;
  3. the stream switches to its re-priced knapsack optimum ONLY when
     it is STRICTLY more valuable (or the incumbent went infeasible
     under the coupled prices) AND the switch keeps the pod's
     projected tick within ``T_cap`` — so the batching discount can
     upgrade plans (skips become runs, models grow) only into device
     time the uncoupled schedule was already paying for.  Keeping the
     incumbent on non-strict improvement is the tie-break that removes
     equal-value swap cycles; ``damping`` caps how many streams may
     switch per round;
  4. iterate until a full sweep changes nothing, or the round cap hits.

The envelope makes the coupled solution dominate by construction:
the projected tick never exceeds the uncoupled projection, and
per-stream values are monotone non-decreasing from the uncoupled
incumbents whenever those incumbents stay budget-feasible under the
coupled prices — structural with per-variant replica groups and no
utilisation markup, where every coupling term is a discount
(``factor <= 1``, no co-variant queue wait).  On a SHARED group the
queue-wait term (or a heavy utilisation markup) may price an
overcommitted incumbent out of its budget, and shedding that work is
the correct answer there.  Accuracy up at equal-or-lower tick latency
is exactly what ``benchmarks/serving_bench.py --pod-allocate``
measures and ``benchmarks/check_regression.py`` gates.

Termination is proven by the round cap; a convergent run is a genuine
fixed point — re-running :func:`best_response` against the returned
plans changes nothing (property-tested).  Degenerate pods
short-circuit: with one variant there is no cross-variant choice to
couple, and a single stream has no co-streams, so both return the
uncoupled plans unchanged (bit-identical).

``solve_pod_bruteforce`` enumerates the joint assignment space on tiny
pods — the oracle for the fixed point's feasibility/value tests.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.core import allocation
from repro_torch.serving.batching import ShapeBuckets

DEFAULT_MAX_ROUNDS = 6
DEFAULT_DAMPING = 1.0       # fraction of streams allowed to switch/round
DEFAULT_QUEUE_WEIGHT = 0.5  # fraction of the co-stream group queue paid
DEFAULT_UTIL_WEIGHT = 0.5   # busy-group price inflation at utilisation 1
_TOL = 1e-9


@dataclasses.dataclass(frozen=True)
class StreamProblem:
    """One stream's per-frame allocation instance.

    Mirrors ``OmniSenseLoop.FrameContext``: (1 + M, R) matrices with
    the zero-cost skip row 0, or ``None`` matrices when the frame
    predicted no SRoIs (the stream then plans nothing).

    ``variants``/``latency_model`` override the pod-level defaults for
    MIXED-TASK pods (``repro.serving.tasks``): the stream's matrices
    are shaped by ITS task's ladder and priced on ITS task's latency
    curve, while the solver still couples every stream under one
    capacity envelope over the union ladder.  ``None`` (the default)
    means "the shared pod ladder" — the single-task path, bit-identical
    to the pre-task-registry solver.
    """

    acc: np.ndarray | None
    d_pre: np.ndarray | None
    d_inf: np.ndarray | None
    budget: float
    variants: tuple | None = None
    latency_model: object | None = None


@dataclasses.dataclass(frozen=True)
class VariantPrice:
    """Coupled repricing terms of one variant for one stream.

    ``coupled_d_inf = (d_inf * factor + extra) * mult`` and
    ``coupled_d_pre = d_pre * pre_factor`` — identity
    (1.0, 0.0, 1.0, 1.0) exactly when the stream has no co-streams and
    the group is idle, which is what pins the degenerate cases.
    """

    factor: float  # batching amortization (<= 1: Q(n) <= n * Q(1))
    extra: float   # co-stream queue wait of the variant's group, seconds
    mult: float    # observed-utilisation congestion inflation (>= 1)
    # mobile-side d_pre amortization: projection/encode also batch when
    # co-streams share the variant (``pre_amortization``'s shallower
    # curve); == 1.0 EXACTLY at b=1, the identity pin that keeps
    # uncoupled d_pre pricing byte-identical
    pre_factor: float = 1.0

    def apply(self, d_inf: float) -> float:
        return (d_inf * self.factor + self.extra) * self.mult

    def apply_pre(self, d_pre: float) -> float:
        return d_pre * self.pre_factor


@dataclasses.dataclass
class PodSolution:
    plans: list            # allocation.Plan | None, one per stream
    rounds: int            # fixed-point rounds run (0 = short-circuit)
    converged: bool        # choices stabilised before the round cap
    counts: dict           # final per-variant request counts
    coupled: bool          # False when a degenerate pod short-circuited
    tick_cap: float        # capacity envelope (uncoupled projected tick)
    projected_tick: float  # projected tick of the returned plans
    # per replica group, the projected chunked-drain seconds of the
    # returned plans (projected_tick is its max).  Exported so the
    # serving runtime's drain policies price admission/carry-over from
    # the SAME curve as the envelope instead of recomputing it
    # (ROADMAP: "share projected_tick when they land").
    projected_load: dict = dataclasses.field(default_factory=dict)


def _plan_counts(plan, variants) -> dict[str, int]:
    out = {v.name: 0 for v in variants}
    if plan is not None:
        for i in plan.models:
            if i > 0:
                out[variants[i - 1].name] += 1
    return out


def _total_counts(plans, variants, problems=None) -> dict[str, int]:
    """Joint per-variant counts.  ``variants`` is the (union) key
    space; with ``problems``, each plan's model indices resolve through
    its stream's OWN ladder (mixed-task pods)."""
    out = {v.name: 0 for v in variants}
    for s, plan in enumerate(plans):
        svars = variants
        if problems is not None and problems[s].variants is not None:
            svars = problems[s].variants
        for name, c in _plan_counts(plan, svars).items():
            out[name] = out.get(name, 0) + c
    return out


def _union_ladder(problems, variants, latency_model):
    """The pod's union ladder: the shared base ladder first (in its
    given order — the float-sum order every single-task projection
    already uses), then per-stream override extras in first-seen
    order.  Returns ``(union, lat_by_name)``; base variants price on
    the base latency model, extras on their stream's override.
    """
    union = list(variants)
    seen = {v.name for v in variants}
    lat_by = {v.name: latency_model for v in variants}
    for p in problems:
        if p.variants is None:
            continue
        lat = p.latency_model if p.latency_model is not None \
            else latency_model
        for v in p.variants:
            if v.name not in seen:
                seen.add(v.name)
                union.append(v)
                lat_by[v.name] = lat
    return union, lat_by


def _group_of(placement, name):
    """(group index, n_devices) of a variant; the placement-less pod is
    one implicit single-device group (every dispatch serialises)."""
    if placement is None:
        return 0, 1
    g = placement.group_for(name)
    return g.index, g.n_devices


def projected_group_load(counts: dict, variants: Sequence, latency_model,
                         buckets: ShapeBuckets, placement=None,
                         latency_models: dict | None = None
                         ) -> dict[int, float]:
    """Per replica group, the chunked drain seconds of serving
    ``counts`` requests/variant (``variant_queue_cost`` — the same
    curve ``tick_schedule_delay`` prices).  The shared load projection:
    :func:`projected_tick` takes its max for the capacity envelope, and
    the serving runtime's drain policies consume it for carry-over
    decisions (``solve_pod`` exports it per tick so neither recomputes
    the other's numbers).  ``latency_models`` optionally maps variant
    name -> that variant's task latency model (mixed-task pods); absent
    entries fall back to ``latency_model``.
    """
    lat_by = latency_models or {}
    group_load: dict[int, float] = {}
    for v in variants:
        gidx, n_dev = _group_of(placement, v.name)
        group_load[gidx] = group_load.get(gidx, 0.0) + \
            lat_by.get(v.name, latency_model).variant_queue_cost(
                v, counts.get(v.name, 0), buckets, n_dev)
    return group_load


def projected_tick(counts: dict, variants: Sequence, latency_model,
                   buckets: ShapeBuckets, placement=None,
                   latency_models: dict | None = None) -> float:
    """Device-aware tick cost of serving ``counts`` requests/variant.

    Max over replica groups of :func:`projected_group_load` — the
    projection of what ``PodServer`` will charge via
    ``tick_inference_delay`` when these counts hit the queues, so the
    solver's capacity envelope and the served tick can never disagree
    on the curve.
    """
    return max(projected_group_load(counts, variants, latency_model,
                                    buckets, placement,
                                    latency_models).values(),
               default=0.0)


def stream_prices(
    variants: Sequence,
    co_counts: dict[str, int],
    latency_model,
    buckets: ShapeBuckets,
    placement=None,
    group_utilisation: dict | None = None,
    queue_weight: float = DEFAULT_QUEUE_WEIGHT,
    util_weight: float = DEFAULT_UTIL_WEIGHT,
    all_variants: Sequence | None = None,
    latency_models: dict | None = None,
) -> dict[str, VariantPrice]:
    """One stream's coupled repricing terms, per variant.

    ``co_counts``: this tick's demand for each variant from the OTHER
    streams.  Three coupling terms, all derived from the latency
    model's batched curve (``pod_amortization`` /
    ``variant_queue_cost``) — the same curve ``tick_schedule_delay``
    prices, so the allocator can never believe in a cost the tick
    model would not charge:

      * ``factor`` — the batching discount: per-request share of the
        variant's chunked tick drain (with this request joining the
        co-stream batch), relative to the solo b=1 forward;
      * ``extra``  — queue depth: the co-stream load of OTHER variants
        serialising ahead in the same replica group, in seconds;
      * ``mult``   — congestion: the group's observed cross-tick busy
        fraction (``ServeStats.group_utilisation``), steering demand
        toward idle groups.

    A stream with no co-streams and an idle group gets the exact
    identity (1.0, 0.0, 1.0, 1.0): coupling can never perturb a lone
    stream's plan.

    ``all_variants`` widens the queue-depth accumulation past the
    stream's OWN ladder (``variants``, the output keys) to the pod's
    union ladder, so a mixed-task stream pays for the OTHER task's
    load serialising in its replica groups; ``latency_models`` maps
    union variant names to their task's latency model.  Both default
    to the single-task identity.
    """
    lat_by = latency_models or {}
    pool = variants if all_variants is None else all_variants
    co = {v.name: max(0, int(round(co_counts.get(v.name, 0))))
          for v in pool}
    # co-stream queue depth per group, in device-busy seconds
    group_load: dict[int, float] = {}
    cost: dict[str, float] = {}
    for v in pool:
        gidx, n_dev = _group_of(placement, v.name)
        cost[v.name] = lat_by.get(v.name, latency_model).variant_queue_cost(
            v, co[v.name], buckets, n_dev)
        group_load[gidx] = group_load.get(gidx, 0.0) + cost[v.name]
    out: dict[str, VariantPrice] = {}
    for v in variants:
        gidx, n_dev = _group_of(placement, v.name)
        lm = lat_by.get(v.name, latency_model)
        factor = lm.pod_amortization(v, 1 + co[v.name], buckets, n_dev)
        pre_fn = getattr(lm, "pre_amortization", None)
        wait = group_load[gidx] - cost[v.name]  # other variants' queue
        util = (group_utilisation or {}).get(gidx, 0.0)
        out[v.name] = VariantPrice(
            factor=factor,
            extra=queue_weight * wait,
            mult=1.0 + util_weight * util,
            pre_factor=(pre_fn(v, 1 + co[v.name])
                        if pre_fn is not None else 1.0),
        )
    return out


def price_hook(prices: dict[str, VariantPrice],
               variants: Sequence) -> allocation.CostHook:
    """The :data:`~repro.core.allocation.CostHook` carrying one
    stream's coupled prices (skip row 0 untouched)."""
    by_row = [None] + [prices[v.name] for v in variants]

    def hook(i: int, j: int, d_pre: float, d_inf: float):
        del j
        if i == 0:
            return d_pre, d_inf
        return by_row[i].apply_pre(d_pre), by_row[i].apply(d_inf)

    return hook


def best_response(
    problems: Sequence[StreamProblem],
    plans: Sequence,
    variants: Sequence,
    latency_model,
    buckets: ShapeBuckets,
    placement=None,
    group_utilisation: dict | None = None,
    queue_weight: float = DEFAULT_QUEUE_WEIGHT,
    util_weight: float = DEFAULT_UTIL_WEIGHT,
    tick_cap: float | None = None,
    max_switches: int | None = None,
):
    """One Gauss–Seidel sweep: streams re-plan in index order against
    the live pod counts.  Returns ``(new_plans, changed)``.

    A stream switches away from its incumbent only when the coupled
    candidate is STRICTLY more valuable (or the incumbent went
    infeasible under the current prices) AND — with a ``tick_cap`` —
    the switch keeps the pod's :func:`projected_tick` within the
    envelope.  A kept incumbent is re-priced so its ``t_done`` reflects
    the current coupled costs.  ``max_switches`` bounds how many
    streams may switch this sweep (the damping knob).  Deterministic:
    equal inputs produce equal outputs, which is what makes a
    convergent :func:`solve_pod` run a checkable fixed point.
    """
    plans = list(plans)
    union, lat_by = _union_ladder(problems, variants, latency_model)
    counts = _total_counts(plans, union, problems)
    changed = False
    switches = 0
    for s, prob in enumerate(problems):
        old = plans[s]
        if prob.acc is None or prob.acc.shape[1] == 0:
            continue
        svars = prob.variants if prob.variants is not None else variants
        own = _plan_counts(old, svars)
        co = {name: c - own.get(name, 0) for name, c in counts.items()}
        prices = stream_prices(
            svars, co, latency_model, buckets, placement,
            group_utilisation, queue_weight, util_weight,
            all_variants=union, latency_models=lat_by)
        # the materialised hook matrices serve both the knapsack and
        # the incumbent re-pricing below (allocate(d_pre_c, d_inf_c)
        # == allocate(cost_hook=hook) bit-for-bit, without running the
        # hook loop twice)
        d_pre_c, d_inf_c = allocation.apply_cost_hook(
            price_hook(prices, svars), prob.d_pre, prob.d_inf)
        cand = allocation.allocate(prob.acc, d_pre_c, d_inf_c, prob.budget)
        keep = cand is None
        forced = False  # incumbent priced out of its budget
        old_lat = None
        if old is not None:
            old_lat = allocation.plan_latency(old.models, d_pre_c, d_inf_c)
            forced = old_lat > prob.budget + _TOL
            # hysteresis tie-break: switch only on strict improvement
            # (or a budget-infeasible incumbent)
            if not keep and not forced and cand.value <= old.value + _TOL:
                keep = True
        cand_counts = None
        if not keep and (old is None or cand.models != old.models):
            cand_counts = dict(counts)
            for name, c in _plan_counts(cand, svars).items():
                cand_counts[name] += c - own[name]
            if tick_cap is not None and projected_tick(
                    cand_counts, union, latency_model, buckets,
                    placement, latency_models=lat_by) > tick_cap + _TOL:
                # capacity envelope: the upgrade must fit inside the
                # device time the incumbent schedule was already paying
                # for.  A FORCED switch that busts the envelope still
                # keeps the incumbent: its load is already inside the
                # cap, and the over-budget t_done is a per-stream
                # planning estimate, not a pod constraint — the
                # envelope is.
                keep = True
            elif not forced and max_switches is not None and \
                    switches >= max_switches:
                # damping: this sweep's switch budget is spent (never
                # blocks a forced shed)
                keep = True
        if keep:
            # a rejected candidate NEVER falls through to adoption —
            # even for the (currently unreachable) old=None case
            chosen = old if old is None else allocation.Plan(
                old.value,
                float(sum(d_pre_c[i, j] for j, i in enumerate(old.models))),
                old_lat, old.models)
        else:
            chosen = cand
        if ((chosen.models if chosen is not None else None)
                != (old.models if old is not None else None)):
            changed = True
            switches += 1
            counts = cand_counts  # the switch's delta, already applied
        plans[s] = chosen
    return plans, changed


def solve_pod(
    problems: Sequence[StreamProblem],
    variants: Sequence,
    latency_model,
    *,
    buckets: ShapeBuckets | None = None,
    placement=None,
    group_utilisation: dict | None = None,
    max_rounds: int = DEFAULT_MAX_ROUNDS,
    damping: float = DEFAULT_DAMPING,
    queue_weight: float = DEFAULT_QUEUE_WEIGHT,
    util_weight: float = DEFAULT_UTIL_WEIGHT,
    slo_s: float | None = None,
) -> PodSolution:
    """The pod-level fixed point (see the module docstring).

    ``damping`` is the fraction of streams allowed to switch plans per
    sweep (1.0 = all of them); lower values smooth oscillating pods.
    A no-switch sweep is a fixed point at any damping, so convergence
    semantics do not depend on it.

    ``slo_s`` tightens the capacity envelope to the run's SLO target:
    ``T_cap = min(uncoupled projected tick, slo_s)``, so the batching
    discount may upgrade plans only into device time that also fits
    the service objective — not merely into whatever the uncoupled
    schedule happened to cost.  ``None`` (the default) keeps the
    round-0 self-referential envelope bit-identical.  The returned
    ``tick_cap`` is the effective (possibly clamped) envelope;
    ``projected_tick`` always reports the returned plans' projection.
    """
    buckets = buckets or ShapeBuckets()
    union, lat_by = _union_ladder(problems, variants, latency_model)
    plans = [
        allocation.allocate(p.acc, p.d_pre, p.d_inf, p.budget)
        if p.acc is not None and p.acc.shape[1] > 0 else None
        for p in problems]
    counts = _total_counts(plans, union, problems)
    cap_load = projected_group_load(counts, union, latency_model, buckets,
                                    placement, lat_by)
    uncoupled_tick = max(cap_load.values(), default=0.0)
    tick_cap = uncoupled_tick if slo_s is None \
        else min(uncoupled_tick, slo_s)
    if len(problems) <= 1 or len(union) <= 1:
        # one stream has no co-streams to share a batch with; one
        # variant has no cross-variant choice to arbitrate — both keep
        # the calibrated per-stream plans byte-identical.
        return PodSolution(plans, rounds=0, converged=True, counts=counts,
                           coupled=False, tick_cap=tick_cap,
                           projected_tick=uncoupled_tick,
                           projected_load=cap_load)
    max_switches = max(1, math.ceil(damping * len(problems)))
    converged = False
    rounds = 0
    for rounds in range(1, max_rounds + 1):
        plans, changed = best_response(
            problems, plans, variants, latency_model, buckets,
            placement=placement, group_utilisation=group_utilisation,
            queue_weight=queue_weight, util_weight=util_weight,
            tick_cap=tick_cap, max_switches=max_switches)
        if not changed:
            converged = True
            break
    counts = _total_counts(plans, union, problems)
    load = projected_group_load(counts, union, latency_model, buckets,
                                placement, lat_by)
    return PodSolution(
        plans, rounds=rounds, converged=converged, counts=counts,
        coupled=True, tick_cap=tick_cap,
        projected_tick=max(load.values(), default=0.0),
        projected_load=load)


def solve_pod_bruteforce(
    problems: Sequence[StreamProblem],
    variants: Sequence,
    latency_model,
    *,
    buckets: ShapeBuckets | None = None,
    placement=None,
    group_utilisation: dict | None = None,
    tick_cap: float | None = None,
    queue_weight: float = DEFAULT_QUEUE_WEIGHT,
    util_weight: float = DEFAULT_UTIL_WEIGHT,
):
    """Exhaustive joint-allocation oracle for tiny pods (tests only).

    Enumerates every combination of per-stream choice vectors, keeps
    the combinations where EVERY stream's plan is feasible under the
    coupled prices induced by the joint counts (each stream priced
    against the others' demand, exactly like one :func:`best_response`
    step) and — when given — the joint :func:`projected_tick` fits
    ``tick_cap``, and returns ``(plans, total_value)`` of the best one.
    The all-skip assignment is always feasible, so the result is never
    ``None``.  Cost grows as ``(1+V)^(S*R)`` — keep S, V, R tiny.
    """
    import itertools

    buckets = buckets or ShapeBuckets()
    union, lat_by = _union_ladder(problems, variants, latency_model)
    spaces = []
    for p in problems:
        r = p.acc.shape[1] if p.acc is not None else 0
        svars = p.variants if p.variants is not None else variants
        spaces.append(list(itertools.product(
            range(1 + len(svars)), repeat=r)))
    best_plans, best_value = None, -1.0
    for combo in itertools.product(*spaces):
        pseudo = [allocation.Plan(0.0, 0.0, 0.0, models) for models in combo]
        counts = _total_counts(pseudo, union, problems)
        if tick_cap is not None and projected_tick(
                counts, union, latency_model, buckets,
                placement, latency_models=lat_by) > tick_cap + _TOL:
            continue
        plans = []
        total = 0.0
        feasible = True
        for s, (prob, models) in enumerate(zip(problems, combo)):
            if not models:
                plans.append(None)
                continue
            svars = prob.variants if prob.variants is not None else variants
            own = _plan_counts(pseudo[s], svars)
            co = {name: c - own.get(name, 0) for name, c in counts.items()}
            prices = stream_prices(
                svars, co, latency_model, buckets, placement,
                group_utilisation, queue_weight, util_weight,
                all_variants=union, latency_models=lat_by)
            d_pre_c, d_inf_c = allocation.apply_cost_hook(
                price_hook(prices, svars), prob.d_pre, prob.d_inf)
            lat = allocation.plan_latency(models, d_pre_c, d_inf_c)
            if lat > prob.budget + _TOL:
                feasible = False
                break
            value = float(sum(prob.acc[i, j]
                              for j, i in enumerate(models)))
            total += value
            plans.append(allocation.Plan(
                value,
                float(sum(d_pre_c[i, j] for j, i in enumerate(models))),
                lat, models))
        if feasible and total > best_value + _TOL:
            best_plans, best_value = plans, total
    return best_plans, best_value
