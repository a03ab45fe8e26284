"""Event-driven serving runtime: the tick-overlap clock + drain policies.

``PodServer.step`` used to be a tick-barrier monolith: every variant
queue drained fully, the tick paid ``max`` over per-group dispatch sums,
and no stream advanced until the slowest replica group finished.  That
barrier is exactly the serialization the paper's pipeline overlapping
avoids — the edge admits work as capacity frees, not at batch
boundaries.  This module makes the timeline explicit so drain policies
can be composed instead of hard-coded:

  * :class:`GroupClock` — the pod's event clock: ``now`` (the current
    tick's start) plus a monotone ``free_at`` per replica group.  A
    dispatch on group ``g`` launches at ``max(now, free_at(g))`` (groups
    serialise internally, run concurrently across each other) and
    pushes ``free_at(g)`` to its completion — the tick-overlap pricing
    the ROADMAP's async-drain item needed.
  * :class:`DispatchEvent` / :class:`TickTimeline` — one record per
    batched forward with launch/complete stamps.  The timeline
    generalises ``OmniSenseLatencyModel.tick_inference_delay`` to
    overlapping dispatches: with no carry-in its barrier delay is
    bit-identical to the old max-over-group-sums charge
    (:meth:`TickTimeline.barrier_delay`), and with carry-in the
    event-time horizon prices work launched while a group was still
    busy from an earlier tick (``tick_overlap_delay`` on the latency
    model is the same curve in closed form).
  * :class:`SchedulePolicy` — owns the three decisions the monolith
    hard-wired: **admission** (per-stream knapsacks vs the pod-level
    fixed point, the old ``pod_allocate`` flag), **drain ordering**
    (which chunk dispatches first) and **carry-over** (which requests
    wait for the next tick).  ``PodServer.step``/``run`` are thin
    drivers over whatever policy is plugged in.

Shipped policies:

  * :class:`SyncTickPolicy` — the pre-refactor behaviour, bit-identical
    on seeded corpora (sorted-variant drain order, full drain every
    tick, barrier advance; proven by the equivalence tests in
    ``tests/test_runtime.py``).
  * :class:`DeadlineOrderPolicy` — earliest-deadline-first cross-variant
    ordering over the streams' latency budgets, shortest-forward-first
    among equal deadlines.  Same dispatches, same tick makespan, but
    urgent/cheap chunks complete earlier, which is what the event-clock
    E2E percentiles in ``serving_bench --policy`` measure.
  * :class:`AsyncDrainPolicy` — residual sub-bucket chunks carry to the
    next tick while their replica group is still busy (or sits on the
    tick's critical path), merging into fuller batches; the tick
    advances as soon as capacity frees (min over busy groups) instead
    of at the barrier.  Priced end-to-end by the overlap model; on a
    single-group pod the advance degenerates to the barrier over the
    admitted work while carry-over still merges chunks.

All three price from one shared curve: the pod-level allocator's
per-group :func:`repro.serving.pod_allocation.projected_group_load`
(``solve_pod`` exports it per tick; without pod-level allocation the
policies rebuild the same chunked-drain sums from the live queues via
the server's chunk-cost callable), so the capacity envelope and the
drain decisions can never disagree on what a queue costs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

_EPS = 1e-12

# how many ticks a residual request may be carried before the async
# policy must dispatch it (bounds per-request staleness to one tick)
DEFAULT_MAX_CARRY = 1


@dataclasses.dataclass(frozen=True)
class DispatchEvent:
    """One batched forward on the event clock.

    ``launch_s``/``complete_s`` are absolute clock seconds;
    ``emitted_s`` is the latest emission time over the requests the
    dispatch serves, so ``launch_s >= emitted_s`` is the causality
    invariant the property tests pin (no dispatch may launch before its
    inputs exist).  ``carried`` counts the chunk's requests that waited
    at least one tick in the queue (async carry-over).
    """

    variant: str
    b: int
    padded: int
    group: int
    n_devices: int
    cost_s: float
    launch_s: float
    complete_s: float
    emitted_s: float
    tick: int
    carried: int = 0


class GroupClock:
    """Per-replica-group availability on one shared event timeline.

    ``now`` is the current tick's start (monotone — it only advances);
    ``free_at(g)`` is when group ``g``'s last dispatch completes
    (monotone per group: every dispatch launches at
    ``max(now, free_at(g))`` and can only push the horizon out).
    Groups the clock has never seen are free at the clock's start.
    """

    def __init__(self, start: float = 0.0):
        self.start = start
        self.now = start
        self._free_at: dict[int, float] = {}

    def free_at(self, group: int) -> float:
        return self._free_at.get(group, self.start)

    def busy(self, group: int) -> bool:
        """Whether ``group`` is still executing past the current tick
        start (i.e. carrying work over from an earlier tick)."""
        return self.free_at(group) > self.now + _EPS

    def dispatch(self, group: int, cost_s: float) -> tuple[float, float]:
        """Book one dispatch; returns ``(launch_s, complete_s)``."""
        if cost_s < 0:
            raise ValueError(f"dispatch cost must be >= 0, got {cost_s}")
        launch = max(self.now, self.free_at(group))
        complete = launch + cost_s
        self._free_at[group] = complete
        return launch, complete

    def horizon(self) -> float:
        """When the last booked dispatch completes (>= ``now``)."""
        return max(self.now, max(self._free_at.values(), default=self.now))

    def carry(self) -> dict[int, float]:
        """Busy seconds past ``now`` per group still executing (empty
        when every group is free) — the open-loop admission backlog's
        carry-in term."""
        return {g: t - self.now for g, t in self._free_at.items()
                if t > self.now + _EPS}

    def next_free(self) -> float | None:
        """Earliest completion among groups still busy past ``now``
        (``None`` when every group is already free) — the async
        policy's "admit as capacity frees" advance point."""
        busy = [t for t in self._free_at.values() if t > self.now + _EPS]
        return min(busy) if busy else None

    def advance(self, to: float) -> float:
        """Move the tick start forward (never backward)."""
        self.now = max(self.now, to)
        return self.now


class TickTimeline:
    """The event record of one scheduler tick.

    Generalises ``OmniSenseLatencyModel.tick_inference_delay`` to
    overlapping dispatches: :meth:`barrier_delay` reproduces the old
    charge exactly (max over per-group cost sums, carry-in ignored)
    while :meth:`overlap_delay` prices the true event horizon — what
    the tick costs when some groups were still busy at its start.
    """

    def __init__(self, tick: int, start: float):
        self.tick = tick
        self.start = start
        self.events: list[DispatchEvent] = []
        # per-group cost sums in dispatch order: the same accumulation
        # the barrier server used, so barrier_delay is bit-identical
        self.group_costs: dict[int, float] = {}
        self.carry_in: dict[int, float] = {}

    def open_group(self, group: int, free_at: float) -> None:
        """Record a group's carry-in (busy seconds past the tick
        start) the first time the tick touches it."""
        if group not in self.carry_in:
            self.carry_in[group] = max(0.0, free_at - self.start)

    def record(self, event: DispatchEvent) -> None:
        self.events.append(event)
        self.group_costs[event.group] = (
            self.group_costs.get(event.group, 0.0) + event.cost_s)

    def barrier_delay(self, tick_lat=None) -> float:
        """The pre-refactor tick charge: every group starts free at the
        tick boundary, groups run concurrently, dispatches within a
        group serialise — max over per-group sums.  ``tick_lat`` is
        ``OmniSenseLatencyModel.tick_inference_delay`` when the pricing
        latency model provides one (kept so a curve change there cannot
        silently diverge from the runtime's charge)."""
        if tick_lat is not None:
            return tick_lat(self.group_costs.values())
        return max(self.group_costs.values(), default=0.0)

    def overlap_delay(self) -> float:
        """Event-time tick cost: latest completion relative to the tick
        start.  Equals :meth:`barrier_delay` (up to float association)
        when no group carried work in; strictly larger on the group
        that was still busy — the overlap pricing of carried work."""
        return max((e.complete_s for e in self.events),
                   default=self.start) - self.start

    def horizon(self) -> float:
        return max((e.complete_s for e in self.events), default=self.start)


@dataclasses.dataclass(frozen=True)
class DrainOp:
    """One planned dispatch: pop ``take`` queued requests of
    ``variant`` (FIFO) and run them as a single batched forward."""

    variant: str
    take: int


# admission verdicts (AdmissionPolicy.decide return values)
ADMIT = "admit"
DEGRADE = "degrade"
REJECT = "reject"


class AdmissionPolicy:
    """Open-loop admission: what to do with one arriving frame.

    Closed-loop ticks admit everything by construction (the clock only
    advances at pod capacity), so admission is a no-op there.  Under
    arrival-clocked traffic (``PodServer.run_open_loop``) every arrival
    consults the schedule policy's ``admission`` hook BEFORE emission:

      * ``ADMIT`` — emit the stream's full allocator plan;
      * ``DEGRADE`` — re-plan restricted to skip + the P1 variant (the
        cheapest real model), shedding load while keeping the frame;
      * ``REJECT`` — drop the frame entirely (counted, never served).

    ``decide`` sees the pod's projected state in seconds: ``backlog_s``
    (busy carry-in plus queued drain cost, max over replica groups, on
    the server's shared pricing curve), the candidate plan's cost, the
    degraded plan's cost, and the run's SLO target (``None`` when the
    run has no SLO — the default policy admits everything either way).
    """

    name = "admit-all"

    def decide(self, *, backlog_s: float, plan_cost_s: float,
               degraded_cost_s: float, slo_s: float | None) -> str:
        del backlog_s, plan_cost_s, degraded_cost_s, slo_s
        return ADMIT


class SloAdmissionPolicy(AdmissionPolicy):
    """Admit while the projected completion fits the SLO envelope.

    The envelope is ``slo_s * slack``: a frame whose backlog + full
    plan cost fits is admitted untouched; one that fits only with the
    degraded (P1-only) plan is degraded; one that cannot fit even
    degraded is rejected — graceful degradation before load shedding,
    the paper's under-pressure behaviour.  With no SLO configured the
    policy admits everything (same as :class:`AdmissionPolicy`).
    """

    name = "slo"

    def __init__(self, slack: float = 1.0):
        if slack <= 0:
            raise ValueError(f"slack must be > 0, got {slack}")
        self.slack = slack

    def decide(self, *, backlog_s: float, plan_cost_s: float,
               degraded_cost_s: float, slo_s: float | None) -> str:
        if slo_s is None:
            return ADMIT
        limit = slo_s * self.slack
        if backlog_s + plan_cost_s <= limit + _EPS:
            return ADMIT
        if backlog_s + degraded_cost_s <= limit + _EPS:
            return DEGRADE
        return REJECT


ADMISSIONS: dict[str, type[AdmissionPolicy]] = {
    AdmissionPolicy.name: AdmissionPolicy,
    SloAdmissionPolicy.name: SloAdmissionPolicy,
}


def make_admission(spec) -> AdmissionPolicy:
    """Resolve an admission spec: instance passes through, a registered
    name constructs, ``None`` means admit-all."""
    if spec is None:
        return AdmissionPolicy()
    if isinstance(spec, AdmissionPolicy):
        return spec
    try:
        cls = ADMISSIONS[spec]
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown admission policy {spec!r}; choose from "
            f"{sorted(ADMISSIONS)} or pass an AdmissionPolicy instance"
        ) from None
    return cls()


class SchedulePolicy:
    """The serving runtime's decision surface (see module docstring).

    Subclasses override :meth:`plan_drain` (admission order +
    carry-over) and :meth:`close_tick` (when the next tick may start
    and what the finished tick is charged).  ``pod_allocate`` is the
    admission half the old ``PodServer(pod_allocate=True)`` boolean
    controlled: whether each tick's plans come from the pod-level
    fixed point (``repro.serving.pod_allocation.solve_pod``) or from
    per-stream knapsacks.  ``admission`` is the open-loop arrival hook
    (:class:`AdmissionPolicy` instance or registered name; default
    admit-all) consulted by ``PodServer.run_open_loop`` — closed-loop
    ``step``/``run`` never invoke it.
    """

    name = "base"

    def __init__(self, pod_allocate: bool = False, admission=None):
        self.pod_allocate = pod_allocate
        self.admission = make_admission(admission)

    def describe(self) -> dict:
        """The policy's replayable configuration — what the telemetry
        ``run_meta`` records and the replay harness reconstructs
        (subclasses extend with their own knobs, e.g. ``max_carry``)."""
        return {"name": self.name, "pod_allocate": self.pod_allocate,
                "admission": self.admission.name}

    # -- drain -------------------------------------------------------------

    def plan_drain(self, queues, buckets, placement, clock: GroupClock, *,
                   chunk_cost=None, projected_load=None) -> list[DrainOp]:
        """Return the tick's ordered dispatch list.

        ``queues`` is the live :class:`~repro.serving.batching.
        VariantQueues`; ``chunk_cost(variant_name, b)`` prices one
        chunk on the server's curve (marginal overrides included);
        ``projected_load`` is the per-group expected drain seconds of
        this tick's demand — ``solve_pod``'s exported projection under
        pod-level allocation, else recomputed from the queues with the
        same shared helper.  Requests not covered by the returned ops
        stay queued (carry-over) and age by one tick.
        """
        raise NotImplementedError

    # -- clock -------------------------------------------------------------

    def close_tick(self, clock: GroupClock, timeline: TickTimeline,
                   tick_lat=None, overlap_lat=None) -> tuple[float, float]:
        """Return ``(charge_s, next_tick_start)`` for a finished tick.

        ``tick_lat``/``overlap_lat`` are the pricing latency model's
        ``tick_inference_delay``/``tick_overlap_delay`` hooks when it
        provides them.  The base rule is the barrier: the next tick
        starts when every group is free, and the charge is the
        pre-refactor max-over-group-sums (bit-identical via
        :meth:`TickTimeline.barrier_delay`).
        """
        del overlap_lat  # barrier ticks never start with carry-in
        return timeline.barrier_delay(tick_lat), clock.horizon()

    # -- placement ---------------------------------------------------------

    def rebalance_point(self, placement, clock: GroupClock,
                        queues) -> bool:
        """Whether NOW is a placement-rebalance opportunity.

        ``PodServer`` consults this hook wherever it used to call
        ``placement.maybe_rebalance()`` unconditionally (after each
        closed-loop emission wave and each open-loop admission);
        returning ``False`` defers the rebalance check entirely, so a
        policy can pin atomically-moving devices to its own capacity
        boundaries.  The base rule is every emission — bit-identical
        to the pre-hook hard-wired timing (pinned by the sync
        equivalence corpus in ``tests/test_runtime.py``).
        """
        del placement, clock, queues
        return True

    # -- helpers shared by the shipped policies ----------------------------

    @staticmethod
    def _group_index(placement, variant_name: str) -> int:
        if placement is None:
            return 0
        return placement.group_for(variant_name).index

    def _full_drain_ops(self, queues, buckets) -> list[DrainOp]:
        """Sorted-variant full drain — the pre-refactor schedule
        (``VariantQueues.full_drain_ops`` is the single source of the
        chunking; the server validates its buckets match the queues')."""
        del buckets
        return [DrainOp(name, take) for name, take in queues.full_drain_ops()]


class SyncTickPolicy(SchedulePolicy):
    """Bit-identical to the pre-refactor ``PodServer.step``: every
    queue drains fully in sorted-variant order and the next tick waits
    at the barrier for the slowest replica group."""

    name = "sync"

    def plan_drain(self, queues, buckets, placement, clock, *,
                   chunk_cost=None, projected_load=None) -> list[DrainOp]:
        del placement, clock, chunk_cost, projected_load
        return self._full_drain_ops(queues, buckets)


class DeadlineOrderPolicy(SchedulePolicy):
    """Earliest-deadline-first cross-variant dispatch ordering.

    Every queue still drains fully (no carry-over; the tick makespan
    equals sync's), but chunks launch in ``(deadline, cost/b, name)``
    order instead of sorted-variant order: a chunk's deadline is the
    tightest ABSOLUTE due time (emission time + the stream's latency
    budget) among the requests it serves — so staggered arrivals sort
    by when work is actually due and carried requests gain urgency as
    they age — and equal
    deadlines fall back to shortest-forward-first PER REQUEST SERVED
    (weighted SJF — a cheap b=1 forward must not jump a b=8 batch and
    delay eight frames to advance one).  FIFO precedence within a
    variant is kept by giving every chunk the suffix-min of its
    variant's remaining keys: a chunk blocking an urgent chunk sorts
    with the urgent key, so precedence never demotes a deadline.
    Within a replica group urgent/cheap forwards therefore complete
    first, cutting the per-request event-clock E2E when variants
    differ 5x in cost (the ROADMAP cross-variant-ordering item).
    """

    name = "deadline"

    def plan_drain(self, queues, buckets, placement, clock, *,
                   chunk_cost=None, projected_load=None) -> list[DrainOp]:
        del clock, projected_load
        per_variant: dict[str, list[tuple]] = {}
        for name, count in sorted(queues.counts().items()):
            if not count:
                continue
            items = queues.peek(name)
            lo = 0
            for b in buckets.split(count):
                chunk = items[lo:lo + b]
                lo += b
                # EDF orders by ABSOLUTE due time: a request's deadline
                # field is the stream's relative latency budget, so the
                # due time is emission + budget.  (Sorting the bare
                # budget is only equivalent while every emission shares
                # one tick boundary — wrong under staggered arrivals,
                # and it would deny carried/aged requests the urgency
                # their early emission earned.)
                deadline = min((it.emitted_s + it.deadline for it in chunk
                                if it.deadline is not None),
                               default=float("inf"))
                cost = chunk_cost(name, b) if chunk_cost is not None else 0.0
                per_variant.setdefault(name, []).append(
                    ((deadline, cost / b, name), DrainOp(name, b)))
        # a DrainOp pops FIFO, so a variant's chunks must dispatch in
        # their original split order.  A chunk therefore inherits the
        # urgency of everything it BLOCKS: its effective key is the
        # suffix-min of its variant's remaining chunk keys (EDF with
        # precedence).  Effective keys are non-decreasing along each
        # FIFO sequence by construction, so one stable sort yields a
        # global deadline order that never inverts a variant's chunks
        # — and never lets a lax early chunk squat on the slot a tight
        # later chunk of the same variant earned.
        keyed = []
        for chunks in per_variant.values():
            keys = [key for key, _ in chunks]
            for i in range(len(keys) - 2, -1, -1):
                keys[i] = min(keys[i], keys[i + 1])
            keyed.extend(zip(keys, (op for _, op in chunks)))
        keyed.sort(key=lambda kv: kv[0])
        return [op for _, op in keyed]


class AsyncDrainPolicy(SchedulePolicy):
    """Residual sub-bucket chunks carry over; the tick advances as
    capacity frees.

    Drain order follows sync (sorted variants), but a variant's final
    chunk is withheld when it under-fills the top batch bucket AND its
    replica group either (a) is still busy executing an earlier tick's
    work, or (b) sits on this tick's critical path (its carry-in plus
    projected drain load — the shared
    :func:`~repro.serving.pod_allocation.projected_group_load` curve —
    is the pod max, so shedding its residual shortens the tick).
    Carried requests age by one tick and are dispatched once any of
    them reaches ``max_carry`` ticks waited, bounding staleness.

    Carry-over is additionally DEADLINE-AWARE: a residual chunk is
    withheld only while the merged batch it would join still meets the
    tightest ABSOLUTE due time (emission + latency budget) among the
    withheld requests — the carried chunk cannot complete before the
    group's expected drain horizon plus its own forward, so when that
    projection busts a member's deadline the chunk dispatches NOW
    instead.  This bounds the event-E2E tail that pure
    batch-efficiency carry paid (the ROADMAP deadline-aware-carry
    follow-on); requests without deadlines are always carry-eligible.

    :meth:`close_tick` advances to the earliest busy-group completion
    (``GroupClock.next_free``) instead of the barrier and charges the
    elapsed event time, so the mean tick is the true interleaved
    makespan over ticks; ``PodServer.flush`` settles the tail.  On a
    single-group pod the advance rule degenerates to the barrier over
    the ADMITTED work (nothing overlaps), but residual carry-over
    still merges sub-bucket chunks into fuller batches.
    """

    name = "async"

    def __init__(self, pod_allocate: bool = False,
                 max_carry: int = DEFAULT_MAX_CARRY, admission=None):
        super().__init__(pod_allocate, admission)
        if max_carry < 1:
            raise ValueError(f"max_carry must be >= 1, got {max_carry}")
        self.max_carry = max_carry

    def describe(self) -> dict:
        return {**super().describe(), "max_carry": self.max_carry}

    def plan_drain(self, queues, buckets, placement, clock, *,
                   chunk_cost=None, projected_load=None) -> list[DrainOp]:
        counts = queues.counts()
        load = self._group_load(queues, buckets, placement, chunk_cost,
                                projected_load)
        expected = {g: max(0.0, clock.free_at(g) - clock.now) + s
                    for g, s in load.items()}
        critical = max(expected.values(), default=0.0)
        ops = []
        for name in sorted(counts):
            count = counts[name]
            if not count:
                continue
            chunks = buckets.split(count)
            g = self._group_index(placement, name)
            if (chunks[-1] < buckets.max_batch
                    and self._may_carry(queues.peek(name), chunks[-1])
                    and self._deadline_allows(
                        queues.peek(name), chunks[-1], name, g,
                        clock, expected, chunk_cost)
                    and (clock.busy(g)
                         or expected.get(g, 0.0) >= critical - _EPS)):
                chunks = chunks[:-1]
            ops.extend(DrainOp(name, b) for b in chunks)
        return ops

    def _may_carry(self, items: Sequence, residual: int) -> bool:
        """The residual chunk is the queue's newest ``residual`` items;
        carrying is allowed only while all of them are fresher than
        ``max_carry`` ticks (so no request waits unboundedly)."""
        return all(it.age < self.max_carry for it in items[-residual:])

    def _deadline_allows(self, items: Sequence, residual: int, name: str,
                         group: int, clock, expected, chunk_cost) -> bool:
        """Carry only while the merged batch still meets the tightest
        withheld member's absolute due time.

        A carried chunk cannot complete before the group's expected
        drain horizon (carry-in plus this tick's projected load, which
        already prices the residual itself) plus the merged forward it
        joins next tick — lower-bounded by the residual's own chunk
        cost.  When that projection busts ``emitted_s + deadline`` for
        any withheld request, the chunk must dispatch now.
        """
        due = min((it.emitted_s + it.deadline for it in items[-residual:]
                   if it.deadline is not None), default=math.inf)
        if due == math.inf:
            return True
        cost = chunk_cost(name, residual) if chunk_cost is not None else 0.0
        eta = clock.now + expected.get(group, 0.0) + cost
        return eta <= due + _EPS

    def _group_load(self, queues, buckets, placement, chunk_cost,
                    projected_load) -> dict[int, float]:
        """Per-group expected drain seconds of the queued demand.

        With the pod-level allocator's exported projection
        (``solve_pod`` already priced this tick's EMISSIONS on the
        shared curve) the policy consumes it and only adds the
        requests an earlier tick carried over — the projection cannot
        know about those, and ignoring them would misplace the
        critical path right after a carry.  Without a projection the
        whole chunked-drain sum is rebuilt from the live queues on the
        server's chunk-cost curve.
        """
        if chunk_cost is None:
            return dict(projected_load or {})
        load: dict[int, float] = dict(projected_load or {})
        for name, count in queues.counts().items():
            if not count:
                continue
            n = count if projected_load is None else \
                sum(1 for it in queues.peek(name) if it.age > 0)
            if not n:
                continue
            g = self._group_index(placement, name)
            load[g] = load.get(g, 0.0) + sum(
                chunk_cost(name, b) for b in buckets.split(n))
        return load

    def close_tick(self, clock, timeline, tick_lat=None, overlap_lat=None):
        del tick_lat, overlap_lat  # the event clock IS the async price
        nxt = clock.next_free()
        if nxt is None:
            nxt = timeline.horizon()
        return max(0.0, nxt - timeline.start), nxt

    def rebalance_point(self, placement, clock, queues) -> bool:
        """Rebalance only at capacity boundaries: while any replica
        group is still executing carried work past the tick start,
        moving devices would invalidate the in-flight dispatch pricing
        the carry decision was made against — wait until every group is
        free (the same advance point :meth:`close_tick` targets)."""
        del placement, queues
        return clock.next_free() is None


POLICIES: dict[str, type[SchedulePolicy]] = {
    SyncTickPolicy.name: SyncTickPolicy,
    DeadlineOrderPolicy.name: DeadlineOrderPolicy,
    AsyncDrainPolicy.name: AsyncDrainPolicy,
}


def make_policy(spec, pod_allocate: bool = False,
                admission=None) -> SchedulePolicy:
    """Resolve a policy spec: an instance passes through (its own
    ``pod_allocate``/``admission`` win), a name constructs the
    registered class."""
    if isinstance(spec, SchedulePolicy):
        return spec
    try:
        cls = POLICIES[spec]
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown scheduling policy {spec!r}; choose from "
            f"{sorted(POLICIES)} or pass a SchedulePolicy instance"
        ) from None
    return cls(pod_allocate=pod_allocate, admission=admission)
