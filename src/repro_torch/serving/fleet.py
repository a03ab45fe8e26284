"""Fleet tier: multi-pod stream routing + elastic scaling (port of
``repro.serving.fleet``, plain Python and NumPy, copied so that fleet
runs record and replay bit-identically across the two packages).

One :class:`~repro_torch.serving.server.PodServer` solves one edge pod; the
ROADMAP's north star is heavy traffic from millions of users, which
means MANY pods behind a router.  This module is that layer:

  * :class:`FleetServer` — owns N pods and drives the same open-loop
    phases a single pod runs (``open_loop_begin`` /
    ``serve_open_batch`` / ``open_loop_end``), with a
    :class:`RoutingPolicy` splitting the global arrival stream per pod.
    Every pod sees the shared ``loops``/``backends`` lists (global
    stream indices), so a stream's per-frame state — detection
    history, discovery, exploration cadence — migrates implicitly when
    its arrivals start landing on another pod.
  * :class:`LeastLoadedRouting` — sticky balance: a new stream lands on
    the active pod with the fewest assigned streams and stays there;
    scale events mark the overflow for lazy rebalance.
  * :class:`AffinityRouting` — consistent hashing on a content/variant
    affinity key (sha1 ring, ``vnodes`` virtual nodes per pod): streams
    sharing a key co-locate, so their same-variant requests merge into
    fuller batches — the fleet-level echo of variant batching.  Scale
    events rebuild the ring and only the streams whose arc moved
    migrate.
  * :class:`ElasticController` — grows/shrinks the active pod set on
    SUSTAINED SLO pressure (shed + missed + violated over offered, per
    control interval), heartbeating each pod's pressure into
    ``distributed/elastic.py``'s :class:`~repro_torch.distributed.elastic.
    HealthTracker`; a retiring pod is DRAINED first (its queued and
    in-flight frames finish on it — nothing is dropped mid-flight) and
    its streams re-route on their next arrival.

A stream never migrates while its newest frame is still in flight on
its current pod: the depth-1 camera buffer (``missed`` accounting)
lives there, and moving mid-frame would double-serve or drop it.  All
routing/scaling state advances only on event-clock arrival times and
seeded identifiers, so fleet runs record and replay bit-identically
(``route``/``scale`` telemetry events; the replay-determinism lane
drives a 2-pod corpus).

Conservation, fleet-wide: every global arrival is routed to exactly
one pod, so ``len(arrivals) == sum over pods of (admitted + rejected
+ missed)`` — the per-pod law lifted through the router.
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
from typing import Callable, Sequence

import numpy as np

from repro_torch.distributed.elastic import HealthTracker
from repro_torch.serving.server import PodServer, ServeStats
from repro_torch.serving.telemetry import TelemetrySink


def _ring_hash(label: str) -> int:
    """Position of ``label`` on the consistent-hash ring.  sha1, not
    Python ``hash()``: stable across processes (no PYTHONHASHSEED
    lottery), which the replay-determinism contract requires."""
    return int.from_bytes(hashlib.sha1(label.encode()).digest()[:8], "big")


def default_affinity_key(stream: int) -> str:
    """Content-class affinity key matching the synthetic corpora: the
    corpora vary scene density as ``30 + 5 * (stream % 4)`` objects,
    so streams congruent mod 4 plan the same variant mix and batch
    together when co-located."""
    return f"c{stream % 4}"


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


class RoutingPolicy:
    """Stream -> pod binding decisions.

    ``assign`` answers where a stream SHOULD run given the fleet's
    current active set; :class:`FleetServer` owns when to ask (new
    stream, retired pod, scale event) and whether the move is safe
    (never mid-flight).  ``sticky`` policies keep an assigned stream
    where it is unless marked for reroute; non-sticky policies are
    re-consulted every arrival and the stream follows their answer.
    """

    name = "base"
    sticky = True

    def assign(self, stream: int, fleet: "FleetServer") -> int:
        raise NotImplementedError

    def on_scale(self, fleet: "FleetServer") -> None:
        """Active pod set changed (grow/shrink)."""

    def wants_reroute(self, stream: int) -> bool:
        """Whether a sticky policy marked ``stream`` for rebalance."""
        return False


class LeastLoadedRouting(RoutingPolicy):
    """Sticky least-loaded: new streams land on the active pod with the
    fewest ASSIGNED streams (ties break to the lower pod id — fully
    deterministic, no wall clock, no RNG).  On a scale event the
    overflow above the balanced share is marked for reroute and moves
    lazily — each marked stream re-assigns on its next SAFE arrival
    (not mid-flight), so a grow drains pressure without a stop-the-
    world reshuffle."""

    name = "least-loaded"
    sticky = True

    def __init__(self):
        self._reroute: set[int] = set()

    def assign(self, stream: int, fleet: "FleetServer") -> int:
        counts = fleet.assigned_counts()
        return min(fleet.active, key=lambda pid: (counts.get(pid, 0), pid))

    def on_scale(self, fleet: "FleetServer") -> None:
        counts = fleet.assigned_counts()
        streams = [s for s, pid in fleet.assignment.items()
                   if pid in counts]
        if not fleet.active:
            return
        target = -(-len(streams) // len(fleet.active))  # balanced share
        self._reroute.clear()
        for pid in fleet.active:
            mine = sorted(s for s, p in fleet.assignment.items()
                          if p == pid)
            # newest streams move first: their history is shortest, so
            # the migration perturbs the least accumulated state
            self._reroute.update(mine[target:])

    def wants_reroute(self, stream: int) -> bool:
        return stream in self._reroute

    def took_reroute(self, stream: int) -> None:
        self._reroute.discard(stream)


class AffinityRouting(RoutingPolicy):
    """Consistent hashing on a content/variant affinity key.

    Each active pod owns ``vnodes`` points on a sha1 ring; a stream
    maps to the first pod point at or after the hash of its affinity
    key.  Streams sharing a key therefore co-locate — their
    same-variant requests merge into fuller batches — and a scale
    event moves only the keys whose owning arc changed (the
    consistent-hashing guarantee), not the whole fleet.
    """

    name = "affinity"
    sticky = False

    def __init__(self, affinity_key: Callable[[int], str] | None = None,
                 vnodes: int = 16):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.affinity_key = affinity_key or default_affinity_key
        self.vnodes = vnodes
        self._ring: list[tuple[int, int]] = []

    def _rebuild(self, fleet: "FleetServer") -> None:
        ring = []
        for pid in fleet.active:
            for v in range(self.vnodes):
                ring.append((_ring_hash(f"pod-{pid}-vnode-{v}"), pid))
        ring.sort()
        self._ring = ring

    def assign(self, stream: int, fleet: "FleetServer") -> int:
        if not self._ring:
            self._rebuild(fleet)
        h = _ring_hash(str(self.affinity_key(stream)))
        idx = bisect.bisect_left(self._ring, (h, -1)) % len(self._ring)
        return self._ring[idx][1]

    def on_scale(self, fleet: "FleetServer") -> None:
        self._rebuild(fleet)


ROUTINGS: dict[str, type[RoutingPolicy]] = {
    LeastLoadedRouting.name: LeastLoadedRouting,
    AffinityRouting.name: AffinityRouting,
}


def make_routing(spec, affinity_key=None) -> RoutingPolicy:
    """Resolve a routing spec: instance passes through, registered name
    constructs (``affinity_key`` applies to the affinity router)."""
    if isinstance(spec, RoutingPolicy):
        return spec
    try:
        cls = ROUTINGS[spec]
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown routing policy {spec!r}; choose from "
            f"{sorted(ROUTINGS)} or pass a RoutingPolicy instance"
        ) from None
    if cls is AffinityRouting:
        return cls(affinity_key=affinity_key)
    return cls()


# ---------------------------------------------------------------------------
# elastic scaling
# ---------------------------------------------------------------------------


class ElasticController:
    """Grow/shrink the active pod set on sustained SLO pressure.

    Pressure over one control interval is the fleet's shed fraction:
    ``(rejected + missed + slo_violations) / max(arrivals, 1)`` deltas
    since the previous interval.  ``sustain`` consecutive hot
    intervals grow by one pod (up to ``max_pods``); ``sustain``
    consecutive cold intervals retire one (down to ``min_pods``) —
    single-step moves with hysteresis, the classic anti-flap shape.

    Every interval each pod heartbeats its OWN pressure into a
    :class:`~repro_torch.distributed.elastic.HealthTracker` (the training
    stack's health machinery, with the serving-side dynamic-membership
    hooks): the shrink victim prefers the emptiest pod, and the
    tracker's straggler view (pressure far above the fleet median) is
    exported for operators via :meth:`stragglers`.
    """

    def __init__(self, min_pods: int = 1, max_pods: int = 8,
                 interval_s: float = 4.0, grow_threshold: float = 0.25,
                 shrink_threshold: float = 0.02, sustain: int = 2,
                 tracker: HealthTracker | None = None):
        if min_pods < 1 or max_pods < min_pods:
            raise ValueError(
                f"need 1 <= min_pods <= max_pods, got {min_pods}/{max_pods}")
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        if sustain < 1:
            raise ValueError(f"sustain must be >= 1, got {sustain}")
        self.min_pods = min_pods
        self.max_pods = max_pods
        self.interval_s = interval_s
        self.grow_threshold = grow_threshold
        self.shrink_threshold = shrink_threshold
        self.sustain = sustain
        self.health = tracker if tracker is not None else \
            HealthTracker(0, beat_interval=2 * interval_s)
        self._next_check = interval_s
        self._prev: dict[int, tuple[int, int, int, int]] = {}
        self._hot = 0
        self._cold = 0

    @staticmethod
    def _counts(stats: ServeStats) -> tuple[int, int, int, int]:
        return (stats.arrivals, stats.rejected, stats.missed,
                stats.slo_violations)

    def stragglers(self) -> list[int]:
        """Pods whose interval pressure ran far above the fleet median
        (the tracker's straggler rule on the heartbeat step times)."""
        return self.health.stragglers()

    def control(self, fleet: "FleetServer", t_s: float) -> None:
        """One control step at event time ``t_s`` (called by the fleet
        before routing each arrival round; cheap no-op between
        interval boundaries)."""
        if t_s < self._next_check:
            return
        # catch up in whole intervals so a traffic lull cannot queue a
        # burst of back-to-back control actions
        while self._next_check <= t_s:
            self._next_check += self.interval_s
        shed = offered = 0
        for pid in list(fleet.active):
            now = self._counts(fleet.pods[pid].stats)
            prev = self._prev.get(pid, (0, 0, 0, 0))
            self._prev[pid] = now
            d_arr = now[0] - prev[0]
            d_shed = sum(now[1:]) - sum(prev[1:])
            offered += d_arr
            shed += d_shed
            self.health.ensure_host(pid, t_s)
            self.health.heartbeat(pid, t_s,
                                  step_time=d_shed / max(d_arr, 1))
        self.health.tick(t_s)
        pressure = shed / max(offered, 1)
        if pressure >= self.grow_threshold:
            self._hot += 1
            self._cold = 0
        elif pressure <= self.shrink_threshold:
            self._cold += 1
            self._hot = 0
        else:
            self._hot = self._cold = 0
        if self._hot >= self.sustain and len(fleet.active) < self.max_pods:
            self._hot = 0
            fleet.grow(t_s, pressure)
        elif (self._cold >= self.sustain
              and len(fleet.active) > self.min_pods):
            self._cold = 0
            victim = self._pick_victim(fleet)
            self.health.remove_host(victim)
            self._prev.pop(victim, None)
            fleet.retire(victim, t_s, pressure)

    @staticmethod
    def _pick_victim(fleet: "FleetServer") -> int:
        """Retire the pod serving the fewest assigned streams (ties
        break to the HIGHEST pod id, so the founding pods persist and
        pod ids stay stable under repeated scale cycles)."""
        counts = fleet.assigned_counts()
        return min(fleet.active,
                   key=lambda pid: (counts.get(pid, 0), -pid))


# ---------------------------------------------------------------------------
# the fleet server
# ---------------------------------------------------------------------------


class _PodSink(TelemetrySink):
    """Tag every record of one pod with its pod id on the shared fleet
    sink.  ``EVENT_FIELDS`` validation tolerates extra keys, so the
    per-pod ``PodServer`` emit sites need no changes."""

    enabled = True

    def __init__(self, base: TelemetrySink, pod: int):
        self._base = base
        self._pod = pod

    def emit(self, event: str, **fields) -> None:
        self._base.emit(event, pod=self._pod, **fields)


@dataclasses.dataclass
class FleetStats:
    """Aggregate serving outcome of one fleet run.

    ``pod_stats`` holds every pod's final :class:`~repro_torch.serving.
    server.ServeStats` in pod-id order — retired pods included, so the
    fleet-wide conservation law covers their frames too.  The summed
    counters mirror the single-pod fields; ``routes``/``migrations``/
    ``scale_ups``/``scale_downs`` are the fleet-only control-plane
    counters the replay fingerprint pins.
    """

    routing: str
    pod_ids: list[int]
    pod_stats: list[ServeStats]
    routes: int = 0
    migrations: int = 0
    scale_ups: int = 0
    scale_downs: int = 0

    def _sum(self, field: str) -> int:
        return sum(getattr(s, field) for s in self.pod_stats)

    @property
    def n_pods(self) -> int:
        return len(self.pod_stats)

    @property
    def arrivals(self) -> int:
        return self._sum("arrivals")

    @property
    def admitted(self) -> int:
        return self._sum("admitted")

    @property
    def degraded(self) -> int:
        return self._sum("degraded")

    @property
    def rejected(self) -> int:
        return self._sum("rejected")

    @property
    def missed(self) -> int:
        return self._sum("missed")

    @property
    def frames(self) -> int:
        return self._sum("frames")

    @property
    def dispatches(self) -> int:
        return self._sum("dispatches")

    @property
    def empty_frames(self) -> int:
        return self._sum("empty_frames")

    @property
    def slo_violations(self) -> int:
        return self._sum("slo_violations")

    @property
    def goodput_frames(self) -> int:
        return sum(s.goodput_frames for s in self.pod_stats)

    @property
    def useful_goodput_frames(self) -> int:
        return sum(s.useful_goodput_frames for s in self.pod_stats)

    @property
    def event_e2e(self) -> list[float]:
        out: list[float] = []
        for s in self.pod_stats:
            out.extend(s.event_e2e)
        return out

    @property
    def mean_queue_delay(self) -> float:
        delays: list[float] = []
        for s in self.pod_stats:
            delays.extend(s.queue_delays)
        return float(np.mean(delays)) if delays else 0.0

    def event_e2e_percentiles(self, qs=(50, 95, 99)) -> dict[int, float]:
        e2e = self.event_e2e
        if not e2e:
            return {q: 0.0 for q in qs}
        arr = np.asarray(e2e)
        return {q: float(np.percentile(arr, q)) for q in qs}


def format_fleet_report(stats: FleetStats, horizon_s: float) -> list[str]:
    """Human-readable fleet summary lines (the fleet sibling of
    ``format_open_loop_report``, shared by the serving launchers)."""
    pct = stats.event_e2e_percentiles()
    per_pod = ", ".join(
        f"p{pid}={s.admitted}adm/{s.rejected}rej"
        for pid, s in zip(stats.pod_ids, stats.pod_stats))
    return [
        f"fleet [{stats.routing} routing, {stats.n_pods} pods]: "
        f"{stats.arrivals} arrivals over {horizon_s:.1f}s -> "
        f"{stats.admitted} admitted ({stats.degraded} degraded), "
        f"{stats.rejected} rejected, {stats.missed} missed",
        f"control plane: {stats.routes} routes "
        f"({stats.migrations} migrations), "
        f"{stats.scale_ups} scale-ups, {stats.scale_downs} scale-downs",
        f"per pod: {per_pod}",
        f"useful goodput {stats.useful_goodput_frames} frames "
        f"({stats.useful_goodput_frames / max(horizon_s, 1e-9):.2f}/s), "
        f"event E2E p50/p95/p99 "
        f"{pct[50]:.3f}/{pct[95]:.3f}/{pct[99]:.3f}s",
    ]


class FleetServer:
    """N pods behind a router, driven on one global arrival clock.

    ``make_pod(pod_id)`` builds one :class:`PodServer`; every pod must
    be constructed over the SAME shared ``loops``/``backends`` lists so
    global stream indices (and each stream's accumulated per-frame
    state) are valid on any pod.  The fleet assigns the pod's
    telemetry sink itself (a :class:`_PodSink` tagging the shared
    sink), so ``make_pod`` should leave telemetry unset.

    ``elastic`` is an optional :class:`ElasticController`; without one
    the active set is fixed at ``n_pods``.  Routing, scaling and
    serving all advance on event-clock arrival times only — a fleet
    run over a seeded corpus is bit-reproducible and replayable.
    """

    def __init__(self, make_pod: Callable[[int], PodServer], n_pods: int,
                 *, routing="least-loaded",
                 elastic: ElasticController | None = None,
                 telemetry: TelemetrySink | None = None,
                 affinity_key: Callable[[int], str] | None = None):
        if n_pods < 1:
            raise ValueError(f"n_pods must be >= 1, got {n_pods}")
        self.make_pod = make_pod
        self.telemetry = telemetry if telemetry is not None \
            else TelemetrySink()
        self.routing = make_routing(routing, affinity_key=affinity_key)
        self.elastic = elastic
        self.pods: dict[int, PodServer] = {}
        self.active: list[int] = []
        self.assignment: dict[int, int] = {}
        self.slo_s: float | None = None
        self.routes = 0
        self.migrations = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self._began = False
        for _ in range(n_pods):
            self._add_pod()

    # -- pod lifecycle -----------------------------------------------------

    def _add_pod(self) -> int:
        pid = len(self.pods)
        pod = self.make_pod(pid)
        if self.telemetry.enabled:
            pod.telemetry = _PodSink(self.telemetry, pid)
        self.pods[pid] = pod
        self.active.append(pid)
        if self._began:
            pod.open_loop_begin(self.slo_s)
        return pid

    def grow(self, t_s: float, pressure: float) -> int:
        """Add one pod to the active set (elastic scale-up)."""
        pid = self._add_pod()
        self.scale_ups += 1
        self.routing.on_scale(self)
        if self.telemetry.enabled:
            self.telemetry.emit("scale", t_s=t_s, action="grow", pod=pid,
                                n_pods=len(self.active), pressure=pressure)
        return pid

    def retire(self, pid: int, t_s: float, pressure: float) -> None:
        """Drain and retire one pod (elastic scale-down): its queued
        and in-flight frames FINISH on it — no stream is dropped
        mid-flight — and its streams re-route on their next arrival
        (their assignment now points at a retired pod)."""
        if pid not in self.active:
            raise ValueError(f"pod {pid} is not active")
        if len(self.active) == 1:
            raise ValueError("cannot retire the last active pod")
        self.active.remove(pid)
        self.pods[pid].open_loop_end()  # the retiring drain
        self.scale_downs += 1
        self.routing.on_scale(self)
        if self.telemetry.enabled:
            self.telemetry.emit("scale", t_s=t_s, action="shrink", pod=pid,
                                n_pods=len(self.active), pressure=pressure)

    def assigned_counts(self) -> dict[int, int]:
        """Streams currently assigned per ACTIVE pod (the least-loaded
        signal; retired-pod assignments are pending migrations and
        count for nobody)."""
        counts = {pid: 0 for pid in self.active}
        for pid in self.assignment.values():
            if pid in counts:
                counts[pid] += 1
        return counts

    # -- routing -----------------------------------------------------------

    def _safe_to_move(self, stream: int, pid: int) -> bool:
        """A stream may only migrate between frames: its newest frame
        on the current pod must have finished (the depth-1 camera
        buffer and ``missed`` accounting live there)."""
        entry = self.pods[pid]._stream_frame.get(stream)
        return entry is None or entry.complete

    def _route(self, arrival) -> int:
        s = arrival.stream
        pid = self.assignment.get(s)
        reason = None
        if pid is None:
            pid = self.routing.assign(s, self)
            reason = "new"
        elif pid not in self.pods or pid not in self.active:
            # the previous pod retired (and drained: nothing of this
            # stream is in flight there) — migrate through the router
            pid = self.routing.assign(s, self)
            reason = "migrate"
        elif self.routing.sticky:
            if (self.routing.wants_reroute(s)
                    and self._safe_to_move(s, pid)):
                new = self.routing.assign(s, self)
                if hasattr(self.routing, "took_reroute"):
                    self.routing.took_reroute(s)
                if new != pid:
                    pid, reason = new, "rebalance"
        else:
            new = self.routing.assign(s, self)
            if new != pid and self._safe_to_move(s, pid):
                pid, reason = new, "rebalance"
        if reason is not None:
            self.assignment[s] = pid
            self.routes += 1
            if reason != "new":
                self.migrations += 1
            if self.telemetry.enabled:
                self.telemetry.emit("route", t_s=arrival.t_s, stream=s,
                                    pod=pid, reason=reason)
        return pid

    # -- serving -----------------------------------------------------------

    def run_open_loop(self, traffic, *, slo_s: float | None = None
                      ) -> FleetStats:
        """Serve one open-loop traffic trace across the fleet.

        The same batched arrival rounds as ``PodServer.run_open_loop``
        — same-instant arrivals share one admission + drain round —
        except each round is split per pod by the router, with the
        elastic controller stepping BEFORE routing (so a pod retiring
        now stops receiving arrivals now, and a pod added now serves
        this very round)."""
        arrivals = traffic.arrivals() if hasattr(traffic, "arrivals") \
            else list(traffic)
        self.slo_s = slo_s
        self._began = True
        for pid in self.active:
            self.pods[pid].open_loop_begin(slo_s)
        i, n = 0, len(arrivals)
        while i < n:
            t = arrivals[i].t_s
            batch = []
            while i < n and arrivals[i].t_s <= t + 1e-12:
                batch.append(arrivals[i])
                i += 1
            if self.elastic is not None:
                self.elastic.control(self, t)
            if slo_s is not None:
                # fleet-global SLO envelope: each pod's fixed point
                # prices this round against the FLEET's residual budget
                # — the SLO minus the worst busy horizon any active pod
                # has already committed past now — instead of a private
                # per-pod envelope.  Pods co-scheduled behind one
                # router share the tail; admitting against the full
                # SLO while a sibling's backlog has spent part of it is
                # exactly the ≥4-pod p99 overshoot this closes.
                worst = max((max(0.0, self.pods[pid].clock.horizon() - t)
                             for pid in self.active), default=0.0)
                env = max(0.0, slo_s - worst)
                for pid in self.active:
                    self.pods[pid].solve_slo_s = env
            per_pod: dict[int, list] = {}
            for a in batch:
                per_pod.setdefault(self._route(a), []).append(a)
            for pid in sorted(per_pod):
                self.pods[pid].serve_open_batch(per_pod[pid])
        for pid in self.active:
            self.pods[pid].open_loop_end()
        return self.fleet_stats()

    def fleet_stats(self) -> FleetStats:
        pod_ids = sorted(self.pods)
        return FleetStats(
            routing=self.routing.name,
            pod_ids=pod_ids,
            pod_stats=[self.pods[pid].stats for pid in pod_ids],
            routes=self.routes,
            migrations=self.migrations,
            scale_ups=self.scale_ups,
            scale_downs=self.scale_downs,
        )


def make_fleet_pods(n_streams: int, *, make_loop, make_backend,
                    pod_server_kwargs: dict | None = None
                    ) -> tuple[Sequence, Sequence, Callable[[int], PodServer]]:
    """Convenience constructor: one shared ``loops``/``backends`` pair and
    a ``make_pod`` factory over them (what :class:`FleetServer`
    requires — every pod must see the same stream lists).

    ``make_loop(stream, backend)`` / ``make_backend(stream)`` build
    the per-stream state once; ``pod_server_kwargs(pod_id)`` (a dict
    or a callable returning one) parameterises each pod — placement
    and policy instances must NOT be shared across pods, so pass a
    callable when using either."""
    backends = [make_backend(s) for s in range(n_streams)]
    loops = [make_loop(s, b) for s, b in enumerate(backends)]

    def make_pod(pod_id: int) -> PodServer:
        kw = pod_server_kwargs or {}
        if callable(kw):
            kw = kw(pod_id)
        return PodServer(loops, backends, **kw)

    return loops, backends, make_pod
