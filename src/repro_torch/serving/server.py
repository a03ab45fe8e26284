"""Pod-scale serving loop: many camera streams multiplexed on one mesh.

The paper's testbed serves ONE stream on one edge GPU.  At pod scale the
same per-frame pipeline (SRoI predict -> allocate -> project -> infer ->
NMS) runs for hundreds of streams, and the interesting systems problem
becomes *variant batching*: PI requests from many streams that chose the
same model variant are batched into one accelerator dispatch.

``PodServer`` drives that loop over the event-clock serving runtime
(``repro.serving.runtime``):

  * each stream runs its own ``OmniSenseLoop`` state (history,
    discovery, allocator) against the shared latency model; per tick
    every loop EMITS its planned inference requests
    (``begin_frame``) instead of executing them inline;
  * the requests park in real per-variant queues
    (``repro.serving.batching.VariantQueues``); a pluggable
    ``SchedulePolicy`` owns admission (per-stream knapsacks vs the
    pod-level fixed point), drain ordering and carry-over, and the
    queues drain into chunks of at most ``max_batch``, each chunk
    zero-padded up to a batch-size bucket and executed as ONE batched
    detector forward (``infer_srois_batched``);
  * every dispatch is booked on the ``GroupClock``: it launches when
    its replica group frees (groups serialise internally, run
    concurrently across each other) and the per-tick ``TickTimeline``
    records launch/complete stamps — the sync policy's tick charge is
    bit-identical to the old barrier model
    (``OmniSenseLatencyModel.tick_inference_delay``), and async
    carry-over is priced by the overlap generalisation;
  * the decoded detections scatter back to their owning frames; a
    frame finishes (``finish_frame``) in the tick its LAST request
    resolves — immediately under the sync barrier, possibly a tick
    later under ``AsyncDrainPolicy``, whose residual sub-bucket
    chunks merge into the next tick's fuller batches;
  * spherical NMS is NOT run per stream: every frame finishing in the
    tick defers suppression, the raw detections are padded into one
    ``(B, N, 4)`` stack, and a single ``sph_nms_batch`` dispatch
    suppresses all rows at once;
  * with a ``VariantPlacement`` (``repro.serving.placement``), each
    variant's forward routes to its own replica group — sharded over
    the group's ``data`` axis and launched before any result is
    resolved, so V variants execute concurrently on disjoint device
    groups.

This is the runnable stand-in for the 256-chip serving mesh (the
dry-run proves the detector steps compile on that mesh; this loop
proves the control plane sustains multi-stream operation).

The port departs from the reference in two places:

  * ``step`` hands the tick's frames to every backend that has a
    ``stage_frames`` hook before emission, and calls its
    ``release_frames`` when the tick ends: ``TorchDetectorBackend``
    uploads each distinct frame once a tick, from pinned memory, behind
    the host's SRoI prediction and allocation, and drops the device
    copies with the tick;
  * ``_suppress_tick`` pads the NMS rows to the ladder when the auto
    backend is the card's (``nms_auto_backend`` answers ``"cuda"``
    where the reference's answers ``"device"``), so the kernels see the
    row shapes the reference's device path sees.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

from repro_torch import tracing
from repro_torch.core import allocation
from repro_torch.core.omnisense import OmniSenseLoop
from repro_torch.core.sphere import (IncrementalNms, nms_auto_backend,
                                     pad_detection_rows, sph_nms_batch)
from repro_torch.serving.batching import (QueuedRequest, ShapeBuckets,
                                          VariantQueues)
from repro_torch.serving.runtime import (DEGRADE, REJECT, DispatchEvent,
                                         GroupClock, SyncTickPolicy,
                                         TickTimeline, make_policy)
from repro_torch.serving.telemetry import (SCHEMA_VERSION, TelemetrySink,
                                           detections_digest)


@dataclasses.dataclass
class ServeStats:
    frames: int = 0
    ticks: int = 0
    total_detections: int = 0
    sum_e2e: float = 0.0
    sum_overhead: float = 0.0
    batch_sizes: list = dataclasses.field(default_factory=list)
    # batched-dispatch accounting (one entry of work per tick)
    dispatches: int = 0
    sum_batched_inf_s: float = 0.0      # aggregate device-busy seconds
    sum_per_request_inf_s: float = 0.0  # what B per-request forwards would
    # device-aware tick accounting: replica groups run concurrently, so
    # the tick pays max-over-groups (sync barrier) or the event-clock
    # elapsed time (async overlap) — the policy's close_tick rule
    sum_tick_inf_s: float = 0.0
    group_busy_s: dict = dataclasses.field(default_factory=dict)
    # device count per group index as last seen at dispatch time, so
    # utilisation reports label busy seconds with the partition that
    # actually accrued them (rebalances can change a group's width)
    group_devices: dict = dataclasses.field(default_factory=dict)
    # summed allocator plan values (the paper's objective — the pod
    # bench's accuracy proxy, comparable coupled vs uncoupled because
    # values come from the acc matrices, never from prices)
    sum_plan_value: float = 0.0
    # pod-level allocation accounting (zero when the policy does not
    # pod-allocate)
    pod_rounds: int = 0
    pod_ticks: int = 0
    pod_converged_ticks: int = 0
    # event-clock accounting (repro.serving.runtime)
    policy: str = "sync"
    # per finished frame: completion of its last dispatch minus its
    # emission time on the event clock (the policy-sensitive E2E the
    # bench's policy_grid reports as p50/p95/p99)
    event_e2e: list = dataclasses.field(default_factory=list)
    # UNIQUE requests that waited in a queue past the tick that emitted
    # them (async carry-over reach; 0 under sync/deadline).  A request
    # counts once no matter how many ticks it waits — the old counter
    # snapshotted the whole queue every tick, so one request carried k
    # ticks counted k times.
    carried_requests: int = 0
    # request-ticks spent waiting (the old per-tick queue-snapshot sum:
    # carry-over VOLUME, still useful as a backlog-pressure integral)
    carry_tick_slots: int = 0
    # open-loop traffic accounting (all zero under closed-loop run():
    # ticks admit everything and no SLO is configured)
    slo_s: float | None = None
    admission: str = "admit-all"
    arrivals: int = 0       # frames the traffic offered
    admitted: int = 0       # emitted with a plan (degraded included)
    degraded: int = 0       # admitted but forced to skip/P1
    rejected: int = 0       # shed by the admission policy
    missed: int = 0         # superseded in the depth-1 camera buffer
    empty_frames: int = 0   # admitted with no requests (nothing planned)
    slo_violations: int = 0  # finished frames with event E2E > slo_s
    # per dispatched request: launch minus emission on the event clock
    # (pure queueing delay, before the forward itself runs)
    queue_delays: list = dataclasses.field(default_factory=list)
    # per-task accounting (keys = AnalyticsTask names; a bare detection
    # pod records everything under "detection").  The open-loop
    # conservation invariant holds PER TASK:
    #   arrivals_by_task[t] == admitted + rejected + missed (each [t])
    arrivals_by_task: dict = dataclasses.field(default_factory=dict)
    admitted_by_task: dict = dataclasses.field(default_factory=dict)
    degraded_by_task: dict = dataclasses.field(default_factory=dict)
    rejected_by_task: dict = dataclasses.field(default_factory=dict)
    missed_by_task: dict = dataclasses.field(default_factory=dict)
    frames_by_task: dict = dataclasses.field(default_factory=dict)
    plan_value_by_task: dict = dataclasses.field(default_factory=dict)

    @property
    def mean_e2e(self) -> float:
        return self.sum_e2e / max(self.frames, 1)

    @property
    def goodput_frames(self) -> int:
        """Frames that finished within the SLO (all finished frames
        when no SLO is configured)."""
        return self.frames - self.slo_violations

    @property
    def useful_goodput_frames(self) -> int:
        """Within-SLO frames that did real inference work.

        An admitted frame with an empty plan completes instantly
        (event E2E 0) and so always lands inside the SLO — but it
        delivered no detections.  Under congestion collapse a starved
        predictor plans nothing for most frames, so raw
        :attr:`goodput_frames` REWARDS the collapse; this is the
        honest metric the bench's open-loop gate compares."""
        return self.goodput_frames - self.empty_frames

    @property
    def mean_queue_delay(self) -> float:
        return float(np.mean(self.queue_delays)) if self.queue_delays else 0.0

    @property
    def accuracy_proxy(self) -> float:
        """Mean allocator plan value per stream-frame."""
        return self.sum_plan_value / max(self.frames, 1)

    @property
    def accuracy_proxy_by_task(self) -> dict:
        """Per-task mean plan value per finished stream-frame — the
        mixed-pod bench's no-collapse signal (each task's proxy is in
        ITS OWN ladder's units; compare same-task across pod mixes,
        never across tasks)."""
        return {t: self.plan_value_by_task.get(t, 0.0) / max(n, 1)
                for t, n in sorted(self.frames_by_task.items())}

    @property
    def mean_tick(self) -> float:
        """Mean per-tick inference seconds (flush charges included in
        the numerator but not the tick count, so async pods pay their
        carried tail instead of hiding it)."""
        return self.sum_tick_inf_s / max(self.ticks, 1)

    @property
    def mean_batch(self) -> float:
        return float(np.mean(self.batch_sizes)) if self.batch_sizes else 0.0

    @property
    def batching_gain(self) -> float:
        """Per-request inference cost over batched cost (>= 1 when
        batching pays; 1.0 when every dispatch had batch 1)."""
        if self.sum_batched_inf_s <= 0:
            return 1.0
        return self.sum_per_request_inf_s / self.sum_batched_inf_s

    @property
    def sharding_gain(self) -> float:
        """Serialised dispatch cost over the device-aware tick cost
        (>= 1; 1.0 on a single-device pod where every tick serialises)."""
        if self.sum_tick_inf_s <= 0:
            return 1.0
        return self.sum_batched_inf_s / self.sum_tick_inf_s

    def group_utilisation(self) -> dict:
        """Per replica group: busy seconds over the pod's tick seconds
        (the idle share is the cost of imbalanced variant load)."""
        if self.sum_tick_inf_s <= 0:
            return {g: 0.0 for g in self.group_busy_s}
        return {g: busy / self.sum_tick_inf_s
                for g, busy in sorted(self.group_busy_s.items())}

    def event_e2e_percentiles(self, qs=(50, 95, 99)) -> dict[int, float]:
        """Event-clock E2E percentiles over the finished frames."""
        if not self.event_e2e:
            return {q: 0.0 for q in qs}
        arr = np.asarray(self.event_e2e)
        return {q: float(np.percentile(arr, q)) for q in qs}


def _bump(counter: dict, task: str, amount=1) -> None:
    """Increment one per-task ServeStats counter dict."""
    counter[task] = counter.get(task, 0) + amount


def format_group_report(stats: ServeStats, placement) -> list[str]:
    """Human-readable replica-group summary lines (shared by the
    serving drivers so the format can't drift between them).  Device
    counts come from dispatch time, not the final partition, so busy
    seconds accrued before a rebalance keep their real group width."""
    util = ", ".join(
        f"g{g}[{stats.group_devices.get(g, '?')}dev]={u:.0%}"
        for g, u in stats.group_utilisation().items())
    return [
        f"replica groups over {placement.n_devices} devices "
        f"[{stats.policy} policy]: "
        f"device-aware tick inference {stats.sum_tick_inf_s:.1f}s "
        f"(sharding gain {stats.sharding_gain:.2f}x, "
        f"{placement.rebalances} rebalances)",
        f"group utilisation: {util}",
    ]


def format_open_loop_report(stats: ServeStats, horizon_s: float) -> list[str]:
    """Human-readable open-loop traffic summary lines (shared by the
    serving drivers so the conservation arithmetic — arrivals =
    admitted + rejected + missed — renders identically everywhere)."""
    pct = stats.event_e2e_percentiles()
    lines = [
        f"open-loop traffic [{stats.admission} admission]: "
        f"{stats.arrivals} arrivals over {horizon_s:.1f}s "
        f"({stats.arrivals / max(horizon_s, 1e-9):.2f} frames/s offered) "
        f"-> {stats.admitted} admitted ({stats.degraded} degraded, "
        f"{stats.empty_frames} empty), "
        f"{stats.rejected} rejected, {stats.missed} missed",
        f"queueing: mean delay {stats.mean_queue_delay * 1e3:.1f}ms, "
        f"event E2E p50/p95/p99 "
        f"{pct[50]:.3f}/{pct[95]:.3f}/{pct[99]:.3f}s",
    ]
    if stats.slo_s is not None:
        useful = stats.useful_goodput_frames
        lines.append(
            f"SLO {stats.slo_s:.2f}s: {useful}/{stats.frames} "
            f"frames served within SLO "
            f"(goodput {useful / max(horizon_s, 1e-9):.2f} "
            f"frames/s, {stats.slo_violations} violations)")
    return lines


def format_pod_allocation_report(stats: ServeStats) -> str:
    """Human-readable pod-level allocation summary (shared by the
    serving drivers, like :func:`format_group_report`, so the format —
    and the accuracy-proxy units — cannot drift between them)."""
    return (f"pod-level allocation: "
            f"{stats.pod_rounds / max(stats.pod_ticks, 1):.1f} "
            f"fixed-point rounds/tick "
            f"({stats.pod_converged_ticks}/{stats.pod_ticks} ticks "
            f"converged), accuracy proxy "
            f"{stats.accuracy_proxy:.3f}/stream-frame")


@dataclasses.dataclass
class _InFlightFrame:
    """A frame emitted but not yet finished (its requests may span
    ticks under a carry-over policy)."""

    loop: OmniSenseLoop
    pending: object               # omnisense.PendingFrame
    emitted_s: float              # event-clock emission time
    done_s: float                 # latest completion among its dispatches
    frame_idx: int | None = None  # stream frame index it was emitted for
    stream: int | None = None     # stream index (diagnostics/open loop)
    slots: dict = dataclasses.field(default_factory=dict)

    @property
    def complete(self) -> bool:
        return len(self.slots) == len(self.pending.requests)


class PodServer:
    """Thin driver over the event-clock serving runtime.

    ``frame_source(stream_idx, frame_idx)`` optionally supplies real
    frame pixels per stream (the real detector path); oracle backends
    sample ground truth and take ``None``.

    ``policy`` is a :class:`repro.serving.runtime.SchedulePolicy`
    instance or registered name (``"sync"``/``"deadline"``/``"async"``)
    and owns admission, drain ordering and carry-over; the default
    ``SyncTickPolicy`` reproduces the pre-runtime tick barrier
    bit-identically.  Pod-level allocation is configured on the policy
    object only.

    ``telemetry`` is a :class:`repro.serving.telemetry.TelemetrySink`
    (default no-op): every arrival, admission verdict, emission,
    dispatch launch/complete, carry, rebalance, policy decision, tick
    close and frame finish emits one structured record — the event log
    the replay harness (``repro.serving.replay``) re-drives.  Records
    carry only deterministic quantities (event-clock seconds, model
    prices, detection digests), never wall-clock time.
    """

    def __init__(self, loops: list[OmniSenseLoop], backends: list,
                 max_batch: int = 8, marginal_batch_cost: float | None = None,
                 buckets: ShapeBuckets | None = None,
                 frame_source: Callable[[int, int], np.ndarray] | None = None,
                 placement=None, policy=None, telemetry=None,
                 incremental_nms: bool = True):
        assert len(loops) == len(backends)
        self.loops = loops
        # the tracer keys each loop's spans by its stream
        for s, loop in enumerate(loops):
            loop.trace_key = s
        self.backends = backends
        self.max_batch = max_batch
        self.policy = make_policy(policy) if policy is not None \
            else SyncTickPolicy()
        self.telemetry = telemetry if telemetry is not None \
            else TelemetrySink()
        # task dimension: each loop serves ONE analytics task (the
        # registry's loop factories stamp ``loop.task``; bare loops
        # default to detection).  Task ladders own disjoint variant-name
        # spaces, so the plain NAME strings that key the queues,
        # placement groups and telemetry already encode (task, variant).
        self.tasks: tuple[str, ...] = tuple(dict.fromkeys(
            self._task(loop) for loop in loops))
        self._variant_task: dict[str, str] = {}
        for loop in loops:
            task = self._task(loop)
            for v in loop.variants:
                prev = self._variant_task.setdefault(v.name, task)
                if prev != task:
                    raise ValueError(
                        f"variant name {v.name!r} is claimed by tasks "
                        f"{prev!r} and {task!r}; task ladders must own "
                        "disjoint name spaces (names key the queues)")
        if self.policy.pod_allocate:
            ladders: dict[str, tuple] = {}
            for loop in loops:
                task = self._task(loop)
                ladder = tuple(v.name for v in loop.variants)
                if ladders.setdefault(task, ladder) != ladder:
                    raise ValueError(
                        "pod-level allocation needs every stream of a "
                        f"task on the same variant ladder; task {task!r} "
                        f"got {ladders[task]} vs {ladder}")
        # repro.serving.placement.VariantPlacement: routes each drained
        # chunk to its variant's replica group and switches the tick
        # model to max-over-groups; None = single-device pod (every
        # dispatch serialises in one implicit group).
        self.placement = placement
        if placement is not None:
            placed = set(placement.variant_names)
            missing = {v.name for loop in loops for v in loop.variants
                       if v.name not in placed}
            if missing:
                raise ValueError(
                    f"placement has no replica group for variants {sorted(missing)}")
        # None = defer to each latency model's batched_inference_delay
        # (the default OmniSenseLatencyModel curve); a float OVERRIDES
        # the curve for every dispatch the server prices.
        self.marginal = marginal_batch_cost
        self.buckets = buckets or ShapeBuckets.for_max_batch(max_batch)
        if self.buckets.max_batch != max_batch:
            raise ValueError(
                f"buckets top out at {self.buckets.max_batch}, "
                f"max_batch is {max_batch}")
        # a drained chunk must be ONE backend dispatch: a backend whose
        # own bucket ladder tops out below the server's would silently
        # split chunks and the priced schedule would diverge from the
        # executed one.
        for b in backends:
            b_buckets = getattr(b, "buckets", None)
            if b_buckets is not None and b_buckets.max_batch < max_batch:
                raise ValueError(
                    f"backend buckets top out at {b_buckets.max_batch} < "
                    f"max_batch {max_batch}; align the backend's "
                    "ShapeBuckets with the server's")
        self.frame_source = frame_source
        self.queues = VariantQueues(self.buckets)
        self.stats = ServeStats(policy=self.policy.name)
        self.clock = GroupClock()
        # per-tick event records (runs in this repo are short; a
        # long-lived deployment would cap/rotate these)
        self.timelines: list[TickTimeline] = []
        self._inflight: list[_InFlightFrame] = []
        self._by_owner: dict[int, _InFlightFrame] = {}
        # the pod-level allocator's per-group load projection for the
        # CURRENT tick (solve_pod exports it; None -> the policy
        # rebuilds it from the live queues on the same curve)
        self._projected_load: dict | None = None
        # the tick-charge curves are POD-level quantities, so they must
        # come from ONE curve no matter which stream's dispatch happens
        # first — resolved once here, and conflicting curves across the
        # streams' latency models are an error instead of a dispatch-
        # order lottery
        self._tick_lat = self._resolve_curve_hook("tick_inference_delay")
        self._overlap_lat = self._resolve_curve_hook("tick_overlap_delay")
        # open-loop state (run_open_loop): the run's SLO target, the
        # busy horizon already charged to sum_tick_inf_s, and each
        # stream's newest in-flight frame (the depth-1 camera buffer)
        self.slo_s: float | None = None
        # the capacity envelope the pod-level fixed point prices
        # against.  Defaults to the pod's own slo_s; the fleet tier
        # overwrites it per arrival round with the FLEET-global
        # residual envelope (slo minus the fleet's worst busy horizon),
        # so co-scheduled pods stop over-admitting against a private
        # budget the shared tail has already spent.
        self.solve_slo_s: float | None = None
        self._open_horizon = 0.0
        self._stream_frame: dict[int, _InFlightFrame] = {}
        # monotone dispatch id joining each telemetry launch/complete
        # record pair across the whole run
        self._dispatch_seq = 0
        # cross-tick incremental NMS: rows whose detections are exactly
        # last tick's reuse last tick's keep-mask instead of paying the
        # (N, N) SphIoU block again (bit-identical by row independence;
        # see repro.core.sphere.IncrementalNms).  Instantiated lazily at
        # the first single-threshold suppression.
        self.incremental_nms = incremental_nms
        self._nms_inc: IncrementalNms | None = None

    @staticmethod
    def _task(loop) -> str:
        """The analytics task a loop serves (registry loop factories
        stamp ``loop.task``; bare loops are detection)."""
        return getattr(loop, "task", "detection")

    def _emit_run_meta(self, mode: str) -> None:
        """One ``run_meta`` telemetry record per run entry point."""
        if not self.telemetry.enabled:
            return
        self.telemetry.emit(
            "run_meta", schema=SCHEMA_VERSION, mode=mode,
            n_streams=len(self.loops), policy=self.policy.describe(),
            max_batch=self.max_batch,
            devices=self.placement.n_devices if self.placement is not None
            else 0,
            variants=list(self._variant_task),
            tasks=list(self.tasks),
            slo_s=self.slo_s)

    def _resolve_curve_hook(self, attr: str):
        """One pod-wide tick-charge hook across the streams' latency
        models.  Models sharing the same underlying function (e.g. many
        instances of one class) agree by construction; models providing
        DIFFERENT curves cannot price one pod tick, so that's an error.
        Streams whose model lacks the hook have no opinion."""
        hooks: dict = {}
        for loop in self.loops:
            h = getattr(loop.latency_model, attr, None)
            if h is not None:
                hooks.setdefault(getattr(h, "__func__", h), h)
        if len(hooks) > 1:
            models = sorted({type(loop.latency_model).__name__
                             for loop in self.loops
                             if getattr(loop.latency_model, attr, None)
                             is not None})
            raise ValueError(
                f"conflicting {attr} curves across the pod's latency "
                f"models {models}; the tick charge is a pod-level "
                "quantity and must come from one curve — share a "
                "latency model (or at least its tick hooks) across "
                "streams")
        return next(iter(hooks.values()), None)

    def _maybe_rebalance(self, t_s: float) -> None:
        """Placement-rebalance check at one observation point.

        The policy owns the TIMING (``SchedulePolicy.rebalance_point``
        — the old hard-wired ``maybe_rebalance()`` call sites asked
        unconditionally, which is exactly what the base hook returns);
        the placement owns the decision and the atomic device swap.
        """
        if not self.policy.rebalance_point(self.placement, self.clock,
                                           self.queues):
            return
        if self.placement.maybe_rebalance() and self.telemetry.enabled:
            self.telemetry.emit("rebalance", t_s=t_s,
                                groups=self.placement.device_counts())

    @property
    def pod_allocate(self) -> bool:
        """Whether admission runs the pod-level fixed point (lives on
        the policy since the runtime refactor)."""
        return self.policy.pod_allocate

    def _price_curve(self, variant, lat, n_dev: int):
        """(curve, single) — the dispatch pricing curve of one variant
        on one latency model, shared by dispatch billing and the
        policies' pre-dispatch chunk estimates so they cannot drift."""
        blat = getattr(lat, "batched_inference_delay", None)
        single = blat(variant, 1) if blat is not None else variant.infer_s

        def curve(n: int) -> float:
            n_eff = -(-n // n_dev)  # largest per-device shard
            if self.marginal is not None:  # explicit override
                return single * (1.0 + (n_eff - 1) * self.marginal)
            shard = getattr(lat, "sharded_inference_delay", None)
            if shard is not None:
                return shard(variant, n, n_dev)
            if blat is not None:
                return blat(variant, n_eff)
            return single * (1.0 + (n_eff - 1) * 0.15)

        return curve, single

    def _dispatch_cost(self, dispatch: dict) -> tuple[float, float]:
        """(batched, per-request-sum) inference seconds of one dispatch.

        A chunk of per-stream *simulation* backends (oracle:
        ``semantic_batch``) models one shared-accelerator forward and
        is priced at the chunk's batch size; with real backends every
        executed backend group is its own forward, so pricing follows
        ``group_sizes`` and cannot overstate batching that never ran.
        A dispatch routed to a multi-device replica group shards its
        batch over the group, so the priced forward is the largest
        per-device shard (``sharded_inference_delay``); the
        per-request comparator stays the single-device sum.
        """
        variant = dispatch["items"][0].request.variant
        lat = dispatch["items"][0].latency_model
        group = dispatch.get("group")
        n_dev = group.n_devices if group is not None else 1
        curve, single = self._price_curve(variant, lat, n_dev)
        b = dispatch["b"]
        if dispatch["semantic"]:
            batched = curve(b)
        else:
            batched = sum(curve(g) for g in dispatch["group_sizes"])
        return batched, single * b

    def _chunk_cost(self, name: str, b: int) -> float:
        """Pre-dispatch estimate of one queued chunk's batched cost
        (the policies' planning signal; the executed dispatch is
        billed by :meth:`_dispatch_cost` on the same curve)."""
        item = self.queues.head(name)
        if item is None:
            return 0.0
        group = self.placement.group_for(name) if self.placement is not None \
            else None
        curve, _ = self._price_curve(
            item.request.variant, item.latency_model,
            group.n_devices if group is not None else 1)
        return curve(b)

    def _pod_plan(self, frames: list) -> list:
        """Coupled emission: collect every stream's planning context,
        solve the pod-level fixed point, emit per the joint plans.

        Coupled prices derive from the FIRST loop's latency model (one
        edge serves the pod, so one batched curve); per-stream base
        matrices still carry each stream's own delivery estimates, and
        the zero-co-stream coupling is the exact identity, so streams
        with private models only ever see pod-relative adjustments."""
        from repro_torch.serving import pod_allocation

        ctxs, ctx_durations = [], []
        for loop, frame in zip(self.loops, frames):
            ctx = loop.frame_context(frame)
            ctx_durations.append(time.perf_counter() - ctx.t0)
            ctxs.append(ctx)
        # a multi-task pod prices the two ladders' cost curves JOINTLY:
        # each stream's problem carries its own (variants, latency
        # model) override and solve_pod unions them onto one capacity
        # envelope.  Single-task pods pass no overrides, keeping the
        # pre-task solve arithmetic bit-identical.
        multi = len(self.tasks) > 1
        problems = [pod_allocation.StreamProblem(
            ctx.acc, ctx.d_pre, ctx.d_inf, ctx.budget,
            variants=tuple(loop.variants) if multi else None,
            latency_model=loop.latency_model if multi else None)
            for loop, ctx in zip(self.loops, ctxs)]
        util = (self.stats.group_utilisation()
                if self.placement is not None and self.stats.sum_tick_inf_s > 0
                else None)
        t_solve = time.perf_counter()
        with tracing.span("emit.allocate", "pod"):
            sol = pod_allocation.solve_pod(
                problems, self.loops[0].variants,
                self.loops[0].latency_model, buckets=self.buckets,
                placement=self.placement, group_utilisation=util)
        solve_share = (time.perf_counter() - t_solve) / len(self.loops)
        self.stats.pod_ticks += 1
        self.stats.pod_rounds += sol.rounds
        self.stats.pod_converged_ticks += int(sol.converged)
        # the solver already projected this tick's per-group load on
        # the shared curve — hand it to the drain policy instead of
        # letting it recompute the same sums from the queues
        self._projected_load = dict(sol.projected_load)
        # re-stamp each context immediately before ITS emission so
        # emit_pending bills the stream its own planning time plus a
        # fair share of the shared solve — never the sequential wall
        # time of the other streams' planning or emission
        out = []
        for loop, ctx, dur, plan in zip(self.loops, ctxs, ctx_durations,
                                        sol.plans):
            ctx.t0 = time.perf_counter() - dur - solve_share
            out.append(loop.emit_pending(ctx, plan))
        return out

    def step(self, frame_idx: int) -> None:
        """Process one frame for every stream (one scheduler tick, the
        tracer's tick ``frame_idx``: ``repro_torch.tracing``)."""
        tracing.begin_tick(frame_idx)
        try:
            with tracing.span("tick"):
                # ---- emission: every loop plans and parks its requests
                # (the pod-allocate path plans all streams jointly
                # first) ----
                frames = []
                for s, backend in enumerate(self.backends):
                    if hasattr(backend, "set_frame"):
                        backend.set_frame(frame_idx)
                    frames.append(self.frame_source(s, frame_idx)
                                  if self.frame_source is not None else None)
                staged = self._stage_frames(frames)
                try:
                    self._step(frame_idx, frames)
                finally:
                    for backend in staged:
                        backend.release_frames()
        finally:
            tracing.end_tick()

    def _stage_frames(self, frames: list) -> list:
        """Hand the tick's frames to each backend that stages them (a
        ``stage_frames`` hook, called only where the backend has one, as
        ``set_frame`` is): its frames upload once, before emission, so
        the copies overlap the host's planning.  Returns the backends
        that staged, whose copies :meth:`step` releases with the tick."""
        by_backend: dict[int, tuple] = {}
        for backend, frame in zip(self.backends, frames):
            if frame is not None and hasattr(backend, "stage_frames"):
                by_backend.setdefault(id(backend), (backend, []))[1].append(
                    frame)
        with tracing.span("stage"):
            for backend, fs in by_backend.values():
                backend.stage_frames(fs)
        return [backend for backend, _ in by_backend.values()]

    def _step(self, frame_idx: int, frames: list) -> None:
        """The tick after the frames are gathered: emission, drain,
        ingestion."""
        self._projected_load = None
        with tracing.span("emit"):
            if self.policy.pod_allocate:
                emitted = self._pod_plan(frames)
            else:
                emitted = [loop.begin_frame(frame)
                           for loop, frame in zip(self.loops, frames)]
            for s, (loop, backend, pending) in enumerate(
                    zip(self.loops, self.backends, emitted)):
                entry = _InFlightFrame(loop=loop, pending=pending,
                                       emitted_s=self.clock.now,
                                       done_s=self.clock.now,
                                       frame_idx=frame_idx, stream=s)
                self._inflight.append(entry)
                self._by_owner[id(pending)] = entry
                task = self._task(loop)
                if pending.plan is not None:
                    self.stats.sum_plan_value += pending.plan.value
                    _bump(self.stats.plan_value_by_task, task,
                          pending.plan.value)
                for req in pending.requests:
                    self.queues.put(QueuedRequest(
                        request=req, owner=pending, backend=backend,
                        latency_model=loop.latency_model,
                        deadline=loop.budget_s, emitted_s=self.clock.now,
                        frame_idx=frame_idx, task=task))
                if self.telemetry.enabled:
                    self.telemetry.emit(
                        "emit", t_s=self.clock.now, stream=s, task=task,
                        frame_idx=frame_idx, n_requests=len(pending.requests),
                        plan_value=pending.plan.value
                        if pending.plan is not None else 0.0,
                        variants=[req.variant.name
                                  for req in pending.requests])

        # ---- placement feedback: fold this tick's variant mix into the
        # popularity EMA and re-balance replica groups if the allocator
        # shifted load (atomic swap: queued requests keep a group).
        # WHEN to rebalance is the policy's call (rebalance_point):
        # sync/deadline check every emission (the pre-hook timing,
        # bit-identical), async only at capacity boundaries ----
        if self.placement is not None:
            counts: dict[str, int] = {}
            for pending in emitted:
                for req in pending.requests:
                    counts[req.variant.name] = counts.get(req.variant.name, 0) + 1
            self.placement.observe(counts)
            self._maybe_rebalance(self.clock.now)

        # ---- drain: the policy picks order and carry-over; every
        # admitted chunk is one batched forward routed to (and sharded
        # over) its variant's replica group ----
        timeline = TickTimeline(len(self.timelines), self.clock.now)
        ops = self.policy.plan_drain(
            self.queues, self.buckets, self.placement, self.clock,
            chunk_cost=self._chunk_cost, projected_load=self._projected_load)
        self._emit_policy_decision(timeline, ops)
        self._execute(ops, timeline, self.policy.close_tick)
        self.stats.ticks += 1
        self.stats.carry_tick_slots += len(self.queues)
        self.stats.carried_requests += self.queues.newly_carried()

        # ---- ingestion: frames whose last request resolved finish now ----
        self._ingest()

    def _emit_policy_decision(self, timeline: TickTimeline, ops) -> None:
        """One ``policy_decision`` record per planned drain (the plan
        as the policy returned it, before execution)."""
        if not self.telemetry.enabled:
            return
        self.telemetry.emit(
            "policy_decision", tick=timeline.tick, t_s=timeline.start,
            policy=self.policy.name,
            ops=[{"variant": op.variant, "take": op.take}
                 if hasattr(op, "variant") else
                 {"variant": op[0], "take": op[1]} for op in ops])

    def _execute(self, ops, timeline: TickTimeline, close) -> None:
        """Dispatch a drain plan, book it on the event clock, charge
        the tick per the policy's close rule."""
        with tracing.span("drain"):
            results, dispatches = self.queues.drain_ops(ops, self.placement)
            for d in dispatches:
                self.stats.dispatches += 1
                self.stats.batch_sizes.append(d["b"])
                batched, per_request = self._dispatch_cost(d)
                self.stats.sum_batched_inf_s += batched
                self.stats.sum_per_request_inf_s += per_request
                group = d.get("group")
                gidx = group.index if group is not None else 0
                n_dev = group.n_devices if group is not None else 1
                timeline.open_group(gidx, self.clock.free_at(gidx))
                launch, complete = self.clock.dispatch(gidx, batched)
                event = DispatchEvent(
                    variant=d["variant"], b=d["b"], padded=d["padded"],
                    group=gidx, n_devices=n_dev, cost_s=batched,
                    launch_s=launch, complete_s=complete,
                    emitted_s=max(it.emitted_s for it in d["items"]),
                    tick=timeline.tick,
                    carried=sum(1 for it in d["items"] if it.age > 0))
                timeline.record(event)
                d["event"] = event
                self.stats.group_busy_s[gidx] = (
                    self.stats.group_busy_s.get(gidx, 0.0) + batched)
                self.stats.group_devices[gidx] = n_dev
                delays = []
                for it in d["items"]:
                    owner = self._by_owner[id(it.owner)]
                    owner.done_s = max(owner.done_s, complete)
                    delays.append(max(0.0, launch - it.emitted_s))
                self.stats.queue_delays.extend(delays)
                if self.telemetry.enabled:
                    self._dispatch_seq += 1
                    self.telemetry.emit(
                        "dispatch_launch", tick=event.tick,
                        dispatch=self._dispatch_seq, variant=event.variant,
                        task=self._variant_task.get(event.variant,
                                                    "detection"),
                        b=event.b, padded=event.padded, group=gidx,
                        n_devices=n_dev, cost_s=batched, launch_s=launch,
                        emitted_s=event.emitted_s, carried=event.carried,
                        queue_delays=delays)
                    self.telemetry.emit(
                        "dispatch_complete", tick=event.tick,
                        dispatch=self._dispatch_seq, variant=event.variant,
                        group=gidx, complete_s=complete, cost_s=batched)
            for item, dets in results:
                self._by_owner[id(item.owner)].slots[item.request.slot] = dets
            self.timelines.append(timeline)
            if self.telemetry.enabled and len(self.queues):
                self.telemetry.emit(
                    "carry", tick=timeline.tick, t_s=self.clock.now,
                    queued={name: c for name, c in self.queues.counts().items()
                            if c},
                    total=len(self.queues))
            charge, next_start = close(self.clock, timeline,
                                       self._tick_lat, self._overlap_lat)
            self.stats.sum_tick_inf_s += charge
            self.clock.advance(next_start)
            if self.telemetry.enabled:
                self.telemetry.emit(
                    "tick_close", tick=timeline.tick, t_s=timeline.start,
                    charge_s=charge, next_start_s=next_start,
                    dispatches=len(timeline.events))

    def _ingest(self) -> None:
        """Finish every in-flight frame whose requests all resolved
        (in emission order, so per-stream history stays in frame
        order), with one batched NMS dispatch across them."""
        with tracing.span("ingest"):
            finishing = [e for e in self._inflight if e.complete]
            if not finishing:
                return
            self._inflight = [e for e in self._inflight if not e.complete]
            plans = []
            for e in finishing:
                del self._by_owner[id(e.pending)]
                request_detections = [e.slots.get(i, [])
                                      for i in range(len(e.pending.requests))]
                # a frame finishing a tick late (carried requests) must run
                # its discovery pass against ITS OWN frame's ground truth,
                # not whatever frame the tick advanced the simulation to
                backend = e.loop.backend
                if e.frame_idx is not None and hasattr(backend, "set_frame"):
                    backend.set_frame(e.frame_idx)
                result = e.loop.finish_frame(e.pending, request_detections,
                                             defer_nms=True)
                plans.append((e.loop, result))

            # one batched spherical-NMS dispatch for every frame that
            # finished this tick (instead of B Python loops)
            with tracing.span("ingest.nms"):
                self.stats.sum_overhead += self._suppress_tick(plans)

            for e, (_, result) in zip(finishing, plans):
                self.stats.frames += 1
                _bump(self.stats.frames_by_task, self._task(e.loop))
                self.stats.total_detections += len(result.detections)
                self.stats.sum_e2e += result.planned_latency
                self.stats.sum_overhead += result.overhead_s
                e2e = max(0.0, e.done_s - e.emitted_s)
                self.stats.event_e2e.append(e2e)
                violated = (self.slo_s is not None
                            and e2e > self.slo_s + 1e-12)
                if violated:
                    self.stats.slo_violations += 1
                if (e.stream is not None
                        and self._stream_frame.get(e.stream) is e):
                    del self._stream_frame[e.stream]
                if self.telemetry.enabled:
                    self.telemetry.emit(
                        "frame_finish", t_s=e.done_s, stream=e.stream,
                        task=self._task(e.loop),
                        frame_idx=e.frame_idx, event_e2e_s=e2e,
                        n_detections=len(result.detections),
                        det_digest=detections_digest(result.detections),
                        slo_violation=violated)

    def _suppress_tick(self, plans: list) -> float:
        """Batched spherical NMS across the tick; returns wall time.

        Frames with detections are padded to a common N and suppressed
        in one ``sph_nms_batch`` call; every loop (including empty ones)
        then gets its keep-mask back via ``finalize_detections`` so the
        per-stream detection feedback matches the inline path exactly.
        Falls back to per-stream single-row calls only if the loops
        disagree on the NMS threshold.
        """
        t0 = time.perf_counter()
        rows = [(loop, res) for loop, res in plans if res.detections]
        thresholds = {loop.nms_threshold for loop, _ in rows}
        keeps: dict[int, np.ndarray] = {}
        if rows and len(thresholds) == 1:
            # bucketed padding bounds the device path's compile shapes:
            # B pins to the stream count, N snaps to the NMS ladder, so
            # a serving lifetime compiles at most len(nms_sizes)
            # programs (pinned by the trace-counter regression test).
            # The host path never compiles, so there padding is skipped
            # instead of wasting O(B*N^2) on masked rows.
            row_dets = [res.detections for _, res in rows]
            n_pad = self.buckets.pad_nms_rows(max(len(d) for d in row_dets))
            # the port's auto backend names the card "cuda" (the
            # reference's "device"): pad exactly where the reference does
            if nms_auto_backend(len(plans), n_pad) == "cuda":
                boxes, scores, mask = pad_detection_rows(
                    row_dets, pad_n=self.buckets.pad_nms_rows,
                    total_rows=len(plans))
            else:
                boxes, scores, mask = pad_detection_rows(row_dets)
            thr = thresholds.pop()
            if self.incremental_nms:
                # per-stream loop identity is the stable row key; the
                # all-masked padding rows get a shared sentinel (their
                # canonical form is empty, so they always reuse)
                if self._nms_inc is None or self._nms_inc.iou_threshold != thr:
                    self._nms_inc = IncrementalNms(thr)
                keys = [id(loop) for loop, _ in rows]
                keys += [("pad", r) for r in range(len(keys), len(boxes))]
                keep = self._nms_inc.suppress(keys, boxes, scores, mask)
            else:
                keep = sph_nms_batch(boxes, scores, mask, iou_threshold=thr)
            for r, (_, res) in enumerate(rows):
                keeps[id(res)] = keep[r, : len(res.detections)]
        elif rows:  # heterogeneous thresholds: per-stream single rows
            for loop, res in rows:
                keeps[id(res)] = loop.nms_keep(res.detections)
        for loop, res in plans:
            loop.finalize_detections(res, keeps.get(id(res)))
        return time.perf_counter() - t0

    def flush(self) -> None:
        """Settle carried work: dispatch every still-queued request in
        one full sorted drain (priced on the overlap model — carried
        work launches when its group frees) and finish the frames left
        in flight.  A strict no-op under policies without carry-over,
        so ``run`` keeps the sync path bit-identical.  Flush charges
        accrue to ``sum_tick_inf_s`` without growing ``ticks``: the
        async mean tick pays its tail instead of hiding it.

        The round bound is keyed to what a drain can actually owe: a
        full drain dispatches every queued request, so one round
        settles everything a well-behaved pod queued, and extra
        headroom covers a policy that carried up to ``max_carry``
        ticks plus the chunked depth of the deepest queue.  A pod
        still unsettled past the bound is a real invariant break
        (e.g. a request whose owner never ingests) and raises a
        diagnostic ``RuntimeError`` naming the unsettled streams."""
        deepest = max(self.queues.counts().values(), default=0)
        rounds = (2 + int(getattr(self.policy, "max_carry", 0))
                  + -(-deepest // self.buckets.max_batch))
        for _ in range(rounds):
            if not len(self.queues) and not self._inflight:
                break
            if len(self.queues):
                timeline = TickTimeline(len(self.timelines), self.clock.now)
                self._execute(self.queues.full_drain_ops(), timeline,
                              self._flush_close)
            self._ingest()
        if len(self.queues) or self._inflight:
            raise RuntimeError(
                f"flush failed to settle the pod after {rounds} "
                f"drain rounds: {self._unsettled_report()}")

    def _unsettled_report(self) -> str:
        """What flush left behind, by stream — the diagnostic payload
        of the flush-depth RuntimeError."""
        queued = {name: c for name, c in self.queues.counts().items() if c}
        frames = []
        for e in self._inflight:
            stream = e.stream if e.stream is not None \
                else self.loops.index(e.loop)
            frames.append(
                f"stream {stream} frame {e.frame_idx} "
                f"({len(e.slots)}/{len(e.pending.requests)} requests "
                "resolved)")
        return (f"queued requests by variant: {queued or '{}'}; "
                f"in-flight frames: {', '.join(frames) or 'none'}")

    @staticmethod
    def _flush_close(clock: GroupClock, timeline: TickTimeline,
                     tick_lat=None, overlap_lat=None) -> tuple[float, float]:
        """Flush charge: the overlap-generalised barrier — each touched
        group pays its carry-in plus its serialised drain, max over
        groups, via the latency model's closed form
        (``tick_overlap_delay``) when it provides one.  The event
        horizon is kept as the floor: it additionally covers busy
        groups the flush had nothing left to drain on, so the carried
        tail can never go unbilled."""
        del tick_lat
        horizon = clock.horizon()
        charge = max(0.0, horizon - timeline.start)
        if overlap_lat is not None:
            charge = max(charge,
                         overlap_lat(timeline.group_costs, timeline.carry_in))
        return charge, horizon

    def run(self, frames: range) -> ServeStats:
        self._emit_run_meta("closed")
        for f in frames:
            self.step(f)
        self.flush()
        return self.stats

    # -- open-loop (arrival-clocked) serving -------------------------------

    def run_open_loop(self, traffic, *, slo_s: float | None = None
                      ) -> ServeStats:
        """Arrival-driven serving: the event clock advances to each
        arrival instead of a global frame barrier.

        ``traffic`` is a :class:`repro.serving.traffic.ArrivalProcess`
        (or any iterable of time-ordered ``Arrival``s): streams
        join/leave per its churn trace, each arrival carries its own
        per-stream ``frame_idx``, and a frame whose predecessor still
        occupies the stream's depth-1 camera buffer is counted
        ``missed`` — never fabricated, never queued behind it.  Every
        surviving arrival consults the policy's
        :class:`~repro.serving.runtime.AdmissionPolicy` against the
        SLO envelope (``slo_s``): admit the full allocator plan,
        degrade to skip+P1, or reject.  The conservation invariant:
        ``arrivals == admitted + rejected + missed``.

        Unlike closed-loop ticks, drains here never block arrivals —
        work is booked on the busy groups and the clock keeps tracking
        arrival time, so queueing delay (launch minus emission) and
        SLO violations are real, not artifacts of a barrier.

        Pod-allocate policies are served too: arrivals landing at the
        same instant are planned JOINTLY through the pod-level fixed
        point with ``slo_s`` as its capacity envelope
        (``solve_pod(..., slo_s=...)``); running one without an SLO is
        deprecated (see :meth:`open_loop_begin`).

        The loop is a thin driver over :meth:`open_loop_begin` /
        :meth:`serve_open_batch` / :meth:`open_loop_end` — the fleet
        tier (``repro.serving.fleet``) drives the same three phases
        per pod with a router splitting the global arrival stream.
        """
        arrivals = traffic.arrivals() if hasattr(traffic, "arrivals") \
            else list(traffic)
        self.open_loop_begin(slo_s)
        i, n = 0, len(arrivals)
        while i < n:
            self.clock.advance(arrivals[i].t_s)
            # arrivals landing at the same instant share one admission
            # + drain round, so their requests can batch together
            batch = []
            while i < n and arrivals[i].t_s <= self.clock.now + 1e-12:
                batch.append(arrivals[i])
                i += 1
            self.serve_open_batch(batch)
        return self.open_loop_end()

    def open_loop_begin(self, slo_s: float | None = None) -> None:
        """Enter open-loop serving: record the SLO target and emit the
        run's ``run_meta`` telemetry.  Called once per run by
        :meth:`run_open_loop`; the fleet tier calls it directly on
        every pod it creates (including pods added mid-run by the
        elastic controller)."""
        if self.policy.pod_allocate and slo_s is None:
            import warnings
            warnings.warn(
                "open-loop serving with a pod_allocate policy but no "
                "slo_s leaves the pod-level fixed point without a "
                "service-level capacity envelope (the round-0 "
                "self-referential cap only); pass slo_s= to "
                "run_open_loop so solve_pod can clamp the envelope. "
                "This will become an error in the next release — see "
                "README 'Migration'.", DeprecationWarning, stacklevel=3)
        self.slo_s = slo_s
        self.solve_slo_s = slo_s
        self.stats.slo_s = slo_s
        self.stats.admission = self.policy.admission.name
        self._emit_run_meta("open")
        self._open_horizon = self.clock.now

    def serve_open_batch(self, batch: list) -> None:
        """Serve one same-instant arrival round: advance the event
        clock, admit every arrival (jointly under a pod-allocate
        policy), then drain and ingest."""
        self.clock.advance(batch[0].t_s)
        if self.policy.pod_allocate:
            self._admit_batch_coupled(batch)
        else:
            for a in batch:
                self._admit_arrival(a)
        self._open_drain()
        self._ingest()

    def open_loop_end(self) -> ServeStats:
        """Leave open-loop serving: settle carried work and finish the
        in-flight tail.  Every busy second up to the horizon is already
        charged; jump the clock there so the settling flush only bills
        new work."""
        self.clock.advance(self.clock.horizon())
        self.flush()
        return self.stats

    def _admit_batch_coupled(self, batch: list) -> None:
        """Joint admission of one same-instant arrival round under a
        pod-allocate policy: the surviving arrivals' planning contexts
        run through the pod-level fixed point together (with the run's
        SLO as the capacity envelope), then each arrival passes the
        usual marginal admission pricing with its coupled plan.  A
        single-arrival round hits ``solve_pod``'s one-stream
        short-circuit, so it prices exactly like the per-stream path."""
        from repro_torch.serving import pod_allocation

        survivors = []
        for arrival in batch:
            s = arrival.stream
            loop, backend = self.loops[s], self.backends[s]
            self.stats.arrivals += 1
            _bump(self.stats.arrivals_by_task, self._task(loop))
            if self.telemetry.enabled:
                self.telemetry.emit("arrival", t_s=arrival.t_s, stream=s,
                                    frame_idx=arrival.frame_idx)
            prev = self._stream_frame.get(s)
            if prev is not None and not prev.complete:
                self.stats.missed += 1
                _bump(self.stats.missed_by_task, self._task(loop))
                if self.telemetry.enabled:
                    self._emit_admission(arrival, "missed", None, None,
                                         None)
                continue
            if hasattr(backend, "set_frame"):
                backend.set_frame(arrival.frame_idx)
            frame = (self.frame_source(s, arrival.frame_idx)
                     if self.frame_source is not None else None)
            survivors.append((arrival, loop, backend,
                              loop.frame_context(frame)))
        if not survivors:
            return
        multi = len(self.tasks) > 1
        problems = [pod_allocation.StreamProblem(
            ctx.acc, ctx.d_pre, ctx.d_inf, ctx.budget,
            variants=tuple(loop.variants) if multi else None,
            latency_model=loop.latency_model if multi else None)
            for _, loop, _, ctx in survivors]
        util = (self.stats.group_utilisation()
                if self.placement is not None
                and self.stats.sum_tick_inf_s > 0 else None)
        sol = pod_allocation.solve_pod(
            problems, self.loops[0].variants, self.loops[0].latency_model,
            buckets=self.buckets, placement=self.placement,
            group_utilisation=util, slo_s=self.solve_slo_s)
        self.stats.pod_ticks += 1
        self.stats.pod_rounds += sol.rounds
        self.stats.pod_converged_ticks += int(sol.converged)
        for (arrival, loop, backend, ctx), plan in zip(survivors,
                                                       sol.plans):
            self._admit_planned(arrival, loop, backend, ctx, plan)

    def _admit_arrival(self, arrival) -> None:
        """Admission-check one arrival, emitting its requests if the
        verdict allows (see :meth:`run_open_loop`)."""
        s = arrival.stream
        loop, backend = self.loops[s], self.backends[s]
        self.stats.arrivals += 1
        _bump(self.stats.arrivals_by_task, self._task(loop))
        if self.telemetry.enabled:
            self.telemetry.emit("arrival", t_s=arrival.t_s, stream=s,
                                frame_idx=arrival.frame_idx)
        prev = self._stream_frame.get(s)
        if prev is not None and not prev.complete:
            self.stats.missed += 1
            _bump(self.stats.missed_by_task, self._task(loop))
            if self.telemetry.enabled:
                self._emit_admission(arrival, "missed", None, None, None)
            return
        if hasattr(backend, "set_frame"):
            backend.set_frame(arrival.frame_idx)
        frame = (self.frame_source(s, arrival.frame_idx)
                 if self.frame_source is not None else None)
        ctx = loop.frame_context(frame)
        plan = None
        if ctx.srois:
            plan = allocation.allocate(ctx.acc, ctx.d_pre, ctx.d_inf,
                                       ctx.budget)
        self._admit_planned(arrival, loop, backend, ctx, plan)

    def _admit_planned(self, arrival, loop, backend, ctx, plan) -> None:
        """Admission pricing + emission of one arrival whose candidate
        plan is already chosen (per-stream knapsack or pod-coupled)."""
        s = arrival.stream
        dplan = None
        if ctx.srois:
            # the degraded alternative: rows 0..1 = skip + the P1
            # variant only (model indices stay valid on the full
            # ladder, so emit_pending needs no special casing)
            dplan = allocation.allocate(ctx.acc[:2], ctx.d_pre[:2],
                                        ctx.d_inf[:2], ctx.budget)
        # plan costs are MARGINAL: joint backlog (plan batched with the
        # queued demand, the way the drain executes) minus the bare one
        backlog = self._open_backlog()
        plan_cost = max(
            0.0, self._open_backlog(self._plan_counts(loop, plan)) - backlog)
        degraded_cost = max(
            0.0, self._open_backlog(self._plan_counts(loop, dplan)) - backlog)
        verdict = self.policy.admission.decide(
            backlog_s=backlog, plan_cost_s=plan_cost,
            degraded_cost_s=degraded_cost, slo_s=self.slo_s)
        if self.telemetry.enabled:
            self._emit_admission(arrival, verdict, backlog, plan_cost,
                                 degraded_cost)
        task = self._task(loop)
        if verdict == REJECT:
            self.stats.rejected += 1
            _bump(self.stats.rejected_by_task, task)
            return
        if verdict == DEGRADE:
            plan = dplan
            self.stats.degraded += 1
            _bump(self.stats.degraded_by_task, task)
        self.stats.admitted += 1
        _bump(self.stats.admitted_by_task, task)
        pending = loop.emit_pending(ctx, plan)
        if not pending.requests:
            self.stats.empty_frames += 1
        entry = _InFlightFrame(loop=loop, pending=pending,
                               emitted_s=arrival.t_s, done_s=arrival.t_s,
                               frame_idx=arrival.frame_idx, stream=s)
        self._inflight.append(entry)
        self._by_owner[id(pending)] = entry
        self._stream_frame[s] = entry
        if pending.plan is not None:
            self.stats.sum_plan_value += pending.plan.value
            _bump(self.stats.plan_value_by_task, task, pending.plan.value)
        for req in pending.requests:
            self.queues.put(QueuedRequest(
                request=req, owner=pending, backend=backend,
                latency_model=loop.latency_model,
                deadline=loop.budget_s, emitted_s=arrival.t_s,
                frame_idx=arrival.frame_idx, task=task))
        if self.telemetry.enabled:
            self.telemetry.emit(
                "emit", t_s=arrival.t_s, stream=s, task=task,
                frame_idx=arrival.frame_idx,
                n_requests=len(pending.requests),
                plan_value=pending.plan.value
                if pending.plan is not None else 0.0,
                variants=[req.variant.name for req in pending.requests])
        if self.placement is not None and pending.requests:
            counts: dict[str, int] = {}
            for req in pending.requests:
                counts[req.variant.name] = counts.get(req.variant.name, 0) + 1
            self.placement.observe(counts)
            self._maybe_rebalance(arrival.t_s)

    def _emit_admission(self, arrival, verdict: str, backlog_s,
                        plan_cost_s, degraded_cost_s) -> None:
        """One ``admission`` record per arrival verdict (``missed``
        frames never reach the policy, so their cost fields are null)."""
        self.telemetry.emit(
            "admission", t_s=arrival.t_s, stream=arrival.stream,
            task=self._task(self.loops[arrival.stream]),
            frame_idx=arrival.frame_idx, verdict=verdict,
            backlog_s=backlog_s, plan_cost_s=plan_cost_s,
            degraded_cost_s=degraded_cost_s, slo_s=self.slo_s)

    def _open_backlog(self, extra: dict | None = None) -> float:
        """The admission policy's load signal: per replica group, busy
        carry-in past ``now`` plus the queued demand's chunked drain
        cost on the server's pricing curve — max over groups (groups
        run concurrently, so the slowest one bounds any new frame's
        wait).

        ``extra`` (``{variant_name: (variant, latency_model, count)}``,
        see :meth:`_plan_counts`) folds a candidate plan's requests
        into the queued counts BEFORE pricing, so the plan batches
        with the queued demand exactly like the drain will execute it
        — the admission cost of a plan is the joint backlog minus the
        bare one (its true marginal), not a standalone serial price.
        """
        counts = {name: c for name, c in self.queues.counts().items() if c}
        pricing: dict[str, tuple] = {}
        for name in counts:
            item = self.queues.head(name)
            pricing[name] = (item.request.variant, item.latency_model)
        for name, (variant, lat, n) in (extra or {}).items():
            counts[name] = counts.get(name, 0) + n
            pricing.setdefault(name, (variant, lat))
        load: dict[int, float] = {}
        for name, count in counts.items():
            variant, lat = pricing[name]
            group = self.placement.group_for(name) \
                if self.placement is not None else None
            g = group.index if group is not None else 0
            curve, _ = self._price_curve(
                variant, lat, group.n_devices if group is not None else 1)
            load[g] = load.get(g, 0.0) + sum(
                curve(b) for b in self.buckets.split(count))
        carry = self.clock.carry()
        return max((carry.get(g, 0.0) + load.get(g, 0.0)
                    for g in set(load) | set(carry)), default=0.0)

    @staticmethod
    def _plan_counts(loop, plan) -> dict:
        """A plan's demand as :meth:`_open_backlog` ``extra`` input:
        per variant name, ``(variant, latency_model, request_count)``."""
        out: dict = {}
        if plan is None:
            return out
        for model_idx in plan.models:
            if model_idx == 0:
                continue
            v = loop.variants[model_idx - 1]
            _, _, n = out.get(v.name, (v, loop.latency_model, 0))
            out[v.name] = (v, loop.latency_model, n + 1)
        return out

    def _open_drain(self) -> None:
        """One arrival-round drain: the policy picks order/carry as in
        closed loop, but the close rule never jumps the arrival clock —
        work books onto the busy groups and the charge is the busy-
        horizon extension (so overlapping rounds never double-bill)."""
        if not len(self.queues):
            return
        self._projected_load = None
        timeline = TickTimeline(len(self.timelines), self.clock.now)
        ops = self.policy.plan_drain(
            self.queues, self.buckets, self.placement, self.clock,
            chunk_cost=self._chunk_cost, projected_load=None)
        self._emit_policy_decision(timeline, ops)
        self._execute(ops, timeline, self._open_close)
        if timeline.events:
            self.stats.ticks += 1
        self.stats.carry_tick_slots += len(self.queues)
        self.stats.carried_requests += self.queues.newly_carried()

    def _open_close(self, clock: GroupClock, timeline: TickTimeline,
                    tick_lat=None, overlap_lat=None) -> tuple[float, float]:
        del tick_lat, overlap_lat
        horizon = clock.horizon()
        charge = max(0.0, horizon - max(self._open_horizon, timeline.start))
        self._open_horizon = max(self._open_horizon, horizon)
        return charge, clock.now
