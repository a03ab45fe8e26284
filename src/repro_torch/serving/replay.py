"""Deterministic replay over the telemetry event log (port of
``repro.serving.replay``; a log recorded by either package checks clean
in the other).

A recorded serving run (``repro_torch.serving.telemetry``) is fully
re-drivable: the pod is deterministic given its construction
parameters (seeded oracle videos, calibrated latency model, virtual
device slots — no wall clock in any replayed quantity), and the
traffic is either a closed-loop ``range(frames)`` or the exact
``arrival`` records in the log.  This module makes that a harness:

  * :class:`CorpusSpec` — the rebuildable pod recipe (the standard
    oracle pod every bench/test in this repo serves).  ``record()``
    writes it into the log as a ``corpus_spec`` event, so a log is a
    self-contained replay artifact;
  * :func:`record` — serve a spec under a sink, stamping
    ``corpus_spec`` first and the final ``run_stats`` fingerprint
    last;
  * :func:`replay` — rebuild the pod from a log's spec (optionally
    under a DIFFERENT schedule/admission policy), re-drive the
    recorded traffic, and compare: same policy must reproduce
    ``ServeStats`` and every per-frame detection digest
    BIT-IDENTICALLY (the replay-determinism CI lane); a different
    policy yields an apples-to-apples :func:`format_policy_diff`;
  * :func:`stats_fingerprint` — ``ServeStats`` as a JSON-stable dict
    with the wall-clock field (``sum_overhead``, the only
    non-deterministic quantity in the dataclass) excluded.
"""

from __future__ import annotations

import dataclasses
import json

from repro_torch.serving.telemetry import MemorySink, read_events

# ServeStats fields measured with time.perf_counter — everything else
# in the dataclass is event-clock/model-priced and must replay exactly
_WALL_CLOCK_FIELDS = frozenset({"sum_overhead"})


@dataclasses.dataclass
class CorpusSpec:
    """The rebuildable recipe of one recorded serving run.

    Everything here feeds seeded constructors (``make_video(seed0+s)``,
    ``ArrivalProcess(seed=traffic_seed)``, ``VariantPlacement.virtual``)
    so two pods built from equal specs are indistinguishable.  The
    variant ladder is selected BY NAME from ``profiles.make_ladder()``
    — the calibrated Table II ladder — so a spec stays valid across
    refactors that reorder it.
    """

    mode: str = "closed"            # "closed" | "open"
    n_streams: int = 4
    frames: int = 8                 # closed: tick count; open: video floor
    budget_s: float | list = 1.8    # scalar or one per stream
    variants: tuple = ("yolo-p5-896", "yolo-p6-1280")
    # per-stream analytics tasks (repro_torch.serving.tasks registry
    # names, one per stream); () keeps every stream on detection — the
    # backward-compatible reading of pre-multi-task logs.  ``variants``
    # only subsets the DETECTION ladder; non-detection streams serve
    # their task's full registered ladder.
    tasks: tuple = ()
    devices: int = 8                # virtual slots; 0 = single-device pod
    max_batch: int = 8
    policy: str = "sync"
    pod_allocate: bool = False
    max_carry: int | None = None    # async policy only
    admission: str | None = None    # None = admit-all
    slo_s: float | None = None      # open-loop SLO target
    seed0: int = 100                # per-stream video seed base
    # fleet tier (repro_torch.serving.fleet): 0 = single pod (the default,
    # backward-compatible with pre-fleet logs); > 0 records an
    # open-loop FleetServer run with a FIXED active set — elastic
    # scaling is exercised by the fleet tests, not the replay corpora
    pods: int = 0
    routing: str = "least-loaded"
    # open-loop traffic (ignored in closed mode)
    fps: float = 0.5
    jitter: float = 0.0
    traffic_seed: int = 0
    horizon_s: float = 30.0
    churn: tuple = ()               # (t_s, stream, connected) triples
    rate_trace: tuple = ()          # (t_start_s, scale) steps

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["variants"] = list(d["variants"])
        d["tasks"] = list(d["tasks"])
        d["churn"] = [list(c) for c in d["churn"]]
        d["rate_trace"] = [list(r) for r in d["rate_trace"]]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "CorpusSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = d.keys() - known
        if unknown:
            raise ValueError(f"corpus_spec has unknown fields "
                             f"{sorted(unknown)}")
        d = dict(d)
        for key in ("variants", "tasks", "churn", "rate_trace"):
            if key in d:
                d[key] = tuple(tuple(x) if isinstance(x, list) else x
                               for x in d[key])
        if isinstance(d.get("budget_s"), list):
            d["budget_s"] = list(d["budget_s"])
        return cls(**d)

    def budget_for(self, stream: int) -> float:
        if isinstance(self.budget_s, (int, float)):
            return float(self.budget_s)
        return float(self.budget_s[stream])

    def traffic(self):
        """The spec's seeded :class:`~repro_torch.serving.traffic.
        ArrivalProcess` (open mode only)."""
        from repro_torch.serving.traffic import ArrivalProcess, ChurnEvent

        return ArrivalProcess(
            self.n_streams, fps=self.fps, jitter=self.jitter,
            seed=self.traffic_seed, horizon_s=self.horizon_s,
            churn=[ChurnEvent(t_s=t, stream=s, connected=bool(c))
                   for t, s, c in self.churn],
            rate_trace=self.rate_trace)


def _build_streams(spec: CorpusSpec):
    """The spec's shared per-stream state, built through the analytics
    task registry (``repro_torch.serving.tasks``): per-task calibrated
    ladders and latency models, seeded oracle backends and loops.  A
    spec with no ``tasks`` is an all-detection pod and reproduces the
    pre-registry construction bit-identically.  One build serves a
    single pod or a whole fleet — every fleet pod must see the SAME
    lists so global stream indices stay valid on any pod.

    Returns ``(variants, loops, backends, cost_fn)``: ``variants`` is
    the union ladder over the tasks present and ``cost_fn`` prices a
    union variant with its own task's latency model (placement
    seeding)."""
    from repro_torch.data.synthetic import make_video
    from repro_torch.serving import tasks as task_registry

    stream_tasks = list(spec.tasks) or ["detection"] * spec.n_streams
    if len(stream_tasks) != spec.n_streams:
        raise ValueError(
            f"corpus_spec.tasks names {len(stream_tasks)} streams, "
            f"n_streams is {spec.n_streams}")
    frames = spec.frames
    if spec.mode == "open":
        frames = max(frames, int(spec.horizon_s * spec.fps) + 8)
    videos = [make_video(n_frames=frames + 8,
                         n_objects=30 + 5 * (s % 4),
                         seed=spec.seed0 + s)
              for s in range(spec.n_streams)]
    budgets = [spec.budget_for(s) for s in range(spec.n_streams)]
    try:
        return task_registry.build_task_streams(
            stream_tasks, videos, budgets,
            detection_variants=spec.variants)
    except ValueError as e:
        if "unknown variants" in str(e):
            raise ValueError(f"corpus_spec names {e}") from None
        raise


def build_pod(spec: CorpusSpec, policy=None, admission=None,
              telemetry=None):
    """The standard deterministic oracle pod for ``spec``.

    ``policy``/``admission`` override the spec's (the policy-diff
    path); ``None`` rebuilds exactly what was recorded.
    """
    from repro_torch.serving.placement import VariantPlacement
    from repro_torch.serving.server import PodServer

    variants, loops, backends, cost_fn = _build_streams(spec)
    placement = None
    if spec.devices > 0:
        placement = VariantPlacement.virtual(variants, spec.devices,
                                             cost_fn=cost_fn)
    if policy is None:
        policy = _spec_policy(spec, admission)
    elif admission is not None:
        raise ValueError("pass admission inside the policy instance or "
                         "leave policy=None")
    return PodServer(loops, backends, max_batch=spec.max_batch,
                     placement=placement, policy=policy,
                     telemetry=telemetry)


def build_fleet(spec: CorpusSpec, policy=None, admission=None,
                telemetry=None):
    """The deterministic ``spec.pods``-pod fleet over the same shared
    streams as :func:`build_pod`.

    ``spec.devices`` is the fleet-wide budget: each pod gets the
    per-pod power-of-two width :func:`~repro_torch.distributed.elastic.
    serving_scale_plan` assigns (0 keeps every pod single-device).
    Each pod receives its OWN placement and (spec-built) policy
    instance; a ``policy`` override instance is shared across pods —
    schedule policies are stateless config objects, so sharing is
    safe — and overrides work the same as on :func:`build_pod`.
    """
    from repro_torch.distributed.elastic import serving_scale_plan
    from repro_torch.serving.fleet import FleetServer
    from repro_torch.serving.placement import VariantPlacement
    from repro_torch.serving.server import PodServer

    if spec.pods < 1:
        raise ValueError(f"build_fleet needs spec.pods >= 1, got "
                         f"{spec.pods}")
    if spec.mode != "open":
        raise ValueError("fleet corpora are open-loop; set mode='open'")
    variants, loops, backends, cost_fn = _build_streams(spec)
    per_pod = serving_scale_plan(spec.devices, spec.pods)["per_pod_devices"]
    if policy is not None and admission is not None:
        raise ValueError("pass admission inside the policy instance or "
                         "leave policy=None")

    def make_pod(pod_id: int) -> PodServer:
        placement = None
        if per_pod > 0:
            placement = VariantPlacement.virtual(variants, per_pod,
                                                 cost_fn=cost_fn)
        pol = policy if policy is not None \
            else _spec_policy(spec, admission)
        return PodServer(loops, backends, max_batch=spec.max_batch,
                         placement=placement, policy=pol)

    return FleetServer(make_pod, spec.pods, routing=spec.routing,
                       telemetry=telemetry)


def _spec_policy(spec: CorpusSpec, admission=None):
    from repro_torch.serving.runtime import POLICIES, AsyncDrainPolicy

    cls = POLICIES[spec.policy]
    adm = admission if admission is not None else spec.admission
    if cls is AsyncDrainPolicy and spec.max_carry is not None:
        return cls(pod_allocate=spec.pod_allocate,
                   max_carry=spec.max_carry, admission=adm)
    return cls(pod_allocate=spec.pod_allocate, admission=adm)


def stats_fingerprint(stats) -> dict:
    """``ServeStats`` as a JSON-round-trip-stable dict, wall-clock
    fields excluded.  Dict keys pass through ``str`` (JSON would do it
    anyway), so a fingerprint read back from a log compares equal to a
    fresh one.

    A :class:`~repro_torch.serving.fleet.FleetStats` (recognised by its
    ``pod_stats`` attribute) fingerprints recursively: the fleet-only
    control-plane counters plus one per-pod ``ServeStats`` fingerprint
    in pod-id order — so a fleet replay must reproduce every pod AND
    every routing/scaling decision bit-identically."""
    if hasattr(stats, "pod_stats"):
        out = {"routing": stats.routing,
               "pod_ids": list(stats.pod_ids),
               "routes": stats.routes,
               "migrations": stats.migrations,
               "scale_ups": stats.scale_ups,
               "scale_downs": stats.scale_downs,
               "pods": [stats_fingerprint(s) for s in stats.pod_stats]}
        return json.loads(json.dumps(out))
    out = {}
    for f in dataclasses.fields(stats):
        if f.name in _WALL_CLOCK_FIELDS:
            continue
        v = getattr(stats, f.name)
        if isinstance(v, dict):
            v = {str(k): v[k] for k in sorted(v, key=str)}
        out[f.name] = v
    # json round-trip normalises tuples/numpy scalars the way a
    # JsonlSink record would have
    return json.loads(json.dumps(out))


def record(spec: CorpusSpec, sink) -> "object":
    """Serve ``spec`` with telemetry into ``sink``; returns the stats.

    The log leads with the ``corpus_spec`` record (so :func:`replay`
    can rebuild the pod) and ends with ``run_stats`` (the fingerprint
    a same-policy replay must reproduce)."""
    sink.emit("corpus_spec", spec=spec.to_dict())
    if spec.pods > 0:
        server = build_fleet(spec, telemetry=sink)
        stats = server.run_open_loop(spec.traffic(), slo_s=spec.slo_s)
    else:
        server = build_pod(spec, telemetry=sink)
        if spec.mode == "open":
            stats = server.run_open_loop(spec.traffic(), slo_s=spec.slo_s)
        else:
            stats = server.run(range(spec.frames))
    sink.emit("run_stats", stats=stats_fingerprint(stats))
    sink.close()
    return stats


def _log_spec(events) -> CorpusSpec:
    specs = [e for e in events if e["event"] == "corpus_spec"]
    if not specs:
        raise ValueError("log has no corpus_spec record; was it written "
                         "by repro_torch.serving.replay.record()?")
    return CorpusSpec.from_dict(specs[0]["spec"])


def _log_digests(events) -> dict:
    """Per (stream, frame_idx): the recorded detection digest."""
    return {(e["stream"], e["frame_idx"]): e["det_digest"]
            for e in events if e["event"] == "frame_finish"}


@dataclasses.dataclass
class ReplayResult:
    """A replay run next to what its log recorded."""

    spec: CorpusSpec
    recorded_stats: dict            # fingerprint from the log
    replayed_stats: dict            # fingerprint of the re-driven run
    recorded_digests: dict          # (stream, frame_idx) -> sha1
    replayed_digests: dict
    events: list                    # the replay's own event records
    same_policy: bool

    @property
    def identical(self) -> bool:
        return (self.replayed_stats == self.recorded_stats
                and self.replayed_digests == self.recorded_digests)

    def drift(self) -> list[str]:
        """Human-readable drift lines (empty when bit-identical)."""
        out = []
        for k in self.recorded_stats:
            a, b = self.recorded_stats[k], self.replayed_stats.get(k)
            if a != b:
                out.append(f"stats.{k}: recorded {a!r} != replayed {b!r}")
        for k in self.replayed_stats.keys() - self.recorded_stats.keys():
            out.append(f"stats.{k}: only in replay")
        keys = self.recorded_digests.keys() | self.replayed_digests.keys()
        drifted = [k for k in sorted(keys)
                   if self.recorded_digests.get(k)
                   != self.replayed_digests.get(k)]
        if drifted:
            out.append(
                f"detections drifted on {len(drifted)} frames "
                f"(first: stream {drifted[0][0]} frame {drifted[0][1]})")
        return out


def replay(log, policy=None, admission=None) -> ReplayResult:
    """Re-drive a recorded log; compare against what it recorded.

    ``log`` is a path (JSONL) or an event-record list.  With
    ``policy``/``admission`` None the pod is rebuilt exactly as
    recorded and the result must be bit-identical; an override turns
    the run into a policy experiment over the SAME content and traffic
    (``format_policy_diff`` renders the comparison).
    """
    events = read_events(log) if isinstance(log, str) else list(log)
    spec = _log_spec(events)
    recorded = [e for e in events if e["event"] == "run_stats"]
    if not recorded:
        raise ValueError("log has no run_stats record (truncated "
                         "recording?)")
    sink = MemorySink()
    if spec.pods > 0:
        server = build_fleet(spec, policy=policy, admission=admission,
                             telemetry=sink)
    else:
        server = build_pod(spec, policy=policy, admission=admission,
                           telemetry=sink)
    if spec.mode == "open":
        from repro_torch.serving.traffic import arrivals_from_records

        stats = server.run_open_loop(arrivals_from_records(events),
                                     slo_s=spec.slo_s)
    else:
        stats = server.run(range(spec.frames))
    return ReplayResult(
        spec=spec,
        recorded_stats=recorded[0]["stats"],
        replayed_stats=stats_fingerprint(stats),
        recorded_digests=_log_digests(events),
        replayed_digests=_log_digests(sink.events),
        events=sink.events,
        same_policy=policy is None and admission is None)


# which fingerprint fields the policy-diff table shows, in order
_DIFF_FIELDS = (
    "frames", "ticks", "dispatches", "carried_requests", "carry_tick_slots",
    "sum_tick_inf_s",
    "sum_plan_value", "arrivals", "admitted", "degraded", "rejected",
    "missed", "empty_frames", "slo_violations", "total_detections",
)


def fingerprint_metrics(fp: dict) -> dict:
    """The diff-table scalars of one stats fingerprint.

    A fleet fingerprint (the ``pods`` key) aggregates: counters sum
    across pods, the e2e percentile pools every pod's events, and the
    fleet-only control-plane counters ride along."""
    if "pods" in fp:
        out = {}
        for k in _DIFF_FIELDS:
            vals = [p.get(k) for p in fp["pods"] if p.get(k) is not None]
            out[k] = round(sum(vals), 4) if vals else None
        e2e = [x for p in fp["pods"] for x in (p.get("event_e2e") or [])]
        if e2e:
            srt = sorted(e2e)
            out["p95_e2e_s"] = round(srt[min(len(srt) - 1,
                                             int(0.95 * len(srt)))], 4)
        for k in ("routes", "migrations", "scale_ups", "scale_downs"):
            out[k] = fp.get(k)
        return out
    out = {}
    for k in _DIFF_FIELDS:
        v = fp.get(k)
        if isinstance(v, float):
            v = round(v, 4)
        out[k] = v
    e2e = fp.get("event_e2e") or []
    if e2e:
        srt = sorted(e2e)
        out["p95_e2e_s"] = round(srt[min(len(srt) - 1,
                                         int(0.95 * len(srt)))], 4)
    return out


def format_policy_diff(result: ReplayResult) -> list[str]:
    """Side-by-side recorded-vs-replayed report lines.

    Same policy: a one-line bit-identical verdict (or the drift list —
    the CI lane's failure payload).  Different policy: the
    apples-to-apples metric table over identical content and traffic.
    """
    rec = fingerprint_metrics(result.recorded_stats)
    rep = fingerprint_metrics(result.replayed_stats)
    if result.same_policy:
        if result.identical:
            fleet = (f", {result.spec.pods} pods "
                     f"({result.spec.routing} routing)"
                     if result.spec.pods else "")
            return [f"replay [{result.spec.policy} policy, "
                    f"{result.spec.mode}-loop, {result.spec.n_streams} "
                    f"streams{fleet}]: bit-identical "
                    f"({rec['frames']} frames, {rec['dispatches']} "
                    f"dispatches, {len(result.recorded_digests)} "
                    f"detection digests)"]
        return ["replay DRIFTED from its recording:"] + [
            f"  {line}" for line in result.drift()]
    rec_pol = result.recorded_stats.get("policy", result.spec.policy)
    rep_pol = result.replayed_stats.get("policy", "?")
    lines = [f"policy diff over identical content/traffic "
             f"[{result.spec.mode}-loop, {result.spec.n_streams} "
             f"streams]: recorded={rec_pol} replayed={rep_pol}"]
    width = max(len(k) for k in rec)
    for k in rec:
        a, b = rec.get(k), rep.get(k)
        if a in (None, 0, 0.0) and b in (None, 0, 0.0):
            continue
        mark = "" if a == b else "  *"
        lines.append(f"  {k:<{width}}  recorded={a!s:>10}  "
                     f"replayed={b!s:>10}{mark}")
    return lines
