"""Structured tick telemetry for the pod serving runtime.

``TickTimeline`` stamps launch/complete/emission per dispatch, but until
this module the data died in ``ServeStats`` aggregates: a policy PR was
reviewable only through coarse bench ratios.  This module exports the
event stream itself — one structured record per arrival, admission
verdict, emission, dispatch launch/complete, carry-over, placement
rebalance, policy decision, tick close and frame finish — through a
``TelemetrySink`` hook on :class:`repro.serving.server.PodServer`:

  * :class:`TelemetrySink` — the default no-op (``enabled = False``, so
    the server skips building payloads entirely; a telemetry-less run
    pays nothing);
  * :class:`MemorySink` — in-memory record list (tests, replay);
  * :class:`JsonlSink` — one JSON object per line on disk, the artifact
    the nightly bench uploads and the replay harness
    (``repro.serving.replay``) re-drives.

Every record is a flat dict with an ``event`` type tag; the required
keys per type live in :data:`EVENT_FIELDS` and are enforced at emit
time (a malformed record fails the producer, not a reader three PRs
later).  Records carry only deterministic quantities — event-clock
seconds, model-priced costs, seeded-oracle detection digests — never
wall-clock measurements, so recording the same seeded corpus twice
yields byte-identical logs and a replay can be checked for
BIT-IDENTICAL drift (the replay-determinism CI lane).

:func:`format_timeline_report` is the offline operator surface: per-
group utilisation, queueing-delay histogram and admission-verdict
breakdown from a log alone — no server, no stats object.
"""

from __future__ import annotations

import collections
import hashlib
import json

import numpy as np

SCHEMA_VERSION = 1

# required keys per event type (the ``event`` tag itself is implicit).
# Extra keys are allowed — readers must tolerate forward growth — but a
# record MISSING a required key is rejected at emit time.
EVENT_FIELDS: dict[str, frozenset] = {
    # one per recorded run: what the pod was (the replay harness stores
    # its rebuildable corpus parameters separately, in ``corpus_spec``)
    "run_meta": frozenset({
        "schema", "mode", "n_streams", "policy", "max_batch", "devices",
        "variants", "tasks", "slo_s"}),
    # repro.serving.replay.CorpusSpec as a dict — everything needed to
    # rebuild the pod and re-drive the run
    "corpus_spec": frozenset({"spec"}),
    # the recorded run's final ServeStats fingerprint (wall-clock
    # fields excluded) — what a same-policy replay must reproduce
    "run_stats": frozenset({"stats"}),
    # open loop: one frame hitting the pod's front door
    "arrival": frozenset({"t_s", "stream", "frame_idx"}),
    # open loop: the admission verdict for one arrival
    # (admit / degrade / reject / missed).  ``task`` is the stream's
    # analytics task — mixed-task replays diff per task.
    "admission": frozenset({
        "t_s", "stream", "task", "frame_idx", "verdict", "backlog_s",
        "plan_cost_s", "degraded_cost_s", "slo_s"}),
    # one frame's requests entering the variant queues
    "emit": frozenset({
        "t_s", "stream", "task", "frame_idx", "n_requests", "plan_value",
        "variants"}),
    # the drain plan the schedule policy returned for one tick
    "policy_decision": frozenset({"tick", "t_s", "policy", "ops"}),
    # one batched forward booked on the event clock (launch half);
    # ``queue_delays`` is the per-request launch-minus-emission list
    "dispatch_launch": frozenset({
        "tick", "dispatch", "variant", "task", "b", "padded", "group",
        "n_devices", "cost_s", "launch_s", "emitted_s", "carried",
        "queue_delays"}),
    # its completion half (same ``dispatch`` id joins the two)
    "dispatch_complete": frozenset({
        "tick", "dispatch", "variant", "group", "complete_s", "cost_s"}),
    # requests left queued after a drain (async carry-over)
    "carry": frozenset({"tick", "t_s", "queued", "total"}),
    # an atomic replica-group rebalance (device counts after the swap)
    "rebalance": frozenset({"t_s", "groups"}),
    # the policy's close rule for one finished tick
    "tick_close": frozenset({
        "tick", "t_s", "charge_s", "next_start_s", "dispatches"}),
    # one frame finishing (post-NMS): the detection digest is what the
    # replay-determinism gate compares for drift
    "frame_finish": frozenset({
        "t_s", "stream", "task", "frame_idx", "event_e2e_s",
        "n_detections", "det_digest", "slo_violation"}),
    # fleet tier (repro.serving.fleet): one routing decision binding a
    # stream to a pod ("new" stream, "migrate" off a retired pod, or a
    # ring move after elastic scaling)
    "route": frozenset({"t_s", "stream", "pod", "reason"}),
    # fleet tier: one elastic-controller action ("grow"/"shrink") with
    # the sustained SLO pressure that triggered it
    "scale": frozenset({"t_s", "action", "pod", "n_pods", "pressure"}),
}


def validate_event(record: dict) -> dict:
    """Check one record against :data:`EVENT_FIELDS`; returns it."""
    kind = record.get("event")
    required = EVENT_FIELDS.get(kind)
    if required is None:
        raise ValueError(
            f"unknown telemetry event type {kind!r}; known types: "
            f"{sorted(EVENT_FIELDS)}")
    missing = required - record.keys()
    if missing:
        raise ValueError(
            f"telemetry event {kind!r} missing required keys "
            f"{sorted(missing)}")
    return record


def detections_digest(detections) -> str:
    """Deterministic digest of a frame's post-NMS detections.

    Hashes the exact float64 bytes of every box plus category and
    score, so the replay gate compares detections bit-for-bit without
    storing them (a 40-char line instead of kilobytes per frame)."""
    h = hashlib.sha1()
    for det in detections:
        h.update(np.asarray(det.box, dtype=np.float64).tobytes())
        h.update(int(det.category).to_bytes(8, "little", signed=True))
        h.update(np.float64(det.score).tobytes())
    return h.hexdigest()


class TelemetrySink:
    """The no-op default.  ``enabled`` gates payload construction: the
    server checks it before building per-event dicts (digests, delay
    lists), so an un-instrumented run does no telemetry work at all."""

    enabled = False

    def emit(self, event: str, **fields) -> None:
        pass

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class MemorySink(TelemetrySink):
    """Collect validated records in ``self.events`` (replay, tests)."""

    enabled = True

    def __init__(self):
        self.events: list[dict] = []

    def emit(self, event: str, **fields) -> None:
        self.events.append(validate_event({"event": event, **fields}))


class JsonlSink(TelemetrySink):
    """One JSON object per line at ``path`` — the durable event log.

    Floats serialise via ``repr`` (Python's default), which round-trips
    float64 exactly, so a log read back compares bit-identically to
    the in-memory record stream that produced it."""

    enabled = True

    def __init__(self, path):
        self.path = path
        self._f = open(path, "w")

    def emit(self, event: str, **fields) -> None:
        record = validate_event({"event": event, **fields})
        self._f.write(json.dumps(record, sort_keys=True) + "\n")

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def read_events(path) -> list[dict]:
    """Load a JSONL event log back into validated records."""
    out = []
    with open(path) as f:
        for line_no, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(validate_event(json.loads(line)))
            except (json.JSONDecodeError, ValueError) as exc:
                raise ValueError(
                    f"{path}:{line_no}: bad telemetry record: {exc}"
                ) from None
    return out


# ---------------------------------------------------------------------------
# offline report
# ---------------------------------------------------------------------------

# queueing-delay histogram edges (seconds); the last bucket is open
_DELAY_EDGES = (0.001, 0.01, 0.1, 1.0)


def _delay_histogram(delays) -> list[str]:
    labels = ["<1ms", "1-10ms", "10-100ms", "0.1-1s", ">=1s"]
    counts = [0] * len(labels)
    for d in delays:
        for i, edge in enumerate(_DELAY_EDGES):
            if d < edge:
                counts[i] += 1
                break
        else:
            counts[-1] += 1
    total = max(len(delays), 1)
    return [f"    {lab:>8}: {c:>6} ({c / total:.0%})"
            for lab, c in zip(labels, counts) if c]


def format_timeline_report(events) -> list[str]:
    """Human-readable summary lines computed from a log ALONE.

    Accepts the record list of :func:`read_events` / ``MemorySink``.
    Reports per-group utilisation (dispatch busy seconds over the
    ticks' charged seconds), the queueing-delay histogram over every
    dispatched request, and — when the log holds an open-loop run —
    the admission-verdict breakdown.  No server or stats object
    needed: this is the offline operator surface over the artifact the
    nightly CI uploads.
    """
    by_type: dict[str, list] = collections.defaultdict(list)
    for e in events:
        by_type[e["event"]].append(e)

    lines = []
    meta = by_type.get("run_meta")
    head = (f"[{meta[0]['policy'].get('name', '?')} policy, "
            f"{meta[0]['mode']}-loop, {meta[0]['n_streams']} streams] "
            if meta else "")
    lines.append(
        f"timeline {head}{len(events)} events: "
        f"{len(by_type.get('tick_close', []))} ticks, "
        f"{len(by_type.get('dispatch_launch', []))} dispatches, "
        f"{len(by_type.get('frame_finish', []))} frames finished")

    busy: dict[str, float] = {}
    delays: list[float] = []
    for d in by_type.get("dispatch_launch", ()):
        g = str(d["group"])
        busy[g] = busy.get(g, 0.0) + d["cost_s"]
        delays.extend(d["queue_delays"])
    tick_s = sum(t["charge_s"] for t in by_type.get("tick_close", ()))
    if busy:
        util = ", ".join(f"g{g}={b / tick_s:.0%}" if tick_s > 0 else f"g{g}=0%"
                         for g, b in sorted(busy.items()))
        lines.append(f"group utilisation over {tick_s:.2f} charged tick "
                     f"seconds: {util}")
    if delays:
        lines.append(f"queueing delay over {len(delays)} dispatched "
                     f"requests (mean {np.mean(delays) * 1e3:.1f}ms):")
        lines.extend(_delay_histogram(delays))

    verdicts = collections.Counter(
        a["verdict"] for a in by_type.get("admission", ()))
    if verdicts:
        breakdown = ", ".join(f"{v}={c}" for v, c in sorted(verdicts.items()))
        lines.append(
            f"admission verdicts over {sum(verdicts.values())} arrivals: "
            f"{breakdown}")

    finishes = by_type.get("frame_finish", ())
    if finishes:
        e2e = [f["event_e2e_s"] for f in finishes]
        viol = sum(1 for f in finishes if f["slo_violation"])
        lines.append(
            f"frame E2E: mean {np.mean(e2e):.3f}s  "
            f"p95 {np.percentile(e2e, 95):.3f}s  "
            f"p99 {np.percentile(e2e, 99):.3f}s  "
            f"({viol} SLO violations)")
    carries = by_type.get("carry", ())
    if carries:
        lines.append(
            f"carry-over: {len(carries)} ticks left work queued "
            f"(max {max(c['total'] for c in carries)} requests)")
    if by_type.get("rebalance"):
        lines.append(f"placement rebalances: {len(by_type['rebalance'])}")
    if by_type.get("route"):
        reasons = collections.Counter(
            r["reason"] for r in by_type["route"])
        lines.append(
            f"fleet routing over {len(by_type['route'])} decisions: "
            + ", ".join(f"{k}={c}" for k, c in sorted(reasons.items())))
    if by_type.get("scale"):
        acts = collections.Counter(s["action"] for s in by_type["scale"])
        lines.append(
            "fleet scaling: "
            + ", ".join(f"{k}={c}" for k, c in sorted(acts.items())))
    return lines
