"""Open-loop arrival-clocked traffic for the pod serving runtime.

Everything served before this module was CLOSED-loop: ``PodServer.step``
advanced one global ``frame_idx`` per tick, so every stream always had
a frame ready and the pod only ever saw exactly the load it could
clear.  Real cameras emit at ``1/fps`` over a shaped, jittery uplink,
users connect and drop, and load is diurnal/bursty — the open-loop
regime in which edge-analytics serving is actually judged (offered
load, not capacity, on the x-axis).

This module is the traffic side of that regime:

  * :class:`StreamClock` — one camera's emission clock.  Inter-arrival
    times are ``1/fps`` with seeded multiplicative lognormal jitter —
    the exact RNG discipline of
    :class:`repro.serving.network.NetworkModel` (``np.random.
    default_rng(seed)`` + ``exp(normal(0, jitter))``), so a jittery
    uplink and a jittery camera share one reproducibility story.
    Per-stream clocks are strictly monotone (jitter is multiplicative
    on a positive interval) and fully determined by ``(seed, stream)``.
  * :class:`ChurnEvent` — a connect/disconnect edge for one stream.  A
    disconnected camera emits nothing (its timeline keeps running; no
    frames are fabricated for the gap) and its per-stream frame index
    only advances on real emissions.
  * rate traces — piecewise-constant fps multipliers
    (``(t_start_s, scale)`` steps) model bursts and diurnal load
    without touching the per-stream clock discipline.
  * :class:`ArrivalProcess` — merges the per-stream clocks, churn and
    rate trace into one time-ordered :class:`Arrival` sequence over a
    horizon.  ``PodServer.run_open_loop`` consumes it: the event clock
    advances to the next arrival or completion, streams join/leave
    mid-run, and frames that miss their interval are counted, not
    fabricated.

The conservation law the property tests pin: every arrival is exactly
one of admitted / rejected (admission control) / missed (superseded in
the depth-1 camera buffer), and every admitted frame finishes.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One camera frame hitting the pod's front door.

    ``t_s`` is the absolute emission time on the event clock;
    ``frame_idx`` is the per-stream frame counter (only real emissions
    advance it, so simulation backends replay the right ground truth).
    """

    t_s: float
    stream: int
    frame_idx: int


@dataclasses.dataclass(frozen=True)
class ChurnEvent:
    """A connect (``connected=True``) or disconnect edge for a stream."""

    t_s: float
    stream: int
    connected: bool


class StreamClock:
    """One camera's emission clock: ``1/fps`` spacing, seeded jitter.

    ``next_arrival()`` returns strictly increasing times: the jitter is
    multiplicative lognormal on a positive base interval (the
    ``NetworkModel`` discipline), so no draw can stall or reverse the
    clock.  ``rate_trace`` is an optional sorted sequence of
    ``(t_start_s, scale)`` steps: the interval consumed at time ``t``
    is divided by the scale of the segment containing ``t`` (scale 2.0
    = a 2x burst; scale 0.5 = a lull).
    """

    def __init__(self, stream: int, fps: float, jitter: float = 0.0,
                 seed: int = 0, start_s: float = 0.0,
                 rate_trace: Sequence[tuple[float, float]] = ()):
        if fps <= 0:
            raise ValueError(f"fps must be > 0, got {fps}")
        if jitter < 0:
            raise ValueError(f"jitter must be >= 0, got {jitter}")
        for t, scale in rate_trace:
            if scale <= 0:
                raise ValueError(f"rate_trace scale must be > 0, got "
                                 f"{scale} at t={t}")
        self.stream = stream
        self.fps = fps
        self.jitter = jitter
        self.rate_trace = tuple(sorted(rate_trace))
        # per-stream derived seed: one process seed reproduces every
        # stream, and streams never share a jitter sequence
        self._rng = np.random.default_rng((seed, stream))
        self._t = start_s

    def _scale_at(self, t: float) -> float:
        scale = 1.0
        for t0, s in self.rate_trace:
            if t >= t0:
                scale = s
        return scale

    def next_arrival(self) -> float:
        """Advance to (and return) the next emission time."""
        dt = 1.0 / (self.fps * self._scale_at(self._t))
        if self.jitter > 0:
            dt *= float(np.exp(self._rng.normal(0.0, self.jitter)))
        self._t += dt
        return self._t


class ArrivalProcess:
    """Merged open-loop traffic over ``n_streams`` cameras.

    ``fps`` is a scalar (shared) or one value per stream; ``churn`` is
    a sequence of :class:`ChurnEvent` (a stream whose FIRST event is a
    connect starts disconnected — late joiners; otherwise streams start
    connected).  ``rate_trace`` applies to every stream.  Arrivals are
    materialised up to ``horizon_s`` and returned sorted by
    ``(t_s, stream)`` — deterministic under a fixed seed.
    """

    def __init__(self, n_streams: int, fps: float | Sequence[float] = 0.5,
                 jitter: float = 0.0, seed: int = 0, horizon_s: float = 30.0,
                 churn: Iterable[ChurnEvent] = (),
                 rate_trace: Sequence[tuple[float, float]] = (),
                 start_s: float = 0.0):
        if n_streams < 1:
            raise ValueError(f"n_streams must be >= 1, got {n_streams}")
        if horizon_s <= start_s:
            raise ValueError(
                f"horizon_s {horizon_s} must exceed start_s {start_s}")
        self.n_streams = n_streams
        self.fps = tuple(fps) if isinstance(fps, (tuple, list)) \
            else (float(fps),) * n_streams
        if len(self.fps) != n_streams:
            raise ValueError(
                f"got {len(self.fps)} fps values for {n_streams} streams")
        self.jitter = jitter
        self.seed = seed
        self.horizon_s = horizon_s
        self.start_s = start_s
        self.churn = tuple(sorted(churn, key=lambda e: (e.t_s, e.stream)))
        for e in self.churn:
            if not 0 <= e.stream < n_streams:
                raise ValueError(f"churn event for unknown stream {e.stream}")
        self.rate_trace = tuple(rate_trace)

    def _connected_intervals(self, stream: int) -> list[tuple[float, float]]:
        """The [on, off) windows of one stream over the horizon."""
        events = [e for e in self.churn if e.stream == stream]
        # a stream whose first churn edge is a CONNECT is a late joiner
        connected = not (events and events[0].connected)
        t_on = self.start_s
        out = []
        for e in events:
            if e.connected and not connected:
                connected, t_on = True, e.t_s
            elif not e.connected and connected:
                connected = False
                if e.t_s > t_on:
                    out.append((t_on, e.t_s))
        if connected:
            out.append((t_on, self.horizon_s))
        return out

    def arrivals(self) -> list[Arrival]:
        """The full traffic trace, sorted by ``(t_s, stream)``."""
        out: list[Arrival] = []
        for s in range(self.n_streams):
            clock = StreamClock(s, self.fps[s], self.jitter, self.seed,
                                self.start_s, self.rate_trace)
            windows = self._connected_intervals(s)
            frame_idx = 0
            t = clock.next_arrival()
            while t < self.horizon_s:
                # the camera timeline keeps running while disconnected;
                # only frames emitted inside an ON window exist
                if any(lo <= t < hi for lo, hi in windows):
                    out.append(Arrival(t_s=t, stream=s, frame_idx=frame_idx))
                    frame_idx += 1
                t = clock.next_arrival()
        out.sort(key=lambda a: (a.t_s, a.stream))
        return out

    def offered_rate(self) -> float:
        """Offered load in frames per second over the horizon."""
        return len(self.arrivals()) / (self.horizon_s - self.start_s)


def split_arrivals(arrivals: Iterable[Arrival],
                   assignment: dict[int, int]) -> dict[int, list[Arrival]]:
    """Partition a time-ordered arrival trace per pod.

    ``assignment`` maps stream -> pod id (the fleet router's binding
    table).  Each pod's sub-trace keeps the global order, so driving
    every sub-trace through its own ``PodServer.run_open_loop`` is
    equivalent to the fleet's batched round-robin when the assignment
    is static.  Raises on a stream the assignment does not cover —
    silently dropping traffic would break the fleet conservation law
    (``arrivals == sum(per-pod admitted + rejected + missed)``).
    """
    out: dict[int, list[Arrival]] = {}
    for a in arrivals:
        try:
            pod = assignment[a.stream]
        except KeyError:
            raise ValueError(
                f"arrival for stream {a.stream} has no pod assignment"
            ) from None
        out.setdefault(pod, []).append(a)
    return out


def arrivals_from_records(records) -> list[Arrival]:
    """Rebuild a time-ordered :class:`Arrival` list from telemetry
    ``arrival`` records (``repro.serving.telemetry``).

    This is the replay harness's traffic source: instead of
    regenerating an :class:`ArrivalProcess` from its seed, the replay
    re-drives the EXACT arrivals a recorded run saw (float64 times
    round-trip JSON exactly), so churn and rate traces are baked into
    the trace and never need reconstructing.  Records of other event
    types are ignored, so a whole event log can be passed verbatim.
    """
    out = [Arrival(t_s=r["t_s"], stream=r["stream"],
                   frame_idx=r["frame_idx"])
           for r in records if r.get("event", "arrival") == "arrival"]
    out.sort(key=lambda a: (a.t_s, a.stream))
    return out
