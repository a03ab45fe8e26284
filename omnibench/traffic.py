"""The one traffic generator: it reads a traffic mix's parameters
(``omnibench/workloads/<traffic>.json``) and drives a pod's ticks.

``closed``: ticks back to back; each tick serves the next pooled frame
of every stream.

``camera``: open loop.  Each stream is a camera on its own
``StreamClock`` (``fps``, lognormal ``jitter``, seeded from the run's
seed), started at the window's start.  Under the sync barrier a tick
starts once the previous tick has ended and every stream holds a frame
it has not served; each stream serves its newest frame, and a frame
superseded before any tick took it is dropped.  A served frame's latency
runs from its due time on the camera clock to the end of the tick that
served it.
"""

from __future__ import annotations

import time

from omnibench.reference.clock import StreamClock


class Tick:
    __slots__ = ("index", "start", "end", "frames", "due", "traced")

    def __init__(self, index, start, end, frames, due=None, traced=False):
        self.index, self.start, self.end = index, start, end
        self.frames, self.due, self.traced = frames, due, traced

    @property
    def wall(self) -> float:
        return self.end - self.start


class Window:
    """What one window of ticks served."""

    def __init__(self, kind: str):
        self.kind = kind
        self.ticks: list[Tick] = []
        self.latencies: list[float] = []
        self.arrived = 0
        self.dropped = 0
        self.start = 0.0
        self.end = 0.0


def run_window(step, n: int, traffic: dict, seconds: float, seed: int,
               first: int, max_ticks: int | None = None) -> Window:
    """Drive ``n`` streams for ``seconds`` of whole ticks (or for
    ``max_ticks`` ticks where given).  ``step(i,
    frames)`` serves window tick ``i``, stream ``s`` its camera's frame
    number ``frames[s]`` (the pool is cycled from ``first`` on), and
    returns whether the tick was traced."""
    loop = traffic["loop"]
    if loop == "closed":
        return _closed(step, n, seconds, first, max_ticks)
    if loop == "camera":
        return _camera(step, n, traffic, seconds, seed, first, max_ticks)
    raise ValueError(f"unknown loop {loop!r}")


def _closed(step, n, seconds, first, max_ticks) -> Window:
    win = Window("closed")
    win.start = time.perf_counter()
    i = 0
    while (i < max_ticks if max_ticks is not None
           else time.perf_counter() - win.start < seconds):
        t0 = time.perf_counter()
        traced = step(i, [first + i] * n)
        t1 = time.perf_counter()
        win.ticks.append(Tick(first + i, t0, t1, n, traced=traced))
        win.arrived += n
        i += 1
    win.end = time.perf_counter()
    return win


def _camera(step, n, traffic, seconds, seed, first, max_ticks) -> Window:
    win = Window("camera")
    clocks = [StreamClock(s, traffic["fps"], traffic["jitter"], seed=seed)
              for s in range(n)]
    # per stream: due times of arrived but unserved frames, and the count
    # of frames the camera has emitted
    pending: list[list[float]] = [[] for _ in range(n)]
    nxt = [c.next_arrival() for c in clocks]
    emitted = [0] * n
    win.start = time.perf_counter()

    def arrivals(now_rel: float) -> None:
        for s in range(n):
            while nxt[s] <= now_rel:
                pending[s].append(nxt[s])
                emitted[s] += 1
                nxt[s] = clocks[s].next_arrival()

    i = 0
    while max_ticks is None or i < max_ticks:
        now = time.perf_counter() - win.start
        if now >= seconds:
            break
        arrivals(now)
        # wait until every stream holds an unserved frame
        wait = max((nxt[s] for s in range(n) if not pending[s]),
                   default=now)
        if wait >= seconds:
            break
        if wait > now:
            time.sleep(wait - now)
            arrivals(wait)
            now = max(wait, time.perf_counter() - win.start)
            arrivals(now)
        due = []
        frames = []
        for s in range(n):
            win.dropped += len(pending[s]) - 1
            due.append(pending[s][-1])
            frames.append(first + emitted[s] - 1)
            pending[s] = []
        t0 = time.perf_counter()
        traced = step(i, frames)
        t1 = time.perf_counter()
        win.ticks.append(Tick(first + i, t0, t1, n,
                              due=[win.start + d for d in due],
                              traced=traced))
        win.latencies += [t1 - (win.start + d) for d in due]
        i += 1
    win.end = time.perf_counter()
    # offered: every frame a tick served or superseded (a frame still
    # waiting when the window closed was neither)
    win.arrived = sum(len(t.due or ()) for t in win.ticks) + win.dropped
    return win
