"""Wall-clock spans and counters of the serving tick.

One process-wide recorder, always on.  ``PodServer.step`` opens a tick
(:func:`begin_tick`, numbered by the frame index it serves) and closes
it when the step returns; the code the tick runs marks its layers with
:class:`span` and counts its work with :func:`count` at the line that
does it (host-device syncs, bytes uploaded and copied back, detector
forwards, kernel launches).  A span records its name, its start and end
on ``time.perf_counter_ns()``, the index of the span open around it in
the same tick (its parent) and a key that joins spans of one item: the
stream for per-frame spans, the chunk's number within the tick for the
drain's.  A span opened outside a tick is not kept; a count outside a
tick still adds to the cumulative totals (:func:`totals`), which the
kernels' launch counts (``kernels/_build.py``) read.  A count that sits
on the device (:func:`count_later`) waits until the caller next reads
the device anyway, and :func:`flush_counts` brings every such count
over in one copy.

The recorder keeps the last :data:`MAX_TICKS` ticks, so a long-lived
server does not grow.  It is meant for one thread, the one that runs
the pod's step, as the step itself is: spans from two threads at once
would nest into each other's trees.

Each tick stores one anchor pair, ``(time.time_ns(),
time.perf_counter_ns())``, taken when it opens (:func:`_anchor`: the
two clocks read as nearly at one instant as three tries give);
:func:`tick_spans` maps
the stamps through it to Unix-epoch nanoseconds, the clock of
``torch.profiler``'s events (``kineto_results.trace_start_ns() + 1000 *
event.time_range.start``), so a span can be laid over a device trace.
The recorder opens no ``torch.profiler.record_function`` range: the
device trace of a profiled run holds only what the program launched.

This lives apart from ``serving/telemetry.py``: the event log carries
only event-clock quantities, so that a replay can be compared with its
recording bit for bit, and wall-clock time would break that.
"""

from __future__ import annotations

import time
from typing import NamedTuple

MAX_TICKS = 256

_now = time.perf_counter_ns


class Span(NamedTuple):
    """One recorded span; ``end_ns`` is None while it is open."""

    name: str
    start_ns: int
    end_ns: int | None
    parent: int | None
    key: object


def _anchor() -> tuple[int, int]:
    """A ``(time.time_ns(), time.perf_counter_ns())`` pair read at one
    instant: of three reads of the wall clock, each between two reads of
    the performance counter, the one whose two reads lie closest
    together, paired with their midpoint.  A thread preempted between
    the two clocks would shift every mapped stamp of the tick by the
    length of the preemption; the closest bracket bounds that shift."""
    best = None
    for _ in range(3):
        a = _now()
        wall = time.time_ns()
        b = _now()
        if best is None or b - a < best[0]:
            best = (b - a, wall, (a + b) // 2)
    return best[1], best[2]


class _Tick:
    __slots__ = ("anchor", "spans", "open", "counters", "seqs")

    def __init__(self):
        self.anchor = _anchor()
        self.spans: list[list] = []  # [name, start, end, parent, key]
        self.open: list[int] = []  # indices of the open spans, innermost last
        self.counters: dict[str, int] = {}
        self.seqs: dict[str, int] = {}


_ticks: dict = {}  # tick -> _Tick, oldest first
_current: _Tick | None = None
_totals: dict[str, int] = {}
_later: dict[str, list] = {}  # name -> device scalars not yet counted


class span:
    """``with span(name, key):`` records the block as one span of the
    current tick (nothing outside a tick)."""

    __slots__ = ("_name", "_key", "_tick", "_rec")

    def __init__(self, name: str, key=None):
        self._name = name
        self._key = key

    def __enter__(self):
        t = self._tick = _current
        if t is not None:
            stack = t.open
            rec = self._rec = [self._name, 0, None,
                               stack[-1] if stack else None, self._key]
            stack.append(len(t.spans))
            t.spans.append(rec)
            rec[1] = _now()
        return self

    def __exit__(self, *exc):
        end = _now()
        t = self._tick
        if t is not None:
            self._rec[2] = end
            t.open.pop()
        return False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``: the current tick's and the
    cumulative total."""
    _totals[name] = _totals.get(name, 0) + n
    t = _current
    if t is not None:
        c = t.counters
        c[name] = c.get(name, 0) + n


def to_host(tensor):
    """``tensor.cpu().numpy()``, counted as one host sync (the host
    waits for the device's queue up to the copy) and its bytes as
    ``d2h_bytes``."""
    out = tensor.cpu().numpy()
    count("host_syncs")
    count("d2h_bytes", out.nbytes)
    return out


def count_later(name: str, n) -> None:
    """Add the device scalar ``n`` to counter ``name`` at the next
    :func:`flush_counts` (reading it now would wait for the device)."""
    _later.setdefault(name, []).append(n)


def flush_counts() -> None:
    """Count every :func:`count_later` scalar since the last flush, in
    the current tick, with one copy to the host."""
    if not _later:
        return
    import torch

    names = list(_later)
    sums = to_host(torch.stack([torch.stack(_later[k]).sum()
                                for k in names]))
    _later.clear()
    for k, v in zip(names, sums):
        count(k, int(v))


def seq(name: str) -> int | None:
    """The next number of ``name`` in the current tick, from 0 (the
    drain's chunk keys); None outside a tick."""
    t = _current
    if t is None:
        return None
    n = t.seqs.get(name, 0)
    t.seqs[name] = n + 1
    return n


def begin_tick(tick) -> None:
    """Open tick ``tick`` (replacing a kept tick of that number) and
    drop the oldest beyond :data:`MAX_TICKS`."""
    global _current
    _ticks.pop(tick, None)
    _current = _ticks[tick] = _Tick()
    while len(_ticks) > MAX_TICKS:
        del _ticks[next(iter(_ticks))]


def end_tick() -> None:
    """Close the current tick: later spans are not kept."""
    global _current
    _current = None


def ticks() -> list:
    """The kept ticks, oldest first."""
    return list(_ticks)


def tick_spans(tick) -> list[Span]:
    """Tick ``tick``'s spans in the order they opened, their stamps in
    Unix-epoch nanoseconds (the profiler's clock; see the module
    docstring); [] for a tick not kept."""
    t = _ticks.get(tick)
    if t is None:
        return []
    wall, perf = t.anchor
    shift = wall - perf
    return [Span(name, start + shift, None if end is None else end + shift,
                 parent, key)
            for name, start, end, parent, key in t.spans]


def tick_totals(tick) -> dict[str, tuple[float, float, int]]:
    """``{name: (seconds, self seconds, calls)}`` over tick ``tick``'s
    closed spans; a span's self time is its duration less its child
    spans'.  {} for a tick not kept."""
    t = _ticks.get(tick)
    if t is None:
        return {}
    spans = t.spans
    inner = [0] * len(spans)
    for name, start, end, parent, _ in spans:
        if end is not None and parent is not None:
            inner[parent] += end - start
    out: dict[str, list] = {}
    for i, (name, start, end, _, _) in enumerate(spans):
        if end is None:
            continue
        acc = out.setdefault(name, [0, 0, 0])
        acc[0] += end - start
        acc[1] += end - start - inner[i]
        acc[2] += 1
    return {k: (v[0] * 1e-9, v[1] * 1e-9, v[2]) for k, v in out.items()}


def tick_counters(tick) -> dict[str, int]:
    """Tick ``tick``'s counters; {} for a tick not kept."""
    t = _ticks.get(tick)
    return dict(t.counters) if t is not None else {}


def totals() -> dict[str, int]:
    """The cumulative counters of the process."""
    return dict(_totals)


def reset_totals(prefix: str) -> None:
    """Drop the cumulative counters whose names start with ``prefix``."""
    for k in [k for k in _totals if k.startswith(prefix)]:
        del _totals[k]


def reset() -> None:
    """Forget every tick and counter (tests)."""
    global _current
    _ticks.clear()
    _totals.clear()
    _later.clear()
    _current = None
