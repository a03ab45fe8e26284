"""The device trace of a few steady ticks, reduced to what the per-layer
readers and the result's ``breakdown`` need.

``torch.profiler`` records the host's ``omnibench.*`` ranges (the spans'
``record_function`` ranges and one ``omnibench.tick`` a tick) and every
device operation.  :func:`reduce` turns that into: the traced window
(first tick start to last tick end, on the trace's clock), the union of
device-busy intervals inside it, device time by operation name, device
time inside each host range, and the idle gaps attributed to the host
range that was open while the device idled.
"""

from __future__ import annotations

import bisect

import torch
from torch.autograd import DeviceType

HOST_PREFIX = "omnibench."


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(prof) -> dict:
    """The trace's numbers; times in seconds (all 0 where the profiler
    never ran)."""
    ops, ranges = [], {}
    by_name: dict[str, float] = {}
    events = prof.events() if prof.profiler is not None else []
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith(HOST_PREFIX):
                continue  # the host ranges' shadows on the device timeline
            ops.append((tr.start, tr.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + (tr.end - tr.start)
        elif e.name.startswith(HOST_PREFIX):
            ranges.setdefault(e.name[len(HOST_PREFIX):], []).append(
                (tr.start, tr.end, e))
    ticks = ranges.get("tick", [])
    out = dict(window_s=0.0, busy_s=0.0, device_ops={}, in_range={},
               idle_by_host={}, n_ops=len(ops), n_ticks=len(ticks))
    if not ticks:
        return out
    lo = min(t[0] for t in ticks)
    hi = max(t[1] for t in ticks)
    busy = [[max(a, lo), min(b, hi)] for a, b in _merge(ops)
            if b > lo and a < hi]
    out["window_s"] = (hi - lo) * 1e-6
    out["busy_s"] = sum(b - a for a, b in busy) * 1e-6
    out["device_ops"] = {k: v * 1e-6 for k, v in by_name.items()}
    # device time of the kernels launched inside each host range
    for name, rs in ranges.items():
        if name != "tick":
            out["in_range"][name] = sum(e.device_time_total
                                        for _, _, e in rs) * 1e-6
    # idle gaps, each attributed to the innermost host range open at its
    # middle (the tick's own range where no other is)
    gaps = []
    prev = lo
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if hi > prev:
        gaps.append((prev, hi))
    spans = sorted((a, b, name) for name, rs in ranges.items()
                   for a, b, _ in rs if name not in ("tick", "detector"))
    starts = [s[0] for s in spans]
    idle: dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) / 2
        k = bisect.bisect_right(starts, mid)
        owner = "other host work"
        best = None
        for s0, s1, name in spans[max(0, k - 64):k]:
            if s0 <= mid <= s1 and (best is None or s0 >= best):
                owner, best = name, s0
        idle[owner] = idle.get(owner, 0.0) + (b - a) * 1e-6
    out["idle_by_host"] = idle
    return out


def breakdown(red: dict) -> dict:
    top = sorted(red["device_ops"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(red["idle_by_host"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gaps]}
