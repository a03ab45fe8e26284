"""The benchmark's driver: finds a cell by name, builds its pod, warms it
up, measures whole ticks for the window, checks what the timed path
produced against the plain reference, and assembles the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file found by name:

* ``BENCHMARK.json`` (the checkout's root) lists the cells, the
  configurations' files and the metrics;
* ``omnibench/configs/<config>.json``: the configuration, whose ``pod``
  names the module ``omnibench/pods/<pod>.py`` that builds it;
* ``omnibench/workloads/<traffic>.json``: the traffic mix, read by the
  one generator in ``omnibench/traffic.py``;
* ``omnibench/metrics/<metric>.py``: a reader ``read(run)`` of one
  metric, which returns ``None`` where it finds nothing to read.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from omnibench import trace as trace_mod
from omnibench.spans import Spans
from omnibench.traffic import run_window

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.root / "omnibench" / "workloads"
                           / f"{name}.json").read_text())

    def metrics(self, cell: str, traced: bool) -> list[dict]:
        """The cell's end-to-end metrics, or with ``traced`` its per-layer
        ones (those that list it, or with no list, every cell that
        reports the end-to-end metric they move)."""
        e2e = [m for m in self.spec["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if not traced:
            return e2e
        mine = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in mine
                                 else [])]

    def reader(self, metric: str):
        path = self.root / "omnibench" / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"omnibench_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


class Run:
    """What a metric reader reads."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def timed_ticks(self):
        """Window ticks that ran without the profiler."""
        return [t for t in self.window.ticks if not t.traced]


def forbidden_modules() -> list[str]:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def sample_ticks(seed: int, traffic: dict) -> list[int]:
    """The window ticks whose output is checked, drawn from the seed."""
    rng = np.random.default_rng([seed, 7])
    within = int(traffic["check_within"])
    k = min(int(traffic["check_ticks"]), within)
    return sorted(int(t) for t in rng.choice(within, size=k, replace=False))


def run_cell(root, cell_name: str, seed: int, seconds: float, traced: bool,
             *, device="cuda", t_start: float | None = None, log=None,
             fault=None, max_ticks: int | None = None,
             controls: dict | None = None,
             scene_key: int | None = None) -> tuple[dict, list]:
    """Run one cell; returns (the result line's object, the compared
    numbers as (name, value, limit) rows).  ``fault(pod)``, for tests,
    breaks the timed path underneath before the window; ``max_ticks``
    ends a closed-loop window after that many ticks; ``controls`` maps a
    name to a ``produce`` that puts another computation in the program's
    place (``omnibench/control.py``), each judged on the same frames,
    its rows under ``result["controls"][name]``; ``scene_key`` replaces
    the traffic's (``omnibench/control.py`` reads other scenes)."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    bench = Bench(root)
    cell = bench.cell(cell_name)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    if scene_key is not None:
        traffic["scene_key"] = int(scene_key)
    pod_mod = importlib.import_module(f"omnibench.pods.{config['pod']}")
    spans = Spans()
    pod = pod_mod.Pod(config, traffic, seed, device, spans, log=log)
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    pod.warm_shapes()
    warm = int(traffic["warm_ticks"])
    for i in range(warm):
        spans.begin_tick(i, False)
        pod.step(i, [i] * pod.n)
    if fault is not None:
        fault(pod)
    sample = sample_ticks(seed, traffic)
    pod.capture_ticks = {warm + t for t in sample}
    trace_from = int(traffic["trace_from"])
    trace_to = trace_from + int(traffic["trace_ticks"]) if traced else -1
    prof = trace_mod.profiler() if traced else None
    state = dict(on=False)

    def step(i: int, frames: list[int]) -> bool:
        # the profiler starts inside the first traced tick and stops inside
        # the last, so that no untimed tick pays for either
        tr = trace_from <= i < trace_to
        if tr and not state["on"]:
            prof.__enter__()
            state["on"] = True
        spans.begin_tick(warm + i, tr)
        if tr:
            with torch.profiler.record_function("omnibench.tick"):
                pod.step(warm + i, frames)
        else:
            pod.step(warm + i, frames)
        if state["on"] and i + 1 >= trace_to:
            prof.__exit__(None, None, None)
            state["on"] = False
        return tr

    setup_s = time.perf_counter() - t_start
    window = run_window(step, pod.n, traffic, seconds, seed, warm,
                        max_ticks)
    if state["on"]:
        prof.__exit__(None, None, None)
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)
    peak = (torch.cuda.max_memory_allocated() if device != "cpu" else 0)
    red = trace_mod.reduce(prof) if traced else None
    run = Run(window=window, spans=spans, pod=pod, config=config,
              traffic=traffic, setup_s=setup_s, trace=red,
              flops={t.index: pod.tick_flops(t.index) for t in window.ticks})
    metrics = {}
    for m in bench.metrics(cell_name, traced):
        v = bench.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    counters = pod.counters()
    for tk in window.ticks:
        sp = spans.by_tick.get(tk.index, {})
        log(f"tick {tk.index}: wall {tk.wall * 1e3:.1f} ms"
            f"{' (traced)' if tk.traced else ''}; {pod.describe_tick(tk.index)}"
            f"; spans ms " + ", ".join(f"{k} {v * 1e3:.1f}"
                                      for k, v in sorted(sp.items())))
    pod.release()
    t = time.perf_counter()
    checked = [warm + s for s in sample]
    judge = pod_mod.check(pod, checked)
    log(f"check of ticks {checked}: {judge.compared} in "
        f"{time.perf_counter() - t:.1f}s; widest crop gap "
        f"{judge.worst_crop}; widest box gap {judge.worst_box}; "
        f"counters {counters}")
    rows = judge.rows()
    ctrl_rows = {}
    for name, produce in (controls or {}).items():
        t = time.perf_counter()
        ctrl = pod_mod.check(pod, checked, produce=produce)
        ctrl_rows[name] = ctrl.rows()
        log(f"control {name}: {ctrl.compared} in "
            f"{time.perf_counter() - t:.1f}s")
    served = sum(tk.frames for tk in window.ticks)
    result = {
        "correct": judge.correct(),
        "attempted": int(window.arrived),
        "failed": int(window.arrived - served),
        "metrics": metrics,
        "device": device_info(device, peak),
    }
    if traced:
        result["device"]["busy_s"] = red["busy_s"]
        result["device"]["window_s"] = red["window_s"]
        result["breakdown"] = trace_mod.breakdown(red)
    if controls:
        result["controls"] = {n: {k: v for k, v, _ in r}
                              for n, r in ctrl_rows.items()}
    result["compared"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result, rows


class ForbiddenModules(RuntimeError):
    def __init__(self, found):
        super().__init__(f"the run loaded {', '.join(found)}")
        self.found = found


def device_info(device, peak: int) -> dict:
    """The result's ``device``: every cell runs on one card."""
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(peak)}
