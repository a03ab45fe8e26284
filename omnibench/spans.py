"""Host spans and counters the benchmark records from its own wrappers
around the program's public calls.

A wrapper is installed on the run's own instances (or, for a module
function the program looks up at call time, on that module for the run
only, and put back by :meth:`Spans.restore`).  Each call adds its wall
seconds to the current tick's total for its layer; during traced ticks
it also opens a ``torch.profiler.record_function`` range named
``omnibench.<layer>``, so the trace can say what the host was doing
while the device idled.
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch


class Spans:
    def __init__(self):
        self.tick = -1
        self.traced = False
        self.by_tick: dict[int, dict[str, float]] = {}
        self._restore: list = []

    def begin_tick(self, tick: int, traced: bool) -> None:
        self.tick = tick
        self.traced = traced
        self.by_tick.setdefault(tick, {})

    def add(self, layer: str, seconds: float) -> None:
        d = self.by_tick.setdefault(self.tick, {})
        d[layer] = d.get(layer, 0.0) + seconds

    @contextlib.contextmanager
    def span(self, layer: str):
        rf = (torch.profiler.record_function(f"omnibench.{layer}")
              if self.traced else contextlib.nullcontext())
        t = time.perf_counter()
        with rf:
            try:
                yield
            finally:
                self.add(layer, time.perf_counter() - t)

    def wrap(self, fn, layer: str):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            with self.span(layer):
                return fn(*args, **kwargs)
        return timed

    def on_instance(self, obj, method: str, layer: str) -> None:
        """Time ``obj.method`` (an attribute on the instance, which the
        program's own calls find first)."""
        setattr(obj, method, self.wrap(getattr(obj, method), layer))

    def on_module(self, module, name: str, wrapper) -> None:
        """Replace ``module.name`` for this run; :meth:`restore` puts the
        original back."""
        orig = getattr(module, name)
        self._restore.append((module, name, orig))
        setattr(module, name, wrapper(orig))

    def restore(self) -> None:
        for module, name, orig in reversed(self._restore):
            setattr(module, name, orig)
        self._restore.clear()

    def per_tick(self, layer: str, ticks) -> list[float]:
        """The layer's seconds in each of ``ticks`` (0 where it did not
        run)."""
        return [self.by_tick.get(t, {}).get(layer, 0.0) for t in ticks]
