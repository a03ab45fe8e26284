"""One camera's emission clock: a frozen copy of
``repro_torch.serving.traffic.StreamClock`` (``1/fps`` spacing,
multiplicative lognormal jitter, per-stream derived seed), so that later
changes to the port cannot move the camera cell's arrivals."""

from __future__ import annotations

from typing import Sequence

import numpy as np


class StreamClock:
    def __init__(self, stream: int, fps: float, jitter: float = 0.0,
                 seed: int = 0, start_s: float = 0.0,
                 rate_trace: Sequence[tuple[float, float]] = ()):
        if fps <= 0:
            raise ValueError(f"fps must be > 0, got {fps}")
        if jitter < 0:
            raise ValueError(f"jitter must be >= 0, got {jitter}")
        self.stream = stream
        self.fps = fps
        self.jitter = jitter
        self.rate_trace = tuple(sorted(rate_trace))
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
