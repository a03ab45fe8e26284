"""Network model + passive bandwidth profiling (paper sections IV-C, V-B).

The paper shapes the mobile uplink to 17.9 Mbps (average US 5G upload,
T-Mobile / Opensignal Jan-2022) with Linux ``tc`` and estimates delivery
delays with an *online passive* profiler: the edge server keeps the
mean delivery delay of the most recent omega (=7) requests per model
and piggybacks the update on the detection results.

``NetworkModel`` simulates the shaped link (with optional jitter and a
time-varying trace for the sensitivity study); ``PassiveProfiler`` is
the omega-window estimator the allocator consults.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np

PAPER_UPLINK_MBPS = 17.9


@dataclasses.dataclass
class NetworkModel:
    bandwidth_mbps: float = PAPER_UPLINK_MBPS
    rtt_s: float = 0.010
    jitter: float = 0.0  # multiplicative stddev on each transfer
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def delivery_delay(self, n_bytes: float) -> float:
        t = self.rtt_s + n_bytes * 8.0 / (self.bandwidth_mbps * 1e6)
        if self.jitter > 0:
            t *= float(np.exp(self._rng.normal(0.0, self.jitter)))
        return t

    def set_bandwidth(self, mbps: float) -> None:
        """tc-style reshaping (used by the Fig. 9b sensitivity sweep)."""
        self.bandwidth_mbps = mbps


class PassiveProfiler:
    """Sliding mean of the last omega delivery delays per model."""

    def __init__(self, omega: int = 7, initial_s: float = 0.3,
                 rtt_s: float = 0.0):
        self.omega = omega
        self.initial_s = initial_s
        # the link's fixed round-trip floor: observed delays include it,
        # but it does not scale with payload size, so rescaling an
        # estimate to a different payload must hold it constant
        self.rtt_s = rtt_s
        self._window: dict[str, collections.deque] = {}

    def observe(self, model_name: str, delay_s: float) -> None:
        w = self._window.setdefault(
            model_name, collections.deque(maxlen=self.omega))
        w.append(delay_s)

    def estimate(self, model_name: str) -> float:
        w = self._window.get(model_name)
        if not w:
            return self.initial_s
        return float(np.mean(w))

    def scale_estimate(self, model_name: str, ref_bytes: float,
                       new_bytes: float) -> float:
        """Estimate for a different payload size.

        Only the bandwidth term of a delivery delay is linear in bytes;
        the ``rtt_s`` round-trip floor is payload-invariant.  Scaling
        the whole mean (the old behaviour) shrank the RTT along with
        the payload and underpriced small transfers — a zero-byte
        estimate went to 0 instead of to the RTT floor.
        """
        base = self.estimate(model_name)
        if ref_bytes <= 0:
            return base
        bw = max(0.0, base - self.rtt_s)
        return self.rtt_s + bw * new_bytes / ref_bytes
