"""Spherical object discovery (paper section IV-A, last paragraph).

Relying solely on historical detections can cascade: a tight budget
forces cheap models -> fewer detections -> fewer predicted SRoIs ->
even fewer detections.  The discovery mechanism breaks the circle by
opportunistically spending *underutilised* budget on a full-ERP
inference at the server; its detections are converted to SphBBs and
appended to the history used for the next frame's SRoI prediction.

Trigger: the number of predicted SRoIs has been below ``min_srois``
for ``patience`` consecutive frames AND the current plan leaves at
least ``min_slack`` of the budget unused (or the frame has no SRoIs at
all — e.g. the very first frame).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class DiscoveryState:
    min_srois: int = 2
    patience: int = 3
    min_slack: float = 0.15  # fraction of budget that must be free
    low_fraction: float = 0.6  # "consistently low" = below this x peak
    low_streak: int = 0
    peak_srois: int = 0
    cooldown: int = 0  # frames to wait after a discovery pass
    cooldown_frames: int = 5

    def observe(self, n_srois: int) -> None:
        self.peak_srois = max(self.peak_srois, n_srois)
        # "consistently low" is relative to what the stream usually
        # yields: an absolute floor plus a fraction of the peak (moving
        # cameras lose regions permanently without re-exploration).
        threshold = max(self.min_srois, self.low_fraction * self.peak_srois)
        if n_srois < threshold:
            self.low_streak += 1
        else:
            self.low_streak = 0
        if self.cooldown > 0:
            self.cooldown -= 1

    def should_discover(self, budget: float, plan_latency: float) -> bool:
        if self.cooldown > 0:
            return False
        slack_ok = (budget - plan_latency) >= self.min_slack * budget
        trigger = self.low_streak >= self.patience or plan_latency == 0.0
        if trigger and slack_ok:
            self.cooldown = self.cooldown_frames
            self.low_streak = 0
            return True
        return False
