"""The plan of one frame, worked out again: SRoI prediction, the
content-specific accuracy matrix, the latency model's delay matrices,
the pipelined knapsack (Algorithm 2) and the discovery trigger.

Frozen copies of ``repro_torch.core.{accuracy,allocation,discovery}``,
the parts of ``repro_torch.serving.{profiles,network,scheduler}`` that
price a frame (``paper_profile``, ``make_ladder``, the latency model's
``delays``), and the loop's ``frame_context``.  Plain NumPy in float64;
imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from omnibench.reference import sroi

N_CATEGORIES = 80

# the paper's Table II ladder as the latency model sees it: (name, input
# size, width multiplier, depth multiplier, P6 head)
PAPER_LADDER = (
    ("yolo-tiny-416", 416, 0.25, 0.34, False),
    ("yolo-csp-512", 512, 0.50, 0.50, False),
    ("yolo-csp-640", 640, 0.50, 0.50, False),
    ("yolo-p5-896", 896, 1.00, 0.67, False),
    ("yolo-p6-1280", 1280, 1.00, 1.00, True),
)
_MOBILE_EFF = 0.14e12
_EDGE_EFF = 3.4e12
PROJECT_S_PER_MPIX = 0.055
ENCODE_S_PER_MPIX = 0.080
BYTES_PER_PIXEL = 1.5
UPLINK_MBPS = 17.9
RTT_S = 0.010


@dataclasses.dataclass(frozen=True)
class Variant:
    name: str
    index: int
    input_size: int
    location: str
    gav: np.ndarray
    infer_s: float


def _width(base: int, mult: float, k: int) -> int:
    return max(16, int(base * mult * k) // 16 * 16)


def pricing_flops(size: int, width_mult: float, depth_mult: float,
                  p6: bool) -> float:
    """The latency model's FLOP estimate of one image (the program's
    ``flops_per_image``: the backbone only).  It prices the plan; the
    benchmark's own count of the work is ``omnibench.flops``."""
    def w(k):
        return _width(64, width_mult, k)
    depth = max(1, round(3 * depth_mult))
    n_scales = 4 if p6 else 3
    s = size
    total = 0.0
    total += (s / 2) ** 2 * 9 * 3 * w(1)
    total += (s / 4) ** 2 * 9 * w(1) * w(2) // 2
    res = s / 4
    c_prev = w(2) // 2
    for i in range(n_scales):
        c = w(2 ** (i + 1))
        res /= 2
        total += res ** 2 * 9 * c_prev * c
        half = c // 2
        total += res ** 2 * (2 * c * half + c * c)
        total += depth * res ** 2 * (half * half + 9 * half * half)
        c_prev = c
    return float(total * 2)


def synthetic_gav_table(n_models: int = 5, n_categories: int = N_CATEGORIES,
                        seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    cat_bias = rng.uniform(0.7, 1.0, size=n_categories)
    base = np.array([0.08, 0.30, 0.45])
    gain = np.array([0.14, 0.08, 0.05])
    tables = []
    for i in range(n_models):
        levels = np.clip(base + gain * i, 0.0, 0.95)
        tables.append(np.concatenate([levels[k] * cat_bias for k in range(3)]))
    return tables


def make_ladder(n_categories: int = N_CATEGORIES) -> list[Variant]:
    gavs = synthetic_gav_table(len(PAPER_LADDER), n_categories, 0)
    locations = ["device", "edge", "edge", "edge", "edge"]
    out = []
    for i, (name, size, wm, dm, p6) in enumerate(PAPER_LADDER):
        eff = _MOBILE_EFF if i == 0 else _EDGE_EFF
        out.append(Variant(name, i + 1, size, locations[i], gavs[i],
                           float(pricing_flops(size, wm, dm, p6) / eff)))
    return out


def _pre(v: Variant) -> float:
    mpix = v.input_size ** 2 / 1e6
    t = PROJECT_S_PER_MPIX * mpix
    if v.location != "device":
        t += ENCODE_S_PER_MPIX * mpix
    return t


def _inf(v: Variant) -> float:
    t = v.infer_s
    if v.location != "device":
        n_bytes = v.input_size ** 2 * BYTES_PER_PIXEL
        t += RTT_S + n_bytes * 8.0 / (UPLINK_MBPS * 1e6)
    return t


def delays(n_srois: int, variants) -> tuple[np.ndarray, np.ndarray]:
    """The (1 + M, R) preprocessing and inference delays (row 0: skip)."""
    m = len(variants)
    d_pre = np.zeros((1 + m, n_srois))
    d_inf = np.zeros((1 + m, n_srois))
    for i, v in enumerate(variants):
        d_pre[1 + i, :] = _pre(v)
        d_inf[1 + i, :] = _inf(v)
    return d_pre, d_inf


def weighted_acc(srois, variants) -> np.ndarray:
    m, r = len(variants), len(srois)
    out = np.zeros((1 + m, r), dtype=np.float64)
    for j, s in enumerate(srois):
        for i, v in enumerate(variants):
            out[1 + i, j] = s.alpha * float(np.dot(v.gav, s.ccv))
    return out


@dataclasses.dataclass(frozen=True)
class Plan:
    value: float
    t_pre: float
    t_done: float
    models: tuple[int, ...]


def _prune_dominated(plans: list[Plan]) -> list[Plan]:
    plans.sort(key=lambda p: (-p.value, p.t_pre, p.t_done))
    kept: list[Plan] = []
    for p in plans:
        if not any(q.value >= p.value and q.t_pre <= p.t_pre
                   and q.t_done <= p.t_done for q in kept):
            kept.append(p)
    return kept


def allocate(acc, d_pre, d_inf, budget: float) -> Plan | None:
    m, r = acc.shape
    if r == 0:
        return Plan(0.0, 0.0, 0.0, ())
    d_tot = d_pre + d_inf
    frontier = [Plan(float(acc[i, 0]), float(d_pre[i, 0]),
                     float(d_tot[i, 0]), (i,))
                for i in range(m) if d_tot[i, 0] <= budget]
    frontier = _prune_dominated(frontier)
    for j in range(1, r):
        nxt: list[Plan] = []
        for p in frontier:
            for i in range(m):
                cur_t = max(p.t_pre + d_tot[i, j], p.t_done + d_inf[i, j])
                if cur_t <= budget:
                    nxt.append(Plan(p.value + float(acc[i, j]),
                                    p.t_pre + float(d_pre[i, j]), cur_t,
                                    p.models + (i,)))
        frontier = _prune_dominated(nxt)
        if not frontier:
            return None
    return max(frontier, key=lambda p: p.value)


@dataclasses.dataclass
class DiscoveryState:
    min_srois: int = 2
    patience: int = 3
    min_slack: float = 0.15
    low_fraction: float = 0.6
    low_streak: int = 0
    peak_srois: int = 0
    cooldown: int = 0
    cooldown_frames: int = 5

    def observe(self, n_srois: int) -> None:
        self.peak_srois = max(self.peak_srois, n_srois)
        threshold = max(self.min_srois, self.low_fraction * self.peak_srois)
        self.low_streak = self.low_streak + 1 if n_srois < threshold else 0
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


@dataclasses.dataclass
class FramePlan:
    """What the loop derives for one frame before any inference."""

    srois: list
    plan: Plan | None
    # (sroi index, variant) of each request, in slot order
    requests: list
    explore: bool
    explore_variant: Variant


class StreamPlanner:
    """One stream's planning state, as ``OmniSenseLoop`` keeps it with
    its defaults (``f`` 60 degrees, ``gamma`` 1.1, ``delta`` 2, a
    discovery pass every 6th frame with the largest rung whose explore
    cost is at most 0.6 of the budget, which the pass then takes from
    it; costs of 0 where none are given): the history of the last two frames' kept
    detections, the frame counter and the discovery state."""

    def __init__(self, variants, budget_s: float, n_categories: int,
                 seed_detections, f_deg: float = 60.0, gamma: float = 1.1,
                 delta: int = 2, explore_every: int = 6,
                 explore_costs: list[float] | None = None):
        self.variants = list(variants)
        self.explore_costs = explore_costs or [0.0] * len(self.variants)
        self.budget_s = budget_s
        self.n_categories = n_categories
        self.f = math.radians(f_deg)
        self.gamma = gamma
        self.delta = delta
        self.explore_every = explore_every
        self.frame_idx = 0
        self.history = [list(seed_detections)]
        self.discovery = DiscoveryState()

    def plan(self) -> FramePlan:
        """The next frame's plan (advances the frame counter)."""
        self.frame_idx += 1
        explore = (self.explore_every > 0
                   and self.frame_idx % self.explore_every == 0)
        costs = self.explore_costs
        affordable = [i for i, c in enumerate(costs)
                      if c <= 0.6 * self.budget_s]
        explore_idx = max(affordable) if affordable else \
            int(np.argmin(costs))
        budget = self.budget_s
        if explore:
            budget = max(0.0, budget - costs[explore_idx])
        flat = [d for frame in self.history[-self.delta:] for d in frame]
        srois = sroi.predict_srois(flat, f=self.f, gamma=self.gamma,
                                   n_categories=self.n_categories)
        plan = None
        requests = []
        if srois:
            d_pre, d_inf = delays(len(srois), self.variants)
            plan = allocate(weighted_acc(srois, self.variants), d_pre, d_inf,
                            budget)
            if plan is not None:
                requests = [(j, self.variants[m - 1])
                            for j, m in enumerate(plan.models) if m]
        return FramePlan(srois, plan, requests, explore,
                         self.variants[explore_idx])

    def discovers(self, fp: FramePlan) -> bool:
        """Whether the frame runs the full-ERP discovery pass (the
        loop's ``finish_frame`` rule; call once a frame, after
        :meth:`plan`)."""
        self.discovery.observe(len(fp.srois))
        planned = fp.plan.t_done if fp.plan is not None else 0.0
        return fp.explore or self.discovery.should_discover(self.budget_s,
                                                             planned)

    def commit(self, kept) -> None:
        """The frame's kept detections join the history."""
        self.history.append(list(kept))
        self.history = self.history[-self.delta:]
