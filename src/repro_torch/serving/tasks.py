"""Analytics task registry — multi-task serving (port of
``repro.serving.tasks``).

The paper's framework (SRoI pruning + resource-aware model scaling) is
task-agnostic; this module makes the serving stack agnostic too.  An
:class:`AnalyticsTask` declares everything the pod needs to serve one
workload:

  * its **variant ladder** (``ModelProfile`` rungs with gav tables),
  * its **latency curve** (an ``OmniSenseLatencyModel`` or subclass —
    the pricing the allocator, queues and tick model share),
  * its **accuracy proxy** (the ``serving.evaluation`` metric name),
  * its **batched backend entry** (oracle factory for benches/replay),
  * its **result kind** (what ``finish_frame`` hands back).

``detection`` is registered first by pure delegation to the existing
factories (``profiles.make_ladder`` / ``OmniSenseLatencyModel`` /
``OracleBackend`` / ``OmniSenseLoop``), so detection-only serving built
through the registry is bit-identical to the pre-registry construction
— pinned by the replay corpora.

``action_recognition`` is the second task: consecutive per-stream SRoI
crops window into tubelets (the per-region window lives in the backend)
and a small temporal head (``repro_torch.models.action``) classifies them.
Its P1-P4 ladder scales clip length x resolution, so its cost curve has
a genuinely different shape from detection's — the first real test that
``solve_pod`` generalises past one cost curve.  Action results are
ordinary ``sroi.Detection`` records whose ``category`` is the action
class, so NMS, digests, history feedback and telemetry are unchanged.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import accuracy as acc_mod
from repro_torch.core import sroi as sroi_mod
from repro_torch.core.omnisense import OmniSenseLoop
from repro_torch.data.synthetic import SyntheticVideo
from repro_torch.serving import profiles
from repro_torch.serving.network import NetworkModel
from repro_torch.serving.scheduler import (FrameStaging,
                                           OmniSenseLatencyModel,
                                           OracleBackend, _angular_distance,
                                           _fully_enclosed, _in_sroi,
                                           _params_to)

N_ACTION_CLASSES = 16

# P1-P4 action ladder: (name, clip length, crop resolution).  Cost
# scales with clip * resolution^2 — a different shape from detection's
# single-frame resolution ladder.
ACTION_LADDER: tuple[tuple[str, int, int], ...] = (
    ("act-p1-4x96", 4, 96),
    ("act-p2-8x96", 8, 96),
    ("act-p3-8x128", 8, 128),
    ("act-p4-16x128", 16, 128),
)
ACTION_CLIP_LEN: dict[str, int] = {n: c for n, c, _ in ACTION_LADDER}

# per-frame forward seconds at 96x96 on the edge tier; rungs scale by
# clip length and pixel count (see models/action.py flops_per_clip)
_ACTION_FRAME_S96 = 0.03
_ACTION_MODEL_MB = (9, 9, 14, 14)


def action_ladder(n_categories: int = acc_mod.N_CATEGORIES, seed: int = 7,
                  quality_penalty: float = 1.0) -> list[acc_mod.ModelProfile]:
    """The action task's P1-P4 ``ModelProfile`` ladder.

    gav tables share the detection table's synthetic generator (longer
    clips / higher resolution -> higher per-class accuracy) under a
    task-specific seed; ``infer_s`` is the full-tubelet forward.
    """
    gav = acc_mod.synthetic_gav_table(len(ACTION_LADDER), n_categories,
                                      seed=seed)
    out = []
    for i, (name, clip, res) in enumerate(ACTION_LADDER):
        infer_s = _ACTION_FRAME_S96 * clip * (res / 96.0) ** 2
        out.append(acc_mod.ModelProfile(
            name=name, index=i + 1, input_size=res, location="edge",
            gav=gav[i] * quality_penalty, infer_s=infer_s,
            model_bytes=_ACTION_MODEL_MB[i] * 2 ** 20))
    return out


class ActionLatencyModel(OmniSenseLatencyModel):
    """Detection's latency curve generalised to tubelets.

    Projection/encode run once per clip frame and the remote payload is
    the whole tubelet, so ``_pre``/``_inf`` scale by the variant's clip
    length.  Everything downstream — batching, sharding, queue costs,
    tick hooks — is inherited, so a mixed-task pod's tick model resolves
    to the SAME curve functions for both tasks.
    """

    def __init__(self, costs, network, clip_len: dict[str, int],
                 profiler=None, batch_marginal: float = 0.15):
        super().__init__(costs, network, profiler=profiler,
                         batch_marginal=batch_marginal)
        self.clip_len = dict(clip_len)

    def _clip(self, variant: acc_mod.ModelProfile) -> int:
        return self.clip_len.get(variant.name, 1)

    def _pre(self, variant: acc_mod.ModelProfile) -> float:
        return super()._pre(variant) * self._clip(variant)

    def _inf(self, variant: acc_mod.ModelProfile) -> float:
        t = variant.infer_s
        if variant.location != "device":
            n_bytes = (self._clip(variant) * variant.input_size ** 2
                       * self.costs.bytes_per_pixel)
            est = self.profiler.estimate(variant.name)
            if est == self.profiler.initial_s:
                t += self.network.delivery_delay(n_bytes)
            else:
                t += est
        return t


@dataclasses.dataclass
class OracleActionBackend:
    """Ground-truth-driven action sampling (``OracleBackend``'s twin).

    Each ground-truth object carries a deterministic action class; the
    variant's gav is the top-1 hit probability, discounted by how full
    the region's tubelet window is (a fresh window has seen too few
    frames for the clip length, so recognition warms up as consecutive
    crops of the same region accumulate).  Results are ``Detection``
    records with ``category`` = action class.
    """

    video: SyntheticVideo
    clip_len: dict[str, int] = dataclasses.field(
        default_factory=lambda: dict(ACTION_CLIP_LEN))
    frame: int = 0
    seed: int = 0
    fp_rate: float = 0.02
    n_actions: int = N_ACTION_CLASSES
    semantic_batch = True  # class-level: not a dataclass field

    def __post_init__(self):
        # region key -> (last frame observed, consecutive-run length)
        self._windows: dict = {}

    def set_frame(self, frame: int) -> None:
        self.frame = frame

    def _window_fill(self, region: sroi_mod.SRoI,
                     variant: acc_mod.ModelProfile) -> float:
        """Advance the region's tubelet window; return fill in (0, 1].

        Idempotent per frame (a repeat observation of the same frame —
        the batched-vs-inline equivalence path — leaves the run
        unchanged) and monotone under carried-request rewinds.
        """
        key = (round(region.center[0], 1), round(region.center[1], 1))
        last, run = self._windows.get(key, (-2, 0))
        if self.frame == last + 1:
            run += 1
        elif self.frame > last + 1:
            run = 1
        self._windows[key] = (max(last, self.frame), run)
        clip = self.clip_len.get(variant.name, 1)
        return min(run, clip) / clip

    def _action_of(self, det: sroi_mod.Detection, okey: int) -> int:
        return (det.category * 7 + okey) % self.n_actions

    def _recognise(self, candidates, variant, region_tag: int,
                   fill: float = 1.0, ref_sr: float = 4 * math.pi,
                   region: sroi_mod.SRoI | None = None):
        out = []
        n_cat = len(variant.gav) // 3
        fp_rng = np.random.default_rng(
            (self.seed * 1_000_003 + self.frame) * 137 + variant.index * 11
            + region_tag)
        for det in candidates:
            okey = hash((round(float(det.box[2]), 6),
                         round(float(det.box[3]), 6), det.category))
            action = self._action_of(det, okey)
            # temporally-coherent sampling, same idiom as the detection
            # oracle: the hit decision re-randomises every few frames
            rng = np.random.default_rng(
                (self.seed * 5_915_587 + okey) % (2 ** 31)
                + variant.index * 89 + (self.frame // 4) * 29)
            level = sroi_mod.size_level_in(det, ref_sr, acc_mod.SMALL_NOA,
                                           acc_mod.MEDIUM_NOA)
            acc = float(variant.gav[level * n_cat + action % n_cat]) * fill
            if region is not None:
                if not _fully_enclosed(det, region):
                    acc *= 0.3
                d = _angular_distance(det, region)
                acc *= max(math.cos(min(d, math.pi / 2)), 0.15) ** 2
            if rng.uniform() < acc:
                jitter = (1.0 - acc) * 0.1
                box = det.box.copy()
                box[0] += rng.normal(0, jitter * box[2])
                box[1] += rng.normal(0, jitter * box[3])
                out.append(sroi_mod.Detection(
                    box=box, category=action,
                    score=float(np.clip(acc + rng.normal(0, 0.05),
                                        0.05, 1.0))))
        if fp_rng.uniform() < self.fp_rate and candidates:
            ref = candidates[0]
            out.append(sroi_mod.Detection(
                box=ref.box * np.array([1.0, 1.0, 0.7, 0.7]),
                category=int(fp_rng.integers(0, self.n_actions)), score=0.3))
        return out

    def infer_sroi(self, frame_img, region: sroi_mod.SRoI,
                   variant: acc_mod.ModelProfile):
        del frame_img
        gt = self.video.visible_objects(self.frame)
        cands = [d for d in gt if _in_sroi(d, region)]
        tag = hash((round(region.center[0], 3),
                    round(region.center[1], 3))) % 9973
        fill = self._window_fill(region, variant)
        return self._recognise(
            cands, variant, tag, fill=fill,
            ref_sr=sroi_mod.region_solid_angle(*region.fov), region=region)

    def infer_srois_batched(self, items, variant: acc_mod.ModelProfile):
        """Semantic batch: bit-identical to per-request calls."""
        return [self.infer_sroi(frame_img, region, variant)
                for frame_img, region in items]

    def infer_erp(self, frame_img, variant: acc_mod.ModelProfile):
        """Full-ERP pass (discovery): distortion demotes the gav, no
        tubelet warm-up discount (the ERP sees every region)."""
        del frame_img
        gt = self.video.visible_objects(self.frame)
        third = len(variant.gav) // 3
        demoted = dataclasses.replace(
            variant, gav=np.concatenate([
                variant.gav[:third] * 0.3,
                variant.gav[third: 2 * third] * 0.6,
                variant.gav[2 * third:] * 0.9,
            ]))
        return self._recognise(gt, demoted, region_tag=0)


class TorchActionBackend(FrameStaging):
    """Real path: gnomonic crops window into tubelets, one temporal-head
    forward per (variant, padded batch); the port of the reference's
    ``JaxActionBackend``.

    * Each SRoI projects through the gnomonic sampling kernel
      (``kernels/gnomonic/ops.py::project_sroi_kernel``), or through the
      plain projection with ``use_kernel=False``; a backend on the CPU
      runs the kernel's plain version.
    * Each region's window of crops stays on the device, keyed by
      ``(variant idx, round(theta, 1), round(phi, 1))``; a short window
      is left-padded with its oldest crop, and the window keeps the last
      ``clip_len`` crops.  A window holds crops, not frames, so it may
      outlive the tick whose frame it was cut from.
    * The batch is zero-padded to its bucket and runs ``action.apply``;
      the logits come back to the host once, and the reference's own
      NumPy softmax turns each row into one ``Detection``.
    * ``trace_count`` counts the distinct (variant, padded batch)
      shapes run, as the reference's jit cache counts its traces.
    * The tick's frames upload once (:class:`~repro_torch.serving.
      scheduler.FrameStaging`, the detector backend's staging).

    Everything runs on ``device`` (default ``cuda``; with no CUDA device
    and no device given the constructor raises), float32 with TF32 off.
    """

    def __init__(self, cfgs, params_per_variant, buckets=None,
                 use_kernel: bool = True,
                 device: str | torch.device | None = None):
        from repro_torch.device import resolve_device, set_fp32_policy
        from repro_torch.serving.batching import ShapeBuckets

        self.device = resolve_device(device)
        set_fp32_policy()
        self.cfgs = list(cfgs)
        self.params = [_params_to(p, self.device) for p in params_per_variant]
        self.use_kernel = use_kernel
        self.buckets = buckets or ShapeBuckets(
            resolutions=tuple(sorted({c.input_size for c in self.cfgs})))
        self._shapes: set = set()
        self.trace_count = 0  # distinct (variant, padded batch) shapes run
        self._clips: dict = {}  # (variant idx, region key) -> recent crops
        self.frame = 0
        self._init_staging()

    def set_frame(self, frame: int) -> None:
        self.frame = frame

    def _project(self, frame_img, region: sroi_mod.SRoI, size: int):
        frame = self._device_frame(frame_img)
        if self.use_kernel:
            from repro_torch.kernels.gnomonic import ops as gno_ops

            return gno_ops.project_sroi_kernel(
                frame, region.center[0], region.center[1], region.fov,
                (size, size))
        from repro_torch.core.projection import project_sroi

        return project_sroi(frame, region.center[0], region.center[1],
                            region.fov, (size, size))

    def _window(self, key, pi, clip_len: int):
        """Append the crop to the region's window, return the tubelet
        (short windows left-pad by repeating the oldest crop)."""
        win = self._clips.setdefault(key, [])
        win.append(pi)
        del win[:-clip_len]
        return torch.stack([win[0]] * (clip_len - len(win)) + win)

    def _batched_fn(self, idx: int, b_pad: int):
        """The forward of one (variant, padded batch) shape; counts the
        distinct shapes in ``trace_count``."""
        from repro_torch.models import action as act_mod

        if (idx, b_pad) not in self._shapes:
            self._shapes.add((idx, b_pad))
            self.trace_count += 1
        cfg = self.cfgs[idx]
        return lambda params, clips: act_mod.apply(params, clips, cfg)

    @torch.inference_mode()
    def infer_srois_batched(self, items, variant: acc_mod.ModelProfile):
        idx = variant.index - 1
        cfg = self.cfgs[idx]
        size = cfg.input_size
        clips = []
        for frame_img, region in items:
            pi = self._project(frame_img, region, size)
            key = (idx, round(region.center[0], 1),
                   round(region.center[1], 1))
            clips.append(self._window(key, pi, cfg.clip_len))
        b = len(clips)
        b_pad = self.buckets.pad_batch(b)
        batch = torch.zeros((b_pad, cfg.clip_len, size, size, 3),
                            dtype=torch.float32, device=self.device)
        batch[:b] = torch.stack(clips)
        logits = self._batched_fn(idx, b_pad)(self.params[idx], batch)
        logits = tracing.to_host(logits[:b])
        out = []
        for row, (_, region) in zip(logits, items):
            e = np.exp(row - row.max())
            probs = e / e.sum()
            cat = int(np.argmax(probs))
            ct, cp = region.center
            fh, fv = region.fov
            out.append([sroi_mod.Detection(
                box=np.array([ct, cp, fh * 0.8, fv * 0.8]),
                category=cat, score=float(probs[cat]))])
        return out

    def infer_sroi(self, frame_img, region: sroi_mod.SRoI,
                   variant: acc_mod.ModelProfile):
        return self.infer_srois_batched([(frame_img, region)], variant)[0]

    def infer_erp(self, frame_img, variant: acc_mod.ModelProfile):
        del frame_img, variant
        return []  # the action head has no full-ERP discovery pass


def default_action_configs(n_actions: int = N_ACTION_CLASSES):
    """``ActionConfig`` per ladder rung (the TorchActionBackend zoo)."""
    from repro_torch.models.action import ActionConfig

    return [ActionConfig(name=name, input_size=res, clip_len=clip,
                         n_actions=n_actions)
            for name, clip, res in ACTION_LADDER]


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AnalyticsTask:
    """One registered analytics workload (see module docstring)."""

    name: str
    make_ladder: Callable[[], list]
    make_latency_model: Callable[[], object]
    make_backend: Callable[[SyntheticVideo], object]
    make_loop: Callable[..., object]
    accuracy_proxy: str  # metric name in repro_torch.serving.evaluation
    result_kind: str

    def ladder_names(self) -> tuple[str, ...]:
        return tuple(v.name for v in self.make_ladder())


TASKS: dict[str, AnalyticsTask] = {}
_VARIANT_TASK: dict[str, str] = {}


def register_task(task: AnalyticsTask) -> AnalyticsTask:
    if task.name in TASKS:
        raise ValueError(f"task {task.name!r} already registered")
    for name in task.ladder_names():
        owner = _VARIANT_TASK.get(name)
        if owner is not None:
            raise ValueError(
                f"variant {name!r} already registered to task {owner!r}")
    TASKS[task.name] = task
    for name in task.ladder_names():
        _VARIANT_TASK[name] = task.name
    return task


def get_task(name: str) -> AnalyticsTask:
    try:
        return TASKS[name]
    except KeyError:
        raise ValueError(f"unknown task {name!r}; registered: "
                         f"{sorted(TASKS)}") from None


def task_names() -> list[str]:
    return sorted(TASKS)


def task_for_variant(variant_name: str) -> str:
    """The owning task of a registered variant name.

    Unregistered names (toy test ladders) default to ``detection`` —
    the pre-registry behavior of every queue/policy path.
    """
    return _VARIANT_TASK.get(variant_name, "detection")


def _detection_loop(variants, latency_model, backend, budget_s, **kw):
    loop = OmniSenseLoop(variants, latency_model, backend,
                         budget_s=budget_s, **kw)
    loop.task = "detection"
    return loop


def _action_loop(variants, latency_model, backend, budget_s, **kw):
    loop = OmniSenseLoop(variants, latency_model, backend,
                         budget_s=budget_s, **kw)
    loop.task = "action_recognition"
    return loop


register_task(AnalyticsTask(
    name="detection",
    make_ladder=profiles.make_ladder,
    make_latency_model=lambda: OmniSenseLatencyModel(
        profiles.paper_profile(), NetworkModel()),
    make_backend=OracleBackend,
    make_loop=_detection_loop,
    accuracy_proxy="sph_map",
    result_kind="detections",
))

register_task(AnalyticsTask(
    name="action_recognition",
    make_ladder=action_ladder,
    make_latency_model=lambda: ActionLatencyModel(
        profiles.paper_profile(), NetworkModel(),
        clip_len=dict(ACTION_CLIP_LEN)),
    make_backend=OracleActionBackend,
    make_loop=_action_loop,
    accuracy_proxy="action_top1",
    result_kind="actions",
))


# --------------------------------------------------------------------------
# mixed-task pod construction
# --------------------------------------------------------------------------


def build_task_streams(stream_tasks: Sequence[str], videos, budgets, *,
                       detection_variants: Sequence[str] | None = None):
    """Per-stream loops/backends for a (possibly mixed-task) pod.

    One shared ladder + latency model per task present (first-seen
    order), loops built through each task's registered factories —
    detection-only input reproduces the pre-registry construction
    bit-identically.  ``detection_variants`` optionally subsets the
    detection ladder by name (a replay spec's ``variants``); other
    tasks always serve their full registered ladder.

    Returns ``(variants, loops, backends, cost_fn)``: ``variants`` is
    the union ladder in first-seen task order and ``cost_fn`` prices
    any union variant with its own task's latency model (placement
    seeding).
    """
    ctx: dict = {}
    order: list[str] = []
    for tname in stream_tasks:
        if tname in ctx:
            continue
        task = get_task(tname)
        ladder = task.make_ladder()
        if tname == "detection" and detection_variants is not None:
            by_name = {v.name: v for v in ladder}
            unknown = [n for n in detection_variants if n not in by_name]
            if unknown:
                raise ValueError(f"unknown variants {unknown}; ladder has "
                                 f"{sorted(by_name)}")
            ladder = [by_name[n] for n in detection_variants]
        lat = task.make_latency_model()
        costs = [lat._pre(v) + lat._inf(v) for v in ladder]
        ctx[tname] = (ladder, lat, costs)
        order.append(tname)

    loops, backends = [], []
    for s, tname in enumerate(stream_tasks):
        ladder, lat, costs = ctx[tname]
        task = get_task(tname)
        backend = task.make_backend(videos[s])
        loops.append(task.make_loop(ladder, lat, backend, budgets[s],
                                    explore_costs=costs))
        backends.append(backend)

    union = [v for tname in order for v in ctx[tname][0]]
    if len(ctx) == 1:
        cost_fn = ctx[order[0]][1]._inf
    else:
        lat_by_name = {v.name: ctx[tname][1]
                       for tname in order for v in ctx[tname][0]}

        def cost_fn(v):
            return lat_by_name[v.name]._inf(v)

    return union, loops, backends, cost_fn


def shape_buckets_for(tasks: Sequence[str], max_batch: int = 8):
    """``ShapeBuckets`` whose legal crop resolutions are the UNION of
    the given tasks' ladder input sizes — the (task, variant) shape
    space of a mixed-task pod's real (pixel-touching) backends."""
    from repro_torch.serving.batching import ShapeBuckets

    sizes = sorted({v.input_size for t in tasks
                    for v in get_task(t).make_ladder()})
    return ShapeBuckets.for_max_batch(max_batch, tuple(sizes))


def stream_tasks_for(mode: str, n_streams: int) -> list[str]:
    """Expand a ``--tasks`` shorthand into per-stream task names.

    ``detection`` / ``action`` are homogeneous pods; ``mixed``
    alternates the two (even streams detect, odd streams recognise).
    """
    if mode in ("detection", "action", "action_recognition"):
        name = "detection" if mode == "detection" else "action_recognition"
        return [name] * n_streams
    if mode == "mixed":
        return ["detection" if s % 2 == 0 else "action_recognition"
                for s in range(n_streams)]
    raise ValueError(f"unknown task mode {mode!r} "
                     "(expected detection|action|mixed)")
