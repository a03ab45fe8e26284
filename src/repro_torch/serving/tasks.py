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

``region_description`` is the third, and has no counterpart in the
reference: a vision-language model (Kimi-VL-A3B, ``models/kimi_vl.py``)
describes each SRoI's crop, one prefill and a greedy answer a request,
the answers of a tick decoded together (:class:`TorchVlmBackend`).  Its
ladder is one model read at four crop sizes, so the allocator's rung
sets the number of image tokens.  A result is a ``Detection`` on the
region's own box, so the same downstream stays unchanged.
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
# region description (Kimi-VL-A3B)
# --------------------------------------------------------------------------

N_DESCRIBE_CLASSES = 80

# the region-description ladder: (name, crop size).  MoonViT reads a
# crop at its own resolution, so the rung sets the image tokens:
# (size / 28)^2, 64 to 1024.
VLM_LADDER: tuple[tuple[str, int], ...] = (
    ("kimivl-224", 224),
    ("kimivl-448", 448),
    ("kimivl-672", 672),
    ("kimivl-896", 896),
)
# edge seconds of one request at each rung (vision, prefill and the
# answer's decode), as the allocator prices them: constants of the
# latency model, not measurements
_VLM_INFER_S = (0.15, 0.4, 0.8, 1.4)
_VLM_MODEL_MB = 33_000


def vlm_ladder(n_categories: int = acc_mod.N_CATEGORIES, seed: int = 11,
               quality_penalty: float = 1.0) -> list[acc_mod.ModelProfile]:
    """The region-description task's ``ModelProfile`` ladder: one
    model read at four crop sizes, a gav table from the detection
    table's synthetic generator under a task seed (more image tokens,
    higher accuracy)."""
    gav = acc_mod.synthetic_gav_table(len(VLM_LADDER), n_categories,
                                      seed=seed)
    return [acc_mod.ModelProfile(
        name=name, index=i + 1, input_size=size, location="edge",
        gav=gav[i] * quality_penalty, infer_s=_VLM_INFER_S[i],
        model_bytes=_VLM_MODEL_MB * 2 ** 20)
        for i, (name, size) in enumerate(VLM_LADDER)]


@dataclasses.dataclass
class DescribedRegion(sroi_mod.Detection):
    """A region-description result: a ``Detection`` (the region's box,
    its class and that class's probability) and the answer's ids."""

    tokens: tuple[int, ...] = ()


def region_box(region: sroi_mod.SRoI) -> np.ndarray:
    """A description's box: the region's centre and the extent of the
    objects it was predicted from (a special region's one object, a
    regular region's merged extent), so that the next frame predicts the
    same region from it."""
    if not region.objects:
        return np.array([*region.center, *region.fov], dtype=np.float64)
    if region.special:
        fh, fv = region.objects[0].fov
    else:
        fh, fv = sroi_mod._merged_extents(region.objects)[:2]
    return np.array([region.center[0], region.center[1], fh, fv],
                    dtype=np.float64)


@dataclasses.dataclass
class OracleDescribeBackend:
    """Ground-truth-driven region description (``OracleBackend``'s twin
    for benches and replay): each region is described by the category of
    the largest ground-truth object inside it, hit with the variant's
    gav for it."""

    video: SyntheticVideo
    frame: int = 0
    seed: int = 0
    semantic_batch = True  # class-level: not a dataclass field

    def set_frame(self, frame: int) -> None:
        self.frame = frame

    def infer_sroi(self, frame_img, region: sroi_mod.SRoI,
                   variant: acc_mod.ModelProfile):
        del frame_img
        inside = [d for d in self.video.visible_objects(self.frame)
                  if _in_sroi(d, region)]
        if not inside:
            return []
        obj = max(inside, key=lambda d: d.noa())
        n_cat = len(variant.gav) // 3
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + self.frame) * 131 + variant.index)
        hit = rng.uniform() < float(variant.gav[n_cat + obj.category % n_cat])
        cat = obj.category if hit else int(rng.integers(0, n_cat))
        return [DescribedRegion(box=region_box(region), category=cat,
                                score=float(variant.gav[n_cat + cat]))]

    def infer_srois_batched(self, items, variant: acc_mod.ModelProfile):
        return [self.infer_sroi(f, r, variant) for f, r in items]

    def infer_erp(self, frame_img, variant: acc_mod.ModelProfile):
        del frame_img, variant
        return []  # region description has no full-ERP discovery pass


class _Prefilled:
    """One launched chunk: its items, the prefill's last-position logits
    and latents, and (after the tick's joint decode) its results."""

    __slots__ = ("key", "items", "size", "last", "latents", "out")

    def __init__(self, key, items, size, last, latents):
        self.key, self.items, self.size = key, items, size
        self.last, self.latents = last, latents
        self.out = None


class TorchVlmBackend(FrameStaging):
    """Real path of the region-description task: Kimi-VL-A3B
    (``models/kimi_vl.py``) on each request's crop.

    * :meth:`launch_srois_batched` serves one rung's requests in chunks
      of at most ``buckets.max_batch``: the chunk's crops in one
      batched projection (``kernels/gnomonic``), MoonViT and the
      projector (span ``vlm.vision``), then the LM's prefill over
      ``[pre_ids] + image tokens + [post_ids]`` (span ``vlm.prefill``),
      which leaves each request's latents for the decode cache.
    * The first resolver called after a launch decodes every chunk
      launched since the last decode together: one latent cache over the
      tick's requests, whatever their rung (a ragged batch, masked), and
      ``answer_len`` greedy steps over the full vocabulary (spans
      ``vlm.decode``, keyed by step).  The drain launches every chunk of
      a tick before it resolves any, so a tick decodes once.
    * Each request's result is one :class:`DescribedRegion` on the
      region's own box (:func:`region_box`): its category is the argmax
      over ``class_ids`` of the logits at the first answer position, its
      score that id's softmax over ``class_ids``, and its tokens the ids
      the decode steps chose.

    Nothing waits for the card until the decode's results come back, so
    the host enqueues the next chunk while the card runs this one; the
    spans time the host's side.  Counted (``repro_torch.tracing``):
    ``vlm.image_tokens``, ``vlm.decode_tokens``, ``vlm.cache_bytes`` and
    the MoE layers' ``moe.expert_tokens`` / ``moe.expert_tokens_max``
    (the latter flushed with the decode's copies back).  The weights stay
    where they are given (bfloat16 on the card for the published widths);
    products accumulate in float32.
    """

    def __init__(self, cfg, params, *, pre_ids, post_ids, class_ids,
                 answer_len: int = 16, buckets=None,
                 device: str | torch.device | None = None):
        from repro_torch.device import resolve_device, set_bf16_policy
        from repro_torch.serving.batching import ShapeBuckets

        self.device = resolve_device(device)
        set_bf16_policy()
        self.cfg = cfg
        self.params = _params_to(params, self.device)

        def ids(x):
            return torch.as_tensor(x, dtype=torch.long, device=self.device)

        self.pre_ids, self.post_ids = ids(pre_ids), ids(post_ids)
        self.class_ids = ids(class_ids)
        self.answer_len = answer_len
        self.buckets = buckets or ShapeBuckets(
            resolutions=tuple(size for _, size in VLM_LADDER))
        self._pending: list[_Prefilled] = []
        self._pos: dict = {}  # crop size -> its interpolated position table
        self._init_staging()

    def _prefill(self, key, chunk, size: int) -> _Prefilled:
        from repro_torch.kernels.gnomonic.ops import project_srois_batched
        from repro_torch.models import kimi_vl
        from repro_torch.models.vision import moonvit_pos

        frames, frame_idx = self._chunk_frames([f for f, _ in chunk])
        crops = project_srois_batched(
            frames, frame_idx, [r.center for _, r in chunk],
            [r.fov for _, r in chunk], (size, size))
        pos = self._pos.get(size)
        if pos is None:
            g = size // self.cfg.vision.patch
            pos = self._pos[size] = moonvit_pos(self.params["vision"]["pos"],
                                                g, g)
        with tracing.span("vlm.vision", key):
            img = kimi_vl.image_tokens(self.params, crops, self.cfg, pos)
        tracing.count("vlm.image_tokens", img.shape[0] * img.shape[1])
        with tracing.span("vlm.prefill", key):
            emb = kimi_vl.prompt_embeds(self.params, self.pre_ids, img,
                                        self.post_ids)
            last, latents = kimi_vl.prefill(self.params["lm"], emb,
                                            self.cfg.lm)
        tracing.count("forwards")
        return _Prefilled(key, list(chunk), size, last, latents)

    def _decode(self) -> None:
        """Decode every pending chunk together and fill their results."""
        from repro_torch.models import kimi_vl

        chunks, self._pending = self._pending, []
        fed, logits, cache = kimi_vl.generate(
            self.params, [(c.last.argmax(-1), c.latents) for c in chunks],
            self.cfg, self.answer_len)
        tracing.count("vlm.cache_bytes", cache.nbytes)
        tracing.count("vlm.decode_tokens", fed.numel())
        first = torch.cat([c.last for c in chunks])
        probs = torch.softmax(first[:, self.class_ids], -1)
        score, cat = probs.max(-1)
        tokens = tracing.to_host(torch.stack([s.argmax(-1) for s in logits],
                                             1))
        cat, score = tracing.to_host(cat), tracing.to_host(score)
        tracing.flush_counts()
        r = 0
        for c in chunks:
            c.out = []
            for _, region in c.items:
                c.out.append([DescribedRegion(
                    box=region_box(region), category=int(cat[r]),
                    score=float(score[r]),
                    tokens=tuple(int(t) for t in tokens[r]))])
                r += 1

    @torch.inference_mode()
    def launch_srois_batched(self, items, variant: acc_mod.ModelProfile,
                             group=None):
        """Prefill one rung's requests chunk by chunk; returns the
        resolver of their results (which decodes what is pending)."""
        del group  # one card
        size = variant.input_size
        launched = []
        lo = 0
        for b in self.buckets.split(len(items)):
            key = tracing.seq("chunk")
            with tracing.span("drain.launch", key):
                launched.append(self._prefill(key, items[lo:lo + b], size))
            lo += b
        self._pending.extend(launched)

        @torch.inference_mode()
        def resolve() -> list[list]:
            if any(c.out is None for c in launched):
                with tracing.span("drain.wait", launched[0].key):
                    self._decode()
            return [dets for c in launched for dets in c.out]

        return resolve

    def infer_srois_batched(self, items, variant: acc_mod.ModelProfile):
        return self.launch_srois_batched(items, variant)()

    def infer_sroi(self, frame_img, region: sroi_mod.SRoI,
                   variant: acc_mod.ModelProfile):
        return self.infer_srois_batched([(frame_img, region)], variant)[0]

    def infer_erp(self, frame_img, variant: acc_mod.ModelProfile):
        del frame_img, variant
        return []  # region description has no full-ERP discovery pass


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


def _describe_loop(variants, latency_model, backend, budget_s, **kw):
    loop = OmniSenseLoop(variants, latency_model, backend,
                         budget_s=budget_s, **kw)
    loop.task = "region_description"
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

register_task(AnalyticsTask(
    name="region_description",
    make_ladder=vlm_ladder,
    make_latency_model=lambda: OmniSenseLatencyModel(
        profiles.paper_profile(), NetworkModel()),
    make_backend=OracleDescribeBackend,
    make_loop=_describe_loop,
    accuracy_proxy="action_top1",
    result_kind="descriptions",
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
