"""Latency model + inference backends + the OmniSense scheduler glue.

``OmniSenseLatencyModel`` computes the allocator's (d_pre, d_inf)
matrices exactly as section IV-C specifies:

    d_pre[i][j] = projection(PI at model i's input size)
                  + encode(same) if model i runs remotely
    d_inf[i][j] = delivery(PI bytes) if remote else 0
                  + model i's profiled inference time

Row 0 is the zero-cost "skip" pseudo-model.  Delivery delays come from
the passive profiler (omega-window) scaled by payload size, and the
projection/encode terms from the offline stage-cost profile — the PI
resolution always equals the allocated model's input size ("to avoid
resizing the image").

Backends:
  * ``OracleBackend`` — samples detections from the scene ground truth
    using each variant's gav as hit probability (+ box jitter, rare
    false positives).  Drives the reproduction benchmark (DESIGN.md
    section 7: no pretrained weights exist, the systems claim is about
    allocation given a ladder).
  * ``TorchDetectorBackend`` — really projects the SRoI (the gnomonic
    CUDA kernels) and runs the PyTorch detector ladder; the port of the
    reference's ``JaxDetectorBackend``.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import accuracy as acc_mod
from repro_torch.core import sroi as sroi_mod
from repro_torch.data.synthetic import SyntheticVideo
from repro_torch.serving.network import NetworkModel, PassiveProfiler
from repro_torch.serving.profiles import StageCosts


class OmniSenseLatencyModel:
    def __init__(self, costs: StageCosts, network: NetworkModel,
                 profiler: PassiveProfiler | None = None,
                 batch_marginal: float = 0.15,
                 pre_batch_marginal: float = 0.35):
        self.costs = costs
        self.network = network
        # a defaulted profiler inherits the link's RTT floor so its
        # payload rescaling never shrinks the fixed round-trip term
        self.profiler = profiler or PassiveProfiler(rtt_s=network.rtt_s)
        # marginal cost of each item beyond the first in a batched
        # forward (the standard sub-linear batching curve)
        self.batch_marginal = batch_marginal
        # same curve for the mobile-side projection/encode stage —
        # shallower batching than the edge forward (the mobile SoC
        # pipelines crops but streams encode mostly serially)
        self.pre_batch_marginal = pre_batch_marginal

    def _pre(self, variant: acc_mod.ModelProfile) -> float:
        mpix = variant.input_size ** 2 / 1e6
        t = self.costs.project_s_per_mpix * mpix
        if variant.location != "device":
            t += self.costs.encode_s_per_mpix * mpix
        return t

    def _inf(self, variant: acc_mod.ModelProfile) -> float:
        t = variant.infer_s
        if variant.location != "device":
            n_bytes = variant.input_size ** 2 * self.costs.bytes_per_pixel
            est = self.profiler.estimate(variant.name)
            if est == self.profiler.initial_s:
                t += self.network.delivery_delay(n_bytes)
            else:
                t += est
        return t

    def delays(self, srois: Sequence[sroi_mod.SRoI],
               variants: Sequence[acc_mod.ModelProfile]):
        r = len(srois)
        m = len(variants)
        d_pre = np.zeros((1 + m, r))
        d_inf = np.zeros((1 + m, r))
        for i, var in enumerate(variants):
            d_pre[1 + i, :] = self._pre(var)
            d_inf[1 + i, :] = self._inf(var)
        return d_pre, d_inf

    def batched_inference_delay(self, variant: acc_mod.ModelProfile,
                                batch_size: int) -> float:
        """Cost of ONE batched forward serving ``batch_size`` PIs.

        Per-batch fixed cost (the b=1 forward: dispatch, weight
        streaming and — for remote variants — the bundled payload
        delivery) plus a ``batch_marginal`` fraction of it for every
        additional item.  ``batch_size == 1`` reduces exactly to the
        per-request :meth:`_inf` term, so the allocator's utility
        ordering (which prices requests individually) is unchanged by
        the batched serving path; the pod server charges this instead
        of summing ``_inf`` per request.
        """
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        return self._inf(variant) * (
            1.0 + (batch_size - 1) * self.batch_marginal)

    def amortized_inference_delay(self, variant: acc_mod.ModelProfile,
                                  batch_size: int) -> float:
        """Per-item share of a batched forward (decreasing in batch)."""
        return self.batched_inference_delay(variant, batch_size) / batch_size

    def sharded_inference_delay(self, variant: acc_mod.ModelProfile,
                                batch_size: int, n_devices: int = 1) -> float:
        """Cost of one batched forward sharded over a replica group.

        The batch splits evenly over the group's ``data`` axis, so the
        critical path is the largest per-device shard; ``n_devices == 1``
        reduces exactly to :meth:`batched_inference_delay`.
        """
        if n_devices < 1:
            raise ValueError(f"n_devices must be >= 1, got {n_devices}")
        per_device = -(-batch_size // n_devices)  # ceil division
        return self.batched_inference_delay(variant, per_device)

    def tick_inference_delay(self, group_costs) -> float:
        """Device-aware cost of one pod tick.

        ``group_costs``: per replica group, the summed delays of the
        dispatches it executed this tick.  Dispatches within a group
        serialise; groups run concurrently on disjoint devices, so the
        tick pays the MAX over groups — the single-device pod (one
        group) degenerates to the old sum-over-dispatches.
        """
        return max(group_costs, default=0.0)

    def tick_overlap_delay(self, group_costs: dict,
                           carry_in: dict | None = None) -> float:
        """:meth:`tick_inference_delay` generalised to overlapping
        dispatches (the event-clock runtime, ``repro.serving.runtime``).

        ``group_costs`` maps replica-group index to the summed delays
        of the dispatches the tick ADDED to that group; ``carry_in``
        maps group index to the busy seconds the group still owed past
        the tick start (work launched in an earlier tick under an
        async drain policy).  Each group completes at carry-in plus
        its serialised new work and the tick pays the max — with no
        carry-in this is exactly :meth:`tick_inference_delay`, which
        is what pins the sync policy's bit-identity.  ``PodServer``'s
        flush prices the carried tail through this closed form (with
        the event horizon as the floor for untouched busy groups).
        """
        carry = carry_in or {}
        return max((carry.get(g, 0.0) + c for g, c in group_costs.items()),
                   default=0.0)

    def variant_queue_cost(self, variant: acc_mod.ModelProfile,
                           n_requests: int, buckets=None,
                           n_devices: int = 1) -> float:
        """Device-busy seconds of draining ``n_requests`` of ``variant``.

        Exactly the variant's contribution to its replica group in one
        tick schedule: the requests split into bucket-capped chunks
        (``ShapeBuckets.split``) and each chunk is one sharded batched
        forward (:meth:`sharded_inference_delay`) — the same curve
        :meth:`tick_schedule_delay` prices, so the pod-level allocator
        and the tick model can never disagree on what a queue costs.
        Without ``buckets`` the whole count is one dispatch.
        """
        if n_requests <= 0:
            return 0.0
        chunks = buckets.split(n_requests) if buckets is not None \
            else [n_requests]
        return sum(self.sharded_inference_delay(variant, b, n_devices)
                   for b in chunks)

    def pod_amortization(self, variant: acc_mod.ModelProfile,
                         batch_size: int, buckets=None,
                         n_devices: int = 1) -> float:
        """Per-request share of the variant's tick drain, relative to
        the b=1 forward.

        ``== 1.0`` exactly at ``batch_size == 1`` on one device (the
        b=1 pin that keeps uncoupled plans byte-identical), decreasing
        as co-streams share the batch and as the replica group widens.
        The pod allocator scales each stream's base ``d_inf`` row by
        this factor, so coupling inherits whatever per-stream delivery
        estimates the base matrices carry.
        """
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        total = self.variant_queue_cost(variant, batch_size, buckets,
                                        n_devices)
        return total / (batch_size * self.batched_inference_delay(variant, 1))

    def batched_pre_delay(self, variant: acc_mod.ModelProfile,
                          batch_size: int) -> float:
        """Cost of projecting/encoding ``batch_size`` PIs as one batch.

        The :meth:`_pre` stage follows the same sub-linear curve as the
        edge forward, with its own (shallower) ``pre_batch_marginal``;
        ``batch_size == 1`` reduces exactly to the per-request term.
        """
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        return self._pre(variant) * (
            1.0 + (batch_size - 1) * self.pre_batch_marginal)

    def pre_amortization(self, variant: acc_mod.ModelProfile,
                         batch_size: int) -> float:
        """Per-request share of the batched mobile-side stage, relative
        to the b=1 projection/encode.

        ``== 1.0`` EXACTLY at ``batch_size == 1`` (the identity pin
        that keeps uncoupled d_pre pricing byte-identical), decreasing
        as co-streams share the mobile stage.  ``solve_pod``'s coupled
        price scales each stream's ``d_pre`` row by this factor.
        """
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        pre = self._pre(variant)
        if pre <= 0.0:
            return 1.0
        return self.batched_pre_delay(variant, batch_size) / \
            (batch_size * pre)

    def tick_schedule_delay(self, schedule):
        """Price a whole tick's dispatch schedule on the pure curve.

        ``schedule``: one ``(variant, batch_size, n_devices,
        group_index)`` tuple per dispatch.  Returns ``(tick_delay,
        per-group sums)`` — the projection ``benchmarks/serving_bench``
        records, kept here so a future curve change cannot silently
        diverge from the serving path's pricing (``PodServer`` adds
        execution detail — marginal overrides, per-backend forwards —
        on top of these same methods).
        """
        group_sums: dict = {}
        for variant, batch_size, n_devices, gidx in schedule:
            group_sums[gidx] = group_sums.get(gidx, 0.0) + \
                self.sharded_inference_delay(variant, batch_size, n_devices)
        return self.tick_inference_delay(group_sums.values()), group_sums

    def observe_delivery(self, variant: acc_mod.ModelProfile) -> float:
        """Simulate one remote delivery, feed the passive profiler."""
        n_bytes = variant.input_size ** 2 * self.costs.bytes_per_pixel
        d = self.network.delivery_delay(n_bytes)
        self.profiler.observe(variant.name, d)
        return d


# --------------------------------------------------------------------------
# backends
# --------------------------------------------------------------------------


def _in_sroi(det: sroi_mod.Detection, region: sroi_mod.SRoI) -> bool:
    ct, cp = region.center
    fh, fv = region.fov
    dlon = abs((det.box[0] - ct + math.pi) % (2 * math.pi) - math.pi)
    return dlon <= fh / 2 and abs(det.box[1] - cp) <= fv / 2


def _fully_enclosed(det: sroi_mod.Detection, region: sroi_mod.SRoI) -> bool:
    ct, cp = region.center
    fh, fv = region.fov
    dlon = abs((det.box[0] - ct + math.pi) % (2 * math.pi) - math.pi)
    return (dlon + det.box[2] / 2 <= fh / 2
            and abs(det.box[1] - cp) + det.box[3] / 2 <= fv / 2)


def _angular_distance(det: sroi_mod.Detection, region: sroi_mod.SRoI) -> float:
    ct, cp = region.center
    dlon = abs((det.box[0] - ct + math.pi) % (2 * math.pi) - math.pi)
    # great-circle distance (spherical law of cosines)
    cosd = (math.sin(cp) * math.sin(det.box[1])
            + math.cos(cp) * math.cos(det.box[1]) * math.cos(dlon))
    return math.acos(max(-1.0, min(1.0, cosd)))


@dataclasses.dataclass
class OracleBackend:
    """Ground-truth-driven detection sampling (see module docstring).

    ``semantic_batch``: the batched entry point is a pure simulation
    (no accelerator behind it), so the pod server prices a drained
    chunk spanning per-stream oracle instances as ONE shared-
    accelerator dispatch — the regime being simulated.
    """

    video: SyntheticVideo
    frame: int = 0
    seed: int = 0
    fp_rate: float = 0.02
    semantic_batch = True  # class-level: not a dataclass field

    def set_frame(self, frame: int) -> None:
        self.frame = frame

    def _detect(self, candidates, variant, region_tag: int,
                ref_sr: float = 4 * math.pi,
                region: sroi_mod.SRoI | None = None):
        out = []
        n_cat = self.video.n_categories
        fp_rng = np.random.default_rng(
            (self.seed * 1_000_003 + self.frame) * 131 + variant.index * 7
            + region_tag)
        for det in candidates:
            # temporally-coherent sampling: the hit decision for an
            # object re-randomises every few frames, not every frame —
            # real detectors find the same object in consecutive frames,
            # which is exactly what Algorithm 1's history exploits.
            okey = hash((round(float(det.box[2]), 6),
                         round(float(det.box[3]), 6), det.category))
            rng = np.random.default_rng(
                (self.seed * 7_368_787 + okey) % (2 ** 31)
                + variant.index * 97 + (self.frame // 4) * 31)
            # effective-resolution model: the object's share of THE
            # IMAGE IT IS ANALYSED IN decides its gav size level
            level = sroi_mod.size_level_in(det, ref_sr, acc_mod.SMALL_NOA,
                                           acc_mod.MEDIUM_NOA)
            acc = float(variant.gav[level * n_cat + det.category % n_cat])
            if region is not None:
                # geometric penalties of analysing a PI (paper Fig. 1):
                # (a) objects cut by the PI border are detected poorly —
                #     CubeMap's fixed 90-degree grid splits constantly,
                #     SRoIs are centred on objects by construction;
                # (b) gnomonic stretch away from the tangent point
                #     degrades off-axis objects (1 at centre, ~cos^2 d).
                if not _fully_enclosed(det, region):
                    acc *= 0.3
                d = _angular_distance(det, region)
                acc *= max(math.cos(min(d, math.pi / 2)), 0.15) ** 2
            if rng.uniform() < acc:
                jitter = (1.0 - acc) * 0.1
                box = det.box.copy()
                box[0] += rng.normal(0, jitter * box[2])
                box[1] += rng.normal(0, jitter * box[3])
                box[2] *= float(np.exp(rng.normal(0, jitter)))
                box[3] *= float(np.exp(rng.normal(0, jitter)))
                out.append(sroi_mod.Detection(
                    box=box, category=det.category,
                    score=float(np.clip(acc + rng.normal(0, 0.05), 0.05, 1.0))))
        if fp_rng.uniform() < self.fp_rate and candidates:
            ref = candidates[0]
            out.append(sroi_mod.Detection(
                box=ref.box * np.array([1.0, 1.0, 0.7, 0.7]),
                category=int(fp_rng.integers(0, n_cat)), score=0.3))
        return out

    def infer_sroi(self, frame_img, region: sroi_mod.SRoI,
                   variant: acc_mod.ModelProfile):
        del frame_img
        gt = self.video.visible_objects(self.frame)
        cands = [d for d in gt if _in_sroi(d, region)]
        tag = hash((round(region.center[0], 3), round(region.center[1], 3))) % 9973
        return self._detect(cands, variant, tag,
                            ref_sr=sroi_mod.region_solid_angle(*region.fov),
                            region=region)

    def infer_srois_batched(self, items, variant: acc_mod.ModelProfile):
        """Batched entry point of the variant-queue machinery.

        ``items`` is a list of ``(frame_img, region)`` pairs.  The
        oracle samples from per-stream ground truth, so the "batch" is
        semantic — results are bit-identical to per-request
        :meth:`infer_sroi` calls, which is exactly what the
        batched-vs-inline equivalence tests pin.
        """
        return [self.infer_sroi(frame_img, region, variant)
                for frame_img, region in items]

    def infer_erp(self, frame_img, variant: acc_mod.ModelProfile):
        """Full-ERP inference: distortion + downsampling degrade small
        objects — modelled as a size-level demotion of the gav."""
        del frame_img
        gt = self.video.visible_objects(self.frame)
        demoted = dataclasses.replace(
            variant, gav=np.concatenate([
                variant.gav[:len(variant.gav) // 3] * 0.3,   # small: mostly lost
                variant.gav[len(variant.gav) // 3: 2 * len(variant.gav) // 3] * 0.6,
                variant.gav[2 * len(variant.gav) // 3:] * 0.9,
            ]))
        return self._detect(gt, demoted, region_tag=0, ref_sr=4 * math.pi)


class TorchDetectorBackend:
    """Real path: gnomonic projection (CUDA kernels) + the PyTorch
    detector ladder; the port of the reference's ``JaxDetectorBackend``.

    Exposes BOTH execution paths of the serving loop:

      * :meth:`infer_sroi` — the per-request path (one forward per PI,
        its projection through the gnomonic sampling kernel);
      * :meth:`launch_srois_batched` — the tick path: one variant's
        crops are projected together (the batched projection kernel,
        behind a cross-tick crop cache), zero-padded up to a batch-size
        bucket and pushed through ONE ``apply`` + masked ``decode``.
        PyTorch runs eagerly, so there is no compile cache;
        ``trace_count`` counts the distinct (variant, padded batch)
        shapes a serving lifetime has run.

    Everything runs on ``device`` (default ``cuda``; with no CUDA device
    and no device given the constructor raises).  Float32 throughout:
    the constructor turns TF32 off (``repro_torch.device.set_fp32_policy``).
    Decoded rows come back to the host once per chunk; the
    back-projection of a row's few boxes to SphBBs runs there, in
    float32.
    """

    def __init__(self, variants_cfg, params_per_variant, conf: float = 0.25,
                 max_det: int = 16, buckets=None,
                 fused: bool = True, crop_cache_size: int = 256,
                 device: str | torch.device | None = None):
        from repro_torch.device import resolve_device, set_fp32_policy
        from repro_torch.serving.batching import ShapeBuckets

        self.device = resolve_device(device)
        set_fp32_policy()
        self.cfgs = list(variants_cfg)
        self.params = [_params_to(p, self.device) for p in params_per_variant]
        self.conf = conf
        self.max_det = max_det
        self.buckets = buckets or ShapeBuckets(
            resolutions=tuple(sorted({c.input_size for c in self.cfgs})))
        self._shapes: set = set()
        self.trace_count = 0  # distinct (variant, padded batch) shapes run
        # fused tick: batched gnomonic projection (one launch per chunk
        # instead of one `_project` per crop) + a cross-tick crop cache
        # keyed on pitch-quantised region geometry.  `fused=False`
        # restores the staged per-crop path.
        self.fused = fused
        self.crop_cache_size = crop_cache_size if fused else 0
        # key -> (frame ref, guard, pi, ct, cp, fov)
        self._crop_cache: dict = {}
        self.crop_cache_hits = 0
        self.crop_cache_misses = 0

    def _device_frame(self, frame_img) -> torch.Tensor:
        """``frame_img`` as a float32 tensor on the backend's device,
        uploaded anew on every call (as the reference does), so a frame
        is always served from its own pixels."""
        if isinstance(frame_img, torch.Tensor):
            return frame_img.to(device=self.device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(frame_img, dtype=np.float32),
                               device=self.device)

    def _project(self, frame_img, region: sroi_mod.SRoI, size: int):
        """SRoI -> (size, size, 3) PI on the device, through the gnomonic
        sampling kernel (its plain version for a CPU backend)."""
        from repro_torch.kernels.gnomonic import ops as gno_ops

        return gno_ops.project_sroi_kernel(
            self._device_frame(frame_img), region.center[0], region.center[1],
            region.fov, (size, size))

    def _row_to_dets(self, boxes, scores, classes,
                     region: sroi_mod.SRoI, size: int, geom=None):
        """Back-project one host row of decoded PI boxes to SphBB
        detections, in one vectorised ``pi_box_to_sphbb`` call over the
        row's live detections.  ``geom`` overrides the back-projection
        geometry: a crop-cache hit reuses the PI projected at the anchor
        region, so its boxes lift through the anchor's geometry."""
        from repro_torch.core.sphere import pi_box_to_sphbb

        live = np.flatnonzero(scores > 0)
        if live.size == 0:
            return []
        ct, cp, fov = (geom if geom is not None
                       else (region.center[0], region.center[1], region.fov))
        sphbbs = pi_box_to_sphbb(torch.from_numpy(boxes[live]), ct, cp, fov,
                                 (size, size)).numpy()
        return [sroi_mod.Detection(box=sphbbs[i], category=int(classes[r]),
                                   score=float(scores[r]))
                for i, r in enumerate(live)]

    @torch.inference_mode()
    def infer_sroi(self, frame_img, region: sroi_mod.SRoI,
                   variant: acc_mod.ModelProfile):
        from repro_torch.models import detector as det_mod

        idx = variant.index - 1
        cfg = self.cfgs[idx]
        size = cfg.input_size
        pi = self._project(frame_img, region, size)
        outs = det_mod.apply(self.params[idx], pi[None], cfg)
        boxes, scores, classes = det_mod.decode(outs, cfg, self.conf,
                                                max_det=self.max_det)
        return self._row_to_dets(boxes[0].cpu().numpy(),
                                 scores[0].cpu().numpy(),
                                 classes[0].cpu().numpy(), region, size)

    def _batched_fn(self, idx: int, b_pad: int):
        """The (apply + masked decode) forward of one (variant, padded
        batch) shape; counts the distinct shapes in ``trace_count``."""
        from repro_torch.models import detector as det_mod

        if (idx, b_pad) not in self._shapes:
            self._shapes.add((idx, b_pad))
            self.trace_count += 1
        cfg = self.cfgs[idx]

        def forward(params, imgs, valid):
            outs = det_mod.apply(params, imgs, cfg)
            return det_mod.decode(outs, cfg, self.conf,
                                  max_det=self.max_det, valid=valid)

        return forward

    # ---- cross-tick crop cache -------------------------------------
    #
    # Static scenes re-project near-identical SRoIs tick after tick.
    # A crop is reusable when (a) the source frame is the same array
    # (a weak reference to the anchor's frame must still point at it,
    # so id() reuse after gc can never alias a different frame, and a
    # strided content guard must match) and (b) the region geometry
    # moved less than the bucket's pixel pitch (fov / size): quantising
    # centre and fov at the pitch makes sub-pixel drift hash to the
    # anchor's key.  Hits return the anchor's PI *and geometry*, so
    # back-projection equals re-serving the anchor region.

    @staticmethod
    def _frame_guard(frame_img) -> bytes:
        h, w = frame_img.shape[:2]
        sample = np.asarray(frame_img[::max(1, h // 8), ::max(1, w // 8)])
        return np.ascontiguousarray(sample).tobytes()

    @staticmethod
    def _crop_key(frame_img, region: sroi_mod.SRoI, size: int):
        fx, fy = float(region.fov[0]), float(region.fov[1])
        px, py = fx / size, fy / size  # radians per output pixel
        return (id(frame_img), frame_img.shape[:2], size,
                round(float(region.center[0]) / px),
                round(float(region.center[1]) / py),
                round(fx / px), round(fy / py))

    def _cache_put(self, key, frame_img, guard, pi,
                   region: sroi_mod.SRoI) -> None:
        if len(self._crop_cache) >= self.crop_cache_size:
            self._crop_cache.pop(next(iter(self._crop_cache)))
        self._crop_cache[key] = (
            weakref.ref(frame_img), guard, pi, float(region.center[0]),
            float(region.center[1]),
            (float(region.fov[0]), float(region.fov[1])))

    def _project_chunk(self, chunk, size: int):
        """Project one chunk's crops: cache lookups + ONE batched
        projection launch for the misses, over the chunk's distinct
        frames (each crop indexes its frame; no frame is copied per
        crop).

        Returns ``(pis, geoms)`` — the (b, S, S, 3) PI stack and the
        per-item back-projection geometry (the anchor's for hits).
        """
        from repro_torch.kernels.gnomonic.ops import project_srois_batched

        b = len(chunk)
        rows: list = [None] * b
        geoms: list = [None] * b
        miss: list[int] = []
        guards: dict[int, bytes] = {}  # per distinct frame per chunk
        keys: list = [None] * b
        for i, (frame_img, region) in enumerate(chunk):
            geoms[i] = (region.center[0], region.center[1],
                        (float(region.fov[0]), float(region.fov[1])))
            if not self.crop_cache_size:
                miss.append(i)
                continue
            key = keys[i] = self._crop_key(frame_img, region, size)
            ent = self._crop_cache.get(key)
            if ent is not None and ent[0]() is frame_img:
                guard = guards.get(id(frame_img))
                if guard is None:
                    guard = guards[id(frame_img)] = self._frame_guard(frame_img)
                if ent[1] == guard:
                    self.crop_cache_hits += 1
                    rows[i] = ent[2]
                    geoms[i] = (ent[3], ent[4], ent[5])
                    continue
            self.crop_cache_misses += 1
            miss.append(i)
        if miss:
            # each distinct frame of the chunk is uploaded once, into
            # its slot of one (F, H, W, C) stack
            slot: dict[int, int] = {}  # id(frame) -> index into `frames`
            distinct = []
            frame_idx = []
            for i in miss:
                f = chunk[i][0]
                if id(f) not in slot:
                    slot[id(f)] = len(distinct)
                    distinct.append(f)
                frame_idx.append(slot[id(f)])
            frames = torch.empty(
                (len(distinct),) + tuple(distinct[0].shape),
                dtype=torch.float32, device=self.device)
            for k, f in enumerate(distinct):
                frames[k].copy_(torch.as_tensor(f, dtype=torch.float32))
            fresh = project_srois_batched(
                frames, frame_idx,
                [chunk[i][1].center for i in miss],
                [chunk[i][1].fov for i in miss], (size, size))
            for j, i in enumerate(miss):
                rows[i] = fresh[j]
                if self.crop_cache_size:
                    guard = guards.get(id(chunk[i][0]))
                    if guard is None:
                        guard = guards[id(chunk[i][0])] = self._frame_guard(
                            chunk[i][0])
                    self._cache_put(keys[i], chunk[i][0], guard,
                                    fresh[j].clone(), chunk[i][1])
        return torch.stack(rows), geoms

    @torch.inference_mode()
    def launch_srois_batched(self, items, variant: acc_mod.ModelProfile,
                             group=None):
        """Launch the padded batched forward(s) for a tick's
        same-variant crops WITHOUT waiting for the result.

        Returns a zero-argument resolver producing the per-item
        detection lists; CUDA work is asynchronous, so a caller that
        launches every variant before resolving any overlaps the host
        work of one with the device work of the next.  With
        ``fused=True`` (default) a chunk's crops project in ONE batched
        launch (cache hits skip projection); ``fused=False`` keeps the
        staged per-crop path.  Multi-device replica groups (``group``)
        are not ported yet.
        """
        if group is not None and getattr(group, "n_devices", 1) > 1:
            raise NotImplementedError(
                "sharded replica groups are not ported yet")
        idx = variant.index - 1
        cfg = self.cfgs[idx]
        size = self.buckets.bucket_resolution(cfg.input_size)
        launched = []  # (chunk, geoms, boxes, scores, classes)
        lo = 0
        for b in self.buckets.split(len(items)):
            chunk = items[lo:lo + b]
            lo += b
            if self.fused:
                pis, geoms = self._project_chunk(chunk, size)
            else:
                pis = torch.stack([self._project(f, r, size)
                                   for f, r in chunk])
                geoms = [None] * b
            b_pad = self.buckets.pad_batch(b)
            if b_pad > b:
                pis = torch.cat(
                    [pis, pis.new_zeros((b_pad - b,) + tuple(pis.shape[1:]))])
            valid = torch.arange(b_pad, device=self.device) < b
            boxes, scores, classes = self._batched_fn(idx, b_pad)(
                self.params[idx], pis, valid)
            launched.append((chunk, geoms, boxes, scores, classes))

        def resolve() -> list[list]:
            out: list[list] = []
            for chunk, geoms, boxes, scores, classes in launched:
                boxes = boxes.cpu().numpy()
                scores = scores.cpu().numpy()
                classes = classes.cpu().numpy()
                for r, (_, region) in enumerate(chunk):
                    out.append(self._row_to_dets(
                        boxes[r], scores[r], classes[r], region, size,
                        geom=geoms[r]))
            return out

        return resolve

    def infer_srois_batched(self, items, variant: acc_mod.ModelProfile,
                            group=None):
        """ONE padded batched forward for a tick's same-variant crops
        (:meth:`launch_srois_batched`, resolved at once)."""
        return self.launch_srois_batched(items, variant, group)()

    @torch.inference_mode()
    def infer_erp(self, frame_img, variant: acc_mod.ModelProfile):
        # ERP-wide pass with the given model on the resized frame
        from repro_torch.core.projection import (erp_resize_coords,
                                                 sample_erp_bilinear)
        from repro_torch.models import detector as det_mod

        idx = variant.index - 1
        cfg = self.cfgs[idx]
        size = cfg.input_size
        u, v = erp_resize_coords((size, size), frame_img.shape[:2],
                                 self.device)
        resized = sample_erp_bilinear(self._device_frame(frame_img), u, v)
        outs = det_mod.apply(self.params[idx], resized[None], cfg)
        boxes, scores, classes = det_mod.decode(outs, cfg, self.conf,
                                                max_det=self.max_det)
        h, w = frame_img.shape[:2]
        dets = []
        for b, s, c in zip(boxes[0].cpu().numpy(), scores[0].cpu().numpy(),
                           classes[0].cpu().numpy()):
            if s <= 0:
                continue
            # rectangular BB on the ERP -> SphBB via ERP coords
            x0, y0, x1, y1 = b * np.array([w / size, h / size] * 2)
            theta = ((x0 + x1) / 2 / w - 0.5) * 2 * math.pi
            phi = (0.5 - (y0 + y1) / 2 / h) * math.pi
            dth = (x1 - x0) / w * 2 * math.pi
            dph = (y1 - y0) / h * math.pi
            dets.append(sroi_mod.Detection(
                box=np.array([theta, phi, abs(dth), abs(dph)]),
                category=int(c), score=float(s)))
        return dets


def _params_to(tree, device: torch.device):
    """A parameter tree with every tensor moved to ``device``."""
    if isinstance(tree, dict):
        return {k: _params_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_params_to(v, device) for v in tree]
    return tree.to(device)
