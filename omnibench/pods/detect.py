"""The detection pod of the port, as a benchmark cell drives it.

One ``TorchDetectorBackend`` on the configuration's ladder serves every
stream; each stream runs its own ``OmniSenseLoop`` (the paper's latency
model, the stream's budget) and ``PodServer.step`` serves one frame of
every stream a tick under the configured policy.  The benchmark makes
the inputs: the weights (``omnibench.weights``), one synthetic video a
stream (``omnibench.reference.scene``) and a pool of rendered frames a
stream, cycled.  The traffic mix's ``scene_key`` makes the weights and
the set of videos with where in its cycle each video starts; the run's
seed orders them (which video each stream shows).  Each served frame is
handed over as a fresh array object over the pooled pixels, so the crop
cache, which is keyed on the live frame, hits only where a live camera
would let it.

What the program derives on the timed path is recorded for the check,
through wrappers on the run's own instances: each frame's plan
(``begin_frame``), its per-request detections and raw detections
(``finish_frame``), its NMS keep-mask (``finalize_detections``), and for
the sampled ticks every crop the batched projection made and every
resized frame a discovery pass read.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from omnibench.reference import scene
from omnibench.reference.detector import Rung
from omnibench.weights import ladder_weights


def stream_seed(key: int, video: int) -> int:
    """The seed of one video, derived from the cell's scene key."""
    return int(np.random.SeedSequence([key, 1, video]).generate_state(1)[0])


class DetectPod:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 spans, log=print):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.spans = spans
        self.n = int(traffic["streams"])
        self.rungs = [Rung(r["name"], r["input_size"], r["width_mult"],
                           r["depth_mult"], r["p6"], config["n_classes"])
                      for r in config["ladder"]]
        h, w = config["erp"]
        t = time.perf_counter()
        # the cell's fixed key makes the weights, one video a stream and
        # where in its frame cycle each video starts, so that every seed
        # serves the same frames; the seed orders them among the streams
        key = int(traffic["scene_key"])
        self.weights = ladder_weights(self.rungs, key, self.device)
        rng = np.random.default_rng([seed, 3])
        self.order = [int(k) for k in rng.permutation(self.n)]
        pool = int(traffic["pool_frames"])
        start = np.random.default_rng([key, 3]).integers(0, pool, self.n)
        self.phase = [int(start[v]) for v in self.order]
        self.videos = [scene.make_video(n_frames=traffic["video_frames"],
                                        n_objects=traffic["objects"],
                                        n_categories=config["n_classes"],
                                        seed=stream_seed(key, v))
                       for v in self.order]
        self.pool = [[scene.render_erp(v, 1 + k, height=h, width=w)
                      for k in range(pool)] for v in self.videos]
        log(f"inputs: {self.n} x {pool} frames {h}x{w}x3 in "
            f"{time.perf_counter() - t:.1f}s; videos by stream {self.order}, "
            f"phases {self.phase}")
        self.budgets = [float(traffic["budget_s"])] * self.n
        self._build_program()
        # what the timed path derived, tick by tick and stream by stream
        self.records: dict[int, list[dict]] = {}
        self.crops: dict[int, list] = {}
        self.launches: dict[int, list] = {}
        self.resized: dict[tuple, torch.Tensor] = {}
        self._finishing = None
        self.capture_ticks: set[int] = set()
        self.tick = -1
        self._slots = [0] * self.n
        self._install()

    # -- the program --------------------------------------------------------

    def reference_ladder(self, stream: int):
        """The stream's ladder and explore costs, worked out again."""
        from omnibench.reference import plan as ref_plan

        return ref_plan.make_ladder(self.config["n_classes"]), None

    def _detector_backend(self, buckets):
        from repro_torch.models.detector import DetectorConfig
        from repro_torch.serving.scheduler import TorchDetectorBackend

        c = self.config
        cfgs = [DetectorConfig(r.name, r.input_size, width_mult=r.width_mult,
                               depth_mult=r.depth_mult,
                               n_classes=c["n_classes"], p6=r.p6)
                for r in self.rungs]
        return TorchDetectorBackend(cfgs, self.weights, conf=c["conf"],
                                    max_det=c["max_det"], buckets=buckets,
                                    device=self.device)

    def _seed(self, loop, video) -> None:
        from repro_torch.core.sroi import Detection

        loop.seed_history([Detection(box=d.box.copy(), category=d.category,
                                     score=d.score)
                           for d in video.visible_objects(0)])

    def _build_program(self) -> None:
        from repro_torch.core.omnisense import OmniSenseLoop
        from repro_torch.serving import profiles
        from repro_torch.serving.batching import ShapeBuckets
        from repro_torch.serving.network import NetworkModel
        from repro_torch.serving.scheduler import OmniSenseLatencyModel
        from repro_torch.serving.server import PodServer

        c = self.config
        buckets = ShapeBuckets.for_max_batch(
            c["max_batch"], tuple(sorted({r.input_size for r in self.rungs})))
        self.backend = self._detector_backend(buckets)
        variants = profiles.make_ladder(n_categories=c["n_classes"])
        lat = OmniSenseLatencyModel(profiles.paper_profile(), NetworkModel())
        self.loops = []
        for video in self.videos:
            loop = OmniSenseLoop(variants, lat, self.backend,
                                 budget_s=self.traffic["budget_s"],
                                 n_categories=c["n_classes"],
                                 nms_threshold=c["nms_threshold"])
            self._seed(loop, video)
            self.loops.append(loop)
        self.backends = [self.backend] * self.n
        self.server = PodServer(self.loops, self.backends,
                                max_batch=c["max_batch"], buckets=buckets,
                                frame_source=self._frame,
                                policy=c["policy"])

    def _frame(self, stream: int, frame_idx: int):
        # a fresh array object over the pooled pixels of this tick's frame
        view = self.pool[stream][self._slots[stream]].view()
        self._frame_stream[id(view)] = stream
        return view

    def _install(self) -> None:
        from repro_torch.core import projection, sphere
        from repro_torch.kernels.gnomonic import ops as gno_ops
        from repro_torch.models import detector as det_mod
        from repro_torch.serving import server as server_mod

        sp = self.spans
        self._frame_stream: dict[int, int] = {}
        sp.on_instance(self.backend, "stage_frames", "stage")
        sp.on_instance(self.server.queues, "drain_ops", "drain")
        for s, loop in enumerate(self.loops):
            self._record_loop(s, loop)

        def nms(orig):
            return sp.wrap(orig, "nms")
        sp.on_module(sphere, "sph_nms_batch", nms)
        sp.on_module(server_mod, "sph_nms_batch", nms)

        def detector(orig):
            def apply(*args, **kwargs):
                if not sp.traced:
                    return orig(*args, **kwargs)
                with torch.profiler.record_function("omnibench.detector"):
                    return orig(*args, **kwargs)
            return apply
        sp.on_module(det_mod, "apply", detector)

        def project(orig):
            def batched(frames, frame_idx, centers, fovs, out_size):
                out = orig(frames, frame_idx, centers, fovs, out_size)
                slots = np.asarray(frame_idx)
                geo = (tuple(frames.shape), slots.copy(),
                       np.asarray(centers, np.float32).copy(),
                       np.asarray(fovs, np.float32).copy(), int(out_size[0]))
                if sp.traced:
                    self.launches.setdefault(self.tick, []).append(geo)
                if self.tick in self.capture_ticks:
                    self.crops.setdefault(self.tick, []).append(
                        ((geo[0], slots.tolist()) + geo[2:], out))
                return out
            return batched
        sp.on_module(gno_ops, "project_srois_batched", project)

        def resize(orig):
            def sample(erp, u, v):
                out = orig(erp, u, v)
                if self.tick in self.capture_ticks and \
                        self._finishing is not None:
                    self.resized[(self.tick, self._finishing)] = out
                return out
            return sample
        sp.on_module(projection, "sample_erp_bilinear", resize)

    def _record_loop(self, s: int, loop) -> None:
        sp = self.spans
        begin, finish, finalize = (loop.begin_frame, loop.finish_frame,
                                   loop.finalize_detections)

        def begin_frame(frame):
            with sp.span("plan"):
                pending = begin(frame)
            self.records[self.tick][s]["pending"] = pending
            return pending

        def finish_frame(pending, request_detections, **kw):
            self._finishing = s
            with sp.span("finish"):
                result = finish(pending, request_detections, **kw)
            self._finishing = None
            rec = self.records[self.tick][s]
            rec["request_dets"] = [list(d) for d in request_detections]
            rec["raw"] = list(result.detections)
            rec["discovered"] = result.discovered
            return result

        def finalize_detections(result, keep):
            out = finalize(result, keep)
            rec = self.records[self.tick][s]
            rec["keep"] = None if keep is None else np.asarray(keep).copy()
            rec["kept"] = list(out.detections)
            return out

        loop.begin_frame = begin_frame
        loop.finish_frame = finish_frame
        loop.finalize_detections = finalize_detections

    # -- driving ------------------------------------------------------------

    def warm_shapes(self) -> None:
        """Every (rung, padded batch) forward and decode the ticks can
        run, once, so that no shape meets the card first in the window."""
        from repro_torch.models import detector as det_mod

        with torch.inference_mode():
            for cfg, params in zip(self.backend.cfgs, self.backend.params):
                s = cfg.input_size
                for b in self.backend.buckets.batch_sizes:
                    x = torch.zeros((b, s, s, 3), device=self.device)
                    valid = torch.arange(b, device=self.device) < b
                    det_mod.decode(det_mod.apply(params, x, cfg), cfg,
                                   self.config["conf"],
                                   max_det=self.config["max_det"],
                                   valid=valid)
        self.sync()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self, tick: int, slots: list[int]) -> None:
        """One pod tick: stream ``s`` serves pooled frame ``slots[s]``;
        returns once the card has finished the tick's work."""
        self.tick = tick
        self._slots = [(k + p) % len(self.pool[0])
                       for k, p in zip(slots, self.phase)]
        self.records[tick] = [dict(slot=self._slots[s]) for s in range(self.n)]
        self._frame_stream = {}
        self.server.step(tick)
        self.sync()

    def tick_flops(self, tick: int) -> int:
        """The convolution FLOPs of the tick's detector forwards: one a
        served request at its rung's size, one a discovery pass at the
        explore rung's (padded rows not counted)."""
        from omnibench.flops import conv_flops_per_image

        per = [conv_flops_per_image(r) for r in self.rungs]
        total = 0
        for rec in self.records.get(tick, []):
            pend = rec.get("pending")
            if pend is None:
                continue
            total += sum(per[q.variant.index - 1] for q in pend.requests)
            if rec.get("discovered"):
                total += per[pend.explore_idx]
        return total

    def tick_counts(self, tick: int) -> dict:
        """What the tick served: requests (one crop each), discovery
        passes, and detections served (before NMS) and kept."""
        out = dict(requests=0, discovery=0, served=0, kept=0)
        for rec in self.records.get(tick, []):
            pend = rec.get("pending")
            out["requests"] += len(pend.requests) if pend is not None else 0
            out["discovery"] += int(bool(rec.get("discovered")))
            out["served"] += len(rec.get("raw", ()))
            out["kept"] += len(rec.get("kept", ()))
        return out

    def describe_tick(self, tick: int) -> str:
        """Requests by rung and discovery passes of one tick."""
        by_rung: dict = {}
        disc = srois = dets = kept = 0
        recs = self.records.get(tick, [])
        for rec in recs:
            pend = rec.get("pending")
            for q in (pend.requests if pend is not None else []):
                by_rung[q.variant.name] = by_rung.get(q.variant.name, 0) + 1
            srois += len(pend.srois) if pend is not None else 0
            dets += len(rec.get("raw", ()))
            kept += len(rec.get("kept", ()))
            disc += int(bool(rec.get("discovered")))
        return (f"requests by rung {dict(sorted(by_rung.items()))}, SRoIs "
                f"{srois}, detections {dets} -> {kept} kept, discovery "
                f"passes {disc}")

    def counters(self) -> dict:
        from repro_torch.kernels import _build

        b = self.backend
        return dict(frame_uploads=b.frame_uploads,
                    crop_cache_hits=b.crop_cache_hits,
                    crop_cache_misses=b.crop_cache_misses,
                    launches=_build.launch_counts())

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.spans.restore()
        self.server = self.backend = self.loops = self.backends = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


Pod = DetectPod


def check(pod: DetectPod, sample: list[int], produce=None):
    from omnibench.check_detect import check_pod

    return check_pod(pod, sample, produce=produce)
