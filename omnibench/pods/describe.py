"""The region-description pod of the port, as a benchmark cell drives
it: Kimi-VL-A3B describing each SRoI of 16 streams.

One ``TorchVlmBackend`` (``repro_torch.serving.tasks``) serves every
stream; each stream runs its own ``OmniSenseLoop`` built by the task
registry's ``region_description`` factories (its ladder of crop sizes,
its latency model, the stream's budget), and ``PodServer.step`` serves
one frame of every stream a tick.  The inputs are the detection pod's
(``omnibench.pods.detect``): one synthetic video a stream, a pool of
rendered frames a stream, the histories seeded from frame 0's objects.
The weights are made in bfloat16 on the card (``omnibench.vlm_weights``)
and the prompt and class ids drawn from the traffic's scene key.

What the timed path derives is recorded for the check
(``omnibench.check_describe``), through wrappers on the run's own
instances and, for the run only, on the model module's functions: each
frame's plan, results and NMS keep-mask (the detection pod's wrappers),
and on the sampled ticks every crop the batched projection made, each
decode's fed ids and logits, and every MoE layer's expert picks, by
prefill chunk and by decode step.  The model's vision tower, prefill and
decode are ``omnibench.vision``, ``omnibench.vlm_prefill`` and
``omnibench.vlm_decode`` ranges of the device trace.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from omnibench import vlm_weights
from omnibench.pods.detect import DetectPod, stream_seed
from omnibench.reference import scene


class DescribePod(DetectPod):
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 spans, log=print):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.spans = spans
        self.n = int(traffic["streams"])
        self.sizes = [int(r["input_size"]) for r in config["ladder"]]
        h, w = config["erp"]
        t = time.perf_counter()
        key = int(traffic["scene_key"])
        self.weights = vlm_weights.make(config, key, self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        log(f"weights: {sum(t.numel() for t in _leaves(self.weights))} "
            f"parameters in bfloat16 in {time.perf_counter() - t:.1f}s")
        p = config["prompt"]
        ids = np.random.default_rng([key, 5]).choice(
            config["vocab_size"], p["pre"] + p["post"] + config["n_classes"],
            replace=False)
        self.pre_ids = ids[:p["pre"]].tolist()
        self.post_ids = ids[p["pre"]:p["pre"] + p["post"]].tolist()
        self.class_ids = ids[p["pre"] + p["post"]:].tolist()
        t = time.perf_counter()
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
        self.records: dict[int, list[dict]] = {}
        self.crops: dict[int, list] = {}
        self.launches: dict[int, list] = {}
        self.decoded: dict[int, list] = {}
        self.routes: dict[int, dict] = {}
        self.resized: dict = {}
        self._finishing = None
        self._segment = None
        self.capture_ticks: set[int] = set()
        self.tick = -1
        self._slots = [0] * self.n
        self._install()

    # -- the program --------------------------------------------------------

    def reference_ladder(self, stream: int):
        from omnibench.reference import vlm_plan

        return vlm_plan.make_ladder(self.config["n_classes"],
                                    self.sizes), None

    def _build_program(self) -> None:
        from repro_torch.models.kimi_vl import config_from_dict
        from repro_torch.serving import tasks
        from repro_torch.serving.batching import ShapeBuckets
        from repro_torch.serving.server import PodServer

        c = self.config
        task = tasks.get_task("region_description")
        # the configuration's crop sizes (the published ladder's, or a
        # test's smaller ones) on the registered rungs
        ladder = [dataclasses.replace(v, input_size=r["input_size"])
                  for v, r in zip(task.make_ladder(
                      n_categories=c["n_classes"]), c["ladder"], strict=True)]
        assert [v.name for v in ladder] == [r["name"] for r in c["ladder"]]
        self.ladder = ladder
        lat = task.make_latency_model()
        self.cfg = config_from_dict(c, c["name"])
        buckets = ShapeBuckets.for_max_batch(c["max_batch"],
                                             tuple(self.sizes))
        self.backend = tasks.TorchVlmBackend(
            self.cfg, self.weights, pre_ids=self.pre_ids,
            post_ids=self.post_ids, class_ids=self.class_ids,
            answer_len=c["answer_tokens"], buckets=buckets,
            device=self.device)
        self.loops = []
        for video in self.videos:
            loop = task.make_loop(ladder, lat, self.backend,
                                  self.traffic["budget_s"],
                                  n_categories=c["n_classes"],
                                  nms_threshold=c["nms_threshold"])
            self._seed(loop, video)
            self.loops.append(loop)
        self.backends = [self.backend] * self.n
        self.server = PodServer(self.loops, self.backends,
                                max_batch=c["max_batch"], buckets=buckets,
                                frame_source=self._frame,
                                policy=c["policy"])

    def _install(self) -> None:
        from repro_torch.kernels.gnomonic import ops as gno_ops
        from repro_torch.models import kimi_vl
        from repro_torch.serving import server as server_mod
        from repro_torch.core import sphere

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

        def project(orig):
            def batched(frames, frame_idx, centers, fovs, out_size):
                out = orig(frames, frame_idx, centers, fovs, out_size)
                if self.tick in self.capture_ticks:
                    self.crops.setdefault(self.tick, []).append((
                        (tuple(frames.shape), np.asarray(frame_idx).tolist(),
                         np.asarray(centers, np.float32).copy(),
                         np.asarray(fovs, np.float32).copy(),
                         int(out_size[0])), out))
                return out
            return batched
        sp.on_module(gno_ops, "project_srois_batched", project)

        # the MoE layers' expert picks, by prefill chunk and decode step
        def segment(kind):
            def wrapper(orig):
                def run(*args, **kwargs):
                    if self.tick not in self.capture_ticks:
                        return orig(*args, **kwargs)
                    self._segment = []
                    out = orig(*args, **kwargs)
                    self.routes.setdefault(self.tick, {}).setdefault(
                        kind, []).append(self._segment)
                    self._segment = None
                    return out
                return run
            return wrapper
        sp.on_module(kimi_vl, "prefill", segment("prefill"))
        sp.on_module(kimi_vl, "decode_step", segment("decode"))

        def route(orig):
            def picks(*args, **kwargs):
                out = orig(*args, **kwargs)
                if self._segment is not None:
                    self._segment.append(out[0])
                return out
            return picks
        sp.on_module(kimi_vl, "route", route)

        # each decode's chunks (in the order the backend prefilled them),
        # their first logits, the fed ids and every step's logits
        prefilled = []

        def keep(orig):
            def run(*args, **kwargs):
                out = orig(*args, **kwargs)
                prefilled.append(out)
                return out
            return run
        self.backend._prefill = keep(self.backend._prefill)

        def generate(orig):
            def run(*args, **kwargs):
                fed, logits, cache = orig(*args, **kwargs)
                chunks = prefilled[:]
                prefilled.clear()
                if self.tick in self.capture_ticks:
                    first = torch.cat([c.last for c in chunks])
                    self.decoded.setdefault(self.tick, []).append(dict(
                        items=[(c.size, list(c.items)) for c in chunks],
                        first=first.to(torch.bfloat16), fed=fed,
                        logits=[x.to(torch.bfloat16) for x in logits]))
                return fed, logits, cache
            return run
        sp.on_module(kimi_vl, "generate", generate)

        # the model's layers as ranges of the device trace
        for name, layer in (("image_tokens", "vision"),
                            ("prefill", "vlm_prefill"),
                            ("generate", "vlm_decode")):
            sp.on_module(kimi_vl, name,
                         lambda orig, layer=layer: sp.wrap(orig, layer))

    # -- driving ------------------------------------------------------------

    def warm_shapes(self) -> None:
        """Every (rung, chunk size) vision and prefill shape, once, and a
        decode of the largest chunks, so that no shape meets the card
        first in the window."""
        from repro_torch.core.sroi import SRoI

        b = self.backend
        frame = self.pool[0][0]
        region = SRoI(center=(0.0, 0.0), fov=(1.0, 1.0))
        b.stage_frames([frame])
        with torch.inference_mode():
            for v in self.ladder:
                for n in range(1, self.config["max_batch"] + 1):
                    b.launch_srois_batched([(frame, region)] * n, v)
                b._decode()
        b.release_frames()
        self.sync()

    def tick_flops(self, tick: int) -> int:
        """The matrix-product FLOPs of the tick's requests: vision,
        prefill and decode of each at its rung (``omnibench.vlm_flops``)."""
        from omnibench.vlm_flops import request_flops

        per = {s: request_flops(self.config, s) for s in self.sizes}
        return sum(per[q.variant.input_size]
                   for rec in self.records.get(tick, [])
                   if rec.get("pending") is not None
                   for q in rec["pending"].requests)

    def counters(self) -> dict:
        from repro_torch.kernels import _build

        return dict(frame_uploads=self.backend.frame_uploads,
                    launches=_build.launch_counts())

    def release(self) -> None:
        """Free the program's state (its caches and buffers) before the
        reference runs; the weights stay, the reference reads them."""
        self.spans.restore()
        self.server = self.backend = self.loops = self.backends = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


Pod = DescribePod


def check(pod: DescribePod, sample: list[int], produce=None):
    from omnibench.check_describe import check_pod

    return check_pod(pod, sample, produce=produce)
