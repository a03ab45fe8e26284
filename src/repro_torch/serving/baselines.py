"""The paper's two resource-agnostic baselines (section V-B).

* ``ERP``     — feed the whole (downsampled) ERP frame to one detector;
  convert rectangular BBs to SphBBs.
* ``CubeMap`` — project the frame onto the 6 cube faces (90x90 FoV
  PIs), run the detector on each face, back-project and merge.

Both run every frame with a FIXED model — no content/network
adaptivity — which is exactly what OmniSense's allocator beats.
E2E latencies follow the same stage-cost + network model as OmniSense
(CubeMap pipelines face preprocessing with inference, like the paper's
implementation does).
"""

from __future__ import annotations

import math

import numpy as np

from repro_torch.core import accuracy as acc_mod
from repro_torch.core import allocation, sroi as sroi_mod
from repro_torch.core.omnisense import InferenceRequest
from repro_torch.core.sphere import pad_detection_rows, sph_nms_batch
from repro_torch.serving.batching import QueuedRequest, ShapeBuckets, VariantQueues
from repro_torch.serving.scheduler import OmniSenseLatencyModel

CUBE_CENTERS = [
    (0.0, 0.0), (math.pi / 2, 0.0), (math.pi, 0.0), (-math.pi / 2, 0.0),
    (0.0, math.pi / 2), (0.0, -math.pi / 2),
]


def run_erp_baseline(video, backend, latency: OmniSenseLatencyModel,
                     variant: acc_mod.ModelProfile, frames: range):
    """Returns (predictions [(frame, det)], mean E2E seconds)."""
    preds = []
    e2e = []
    for f in frames:
        backend.set_frame(f)
        dets = backend.infer_erp(None, variant)
        for d in dets:
            preds.append((f, d))
        t = latency._pre(variant) + latency._inf(variant)
        if variant.location != "device":
            latency.observe_delivery(variant)
        e2e.append(t)
    return preds, float(np.mean(e2e))


def run_cubemap_baseline(video, backend, latency: OmniSenseLatencyModel,
                         variant: acc_mod.ModelProfile, frames: range,
                         nms_threshold: float = 0.6,
                         face_batch: int = 1):
    """Six 90-degree faces through the pod's variant-queue machinery.

    Faces enqueue as :class:`InferenceRequest`s and drain through the
    same bucketed ``infer_srois_batched`` dispatch path as
    ``PodServer`` (resource-agnostic baselines share the serving
    engine, they just never adapt).  ``face_batch=1`` reproduces the
    paper's single-GPU implementation — preprocessing pipelined with
    per-face inference — and keeps the calibrated E2E formula exactly;
    ``face_batch>1`` additionally batches faces per forward (beyond
    paper: serial preprocessing + sub-linear batched inference).

    Frames are independent (no detection feedback), so the overlapping
    face-edge detections of the WHOLE range are merged in one padded
    ``sph_nms_batch`` call — one row per frame — instead of a host NMS
    loop per frame.
    """
    fov = (math.pi / 2, math.pi / 2)
    e2e = []
    d_pre = latency._pre(variant)
    d_inf = latency._inf(variant)
    n_faces = len(CUBE_CENTERS)
    buckets = ShapeBuckets.for_max_batch(face_batch)
    if face_batch == 1:
        per_frame_e2e = allocation.plan_latency(
            tuple([1] * n_faces),
            np.array([[0.0] * n_faces, [d_pre] * n_faces]),
            np.array([[0.0] * n_faces, [d_inf] * n_faces]))
    else:
        per_frame_e2e = n_faces * d_pre + sum(
            latency.batched_inference_delay(variant, b)
            for b in buckets.split(n_faces))
    queues = VariantQueues(buckets)
    per_frame: list[tuple[int, list]] = []
    for f in frames:
        backend.set_frame(f)
        for slot, (ct, cp) in enumerate(CUBE_CENTERS):
            region = sroi_mod.SRoI(center=(ct, cp), fov=fov)
            queues.put(QueuedRequest(
                request=InferenceRequest(region=region, variant=variant,
                                         slot=slot, special=False),
                owner=f, backend=backend, latency_model=latency))
        results, _ = queues.drain()
        by_slot = {item.request.slot: d for item, d in results}
        dets = []
        for slot in range(n_faces):
            dets.extend(by_slot[slot])
        per_frame.append((f, dets))
        if variant.location != "device":
            latency.observe_delivery(variant)
        e2e.append(per_frame_e2e)

    preds = []
    rows = [(f, dets) for f, dets in per_frame if dets]
    if rows:
        boxes, scores, mask = pad_detection_rows([dets for _, dets in rows])
        keep = sph_nms_batch(boxes, scores, mask, iou_threshold=nms_threshold)
        for r, (f, dets) in enumerate(rows):
            preds.extend((f, d) for d, k in zip(dets, keep[r]) if k)
    return preds, float(np.mean(e2e))
