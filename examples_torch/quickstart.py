"""Quickstart (the PyTorch port's twin of ``examples/quickstart.py``):
OmniSense on a synthetic 360-degree stream in ~10 seconds.

Runs the full per-frame loop (SRoI prediction -> latency-constrained
model allocation -> inference -> spherical NMS) against a synthetic
scene with the calibrated oracle backend and the paper-regime network
model, then reports Sph-mAP vs the CubeMap baseline.

    PYTHONPATH=src python examples_torch/quickstart.py

The oracle backend and the allocator are NumPy, so it prints the same
lines as the reference's quickstart.
"""

import numpy as np

from repro_torch.core.omnisense import OmniSenseLoop
from repro_torch.data.synthetic import make_video
from repro_torch.serving import baselines, profiles
from repro_torch.serving.evaluation import sph_map
from repro_torch.serving.network import NetworkModel
from repro_torch.serving.scheduler import OmniSenseLatencyModel, OracleBackend


def main():
    video = make_video(n_frames=28, n_objects=50, seed=3)
    frames = range(24)
    gts = [(f, d) for f in frames for d in video.visible_objects(f)]

    variants = profiles.make_ladder()
    lat = OmniSenseLatencyModel(profiles.paper_profile(), NetworkModel())
    backend = OracleBackend(video)
    costs = [lat._pre(v) + lat._inf(v) for v in variants]
    loop = OmniSenseLoop(variants, lat, backend, budget_s=2.0,
                         explore_costs=costs)

    preds, lats = [], []
    for f in frames:
        backend.set_frame(f)
        res = loop.process_frame(None)
        preds.extend((f, d) for d in res.detections)
        lats.append(res.planned_latency)
        marks = "".join("*" if m else "." for m in
                        (res.plan.models if res.plan else []))
        print(f"frame {f:2d}: {len(res.srois):2d} SRoIs plan=[{marks}] "
              f"{len(res.detections):2d} detections "
              f"lat={res.planned_latency:.2f}s"
              f"{'  [discovery]' if res.discovered else ''}")

    acc = sph_map(preds, gts)
    print(f"\nOmniSense: Sph-mAP={acc:.3f} @ mean {np.mean(lats):.2f}s/frame")

    lat2 = OmniSenseLatencyModel(profiles.paper_profile(), NetworkModel())
    cm_preds, cm_t = baselines.run_cubemap_baseline(
        video, OracleBackend(video), lat2, variants[2], frames)
    print(f"CubeMap-3: Sph-mAP={sph_map(cm_preds, gts):.3f} @ {cm_t:.2f}s/frame")


if __name__ == "__main__":
    main()
