"""The REAL inference path of the PyTorch port, end to end, on actual
pixels (the twin of ``examples/real_detector_pipeline.py``).

Renders synthetic ERP frames, extracts SRoI perspective images with the
gnomonic CUDA kernel, runs the PyTorch CSP detector ladder on them,
back-projects detections to SphBBs and applies spherical NMS — every
data-plane stage of the paper's Fig. 5 with no oracle anywhere.
Detectors are randomly initialised from a seeded ``torch.Generator``
(no pretrained weights offline), so boxes are not semantically
meaningful; the point is the full pipeline executing on real tensors.

It runs on the card; ``--device cpu`` runs the kernels' plain PyTorch
versions instead:

    PYTHONPATH=src python examples_torch/real_detector_pipeline.py
    PYTHONPATH=src python examples_torch/real_detector_pipeline.py \\
        --device cpu
"""

import argparse
import dataclasses
import time

import torch

from repro_torch.core.omnisense import OmniSenseLoop
from repro_torch.data.synthetic import make_video, render_erp
from repro_torch.models import detector as det_mod
from repro_torch.serving import profiles
from repro_torch.serving.network import NetworkModel
from repro_torch.serving.scheduler import (OmniSenseLatencyModel,
                                           TorchDetectorBackend)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the detector and the kernels run (cuda, "
                         "or cpu for the plain versions)")
    args = ap.parse_args()

    video = make_video(n_frames=6, n_objects=20, seed=7)
    # reduced detector ladder (CPU-friendly input sizes)
    cfgs = [dataclasses.replace(c, input_size=max(64, c.input_size // 8
                                                  // 32 * 32),
                                n_classes=16)
            for c in det_mod.PAPER_LADDER[:3]]
    params = [det_mod.init_params(torch.Generator().manual_seed(i), c)
              for i, c in enumerate(cfgs)]
    variants = profiles.make_ladder(n_categories=16)[:3]
    backend = TorchDetectorBackend(cfgs, params, conf=0.05, max_det=4,
                                   device=args.device)
    lat = OmniSenseLatencyModel(profiles.paper_profile(), NetworkModel())
    loop = OmniSenseLoop(variants, lat, backend, budget_s=2.0,
                         n_categories=16,
                         explore_costs=[0.1, 0.2, 0.3])

    for f in range(3):
        frame = render_erp(video, f, height=192, width=384)
        t0 = time.perf_counter()
        res = loop.process_frame(frame)
        if backend.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"frame {f}: {len(res.srois)} SRoIs -> "
              f"{len(res.detections)} SphBB detections "
              f"(host wall {wall:.2f}s, incl. kernel builds and cuDNN "
              f"set-up on the first frame)")
        for d in res.detections[:3]:
            print(f"    cat={d.category:2d} score={d.score:.2f} "
                  f"box=({d.box[0]:+.2f},{d.box[1]:+.2f},"
                  f"{d.box[2]:.2f},{d.box[3]:.2f})")
    print(f"\nfull real-tensor pipeline OK on {backend.device} "
          "(gnomonic kernel -> detector -> SphBB -> spherical NMS)")


if __name__ == "__main__":
    main()
