"""Offline latency profiles (paper section IV-B; port of
``repro.serving.profiles``).

The paper profiles each pipeline stage offline on its testbed (Jetson
TX2 mobile + GTX 1080Ti edge).  Neither device exists here, so the
default profile is *calibrated to the paper's reported numbers*:

  * Table II model ladder with the input sizes 416/512/640/896/1280;
  * CubeMap-with-model-2 E2E ~1.4 s, CubeMap-with-model-4 ~4.4 s,
    CubeMap-with-model-5 ~8.2 s (Fig. 7 text points);
  * 17.9 Mbps uplink (T-Mobile 5G average used by the paper).

The reference's ``measure_host_profile`` (profiling the real detector
ladder on the host) is not ported yet.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import accuracy as acc_mod
from repro_torch.models import detector as det_mod


@dataclasses.dataclass(frozen=True)
class StageCosts:
    """Per-variant stage costs; sizes in pixels, times in seconds."""

    project_s_per_mpix: float  # gnomonic projection on the mobile device
    encode_s_per_mpix: float  # lossless PNG encode
    bytes_per_pixel: float  # compressed wire size
    infer_s: dict  # variant name -> model inference seconds


# FLOPs-derived inference times: mobile ~0.14 TFLOP/s effective,
# edge 1080Ti ~3.4 TFLOP/s effective (30% of 11.3 TFLOPs fp32).
_MOBILE_EFF = 0.14e12
_EDGE_EFF = 3.4e12


def paper_profile() -> StageCosts:
    infer = {}
    for i, cfg in enumerate(det_mod.PAPER_LADDER):
        flops = det_mod.flops_per_image(cfg)
        eff = _MOBILE_EFF if i == 0 else _EDGE_EFF
        infer[cfg.name] = float(flops / eff)
    return StageCosts(
        project_s_per_mpix=0.055,   # OpenCV remap on TX2-class CPU
        encode_s_per_mpix=0.080,    # PNG on TX2-class CPU
        bytes_per_pixel=1.5,        # lossless PNG of natural video
        infer_s=infer,
    )


def make_ladder(n_categories: int = acc_mod.N_CATEGORIES,
                seed: int = 0,
                costs: StageCosts | None = None,
                quality_penalty: float = 1.0) -> list[acc_mod.ModelProfile]:
    """The paper's Table II as ModelProfiles (gav ladder + latencies).

    ``quality_penalty`` scales the gav (degraded inputs degrade every
    model's accuracy).
    """
    costs = costs or paper_profile()
    gavs = acc_mod.synthetic_gav_table(len(det_mod.PAPER_LADDER),
                                       n_categories, seed)
    out = []
    locations = ["device", "edge", "edge", "edge", "edge"]
    sizes_mb = [23, 202, 202, 271, 487]
    for i, cfg in enumerate(det_mod.PAPER_LADDER):
        out.append(acc_mod.ModelProfile(
            name=cfg.name,
            index=i + 1,
            input_size=cfg.input_size,
            location=locations[i],
            gav=gavs[i] * quality_penalty,
            infer_s=costs.infer_s[cfg.name],
            model_bytes=sizes_mb[i] * 1024 * 1024,
        ))
    return out
