"""Offline latency profiles (paper section IV-B; port of
``repro.serving.profiles``).

The paper profiles each pipeline stage offline on its testbed (Jetson
TX2 mobile + GTX 1080Ti edge).  Neither device exists here, so the
default profile is *calibrated to the paper's reported numbers*:

  * Table II model ladder with the input sizes 416/512/640/896/1280;
  * CubeMap-with-model-2 E2E ~1.4 s, CubeMap-with-model-4 ~4.4 s,
    CubeMap-with-model-5 ~8.2 s (Fig. 7 text points);
  * 17.9 Mbps uplink (T-Mobile 5G average used by the paper).

``measure_host_profile`` additionally profiles the *real* PyTorch
detector ladder on the card (CUDA events; on the CPU for
``device="cpu"``), so the latency model can be set beside the H100; the
reproduction benchmark uses the paper-regime profile so latency budgets
(T_e4, T_c2..T_c4) live in the paper's range.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch import tracing
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


def jpeg_profile(quality: int) -> StageCosts:
    """Lossy-compression variant for the Fig. 9a sensitivity study."""
    base = paper_profile()
    # JPEG is cheaper to encode and much smaller on the wire.
    ratio = {100: 0.55, 75: 0.25, 50: 0.18, 25: 0.12}.get(quality, 0.55)
    return dataclasses.replace(
        base,
        encode_s_per_mpix=0.035,
        bytes_per_pixel=3.0 * ratio,
    )


def make_ladder(n_categories: int = acc_mod.N_CATEGORIES,
                seed: int = 0,
                costs: StageCosts | None = None,
                quality_penalty: float = 1.0) -> list[acc_mod.ModelProfile]:
    """The paper's Table II as ModelProfiles (gav ladder + latencies).

    ``quality_penalty`` scales the gav (used by the JPEG sensitivity
    study: degraded inputs degrade every model's accuracy).
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


@torch.inference_mode()
def measure_host_profile(reduced: bool = True, repeats: int = 3,
                         device: str | torch.device | None = "cuda") -> dict:
    """Profile the real PyTorch detector ladder (seconds/image).

    On the card each forward is timed with CUDA events around
    ``repeats`` back-to-back calls, after one warm-up call (cuDNN picks
    its algorithms there); for ``device="cpu"`` the host clock times
    them.  ``reduced`` shrinks input sizes (and keeps the first three
    rungs) so the measurement finishes quickly.  Random weights from a
    seeded generator: the time does not depend on their values.
    """
    from repro_torch.device import resolve_device, set_fp32_policy

    dev = resolve_device(device)
    set_fp32_policy()
    out = {}
    for cfg in det_mod.PAPER_LADDER[:3] if reduced else det_mod.PAPER_LADDER:
        size = cfg.input_size // 4 if reduced else cfg.input_size
        size = max(64, size // 32 * 32)
        c = dataclasses.replace(cfg, input_size=size)
        params = det_mod.init_params(torch.Generator().manual_seed(0), c,
                                     device=dev)
        img = torch.zeros((1, size, size, 3), dtype=torch.float32, device=dev)
        det_mod.apply(params, img, c)  # warm-up
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            tracing.count("host_syncs")
            start.record()
            for _ in range(repeats):
                det_mod.apply(params, img, c)
            end.record()
            end.synchronize()
            tracing.count("host_syncs")
            out[cfg.name] = start.elapsed_time(end) / 1e3 / repeats
        else:
            t0 = time.perf_counter()
            for _ in range(repeats):
                det_mod.apply(params, img, c)
            out[cfg.name] = (time.perf_counter() - t0) / repeats
    return out
