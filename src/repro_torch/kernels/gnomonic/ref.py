"""Plain PyTorch versions of the gnomonic kernels.

``gnomonic_sample_ref`` is :func:`repro_torch.core.projection.sample_erp_bilinear`;
``project_srois_ref`` is the per-crop composition of ``gnomonic_coords``
and that sampler that the batched kernel fuses.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.projection import gnomonic_coords, sample_erp_bilinear


def gnomonic_sample_ref(erp: torch.Tensor, u: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    return sample_erp_bilinear(erp, u, v)


def project_srois_ref(frames: torch.Tensor, frame_idx: torch.Tensor,
                      centers: torch.Tensor, fovs: torch.Tensor,
                      out_size: tuple[int, int]) -> torch.Tensor:
    """(F, H, W, C) frames, (B,) frame index, (B, 2) centres and FoVs ->
    (B, S, S, C) PIs, one crop at a time."""
    erp_size = tuple(frames.shape[1:3])
    rows = []
    for f, (ct, cp), (fx, fy) in zip(frame_idx.tolist(), centers.tolist(),
                                     fovs.tolist()):
        u, v = gnomonic_coords(ct, cp, (fx, fy), out_size, erp_size,
                               frames.device)
        rows.append(sample_erp_bilinear(frames[f], u, v))
    return torch.stack(rows)


def project_sroi_f64(frame: torch.Tensor, center_theta: float,
                     center_phi: float, fov, size: int) -> torch.Tensor:
    """One crop with the gnomonic map of ``gnomonic_coords`` evaluated in
    float64 and sampled from the float64 frame -> (S, S, C) float64.

    The yardstick for the float32 projections where they are
    ill-conditioned: one ulp of ``u`` is 2.4e-4 px at W=3840, and near a
    pole ``atan2``/``asin`` amplify it, so two float32 versions that
    fuse the map differently can differ there by more than any fixed
    tolerance, while each stays close to this map.
    """
    f64, dev = torch.float64, frame.device
    h, w = frame.shape[:2]
    t = (torch.arange(size, dtype=f64, device=dev) + 0.5) / size - 0.5
    y, x = torch.meshgrid(-2.0 * math.tan(fov[1] / 2) * t,
                          2.0 * math.tan(fov[0] / 2) * t, indexing="ij")
    n = torch.sqrt(1.0 + x * x + y * y)
    d0, d1, d2 = 1.0 / n, x / n, y / n
    st, ct = math.sin(center_theta), math.cos(center_theta)
    sp, cp = math.sin(center_phi), math.cos(center_phi)
    # rotation_from_origin(theta, phi) applied to d, then cart_to_sph
    wx = cp * ct * d0 - st * d1 - sp * ct * d2
    wy = cp * st * d0 + ct * d1 - sp * st * d2
    wz = sp * d0 + cp * d2
    u = (torch.atan2(wy, wx) / (2 * math.pi) + 0.5) * w
    v = (0.5 - torch.asin(wz.clamp(-1.0, 1.0)) / math.pi) * h
    return sample_erp_bilinear(frame.to(f64), u, v)


__all__ = ["gnomonic_sample_ref", "project_srois_ref", "project_sroi_f64",
           "gnomonic_coords"]
