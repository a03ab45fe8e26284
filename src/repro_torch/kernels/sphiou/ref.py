"""Plain PyTorch versions of the SphIoU kernel.

* float32: the framework reference
  :func:`repro_torch.core.sphere.sph_iou_matrix`, which broadcasts over
  leading batch axes, so it is its own batched twin;
* bf16 compute: :func:`sphiou_ref_batch_bf16`, the reference kernel's
  tile body (``repro/kernels/sphiou/sphiou.py`` ``_iou_tile`` and
  ``_intersection``, explicit scalar trig) on bf16 tensors, so every
  intermediate is rounded to bf16 as the kernel's bf16 entry rounds it.
"""

from __future__ import annotations

import torch

from repro_torch.core.sphere import sph_iou_matrix as sphiou_ref

Tensor = torch.Tensor

# (B, N, 4) x (B, M, 4) -> (B, N, M)
sphiou_ref_batch = sphiou_ref


def _intersection(ta, pa, ha, va, tb, pb, hb, vb):
    """Intersection with box A rotated to the origin (one direction)."""
    dt = tb - ta
    cpa, spa = torch.cos(pa), torch.sin(pa)
    cpb, spb = torch.cos(pb), torch.sin(pb)
    cdt = torch.cos(dt)
    # B's centre direction expressed in A's tangent frame
    x = cpa * cpb * cdt + spa * spb
    y = cpb * torch.sin(dt)
    z = -spa * cpb * cdt + cpa * spb
    dlon = torch.atan2(y, x)
    dlat = torch.asin(torch.clamp(z, -1.0, 1.0))
    lon_lo = torch.maximum(-ha, dlon - hb)
    lon_hi = torch.minimum(ha, dlon + hb)
    lat_lo = torch.maximum(-va, dlat - vb)
    lat_hi = torch.minimum(va, dlat + vb)
    lon_w = torch.clamp(lon_hi - lon_lo, min=0.0)
    lat_w = torch.where(lat_hi > lat_lo,
                        torch.sin(lat_hi) - torch.sin(lat_lo),
                        torch.zeros((), dtype=ha.dtype, device=ha.device))
    return lon_w * torch.clamp(lat_w, min=0.0)


def sphiou_ref_batch_bf16(a: Tensor, b: Tensor) -> Tensor:
    """(B, N, 4) x (B, M, 4) float32 -> (B, N, M) float32 SphIoU computed
    in bf16."""
    a = a.to(torch.bfloat16)
    b = b.to(torch.bfloat16)
    ta, pa = a[..., :, None, 0], a[..., :, None, 1]
    ha, va = a[..., :, None, 2] * 0.5, a[..., :, None, 3] * 0.5
    tb, pb = b[..., None, :, 0], b[..., None, :, 1]
    hb, vb = b[..., None, :, 2] * 0.5, b[..., None, :, 3] * 0.5
    # symmetrised intersection (repro/core/sphere.py sph_iou)
    inter = 0.5 * (_intersection(ta, pa, ha, va, tb, pb, hb, vb)
                   + _intersection(tb, pb, hb, vb, ta, pa, ha, va))
    area_a = 4.0 * ha * torch.sin(va)  # 2 * dtheta * sin(dphi / 2)
    area_b = 4.0 * hb * torch.sin(vb)
    iou = inter / torch.clamp(area_a + area_b - inter, min=1e-12)
    return iou.to(torch.float32)


__all__ = ["sphiou_ref", "sphiou_ref_batch", "sphiou_ref_batch_bf16"]
