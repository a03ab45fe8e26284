"""Plain PyTorch versions of the SphIoU kernel: the framework reference
:func:`repro_torch.core.sphere.sph_iou_matrix`, which broadcasts over
leading batch axes, so it is its own batched twin."""

from __future__ import annotations

from repro_torch.core.sphere import sph_iou_matrix as sphiou_ref

# (B, N, 4) x (B, M, 4) -> (B, N, M)
sphiou_ref_batch = sphiou_ref

__all__ = ["sphiou_ref", "sphiou_ref_batch"]
