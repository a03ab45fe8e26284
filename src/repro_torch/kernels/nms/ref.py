"""Plain PyTorch version of the per-row greedy suppression kernel: the
reference's batched ``lax.while_loop`` (``repro/core/sphere.py``
``_sph_nms_batch_device``) written out in torch."""

from __future__ import annotations

import torch


def greedy_suppress_rows_ref(iou: torch.Tensor, scores: torch.Tensor,
                             mask: torch.Tensor, iou_threshold: float
                             ) -> torch.Tensor:
    """(B, N, N) IoU, (B, N) scores and validity mask -> (B, N) keep.

    Every step keeps each row's best remaining candidate (highest
    score, lowest index on ties) and drops the candidates it overlaps
    by more than ``iou_threshold``; the loop runs once per survivor of
    the fullest row.
    """
    b, n = scores.shape
    keep = torch.zeros((b, n), dtype=torch.bool, device=scores.device)
    active = mask.to(torch.bool).clone()
    cols = torch.arange(n, device=scores.device)[None, :]
    neg_inf = torch.full_like(scores, -torch.inf)
    while bool(active.any()):
        masked = torch.where(active, scores, neg_inf)
        best = torch.argmax(masked, dim=1)                   # (B,)
        has = active.any(dim=1)                              # (B,)
        sel = (cols == best[:, None]) & has[:, None]
        keep |= sel
        iou_best = torch.gather(
            iou, 1, best[:, None, None].expand(b, 1, n))[:, 0, :]
        active &= ~((iou_best > iou_threshold) & has[:, None]) & ~sel
    return keep
