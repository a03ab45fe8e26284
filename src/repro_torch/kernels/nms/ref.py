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


def greedy_suppress_rows_scan_ref(iou: torch.Tensor, scores: torch.Tensor,
                                  mask: torch.Tensor, iou_threshold: float
                                  ) -> torch.Tensor:
    """The CUDA kernel's algorithm (``csrc/greedy.cu``) written out in
    torch, for the tests on the CPU: same inputs and keep mask as
    :func:`greedy_suppress_rows_ref`.

    Each valid entry's rank is the number of valid entries that come
    before it (NaN first, then the higher score, then the lower index);
    its word row holds bit ``j % 32`` of word ``j // 32`` set where
    ``iou[b, i, j] > iou_threshold``.  The ranks go by in chunks of 32:
    a chunk's candidates not yet in the removed words stay alive; bit
    ``l'`` of ``sup[l]`` says that rank ``l``'s row overlaps the later rank
    ``l'`` of the chunk; walking the chunk, an alive rank clears its
    ``sup`` bits from the alive set; the alive ranks left are kept, and
    their word rows are ORed into the removed words.
    """
    b, n = scores.shape
    valid = mask.to(torch.bool)
    idx = torch.arange(n)
    lower = idx[:, None] < idx[None, :]                      # j < i
    sj, si = scores[:, :, None], scores[:, None, :]
    nj, ni = torch.isnan(sj), torch.isnan(si)
    before = torch.where(nj | ni, nj & (~ni | lower),
                         (sj > si) | ((sj == si) & lower))   # (B, j, i)
    rank = (before & valid[:, :, None]).sum(dim=1)           # (B, N)
    n_words = (n + 31) // 32
    over = torch.zeros((b, n, n_words * 32), dtype=torch.int64)
    over[:, :, :n] = (iou > iou_threshold).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64) << torch.arange(32)
    words = (over.view(b, n, n_words, 32) * weights).sum(-1).tolist()
    keep = torch.zeros((b, n), dtype=torch.bool)
    for r in range(b):
        order = [0] * int(valid[r].sum())
        for i in torch.nonzero(valid[r]).flatten().tolist():
            order[int(rank[r, i])] = i
        removed = [0] * n_words
        for r0 in range(0, len(order), 32):
            chunk = order[r0:r0 + 32]
            alive = [not (removed[c >> 5] >> (c & 31)) & 1 for c in chunk]
            for l, cl in enumerate(chunk):
                if alive[l]:
                    for m in range(l + 1, len(chunk)):
                        c = chunk[m]
                        if (words[r][cl][c >> 5] >> (c & 31)) & 1:
                            alive[m] = False
            for l, cl in enumerate(chunk):
                if alive[l]:
                    keep[r, cl] = True
                    removed = [a | w for a, w in zip(removed, words[r][cl])]
    return keep.to(scores.device)
