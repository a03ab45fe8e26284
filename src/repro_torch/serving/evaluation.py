"""Spherical mAP (Sph-mAP) — the paper's accuracy metric (section V-B).

Standard VOC-style mean Average Precision with the rectangular IoU
replaced by SphIoU (AAAI'20 spherical criteria).  Matching threshold
0.5; all-point interpolation; mAP averages over categories that appear
in the ground truth.
"""

from __future__ import annotations

import collections

import numpy as np

from repro_torch.core.sphere import sph_iou_matrix_np
from repro_torch.core.sroi import Detection


def sph_ap(preds: list[tuple[int, Detection]],
           gts: list[tuple[int, Detection]],
           iou_threshold: float = 0.5) -> float:
    """AP for one category.  Items are (frame_idx, detection).

    IoUs are precomputed as ONE vectorised (preds x gts) matrix per
    frame on the host (the matching loop itself is sequential because
    greedy matching consumes ground truths in score order, but it only
    reads cached rows — no per-prediction jax dispatch).
    """
    if not gts:
        return float("nan")
    gt_by_frame: dict[int, list[Detection]] = collections.defaultdict(list)
    for f, d in gts:
        gt_by_frame[f].append(d)
    matched: dict[int, np.ndarray] = {
        f: np.zeros(len(v), bool) for f, v in gt_by_frame.items()}

    preds_sorted = sorted(preds, key=lambda fd: -fd[1].score)

    # one IoU matrix per frame: rows = that frame's predictions in
    # global (score-sorted) order, columns = its ground truths
    pred_rows: dict[int, list[int]] = collections.defaultdict(list)
    for i, (f, _) in enumerate(preds_sorted):
        pred_rows[f].append(i)
    iou_rows: dict[int, np.ndarray] = {}
    for f, idxs in pred_rows.items():
        cands = gt_by_frame.get(f)
        if not cands:
            continue
        mat = sph_iou_matrix_np(
            np.stack([preds_sorted[i][1].box for i in idxs]),
            np.stack([c.box for c in cands]))
        for row, i in enumerate(idxs):
            iou_rows[i] = mat[row]

    tp = np.zeros(len(preds_sorted))
    fp = np.zeros(len(preds_sorted))
    for i, (f, det) in enumerate(preds_sorted):
        ious = iou_rows.get(i)
        if ious is None:
            fp[i] = 1
            continue
        best = int(np.argmax(ious))
        if ious[best] >= iou_threshold and not matched[f][best]:
            matched[f][best] = True
            tp[i] = 1
        else:
            fp[i] = 1

    n_gt = len(gts)
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    recall = tp_cum / n_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
    # all-point interpolation
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.nonzero(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def action_top1(preds: list[tuple[int, Detection]],
                gts: list[tuple[int, Detection]],
                iou_threshold: float = 0.5) -> float:
    """Top-1 action accuracy over localised ground-truth instances.

    The action task's offline proxy (``repro.serving.tasks``): items
    are (frame_idx, detection) with ``category`` = action class.  A
    ground-truth instance counts as correct when some same-frame
    prediction overlaps it at ``iou_threshold`` SphIoU AND carries its
    action label — classification accuracy conditioned on
    localisation, the top-1 analogue of detection's Sph-mAP matching.
    """
    if not gts:
        return float("nan")
    preds_by_frame: dict[int, list[Detection]] = collections.defaultdict(list)
    for f, d in preds:
        preds_by_frame[f].append(d)
    correct = 0
    for f, gt in gts:
        cands = preds_by_frame.get(f)
        if not cands:
            continue
        ious = sph_iou_matrix_np(
            np.stack([c.box for c in cands]), gt.box[None])[:, 0]
        order = np.argsort([-c.score for c in cands], kind="stable")
        for i in order:
            if ious[i] >= iou_threshold:
                if cands[i].category == gt.category:
                    correct += 1
                break  # top-1: only the best-scored overlap counts
    return correct / len(gts)


def sph_map(predictions: list[tuple[int, Detection]],
            ground_truth: list[tuple[int, Detection]],
            iou_threshold: float = 0.5) -> float:
    """Sph-mAP over all categories present in the ground truth."""
    cats = sorted({d.category for _, d in ground_truth})
    aps = []
    for c in cats:
        ap = sph_ap([(f, d) for f, d in predictions if d.category == c],
                    [(f, d) for f, d in ground_truth if d.category == c],
                    iou_threshold)
        if not np.isnan(ap):
            aps.append(ap)
    return float(np.mean(aps)) if aps else 0.0
