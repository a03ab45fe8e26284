"""The greedy suppression kernel's algorithm against the JAX package's
greedy loops, on the CPU.

``repro_torch/kernels/nms/csrc/greedy.cu`` ranks each row's valid
entries, turns IoU rows into 32-bit words of suppression bits and walks
the ranks once.  ``greedy_suppress_rows_scan_ref`` is that algorithm
written in torch; here it is held exactly to the reference's device loop
(``_sph_nms_batch_device(..., use_pallas=False)``) and its host loop
(``_greedy_suppress_rows_np``) on the same float32 IoU, from seeded numpy
inputs.  The scores hold ties, NaN (``argmax`` ranks NaN above every
number, so the reference keeps a NaN-scored box first), ``+inf``, and
``-0.0`` beside ``0.0`` (equal, so the lower index comes first).  Never
``-inf``: the reference's loop does not end when the only active scores
left are ``-inf`` and index 0 is not among them.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sphere as jsphere
from repro_torch.kernels.nms import ops as tnms
from repro_torch.kernels.nms.ref import (greedy_suppress_rows_ref,
                                         greedy_suppress_rows_scan_ref)

SIZES = [1, 31, 32, 33, 128, 300]
KINDS = ["ties", "nan_inf", "signed_zero"]


def _case(n: int, kind: str, seed: int):
    """Four rows: all masked, all valid, a ragged prefix, and holes."""
    rng = np.random.default_rng(seed)
    b = 4
    # clustered boxes, so that suppression has overlaps to remove
    centers = np.stack([rng.uniform(-0.8, 0.8, (b, 6)),
                        rng.uniform(-0.5, 0.5, (b, 6))], -1)
    pick = rng.integers(0, 6, (b, n))
    ctr = np.take_along_axis(centers, pick[..., None].repeat(2, -1), 1)
    boxes = np.concatenate([ctr + rng.normal(0, 0.08, (b, n, 2)),
                            rng.uniform(0.2, 0.8, (b, n, 2))], -1)
    scores = np.round(rng.uniform(0.05, 1.0, (b, n)), 1)  # ties
    if kind == "nan_inf":
        scores[rng.random((b, n)) < 0.15] = np.nan
        scores[rng.random((b, n)) < 0.1] = np.inf
    elif kind == "signed_zero":
        zero = rng.random((b, n)) < 0.3
        scores[zero] = np.where(rng.random(int(zero.sum())) < 0.5, 0.0, -0.0)
    mask = np.ones((b, n), bool)
    mask[0] = False
    mask[2, rng.integers(0, n + 1):] = False
    mask[3] = rng.random(n) < 0.6
    boxes[~mask] = 0.0
    return boxes.astype(np.float32), scores.astype(np.float32), mask


# Rows are padded to the widest size with masked entries (never kept,
# never suppressing), so that the reference's programs compile once for
# every size; a padded entry's IoU does not touch the others'.
WIDTH = max(SIZES)


def _pad(a, n):
    return np.pad(a, [(0, 0), (0, WIDTH - n)] + [(0, 0)] * (a.ndim - 2))


def _iou(boxes):
    """The reference's float32 SphIoU of each row, (B, N, N)."""
    n = boxes.shape[1]
    padded = jnp.asarray(_pad(boxes, n))
    iou = jax.vmap(jsphere.sph_iou_matrix)(padded, padded)
    return np.array(iou)[:, :n, :n]


def _device_loop(boxes, scores, mask, thr):
    """The reference's device loop, ``use_pallas=False``."""
    n = boxes.shape[1]
    keep = jsphere._sph_nms_batch_device(
        jnp.asarray(_pad(boxes, n)), jnp.asarray(_pad(scores, n)),
        jnp.asarray(_pad(mask, n)), jnp.asarray(thr, jnp.float32),
        use_pallas=False)
    return np.asarray(keep)[:, :n]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("thr", [0.3, 0.6])
@pytest.mark.parametrize("n", SIZES)
def test_scan_matches_reference_loops(n, thr, kind):
    """Same float32 IoU into the scan and both reference loops: keep
    masks equal, and so are the plain version's and the wrapper's."""
    boxes, scores, mask = _case(n, kind, seed=10 * n + KINDS.index(kind))
    iou = _iou(boxes)
    t_iou, t_sc = torch.from_numpy(iou), torch.from_numpy(scores)
    t_mk = torch.from_numpy(mask)
    got = greedy_suppress_rows_scan_ref(t_iou, t_sc, t_mk, thr).numpy()
    host = jsphere._greedy_suppress_rows_np(iou, scores, mask.copy(), thr)
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(got, _device_loop(boxes, scores, mask, thr))
    np.testing.assert_array_equal(
        got, greedy_suppress_rows_ref(t_iou, t_sc, t_mk, thr).numpy())
    np.testing.assert_array_equal(
        got, tnms.greedy_suppress_rows(t_iou, t_sc, t_mk, thr).numpy())
    assert not got[~mask].any()
    if kind == "nan_inf" and n >= 32:
        # the first NaN of a valid row is kept, as argmax picks it first
        for r in range(1, 4):
            nan = np.flatnonzero(np.isnan(scores[r]) & mask[r])
            if len(nan):
                assert got[r, nan[0]]


def test_scan_orders_nan_first_then_score_then_index():
    """No overlaps at all: every valid entry is kept, whatever its score;
    with every pair overlapping, only the first in argmax's order is."""
    scores = torch.tensor([[0.5, float("nan"), 0.2, -0.0, 0.0, float("nan"),
                            float("inf"), 0.5]])
    mask = torch.ones_like(scores, dtype=torch.bool)
    apart = torch.zeros((1, 8, 8))
    keep = greedy_suppress_rows_scan_ref(apart, scores, mask, 0.6)
    assert keep.all()
    together = torch.ones((1, 8, 8))
    keep = greedy_suppress_rows_scan_ref(together, scores, mask, 0.6)
    assert keep[0].tolist() == [False, True] + [False] * 6
    no_nan = torch.where(torch.isnan(scores), torch.tensor(0.1), scores)
    keep = greedy_suppress_rows_scan_ref(together, no_nan, mask, 0.6)
    assert keep[0].tolist() == [False] * 6 + [True, False]
    ties = torch.tensor([[0.1, -0.0, 0.0, -0.0]])
    all_valid = torch.ones_like(ties, dtype=torch.bool)
    keep = greedy_suppress_rows_scan_ref(torch.ones((1, 4, 4)), ties,
                                         all_valid, 0.6)
    assert keep[0].tolist() == [True, False, False, False]
    keep = greedy_suppress_rows_scan_ref(
        torch.ones((1, 4, 4)), ties,
        torch.tensor([[False, True, True, True]]), 0.6)
    assert keep[0].tolist() == [False, True, False, False]
