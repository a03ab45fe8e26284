"""Content-specific model performance estimation (paper section IV-B).

Defines the *general accuracy vector* (gav, eq. 1) per model and the
machinery that dots it with each SRoI's *content characteristics
vector* (ccv, eq. 2), weighted by the SRoI object mass alpha, to give
the weighted accuracy A_{i,j} = alpha_j * (A_i . P_j) that drives the
model-allocation DP.

The gav for a real deployment is profiled offline on a labelled dataset
(the paper uses COCO's 80 categories with NOA size-level thresholds at
COCO's 33.33/66.66 NOA percentiles: 0.0044 and 0.0354).  This container
has no COCO, so :func:`synthetic_gav_table` constructs a ladder with
the same *ordering* as paper Table II (tiny-416 < csp-512 < csp-640 <
p5-896 < p6-1280, with the gap widest for small objects) — see
DESIGN.md section 7 (honesty ledger).
"""

from __future__ import annotations

import dataclasses

import numpy as np

# COCO NOA size-level thresholds from the paper (section IV-B).
SMALL_NOA = 0.0044
MEDIUM_NOA = 0.0354
N_CATEGORIES = 80


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """Offline profile of one detector variant (paper Table II row)."""

    name: str
    index: int  # 1-based paper index; 0 is reserved for "skip"
    input_size: int  # square input resolution in pixels
    location: str  # "device" | "edge"
    gav: np.ndarray  # (3 * N_CATEGORIES,)
    # offline-profiled latencies (seconds); see serving/profiles.py
    infer_s: float
    model_bytes: int


def estimated_accuracy(gav: np.ndarray, ccv: np.ndarray) -> float:
    """A_i . P_j — the expected detection accuracy of a model on an SRoI."""
    return float(np.dot(gav, ccv))


def weighted_accuracy(gav: np.ndarray, ccv: np.ndarray, alpha: float) -> float:
    """A_{i,j} = alpha_j * A_i . P_j (section IV-C)."""
    return alpha * estimated_accuracy(gav, ccv)


def synthetic_gav_table(
    n_models: int = 5,
    n_categories: int = N_CATEGORIES,
    seed: int = 0,
) -> list[np.ndarray]:
    """Construct a plausible gav ladder for ``n_models`` variants.

    Properties enforced (all consistent with the paper's Table II and
    the scaled-YOLOv4 COCO results it cites):
      * accuracy increases monotonically with model index for every
        (size, category) entry;
      * small objects benefit the most from larger input sizes;
      * per-category variation exists (training-set bias).
    """
    rng = np.random.default_rng(seed)
    cat_bias = rng.uniform(0.7, 1.0, size=n_categories)
    # base accuracies per size level for the weakest model
    base = np.array([0.08, 0.30, 0.45])  # small, medium, large
    # headroom gained per rung, biggest for small objects
    gain = np.array([0.14, 0.08, 0.05])
    tables = []
    for i in range(n_models):
        levels = np.clip(base + gain * i, 0.0, 0.95)
        gav = np.concatenate([levels[k] * cat_bias for k in range(3)])
        tables.append(gav)
    return tables


def size_level(noa: float) -> int:
    """0 = small, 1 = medium, 2 = large (paper thresholds)."""
    if noa <= SMALL_NOA:
        return 0
    if noa <= MEDIUM_NOA:
        return 1
    return 2
