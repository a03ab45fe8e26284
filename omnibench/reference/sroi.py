"""Algorithm 1 — lightweight SRoI prediction (a frozen copy of
``repro_torch.core.sroi``: the reference works the plan out again).

Host-side (NumPy) implementation: the paper runs this on the mobile
CPU and reports <2.5 % overhead; it is deliberately not jitted.  The
algorithm merges the detections of the most recent ``delta`` frames
into a set of ``f x f``-FoV spherical regions of interest, creating
*special* SRoIs (scaled by ``gamma``) for objects too large to fit.

Inputs and outputs use plain NumPy; the ccv/alpha fields feed the
content-specific accuracy estimation of ``repro.core.accuracy``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

TWO_PI = 2.0 * math.pi


@dataclasses.dataclass
class Detection:
    """One detected object on the sphere."""

    box: np.ndarray  # (4,) = (theta, phi, dtheta, dphi), radians
    category: int
    score: float = 1.0

    @property
    def center(self) -> tuple[float, float]:
        return float(self.box[0]), float(self.box[1])

    @property
    def fov(self) -> tuple[float, float]:
        return float(self.box[2]), float(self.box[3])

    def noa(self) -> float:
        """Normalised object area (fraction of the sphere)."""
        return float(2.0 * self.box[2] * math.sin(self.box[3] / 2.0) / (4.0 * math.pi))


@dataclasses.dataclass
class SRoI:
    """A spherical region of interest (theta, phi, dtheta, dphi)."""

    center: tuple[float, float]
    fov: tuple[float, float]
    objects: list[Detection] = dataclasses.field(default_factory=list)
    ccv: np.ndarray | None = None  # (3 * n_categories,)
    alpha: float = 0.0
    special: bool = False

    def as_tuple(self) -> tuple[float, float, float, float]:
        return (self.center[0], self.center[1], self.fov[0], self.fov[1])


def _wrap(a: float) -> float:
    """Wrap angle to [-pi, pi)."""
    return (a + math.pi) % TWO_PI - math.pi


def _merged_extents(objects: list[Detection]) -> tuple[float, float, float, float]:
    """Merged (hFoV, vFoV, center_theta, center_phi) covering all objects.

    Longitudes are unwrapped around the first object's centre so the
    ERP seam does not split a cluster.  Latitude extents are plain
    intervals.  This mirrors line 7 of Algorithm 1: the merged FoV is
    the smallest lat/long-aligned spherical rectangle enclosing every
    member object's own extent.
    """
    ref = objects[0].box[0]
    lo_t, hi_t = math.inf, -math.inf
    lo_p, hi_p = math.inf, -math.inf
    for o in objects:
        t = ref + _wrap(float(o.box[0]) - ref)
        half_t, half_p = float(o.box[2]) / 2.0, float(o.box[3]) / 2.0
        lo_t = min(lo_t, t - half_t)
        hi_t = max(hi_t, t + half_t)
        lo_p = min(lo_p, float(o.box[1]) - half_p)
        hi_p = max(hi_p, float(o.box[1]) + half_p)
    h_fov = hi_t - lo_t
    v_fov = hi_p - lo_p
    return h_fov, v_fov, _wrap((lo_t + hi_t) / 2.0), (lo_p + hi_p) / 2.0


def region_solid_angle(fov_h: float, fov_v: float) -> float:
    """Solid angle (sr) of an (fov_h x fov_v) spherical rectangle."""
    return 2.0 * fov_h * math.sin(fov_v / 2.0)


def image_noa(obj_area_sr: float, ref_sr: float) -> float:
    """NOA of an object *in the image it is analysed in*.

    The gav is indexed by COCO image NOA (fraction of the picture).
    When a PI covers only an (f x f) region, an object's share of that
    picture is its solid angle over the REGION's solid angle — this is
    the effective-resolution gain that makes SRoI pruning improve
    accuracy (paper section III-B: downsampled whole frames make tiny
    objects undetectable).
    """
    return float(min(1.0, obj_area_sr / max(ref_sr, 1e-9)))


def size_level_in(o: Detection, ref_sr: float,
                  small_thresh: float, medium_thresh: float) -> int:
    area = 2.0 * float(o.box[2]) * math.sin(float(o.box[3]) / 2.0)
    noa = image_noa(area, ref_sr)
    if noa <= small_thresh:
        return 0
    if noa <= medium_thresh:
        return 1
    return 2


def compute_ccv(
    objects: list[Detection],
    n_categories: int,
    small_thresh: float,
    medium_thresh: float,
    ref_sr: float = 4.0 * math.pi,
) -> np.ndarray:
    """Content characteristics vector P_j (eq. 2): occurrence
    probabilities per (size level x category) among the SRoI's objects.
    Layout matches the gav (eq. 1): [s1..sn, m1..mn, l1..ln].
    Size levels are measured relative to ``ref_sr`` (the solid angle of
    the image the objects will be analysed in — see ``image_noa``).
    """
    ccv = np.zeros(3 * n_categories, dtype=np.float64)
    if not objects:
        return ccv
    for o in objects:
        level = size_level_in(o, ref_sr, small_thresh, medium_thresh)
        ccv[level * n_categories + (o.category % n_categories)] += 1.0
    ccv /= len(objects)
    return ccv


def predict_srois(
    history: list[Detection],
    f: float = math.radians(60.0),
    gamma: float = 1.1,
    n_categories: int = 80,
    small_thresh: float = 0.0044,
    medium_thresh: float = 0.0354,
) -> list[SRoI]:
    """Algorithm 1: predict SRoIs from historical detections.

    ``history`` is O — the detected objects of the most recent ``delta``
    frames (the caller maintains the window).  Returns R = S' | S with
    per-SRoI ccv and alpha populated.
    """
    regular: list[SRoI] = []
    special: list[SRoI] = []
    n_total = len(history)
    if n_total == 0:
        return []

    for o in history:
        o_h, o_v = o.fov
        if o_h <= f and o_v <= f:
            merged = False
            for s in regular:
                h_fov, v_fov, _, _ = _merged_extents(s.objects + [o])
                if h_fov < f and v_fov < f:
                    s.objects.append(o)
                    s.fov = (h_fov, v_fov)
                    merged = True
                    break
            if not merged:
                regular.append(
                    SRoI(center=o.center, fov=o.fov, objects=[o], special=False)
                )
        else:
            # special SRoI: area scaled by gamma around the large object
            scale = math.sqrt(gamma)
            s = SRoI(
                center=o.center,
                fov=(min(o_h * scale, TWO_PI), min(o_v * scale, math.pi)),
                objects=[o],
                special=True,
            )
            s.ccv = compute_ccv([o], n_categories, small_thresh, medium_thresh,
                                ref_sr=region_solid_angle(*s.fov))
            s.alpha = 1.0 / n_total
            special.append(s)

    for s in regular:
        h_fov, v_fov, ct, cp = _merged_extents(s.objects)
        s.center = (ct, cp)
        s.ccv = compute_ccv(s.objects, n_categories, small_thresh,
                            medium_thresh, ref_sr=region_solid_angle(f, f))
        s.alpha = len(s.objects) / n_total
        s.fov = (f, f)
    return special + regular
