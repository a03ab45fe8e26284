"""Synthetic 360-degree scenes with ground-truth spherical annotations.

No real 360° dataset ships in this container (DESIGN.md section 7), so
scenes are generated to match the paper's measurement findings:

  * NOA distribution: log-uniform across ~4 decades (paper Fig. 2 —
    "most objects occupy a tiny area"), with per-category scale offsets
    (Fig. 3 — "same-category sizes differ by orders of magnitude");
  * spatial bias: object centres concentrate in an equatorial band,
    the sky/ground caps are near-empty (Fig. 4 / SR-3);
  * temporal dynamics: the camera yaws (driving/walking) and objects
    drift in/out of existence, so per-region object counts vary
    substantially over time (Fig. 4).

``render_erp`` rasterises a frame into an actual ERP image (objects are
painted as textured axis-aligned spherical rectangles), which feeds the
real JAX detector path and the gnomonic-projection demos.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.sroi import Detection

TWO_PI = 2.0 * math.pi


@dataclasses.dataclass
class SceneObject:
    category: int
    theta: float  # current longitude
    phi: float  # latitude
    dtheta: float  # angular width
    dphi: float  # angular height
    drift: float  # own angular velocity (rad/frame)
    born: int  # first frame
    dies: int  # last frame
    color: np.ndarray  # (3,) render colour


@dataclasses.dataclass
class SyntheticVideo:
    name: str
    n_frames: int
    objects: list[SceneObject]
    yaw_rate: float  # camera yaw per frame (rad)
    n_categories: int

    def visible_objects(self, frame: int) -> list[Detection]:
        """Ground-truth detections for one frame (camera frame coords)."""
        out = []
        yaw = self.yaw_rate * frame
        for o in self.objects:
            if not (o.born <= frame <= o.dies):
                continue
            theta = (o.theta + o.drift * frame - yaw + math.pi) % TWO_PI - math.pi
            box = np.array([theta, o.phi, o.dtheta, o.dphi], dtype=np.float64)
            out.append(Detection(box=box, category=o.category, score=1.0))
        return out


def make_video(
    name: str = "synthetic-drive",
    n_frames: int = 120,
    n_objects: int = 60,
    n_categories: int = 80,
    yaw_rate_deg: float = 0.8,
    seed: int = 0,
    noa_decades: tuple[float, float] = (-6.0, -2.2),
    polar_fraction: float = 0.05,
) -> SyntheticVideo:
    """Generate a video whose statistics match the paper's Fig. 2-4."""
    rng = np.random.default_rng(seed)
    objects = []
    cat_pool = rng.choice(n_categories, size=max(8, n_categories // 8),
                          replace=False)
    cat_scale = {int(c): rng.uniform(0.5, 2.0) for c in cat_pool}
    for _ in range(n_objects):
        cat = int(rng.choice(cat_pool))
        # log-uniform NOA; per-category multiplicative offset
        noa = 10.0 ** rng.uniform(*noa_decades) * cat_scale[cat]
        noa = min(noa, 0.03)
        # NOA = 2 * dtheta * sin(dphi / 2) / (4 pi); pick aspect ~U(0.5, 2)
        aspect = rng.uniform(0.5, 2.0)
        # solve with dphi = aspect * dtheta (small-angle): area ~ dtheta^2 * aspect
        area = noa * 4.0 * math.pi
        dtheta = min(math.sqrt(area / aspect), math.pi)
        dphi = min(aspect * dtheta, math.pi * 0.9)
        if rng.uniform() < polar_fraction:
            phi = rng.uniform(-math.pi / 2 * 0.95, math.pi / 2 * 0.95)
        else:
            phi = rng.normal(0.0, 0.25)  # equatorial band
        phi = float(np.clip(phi, -1.3, 1.3))
        if rng.uniform() < 0.5:
            born = 0  # half the population exists from the start
        else:
            born = int(rng.integers(0, max(1, n_frames - 10)))
        objects.append(SceneObject(
            category=cat,
            theta=float(rng.uniform(-math.pi, math.pi)),
            phi=phi,
            dtheta=float(dtheta),
            dphi=float(dphi),
            drift=float(rng.normal(0, 0.002)),
            born=born,
            dies=int(min(n_frames, born + rng.integers(30, 90))),
            color=rng.uniform(0.3, 1.0, size=3).astype(np.float32),
        ))
    return SyntheticVideo(name, n_frames, objects,
                          math.radians(yaw_rate_deg), n_categories)


def render_erp(video: SyntheticVideo, frame: int,
               height: int = 256, width: int = 512) -> np.ndarray:
    """Rasterise one frame to an (H, W, 3) float32 ERP image.

    Objects paint a flat colour + checker texture inside their lat/long
    footprint (adequate for detector smoke training and projection
    demos; photo-realism is out of scope).
    """
    img = np.zeros((height, width, 3), dtype=np.float32)
    # sky/ground gradient background
    lat = (0.5 - (np.arange(height) + 0.5) / height) * math.pi
    img[..., 2] = 0.15 + 0.1 * np.sin(lat)[:, None]
    img[..., 1] = 0.12
    lon = ((np.arange(width) + 0.5) / width - 0.5) * TWO_PI

    for det in video.visible_objects(frame):
        th, ph, dth, dph = det.box
        dlon = np.abs((lon - th + math.pi) % TWO_PI - math.pi)
        in_lon = dlon <= dth / 2
        in_lat = np.abs(lat - ph) <= dph / 2
        mask = np.outer(in_lat, in_lon)
        if not mask.any():
            continue
        obj = next(o for o in video.objects
                   if o.category == det.category and abs(o.phi - ph) < 1e-9)
        ys, xs = np.nonzero(mask)
        checker = (((ys // 2) + (xs // 2)) % 2).astype(np.float32) * 0.25 + 0.75
        img[ys, xs] = obj.color[None, :] * checker[:, None]
    return img


def noa_histogram(video: SyntheticVideo, frames: range) -> np.ndarray:
    """All NOA values seen over ``frames`` (for the Fig. 2 benchmark)."""
    vals = []
    for f in frames:
        for det in video.visible_objects(f):
            vals.append(det.noa())
    return np.asarray(vals)
