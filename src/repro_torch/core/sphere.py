"""Spherical geometry primitives for 360-degree video analytics (port of
``repro.core.sphere``).

Implements the spherical criteria of Zhao et al. (AAAI'20) used by the
OmniSense paper:

  * ``SphBB`` — a spherical bounding box ``(theta, phi, dtheta, dphi)``
    where ``theta`` is the longitude of the box centre in ``[-pi, pi]``,
    ``phi`` the latitude in ``[-pi/2, pi/2]`` and ``dtheta``/``dphi``
    the horizontal/vertical field-of-view occupied by the object,
    *defined in the box's own tangent frame*.
  * ``sph_area`` — the area of a SphBB on the unit sphere,
    ``2 * dtheta * sin(dphi / 2)``.
  * ``sph_iou`` — pairwise spherical IoU: box A's centre is rotated to
    the equator origin, box B's centre is expressed in that frame, and
    the intersection is the lat/long-interval overlap of two
    equator-centred rectangles, symmetrised over both directions.
  * ``sph_nms_batch`` — batched greedy spherical NMS over padded
    ``(B, N, 4)`` rows, one row per stream/frame.

Two halves.  The torch half (coordinate transforms, SphIoU,
back-projection) works on tensors of any device, float32 as the
reference's jnp defaults.  The NumPy half is the reference's host
serving path, copied unchanged: it compares in float64.

``sph_nms_batch`` backends:

  * ``"host"``  — vectorised NumPy, float64 IoU;
  * ``"torch"`` — the plain PyTorch version of the reference's ``jit``
    path: float32 IoU and the same greedy, on any device;
  * ``"cuda"``  — the SphIoU kernel (``repro_torch.kernels.sphiou``)
    plus the per-row greedy kernel (``repro_torch.kernels.nms``);
  * ``"auto"``  — ``"cuda"`` when a CUDA device is present and the
    batch holds at least ``_AUTO_DEVICE_MIN_ELEMS`` boxes, else
    ``"host"``.  A failure of the ``cuda`` path raises.

The greedy order is descending score with lowest-index-first
tie-breaking in every backend, so their keep masks agree exactly.
Angles are radians everywhere.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import resolve_device

Tensor = torch.Tensor

# --------------------------------------------------------------------------
# Coordinate transforms
# --------------------------------------------------------------------------


def sph_to_cart(theta: Tensor, phi: Tensor) -> Tensor:
    """(lon, lat) -> unit vector, shape (..., 3).

    x axis points at (theta=0, phi=0); z is the north pole.
    """
    cp = torch.cos(phi)
    return torch.stack([cp * torch.cos(theta), cp * torch.sin(theta),
                        torch.sin(phi)], dim=-1)


def cart_to_sph(v: Tensor) -> tuple[Tensor, Tensor]:
    """Unit vector (..., 3) -> (lon, lat)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    theta = torch.atan2(y, x)
    phi = torch.asin(torch.clamp(z, -1.0, 1.0))
    return theta, phi


def wrap_angle(a: Tensor) -> Tensor:
    """Wrap angle(s) to [-pi, pi)."""
    return torch.remainder(a + math.pi, 2.0 * math.pi) - math.pi


def rotation_to_origin(theta: Tensor, phi: Tensor) -> Tensor:
    """Rotation matrix R (.., 3, 3) with R @ dir(theta, phi) == (1, 0, 0).

    First undo longitude (rotate about z by -theta), then undo latitude
    (rotate about y by +phi).
    """
    ct, st = torch.cos(theta), torch.sin(theta)
    cp, sp = torch.cos(phi), torch.sin(phi)
    zero = torch.zeros_like(ct)
    one = torch.ones_like(ct)
    rz = torch.stack([
        torch.stack([ct, st, zero], dim=-1),
        torch.stack([-st, ct, zero], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)
    ry = torch.stack([
        torch.stack([cp, zero, sp], dim=-1),
        torch.stack([zero, one, zero], dim=-1),
        torch.stack([-sp, zero, cp], dim=-1),
    ], dim=-2)
    return ry @ rz


def rotation_from_origin(theta: Tensor, phi: Tensor) -> Tensor:
    """Inverse of :func:`rotation_to_origin` (transpose)."""
    return rotation_to_origin(theta, phi).transpose(-1, -2)


# --------------------------------------------------------------------------
# SphBB area / IoU
# --------------------------------------------------------------------------


def sph_area(boxes: Tensor) -> Tensor:
    """Area on the unit sphere of SphBBs (..., 4) -> (...)."""
    return 2.0 * boxes[..., 2] * torch.sin(boxes[..., 3] / 2.0)


def sph_intersection(boxes_a: Tensor, boxes_b: Tensor) -> Tensor:
    """Pairwise intersection area between two broadcastable SphBB
    tensors (..., 4).  Box A is rotated to the origin; box B's centre is
    expressed exactly in A's frame; both are then treated as
    equator-centred lat/long rectangles (AAAI'20 fast criteria)."""
    boxes_a, boxes_b = torch.broadcast_tensors(boxes_a, boxes_b)
    r = rotation_to_origin(boxes_a[..., 0], boxes_a[..., 1])
    db = sph_to_cart(boxes_b[..., 0], boxes_b[..., 1])
    dlon, dlat = cart_to_sph(torch.einsum("...ij,...j->...i", r, db))

    half_ta, half_pa = boxes_a[..., 2] / 2.0, boxes_a[..., 3] / 2.0
    half_tb, half_pb = boxes_b[..., 2] / 2.0, boxes_b[..., 3] / 2.0
    lon_lo = torch.maximum(-half_ta, dlon - half_tb)
    lon_hi = torch.minimum(half_ta, dlon + half_tb)
    lat_lo = torch.maximum(-half_pa, dlat - half_pb)
    lat_hi = torch.minimum(half_pa, dlat + half_pb)

    lon_w = torch.clamp(lon_hi - lon_lo, min=0.0)
    # exact area element in latitude: integral of cos(phi) d(phi)
    lat_w = torch.clamp(torch.sin(lat_hi) - torch.sin(lat_lo), min=0.0)
    lat_w = torch.where(lat_hi > lat_lo, lat_w, torch.zeros_like(lat_w))
    return lon_w * lat_w


def sph_iou(boxes_a: Tensor, boxes_b: Tensor) -> Tensor:
    """Pairwise SphIoU of broadcastable SphBB tensors -> (...),
    symmetrised by averaging the two directions of the intersection."""
    inter = 0.5 * (sph_intersection(boxes_a, boxes_b)
                   + sph_intersection(boxes_b, boxes_a))
    union = sph_area(boxes_a) + sph_area(boxes_b) - inter
    return inter / torch.clamp(union, min=1e-12)


def sph_iou_matrix(boxes_a: Tensor, boxes_b: Tensor) -> Tensor:
    """(..., N, 4) x (..., M, 4) -> (..., N, M) SphIoU matrices (the
    plain PyTorch version of the SphIoU kernel; leading axes are batch
    axes shared by both inputs)."""
    return sph_iou(boxes_a[..., :, None, :], boxes_b[..., None, :, :])


# --------------------------------------------------------------------------
# Spherical NMS
# --------------------------------------------------------------------------


def sph_nms(boxes, scores, iou_threshold: float = 0.6,
            max_out: int | None = None) -> np.ndarray:
    """Greedy spherical NMS for one frame's boxes -> (N,) keep-mask: the
    single-row (B=1) entry of :func:`sph_nms_batch`."""
    keep = sph_nms_batch(np.asarray(boxes)[None], np.asarray(scores)[None],
                         None, iou_threshold, max_out=max_out)
    return keep[0]


def _sph_intersection_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """NumPy twin of :func:`sph_intersection` for (..., N, 4) x (..., M, 4)
    grids; leading axes are batch dims shared by ``a`` and ``b``."""
    ta, pa = a[..., :, None, 0], a[..., :, None, 1]
    ha, va = a[..., :, None, 2] / 2, a[..., :, None, 3] / 2
    tb, pb = b[..., None, :, 0], b[..., None, :, 1]
    hb, vb = b[..., None, :, 2] / 2, b[..., None, :, 3] / 2
    dt = tb - ta
    cpa, spa = np.cos(pa), np.sin(pa)
    cpb, spb = np.cos(pb), np.sin(pb)
    cdt = np.cos(dt)
    x = cpa * cpb * cdt + spa * spb
    y = cpb * np.sin(dt)
    z = -spa * cpb * cdt + cpa * spb
    dlon = np.arctan2(y, x)
    dlat = np.arcsin(np.clip(z, -1.0, 1.0))
    lon_w = np.maximum(np.minimum(ha, dlon + hb) - np.maximum(-ha, dlon - hb), 0)
    lat_hi = np.minimum(va, dlat + vb)
    lat_lo = np.maximum(-va, dlat - vb)
    lat_w = np.where(lat_hi > lat_lo, np.sin(lat_hi) - np.sin(lat_lo), 0.0)
    return lon_w * np.maximum(lat_w, 0.0)


def sph_iou_matrix_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pure-NumPy (..., N, M) SphIoU — the host serving path (no jax
    dispatch overhead per frame; identical math to
    :func:`sph_iou_matrix`).  Leading axes of ``a``/``b`` are batch
    dims, so a padded (B, N, 4) stack yields (B, N, N) in one call."""
    inter_ba = np.swapaxes(_sph_intersection_np(b, a), -1, -2)
    inter = 0.5 * (_sph_intersection_np(a, b) + inter_ba)
    area_a = 2.0 * a[..., :, 2] * np.sin(a[..., :, 3] / 2.0)
    area_b = 2.0 * b[..., :, 2] * np.sin(b[..., :, 3] / 2.0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / np.maximum(union, 1e-12)


def sph_nms_host(
    boxes: np.ndarray,
    scores: np.ndarray,
    iou_threshold: float = 0.6,
) -> np.ndarray:
    """NumPy greedy spherical NMS for the host-side serving loop.

    Same semantics as :func:`sph_nms`; avoids a device round-trip for
    the handful of boxes the online loop handles per frame.
    """
    n = len(scores)
    if n == 0:
        return np.zeros((0,), dtype=bool)
    order = np.argsort(-np.asarray(scores), kind="stable")
    iou = sph_iou_matrix_np(np.asarray(boxes, np.float64),
                            np.asarray(boxes, np.float64))
    iou_sorted = iou[np.ix_(order, order)]
    # Vectorised greedy: each iteration keeps the best remaining box and
    # suppresses all its overlaps at once, so the loop runs once per
    # SURVIVOR (not once per box as the old per-index loop did).
    keep_sorted = np.zeros((n,), dtype=bool)
    active = np.ones((n,), dtype=bool)
    while True:
        idx = int(np.argmax(active))  # first still-active in score order
        if not active[idx]:
            break
        keep_sorted[idx] = True
        active &= iou_sorted[idx] <= iou_threshold
        active[idx] = False
    keep = np.zeros((n,), dtype=bool)
    keep[order] = keep_sorted
    return keep


# --------------------------------------------------------------------------
# Batched spherical NMS (the pod-tick subsystem; see module docstring)
# --------------------------------------------------------------------------

# Row-chunk caps: bound the (chunk, N, N) IoU tensor so huge rows stay
# within memory — ~32M float64 elements on host, ~128M float32 on device.
_HOST_CHUNK_ELEMS = 1 << 25
_DEVICE_CHUNK_ELEMS = 1 << 27
# "auto" picks the CUDA path only at B*N >= this; below it the launch
# and copy overhead outweighs the handful of boxes involved.
_AUTO_DEVICE_MIN_ELEMS = 512


def _greedy_suppress_rows_np(
    iou: np.ndarray,       # (B, N, N)
    scores: np.ndarray,    # (B, N)
    active: np.ndarray,    # (B, N) bool, consumed
    iou_threshold: float,
) -> np.ndarray:
    """Batched greedy suppression; iterations = max survivors over rows."""
    b, n = scores.shape
    keep = np.zeros((b, n), dtype=bool)
    cols = np.arange(n)[None, :]
    while active.any():
        masked = np.where(active, scores, -np.inf)
        best = np.argmax(masked, axis=1)                     # (B,)
        has = active.any(axis=1)                             # (B,)
        sel = (cols == best[:, None]) & has[:, None]
        keep |= sel
        iou_best = np.take_along_axis(iou, best[:, None, None], axis=1)[:, 0, :]
        active &= ~((iou_best > iou_threshold) & has[:, None]) & ~sel
    return keep


def _sph_nms_batch_host(
    boxes: np.ndarray, scores: np.ndarray, mask: np.ndarray,
    iou_threshold: float,
) -> np.ndarray:
    b, n, _ = boxes.shape
    keep = np.zeros((b, n), dtype=bool)
    chunk = max(1, _HOST_CHUNK_ELEMS // max(n * n, 1))
    for lo in range(0, b, chunk):
        hi = min(lo + chunk, b)
        iou = sph_iou_matrix_np(boxes[lo:hi].astype(np.float64),
                                boxes[lo:hi].astype(np.float64))
        keep[lo:hi] = _greedy_suppress_rows_np(
            iou, scores[lo:hi], mask[lo:hi].copy(), iou_threshold)
    return keep


def nms_auto_backend(b: int, n: int) -> str:
    """The backend ``sph_nms_batch(backend="auto")`` picks for (B, N):
    the CUDA kernels for pod-scale batches when a CUDA device is
    present, the NumPy host path otherwise."""
    pod_scale = b * n >= _AUTO_DEVICE_MIN_ELEMS
    return "cuda" if torch.cuda.is_available() and pod_scale else "host"


def _iou_compute_dtype(iou_dtype) -> torch.dtype | None:
    """``iou_dtype`` as the SphIoU's reduced compute dtype: ``None`` (or
    float32) for float32, else bfloat16, the one the kernel offers."""
    if iou_dtype is None or iou_dtype == torch.float32:
        return None
    if iou_dtype == torch.bfloat16:
        return torch.bfloat16
    raise ValueError(f"iou_dtype {iou_dtype!r} is not torch.bfloat16")


def _sph_nms_batch_torch(boxes: Tensor, scores: Tensor, mask: Tensor,
                         iou_threshold: float, use_kernels: bool,
                         iou_dtype: torch.dtype | None = None) -> Tensor:
    """(B, N) keep-mask of float32 rows on one device: batched SphIoU
    (float32, or computed in ``iou_dtype``), then the per-row greedy
    suppression — the CUDA kernels, or their plain PyTorch versions."""
    if use_kernels:
        from repro_torch.kernels.nms.ops import greedy_suppress_rows
        from repro_torch.kernels.sphiou.ops import sphiou_matrix_batch

        iou = sphiou_matrix_batch(boxes, boxes,
                                  dtype=iou_dtype or torch.float32)
        return greedy_suppress_rows(iou, scores, mask, iou_threshold)
    from repro_torch.kernels.nms.ref import greedy_suppress_rows_ref

    if iou_dtype is not None:
        # the reference's jit path: the framework SphIoU on cast boxes
        low = boxes.to(iou_dtype)
        iou = sph_iou_matrix(low, low).to(torch.float32)
    else:
        iou = sph_iou_matrix(boxes, boxes)
    return greedy_suppress_rows_ref(iou, scores, mask, iou_threshold)


def _apply_max_out_np(
    keep: np.ndarray, scores: np.ndarray, max_out: int
) -> np.ndarray:
    order = np.argsort(-scores, axis=1, kind="stable")
    keep_sorted = np.take_along_axis(keep, order, axis=1)
    rank = np.cumsum(keep_sorted.astype(np.int64), axis=1) - 1
    keep_sorted &= rank < max_out
    out = np.zeros_like(keep)
    np.put_along_axis(out, order, keep_sorted, axis=1)
    return out


def sph_nms_batch(
    boxes,                       # (B, N, 4) padded SphBB stack
    scores,                      # (B, N)
    mask=None,                   # (B, N) bool; False = padding
    iou_threshold: float = 0.6,
    max_out: int | None = None,
    *,
    backend: str = "auto",
    iou_dtype=None,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Batched greedy spherical NMS over padded rows -> (B, N) bool.

    One row per stream/frame; rows are suppressed independently but in
    one dispatch.  Padded entries (``mask == False``) are never kept.
    ``backend`` is one of ``auto``/``host``/``torch``/``cuda`` (module
    docstring).  The host path keeps the inputs' float64; ``torch`` and
    ``cuda`` cast to float32, as the reference's device path does.
    ``device`` places the ``torch`` backend (default ``cuda``); the
    ``cuda`` backend needs a CUDA device.  Rows are independent, so the
    device paths process very large batches in row chunks.

    ``iou_dtype`` (``torch`` and ``cuda`` backends only; the host path
    raises ``ValueError``) lowers the IoU compute precision:
    ``torch.bfloat16`` runs the SphIoU kernel's bf16 entry (``cuda``) or
    the framework SphIoU on bf16 boxes (``torch``, the reference's
    ``jit`` path).  Near-threshold pairs can flip their keep decision.
    """
    boxes = np.asarray(boxes)
    scores = np.asarray(scores)
    b, n = scores.shape
    if mask is None:
        mask = np.ones((b, n), dtype=bool)
    else:
        mask = np.asarray(mask, dtype=bool)
    if n == 0:
        return np.zeros((b, 0), dtype=bool)

    if backend == "auto":
        backend = nms_auto_backend(b, n)
    if backend == "host":
        if iou_dtype is not None:
            raise ValueError("iou_dtype needs the torch or cuda backend")
        keep = _sph_nms_batch_host(boxes, scores, mask, iou_threshold)
    elif backend in ("torch", "cuda"):
        low = _iou_compute_dtype(iou_dtype)
        dev = resolve_device(device)
        if backend == "cuda" and dev.type != "cuda":
            raise ValueError(f"backend 'cuda' needs a CUDA device, got {dev}")
        chunk = max(1, _DEVICE_CHUNK_ELEMS // max(n * n, 1))
        parts = []
        for lo in range(0, b, chunk):
            hi = min(lo + chunk, b)
            parts.append(_sph_nms_batch_torch(
                torch.as_tensor(boxes[lo:hi], dtype=torch.float32, device=dev),
                torch.as_tensor(scores[lo:hi], dtype=torch.float32,
                                device=dev),
                torch.as_tensor(mask[lo:hi], device=dev),
                iou_threshold, use_kernels=backend == "cuda",
                iou_dtype=low).cpu().numpy())
        keep = np.concatenate(parts, axis=0)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    if max_out is not None:
        keep = _apply_max_out_np(keep, scores, max_out)
    return keep


def pad_detection_rows(rows, pad_n=None, total_rows: int | None = None
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad per-row detection lists into ``sph_nms_batch`` inputs.

    ``rows`` is a sequence of detection lists (anything with a ``box``
    (4,) array and a ``score``), one per stream/frame.  Returns
    ``(boxes (B, N, 4), scores (B, N), mask (B, N))`` padded to the
    longest row, float64 so the host path keeps full precision.

    ``pad_n`` bounds the device path's compile shapes: a callable
    (e.g. ``ShapeBuckets.pad_nms_rows``) snapping the longest row up to
    a bucket ladder, so the jitted (B, N) program compiles once per
    ladder rung instead of once per distinct detection count.
    ``total_rows`` pads B with all-masked rows up to a fixed row count
    (the pod's stream count) for the same reason; masked padding can
    never be kept, so the keep-masks of the real rows are unchanged.
    """
    b = max(len(rows), total_rows or 0)
    n_max = max((len(r) for r in rows), default=0)
    if pad_n is not None:
        n_max = pad_n(n_max)
    boxes = np.zeros((b, n_max, 4), np.float64)
    scores = np.zeros((b, n_max), np.float64)
    mask = np.zeros((b, n_max), bool)
    for r, dets in enumerate(rows):
        k = len(dets)
        if k:
            boxes[r, :k] = np.stack([d.box for d in dets])
            scores[r, :k] = [d.score for d in dets]
            mask[r, :k] = True
    return boxes, scores, mask


class IncrementalNms:
    """Cross-tick batched NMS that recomputes only the changed rows.

    Consecutive ticks of a mostly-static scene re-suppress near-identical
    per-stream detection rows; since :func:`sph_nms_batch` rows are
    independent, a row whose (boxes, scores) are *exactly* the ones it
    was suppressed with last tick can reuse last tick's keep-mask and
    skip its (N, N) SphIoU block entirely.  Changed rows batch into one
    ``sph_nms_batch`` call over the changed subset, so the result is
    bit-identical to a full recompute by construction (pinned by the
    fused-tick property tests).

    Rows are addressed by a caller-stable ``key`` (the serving tier uses
    the per-stream loop identity); padding does not participate in the
    comparison, so reuse survives tick-to-tick changes of the padded N.
    """

    def __init__(self, iou_threshold: float = 0.6, *, backend: str = "auto",
                 iou_dtype=None, capacity: int = 4096):
        self.iou_threshold = iou_threshold
        self.backend = backend
        self.iou_dtype = iou_dtype
        self.capacity = capacity
        self.hits = 0
        self.misses = 0
        self._rows: dict = {}  # key -> (k, boxes bytes, scores bytes, keep)

    def clear(self) -> None:
        self._rows.clear()

    @staticmethod
    def _canon(boxes_r: np.ndarray, scores_r: np.ndarray, mask_r: np.ndarray
               ) -> tuple[int, bytes, bytes]:
        k = int(mask_r.sum())
        return (k, np.ascontiguousarray(boxes_r[:k]).tobytes(),
                np.ascontiguousarray(scores_r[:k]).tobytes())

    def suppress(
        self,
        keys,                 # length-B sequence of stable row keys
        boxes: np.ndarray,    # (B, N, 4) padded (mask prefix-contiguous)
        scores: np.ndarray,   # (B, N)
        mask: np.ndarray | None = None,
        *,
        max_out: int | None = None,
    ) -> np.ndarray:
        boxes = np.asarray(boxes)
        scores = np.asarray(scores)
        b, n = scores.shape
        if mask is None:
            mask = np.ones((b, n), dtype=bool)
        else:
            mask = np.asarray(mask, dtype=bool)
        keep = np.zeros((b, n), dtype=bool)
        canon = [self._canon(boxes[r], scores[r], mask[r]) for r in range(b)]
        changed = []
        for r, key in enumerate(keys):
            ent = self._rows.get(key)
            if ent is not None and ent[:3] == canon[r]:
                self.hits += 1
                k, kept = ent[0], ent[3]
                keep[r, :k] = kept
            else:
                self.misses += 1
                changed.append(r)
        if changed:
            sub = np.asarray(changed)
            sub_keep = sph_nms_batch(
                boxes[sub], scores[sub], mask[sub],
                iou_threshold=self.iou_threshold, backend=self.backend,
                iou_dtype=self.iou_dtype)
            keep[sub] = sub_keep
            for r in changed:
                if len(self._rows) >= self.capacity:
                    self._rows.pop(next(iter(self._rows)))
                k = canon[r][0]
                self._rows[keys[r]] = canon[r] + (keep[r, :k].copy(),)
        if max_out is not None:
            keep = _apply_max_out_np(keep, scores, max_out)
        return keep


# --------------------------------------------------------------------------
# ERP pixel <-> sphere
# --------------------------------------------------------------------------


def erp_to_sph(u: Tensor, v: Tensor, width: int, height: int
               ) -> tuple[Tensor, Tensor]:
    """ERP pixel coords (u right, v down; origin top-left) -> (lon, lat)."""
    theta = (u / width - 0.5) * 2.0 * math.pi
    phi = (0.5 - v / height) * math.pi
    return theta, phi


def sph_to_erp(theta: Tensor, phi: Tensor, width: int, height: int
               ) -> tuple[Tensor, Tensor]:
    """(lon, lat) -> ERP pixel coords (float)."""
    u = (theta / (2.0 * math.pi) + 0.5) * width
    v = (0.5 - phi / math.pi) * height
    return u, v


# --------------------------------------------------------------------------
# PI detections -> SphBBs
# --------------------------------------------------------------------------


def _f32(x, like: Tensor) -> Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def pi_box_to_sphbb(
    rect: Tensor,
    center_theta,
    center_phi,
    fov: tuple[float, float],
    pi_size: tuple[int, int],
) -> Tensor:
    """Back-project rectangular detections on a PI into SphBBs.

    ``rect``: (..., 4) boxes as (x0, y0, x1, y1) in PI pixel coords.
    ``fov``: (horizontal, vertical) field of view of the PI in radians.
    ``pi_size``: (width, height) of the PI in pixels.  Runs in float32,
    as the reference's jnp default does.

    The PI is tangent at (center_theta, center_phi) (gnomonic).  Each
    corner is lifted to a direction on the sphere; the detection's own
    centre direction defines its tangent frame, and dtheta/dphi are the
    angular extents of the corners in that frame.
    """
    rect = torch.as_tensor(rect, dtype=torch.float32)
    w, h = pi_size
    half_x = torch.tan(_f32(fov[0] / 2.0, rect))
    half_y = torch.tan(_f32(fov[1] / 2.0, rect))
    r = rotation_from_origin(_f32(center_theta, rect), _f32(center_phi, rect))

    def lift(px, py):
        x = (px / w - 0.5) * 2.0 * half_x
        y = (0.5 - py / h) * 2.0 * half_y
        d = torch.stack([torch.ones_like(x), x, y], dim=-1)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        return torch.einsum("ij,...j->...i", r, d)

    x0, y0, x1, y1 = rect[..., 0], rect[..., 1], rect[..., 2], rect[..., 3]
    cx, cy = (x0 + x1) / 2.0, (y0 + y1) / 2.0
    ct, cp = cart_to_sph(lift(cx, cy))

    corners = torch.stack(
        [lift(x0, y0), lift(x1, y0), lift(x0, y1), lift(x1, y1)], dim=-2
    )  # (..., 4, 3)
    r_inv = rotation_to_origin(ct, cp)
    local = torch.einsum("...ij,...kj->...ki", r_inv, corners)
    lon, lat = cart_to_sph(local)
    dtheta = lon.amax(dim=-1) - lon.amin(dim=-1)
    dphi = lat.amax(dim=-1) - lat.amin(dim=-1)
    return torch.stack([ct, cp, dtheta, dphi], dim=-1)


def normalized_object_area(boxes: Tensor) -> Tensor:
    """NOA: SphBB area normalised by the sphere's surface area (4*pi)."""
    return sph_area(boxes) / (4.0 * math.pi)
