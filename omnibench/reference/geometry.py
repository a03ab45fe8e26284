"""Sphere geometry of the frame loop in plain PyTorch and NumPy, in
float64: the gnomonic crop of an SRoI, the resized ERP of the discovery
pass, the lift of PI boxes back to spherical boxes (SphBBs), the
spherical IoU and the greedy suppression.

Written from the paper's definitions (``repro_torch.core.projection``
and ``repro_torch.core.sphere`` compute the same maps in float32).
Imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

F64 = torch.float64


def _bilinear(erp: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Sample (H, W, C) ``erp`` at float pixel coords: pixel-centre
    convention, the horizontal axis wraps, the vertical one clamps."""
    h, w = erp.shape[:2]
    u0, v0 = torch.floor(u), torch.floor(v)
    fu, fv = (u - u0)[..., None], (v - v0)[..., None]
    u0i = torch.remainder(u0.long(), w)
    u1i = torch.remainder(u0i + 1, w)
    v0i = torch.clamp(v0.long(), 0, h - 1)
    v1i = torch.clamp(v0i + 1, 0, h - 1)
    top = erp[v0i, u0i] * (1.0 - fu) + erp[v0i, u1i] * fu
    bot = erp[v1i, u0i] * (1.0 - fu) + erp[v1i, u1i] * fu
    return top * (1.0 - fv) + bot * fv


def gnomonic_map(ct: float, cp: float, fov, size: int, h: int, w: int,
                 device, dtype=F64) -> tuple[torch.Tensor, torch.Tensor]:
    """ERP pixel coords (u, v) of each pixel centre of a size x size
    gnomonic PI tangent at (ct, cp) with field of view ``fov``, computed
    in ``dtype``."""
    t = ((torch.arange(size, dtype=F64, device=device) + 0.5) / size
         - 0.5).to(dtype)
    y, x = torch.meshgrid(-2.0 * math.tan(fov[1] / 2) * t,
                          2.0 * math.tan(fov[0] / 2) * t, indexing="ij")
    n = torch.sqrt(1.0 + x * x + y * y)
    d0, d1, d2 = 1.0 / n, x / n, y / n
    st, c_t = math.sin(ct), math.cos(ct)
    sp, c_p = math.sin(cp), math.cos(cp)
    wx = c_p * c_t * d0 - st * d1 - sp * c_t * d2
    wy = c_p * st * d0 + c_t * d1 - sp * st * d2
    wz = sp * d0 + c_p * d2
    u = (torch.atan2(wy, wx) / (2 * math.pi) + 0.5) * w
    v = (0.5 - torch.asin(wz.clamp(-1.0, 1.0)) / math.pi) * h
    return u, v


def crop(frame: torch.Tensor, ct: float, cp: float, fov, size: int,
         dtype=F64):
    """(S, S, C) PI of an SRoI from a (H, W, C) frame, its map and
    sampling computed in ``dtype`` (float64 for the reference)."""
    h, w = frame.shape[:2]
    u, v = gnomonic_map(ct, cp, fov, size, h, w, frame.device, dtype)
    return _bilinear(frame.to(dtype), u, v)


def resized(frame: torch.Tensor, size: int):
    """The whole ERP frame bilinearly resized to (size, size, C), float64
    (the discovery pass's input)."""
    h, w = frame.shape[:2]
    u = (torch.arange(size, dtype=F64, device=frame.device) + 0.5) \
        * (w / size) - 0.5
    v = (torch.arange(size, dtype=F64, device=frame.device) + 0.5) \
        * (h / size) - 0.5
    vg, ug = torch.meshgrid(v, u, indexing="ij")
    return _bilinear(frame.to(F64), ug, vg)


def _rot_from_origin(theta, phi):
    """(..., 3, 3) rotation taking (1, 0, 0) to direction (theta, phi)."""
    c_t, st = torch.cos(theta), torch.sin(theta)
    c_p, sp = torch.cos(phi), torch.sin(phi)
    zero = torch.zeros_like(c_t)
    one = torch.ones_like(c_t)
    rz = torch.stack([torch.stack([c_t, st, zero], -1),
                      torch.stack([-st, c_t, zero], -1),
                      torch.stack([zero, zero, one], -1)], -2)
    ry = torch.stack([torch.stack([c_p, zero, sp], -1),
                      torch.stack([zero, one, zero], -1),
                      torch.stack([-sp, zero, c_p], -1)], -2)
    return (ry @ rz).transpose(-1, -2)


def _to_sph(v):
    return (torch.atan2(v[..., 1], v[..., 0]),
            torch.asin(torch.clamp(v[..., 2], -1.0, 1.0)))


def pi_boxes_to_sphbb(rect: torch.Tensor, ct: float, cp: float, fov,
                      size: int) -> torch.Tensor:
    """(N, 4) PI boxes (x0, y0, x1, y1) -> (N, 4) SphBBs (theta, phi,
    dtheta, dphi), float64: the box centre's direction is the SphBB's
    centre, and the extents are those of the four corners in its own
    tangent frame."""
    rect = rect.to(F64)
    hx, hy = math.tan(fov[0] / 2.0), math.tan(fov[1] / 2.0)
    r = _rot_from_origin(torch.tensor(ct, dtype=F64, device=rect.device),
                         torch.tensor(cp, dtype=F64, device=rect.device))

    def lift(px, py):
        x = (px / size - 0.5) * 2.0 * hx
        y = (0.5 - py / size) * 2.0 * hy
        d = torch.stack([torch.ones_like(x), x, y], -1)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        return d @ r.T

    x0, y0, x1, y1 = rect.unbind(-1)
    c_theta, c_phi = _to_sph(lift((x0 + x1) / 2, (y0 + y1) / 2))
    corners = torch.stack([lift(x0, y0), lift(x1, y0), lift(x0, y1),
                           lift(x1, y1)], -2)
    inv = _rot_from_origin(c_theta, c_phi).transpose(-1, -2)
    lon, lat = _to_sph(torch.einsum("nij,nkj->nki", inv, corners))
    return torch.stack([c_theta, c_phi, lon.amax(-1) - lon.amin(-1),
                        lat.amax(-1) - lat.amin(-1)], -1)


def erp_boxes_to_sphbb(rect: torch.Tensor, size: int, h: int, w: int):
    """(N, 4) boxes on the resized ERP -> SphBBs (the discovery pass's
    conversion: centre and extents read off the ERP grid)."""
    rect = rect.to(F64)
    x0, x1 = rect[:, 0] * (w / size), rect[:, 2] * (w / size)
    y0, y1 = rect[:, 1] * (h / size), rect[:, 3] * (h / size)
    theta = ((x0 + x1) / 2 / w - 0.5) * 2 * math.pi
    phi = (0.5 - (y0 + y1) / 2 / h) * math.pi
    return torch.stack([theta, phi, ((x1 - x0) / w * 2 * math.pi).abs(),
                        ((y1 - y0) / h * math.pi).abs()], -1)


def _intersection(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ta, pa = a[:, None, 0], a[:, None, 1]
    ha, va = a[:, None, 2] / 2, a[:, None, 3] / 2
    tb, pb = b[None, :, 0], b[None, :, 1]
    hb, vb = b[None, :, 2] / 2, b[None, :, 3] / 2
    dt = tb - ta
    x = np.cos(pa) * np.cos(pb) * np.cos(dt) + np.sin(pa) * np.sin(pb)
    y = np.cos(pb) * np.sin(dt)
    z = -np.sin(pa) * np.cos(pb) * np.cos(dt) + np.cos(pa) * np.sin(pb)
    dlon = np.arctan2(y, x)
    dlat = np.arcsin(np.clip(z, -1.0, 1.0))
    lon_w = np.maximum(np.minimum(ha, dlon + hb) - np.maximum(-ha, dlon - hb),
                       0)
    hi = np.minimum(va, dlat + vb)
    lo = np.maximum(-va, dlat - vb)
    return lon_w * np.maximum(np.where(hi > lo, np.sin(hi) - np.sin(lo), 0.0),
                              0.0)


def sph_iou(boxes: np.ndarray) -> np.ndarray:
    """(N, N) spherical IoU of SphBBs, float64; the intersection is the
    mean of the two one-sided estimates, so the matrix is symmetric."""
    b = np.asarray(boxes, np.float64)
    inter = 0.5 * (_intersection(b, b) + _intersection(b, b).T)
    area = 2.0 * b[:, 2] * np.sin(b[:, 3] / 2.0)
    return inter / np.maximum(area[:, None] + area[None, :] - inter, 1e-12)


def greedy_keep(boxes, scores, threshold: float) -> tuple[np.ndarray, float]:
    """Greedy NMS keep-mask (the best remaining box is kept and every
    other box above ``threshold`` IoU with it is dropped; ties in score
    keep the lower index first), and the distance to the threshold of
    the closest IoU that decided a drop or a survival."""
    n = len(scores)
    if n == 0:
        return np.zeros((0,), bool), math.inf
    iou = sph_iou(boxes)
    order = np.argsort(-np.asarray(scores, np.float64), kind="stable")
    keep = np.zeros(n, bool)
    active = np.ones(n, bool)
    margin = math.inf
    for i in order:
        if not active[i]:
            continue
        keep[i] = True
        active[i] = False
        row = iou[i]
        live = np.flatnonzero(active)
        if live.size:
            margin = min(margin, float(np.abs(row[live] - threshold).min()))
        active &= row <= threshold
    return keep, margin
