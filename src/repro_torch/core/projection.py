"""Sphere <-> plane projections: gnomonic (perspective), ERP, Cubemap
(port of ``repro.core.projection``).

The OmniSense inference scheduler extracts one perspective image (PI)
per SRoI from the input ERP frame via gnomonic projection, at exactly
the input size of the allocated model.  This module provides:

  * :func:`gnomonic_coords` — the (u, v) ERP source coordinates for
    every output pixel of a PI (the "sampling map");
  * :func:`sample_erp_bilinear` — the plain PyTorch bilinear resampler
    (the plain version of the gnomonic CUDA kernel);
  * :func:`project_sroi` — SRoI -> PI extraction with a ``use_kernel``
    switch between the plain path and the kernel;
  * :func:`cubemap_faces` — the six 90x90-degree cube-face PIs of the
    CubeMap baseline;
  * :func:`erp_resize_coords` — plain ERP downsampling map (the "ERP"
    baseline feeds a resized whole frame to the detector).

Conventions: ERP frames are channel-last ``(H, W, C)`` float tensors;
angles are radians; PI pixel (0, 0) is the top-left corner.  Every map
is float32 on the frame's (or the given) device.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import sphere

Tensor = torch.Tensor


def _scalar(x, device) -> Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


# --------------------------------------------------------------------------
# Sampling maps
# --------------------------------------------------------------------------


def gnomonic_coords(
    center_theta,
    center_phi,
    fov: tuple[float, float],
    out_size: tuple[int, int],
    erp_size: tuple[int, int],
    device: str | torch.device = "cpu",
) -> tuple[Tensor, Tensor]:
    """ERP source coordinates for a gnomonic PI.

    Returns ``(u, v)`` float32 tensors of shape ``out_size`` giving, for
    each output pixel, the (sub-pixel) ERP location to sample.

    ``fov``: (horizontal, vertical) in radians; ``out_size``: (H, W) of
    the PI; ``erp_size``: (H, W) of the source ERP frame.
    """
    out_h, out_w = out_size
    erp_h, erp_w = erp_size
    half_x = torch.tan(_scalar(fov[0] / 2.0, device))
    half_y = torch.tan(_scalar(fov[1] / 2.0, device))

    # pixel centres
    xs = (torch.arange(out_w, dtype=torch.float32, device=device) + 0.5) / out_w
    ys = (torch.arange(out_h, dtype=torch.float32, device=device) + 0.5) / out_h
    x = (xs - 0.5) * 2.0 * half_x  # tangent-plane coords
    y = (0.5 - ys) * 2.0 * half_y
    yg, xg = torch.meshgrid(y, x, indexing="ij")  # (H, W)

    d = torch.stack([torch.ones_like(xg), xg, yg], dim=-1)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    r = sphere.rotation_from_origin(_scalar(center_theta, device),
                                    _scalar(center_phi, device))
    world = torch.einsum("ij,hwj->hwi", r, d)
    theta, phi = sphere.cart_to_sph(world)
    # u wraps horizontally; v is clamped at the poles by the sampler
    return sphere.sph_to_erp(theta, phi, erp_w, erp_h)


def erp_resize_coords(
    out_size: tuple[int, int], erp_size: tuple[int, int],
    device: str | torch.device = "cpu",
) -> tuple[Tensor, Tensor]:
    """Plain bilinear-resize sampling map (ERP baseline)."""
    out_h, out_w = out_size
    erp_h, erp_w = erp_size
    u = (torch.arange(out_w, dtype=torch.float32, device=device) + 0.5) \
        * (erp_w / out_w) - 0.5
    v = (torch.arange(out_h, dtype=torch.float32, device=device) + 0.5) \
        * (erp_h / out_h) - 0.5
    vg, ug = torch.meshgrid(v, u, indexing="ij")
    return ug, vg


CUBE_FACE_CENTERS = (
    # (name, theta, phi) of the six cube-face centres
    ("front", 0.0, 0.0),
    ("right", math.pi / 2, 0.0),
    ("back", math.pi, 0.0),
    ("left", -math.pi / 2, 0.0),
    ("top", 0.0, math.pi / 2),
    ("bottom", 0.0, -math.pi / 2),
)


def cubemap_faces(erp: Tensor, face_size: int
                  ) -> tuple[Tensor, tuple[tuple[str, float, float], ...]]:
    """Project an ERP frame onto the six 90x90-degree cube faces.

    Returns ``(faces, centers)`` where ``faces`` is
    ``(6, face_size, face_size, C)``.  Used by the CubeMap baseline.
    """
    fov = (math.pi / 2, math.pi / 2)
    faces = []
    for _, th, ph in CUBE_FACE_CENTERS:
        u, v = gnomonic_coords(th, ph, fov, (face_size, face_size),
                               tuple(erp.shape[:2]), erp.device)
        faces.append(sample_erp_bilinear(erp, u, v))
    return torch.stack(faces), CUBE_FACE_CENTERS


# --------------------------------------------------------------------------
# Bilinear sampling (plain version; the CUDA kernel mirrors it)
# --------------------------------------------------------------------------


def sample_erp_bilinear(erp: Tensor, u: Tensor, v: Tensor) -> Tensor:
    """Sample an ERP frame at float coords with horizontal wrap.

    ``erp``: (H, W, C); ``u``/``v``: (h, w) float source coords in ERP
    pixel space (pixel-centre convention: integer coords hit texel
    centres).  Horizontal coordinate wraps (the ERP seam is periodic);
    vertical clamps at the poles.  The blend runs in float32, so a
    float16 frame yields float32 samples, as in the reference.
    """
    erp_h, erp_w = erp.shape[0], erp.shape[1]
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]

    u0i = torch.remainder(u0.to(torch.int64), erp_w)  # never negative
    u1i = torch.remainder(u0i + 1, erp_w)
    v0i = torch.clamp(v0.to(torch.int64), 0, erp_h - 1)
    v1i = torch.clamp(v0i + 1, 0, erp_h - 1)

    p00 = erp[v0i, u0i]
    p01 = erp[v0i, u1i]
    p10 = erp[v1i, u0i]
    p11 = erp[v1i, u1i]

    top = p00 * (1.0 - fu) + p01 * fu
    bot = p10 * (1.0 - fu) + p11 * fu
    return top * (1.0 - fv) + bot * fv


def project_sroi(
    erp: Tensor,
    center_theta,
    center_phi,
    fov: tuple[float, float],
    out_size: tuple[int, int],
    use_kernel: bool = False,
) -> Tensor:
    """Extract the PI of one SRoI from an ERP frame (on ``erp``'s device).

    ``use_kernel=True`` samples through the gnomonic kernel's wrapper
    (``repro_torch.kernels.gnomonic.ops``); otherwise the plain path
    runs.  Both produce the same PI.
    """
    u, v = gnomonic_coords(center_theta, center_phi, fov, out_size,
                           tuple(erp.shape[:2]), erp.device)
    if use_kernel:
        from repro_torch.kernels.gnomonic import ops as gno_ops

        return gno_ops.gnomonic_sample(erp, u, v)
    return sample_erp_bilinear(erp, u, v)
