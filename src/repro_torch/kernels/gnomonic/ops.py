"""Wrappers of the gnomonic CUDA kernels (``csrc/gnomonic.cu``).

``gnomonic_sample`` resamples an ERP frame at given (u, v) maps; it
replaces the Pallas kernel ``repro/kernels/gnomonic/gnomonic.py``
``gnomonic_pallas``.  ``project_srois_batched`` projects a whole tick's
crops in one launch, computing each pixel's map in the kernel; it
replaces the XLA program ``repro/kernels/gnomonic/ops.py``
``_project_srois_jit``.

For a tensor on the CPU each wrapper runs the plain PyTorch version
(``ref.py``); for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.projection import gnomonic_coords
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.gnomonic.ref import (gnomonic_sample_ref,
                                              project_srois_ref)

_P = ctypes.c_void_p
_I = ctypes.c_int


def _as_frame(erp, device) -> torch.Tensor:
    if isinstance(erp, torch.Tensor):
        return erp if device is None else erp.to(device)
    return torch.as_tensor(np.asarray(erp), device=resolve_device(device))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def gnomonic_sample(erp, u_map, v_map, *,
                    device: str | torch.device | None = None) -> torch.Tensor:
    """Sample ``erp`` (H, W, C) at the maps (out_h, out_w) -> (out_h,
    out_w, C) in the frame's dtype (float32 or float16).

    Same semantics as :func:`repro_torch.core.projection.sample_erp_bilinear`:
    horizontal wrap, vertical clamp, pixel-centre bilinear, float32
    blend.  ``erp`` is a tensor (which fixes the device) or an array,
    placed on ``device`` (default ``cuda``).
    """
    erp = _as_frame(erp, device)
    u = torch.as_tensor(u_map, dtype=torch.float32, device=erp.device)
    v = torch.as_tensor(v_map, dtype=torch.float32, device=erp.device)
    if erp.dim() != 3 or u.dim() != 2 or u.shape != v.shape:
        raise ValueError(f"want erp (H, W, C) and equal 2-D maps, got "
                         f"{tuple(erp.shape)}, {tuple(u.shape)}, "
                         f"{tuple(v.shape)}")
    if erp.dtype not in (torch.float32, torch.float16):
        raise TypeError(f"erp dtype {erp.dtype} is not float32/float16")
    if erp.device.type == "cpu":
        return gnomonic_sample_ref(erp, u, v).to(erp.dtype)
    if erp.device.type != "cuda":
        raise ValueError(f"unsupported device {erp.device}")
    erp = erp.contiguous()
    u, v = u.contiguous(), v.contiguous()
    h, w, c = erp.shape
    out = torch.empty(u.shape + (c,), dtype=erp.dtype, device=erp.device)
    symbol = ("gnomonic_sample_f32" if erp.dtype == torch.float32
              else "gnomonic_sample_f16")
    fn = _build.bind("gnomonic", symbol, [_P, _P, _P, _P, _I, _I, _I, _I, _P])
    _build.count("gnomonic_sample")
    _build.check(fn(erp.data_ptr(), u.data_ptr(), v.data_ptr(),
                    out.data_ptr(), h, w, c, u.numel(), _stream(erp)),
                 symbol)
    return out


def project_sroi_kernel(erp, center_theta: float, center_phi: float,
                        fov: tuple[float, float], out_size: tuple[int, int],
                        *, device: str | torch.device | None = None
                        ) -> torch.Tensor:
    """SRoI -> PI: the gnomonic map in PyTorch, the sampling through
    :func:`gnomonic_sample`."""
    erp = _as_frame(erp, device)
    u, v = gnomonic_coords(center_theta, center_phi, fov, out_size,
                           tuple(erp.shape[:2]), erp.device)
    return gnomonic_sample(erp, u, v)


def project_srois_batched(frames: torch.Tensor, frame_idx, centers, fovs,
                          out_size: tuple[int, int]) -> torch.Tensor:
    """Batched SRoI -> PI projection of a tick's crops in one launch.

    ``frames``: the tick's DISTINCT frames, (F, H, W, C) float32 (the
    device is theirs); ``frame_idx``: (B,) index of each crop's frame;
    ``centers``/``fovs``: (B, 2) (theta, phi) and (horizontal, vertical)
    FoV in radians.  Returns (B, S, S, C) for ``out_size == (S, S)``.
    """
    idx = np.asarray(frame_idx, dtype=np.int64).reshape(-1)
    cen = np.ascontiguousarray(centers, dtype=np.float32).reshape(-1, 2)
    fov = np.ascontiguousarray(fovs, dtype=np.float32).reshape(-1, 2)
    s = int(out_size[0])
    if int(out_size[1]) != s:
        raise ValueError(f"PIs are square, got {out_size}")
    if frames.dim() != 4 or frames.dtype != torch.float32:
        raise ValueError(f"want (F, H, W, C) float32 frames, got "
                         f"{tuple(frames.shape)} {frames.dtype}")
    if not (len(idx) == len(cen) == len(fov)):
        raise ValueError("frame_idx, centers and fovs differ in length")
    if len(idx) and (idx.min() < 0 or idx.max() >= frames.shape[0]):
        raise IndexError(f"frame index outside [0, {frames.shape[0]})")
    dev = frames.device
    if dev.type == "cpu":
        return project_srois_ref(frames, torch.from_numpy(idx),
                                 torch.from_numpy(cen), torch.from_numpy(fov),
                                 (s, s))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _, h, w, c = frames.shape
    b = len(idx)
    frames = frames.contiguous()
    out = torch.empty((b, s, s, c), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    # the geometry goes up in ONE copy from pinned memory, which does not
    # make the host wait for the device (a pageable copy would): int32
    # frame indices, then the float32 centres and FoVs, bit for bit
    packed = np.concatenate([idx.astype(np.int32), cen.view(np.int32).ravel(),
                             fov.view(np.int32).ravel()])
    host = torch.empty(packed.shape, dtype=torch.int32, pin_memory=True)
    host.copy_(torch.from_numpy(packed))
    geo = host.to(dev, non_blocking=True)
    base = geo.data_ptr()
    fn = _build.bind("gnomonic", "project_srois_f32",
                     [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P])
    _build.count("project_srois_batched")
    _build.check(fn(frames.data_ptr(), base, base + 4 * b, base + 12 * b,
                    out.data_ptr(), b, h, w, c, s, _stream(frames)),
                 "project_srois_f32")
    return out
