"""Wrappers of the SphIoU CUDA kernel (``csrc/sphiou.cu``), which
replaces the Pallas kernels ``repro/kernels/sphiou/sphiou.py``
``sphiou_pallas_batch`` and ``sphiou_pallas`` (the B=1 call here).

For tensors on the CPU the wrappers run the plain PyTorch version
(``ref.py``); for CUDA tensors they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sphiou.ref import sphiou_ref_batch

_P = ctypes.c_void_p
_I = ctypes.c_int
_MAX_GRID_Z = 65535  # CUDA's limit on gridDim.z (the batch axis)


def sphiou_matrix_batch(boxes_a: torch.Tensor, boxes_b: torch.Tensor
                        ) -> torch.Tensor:
    """(B, N, 4) x (B, M, 4) -> (B, N, M) per-row SphIoU matrices.

    Rows are independent: row ``r`` is ``sphiou_matrix(boxes_a[r],
    boxes_b[r])``.  Zero-FoV padding scores IoU 0 against everything.
    Computes in float32 on the inputs' device.
    """
    if (boxes_a.dim() != 3 or boxes_b.dim() != 3
            or boxes_a.shape[0] != boxes_b.shape[0]
            or boxes_a.shape[2] != 4 or boxes_b.shape[2] != 4):
        raise ValueError(f"want (B, N, 4) and (B, M, 4), got "
                         f"{tuple(boxes_a.shape)} and {tuple(boxes_b.shape)}")
    if boxes_a.device != boxes_b.device:
        raise ValueError("boxes on different devices")
    a = boxes_a.to(torch.float32).contiguous()
    b = boxes_b.to(torch.float32).contiguous()
    if a.device.type == "cpu":
        return sphiou_ref_batch(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    rows, n, _ = a.shape
    m = b.shape[1]
    out = torch.empty((rows, n, m), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    fn = _build.bind("sphiou", "sphiou_batch_f32",
                     [_P, _P, _P, _I, _I, _I, _P])
    stream = torch.cuda.current_stream(a.device).cuda_stream
    for lo in range(0, rows, _MAX_GRID_Z):
        hi = min(lo + _MAX_GRID_Z, rows)
        _build.count("sphiou_matrix_batch")
        _build.check(fn(a[lo].data_ptr(), b[lo].data_ptr(),
                        out[lo].data_ptr(), hi - lo, n, m, stream),
                     "sphiou_batch_f32")
    return out


def sphiou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor
                  ) -> torch.Tensor:
    """(N, 4) x (M, 4) -> (N, M) SphIoU matrix: the B=1 call of
    :func:`sphiou_matrix_batch`."""
    return sphiou_matrix_batch(boxes_a[None], boxes_b[None])[0]
