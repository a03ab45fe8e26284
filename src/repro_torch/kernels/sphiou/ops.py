"""Wrappers of the SphIoU CUDA kernel (``csrc/sphiou.cu``), which
replaces the Pallas kernels ``repro/kernels/sphiou/sphiou.py``
``sphiou_pallas_batch`` and ``sphiou_pallas`` (the B=1 call here), in
float32 or with their bf16 compute option.

For tensors on the CPU the wrappers run the plain PyTorch version
(``ref.py``); for CUDA tensors they launch the kernel or raise.  Boxes
against themselves (one tensor passed twice, as NMS calls it, or two
contiguous float32 tensors of the same shape at the same address) take
the kernel's self path, which computes each unordered pair once.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sphiou.ref import (sphiou_ref_batch,
                                            sphiou_ref_batch_bf16)

_P = ctypes.c_void_p
_I = ctypes.c_int
_MAX_GRID_Z = 65535  # CUDA's limit on gridDim.z (the batch axis)
# compute dtype -> (plain version, C entry, launch-count name)
_VARIANTS = {
    torch.float32: (sphiou_ref_batch, "sphiou_batch_f32",
                    "sphiou_matrix_batch"),
    torch.bfloat16: (sphiou_ref_batch_bf16, "sphiou_batch_bf16",
                     "sphiou_matrix_batch_bf16"),
}


def sphiou_matrix_batch(boxes_a: torch.Tensor, boxes_b: torch.Tensor, *,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, N, 4) x (B, M, 4) -> (B, N, M) per-row SphIoU matrices.

    Rows are independent: row ``r`` is ``sphiou_matrix(boxes_a[r],
    boxes_b[r])``.  Zero-FoV padding scores IoU 0 against everything.
    ``dtype`` is the compute precision, float32 or bfloat16 (the
    reference's bf16 option: boxes and every intermediate rounded to
    bf16); inputs and output are float32, on the inputs' device.
    """
    if dtype not in _VARIANTS:
        raise ValueError(f"compute dtype {dtype} is not float32 or bfloat16")
    plain, entry, name = _VARIANTS[dtype]
    if (boxes_a.dim() != 3 or boxes_b.dim() != 3
            or boxes_a.shape[0] != boxes_b.shape[0]
            or boxes_a.shape[2] != 4 or boxes_b.shape[2] != 4):
        raise ValueError(f"want (B, N, 4) and (B, M, 4), got "
                         f"{tuple(boxes_a.shape)} and {tuple(boxes_b.shape)}")
    if boxes_a.device != boxes_b.device:
        raise ValueError("boxes on different devices")
    a = boxes_a.to(torch.float32).contiguous()
    b = a if boxes_b is boxes_a else boxes_b.to(torch.float32).contiguous()
    if a.device.type == "cpu":
        return plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    rows, n, _ = a.shape
    m = b.shape[1]
    out = torch.empty((rows, n, m), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    fn = _build.bind("sphiou", entry, [_P, _P, _P, _I, _I, _I, _P])
    stream = torch.cuda.current_stream(a.device).cuda_stream
    for lo in range(0, rows, _MAX_GRID_Z):
        hi = min(lo + _MAX_GRID_Z, rows)
        _build.count(name)
        _build.check(fn(a[lo].data_ptr(), b[lo].data_ptr(),
                        out[lo].data_ptr(), hi - lo, n, m, stream), entry)
    return out


def trig_check(device: torch.device | str = "cuda") -> int:
    """Count the finite float32 ``x >= 0`` at which the card's precise
    ``sinf(-x) == -sinf(x)``, ``cosf(-x) == cosf(x)`` or ``sincosf`` equal
    to ``sinf`` and ``cosf`` fails, bit for bit: the premises on which the
    kernel computes both directions of a pair from one ``sincosf``.  0 on
    a card where they hold."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the check runs on a CUDA device, not {dev}")
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    fn = _build.bind("sphiou", "sphiou_trig_check",
                     [ctypes.c_uint, ctypes.c_uint, _P, _P])
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(fn(0, 0x7F800000, bad.data_ptr(), stream),
                 "sphiou_trig_check")
    return int(bad)


def sphiou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor
                  ) -> torch.Tensor:
    """(N, 4) x (M, 4) -> (N, M) SphIoU matrix: the B=1 call of
    :func:`sphiou_matrix_batch`."""
    return sphiou_matrix_batch(boxes_a[None], boxes_b[None])[0]
