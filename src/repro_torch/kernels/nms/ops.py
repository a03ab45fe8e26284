"""Wrapper of the per-row greedy suppression CUDA kernel
(``csrc/greedy.cu``), which replaces the ``lax.while_loop`` of the XLA
program ``repro/core/sphere.py`` ``_sph_nms_batch_device``.

For tensors on the CPU the wrapper runs the plain PyTorch version
(``ref.py``); for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.nms.ref import greedy_suppress_rows_ref

MAX_N = 8192  # a row's scores and flags fit a block's 48 KB of shared memory


def greedy_suppress_rows(iou: torch.Tensor, scores: torch.Tensor,
                         mask: torch.Tensor, iou_threshold: float
                         ) -> torch.Tensor:
    """(B, N, N) float32 IoU, (B, N) scores, (B, N) bool mask ->
    (B, N) bool keep mask of greedy NMS per row (highest score first,
    lowest index on ties; masked entries are never kept)."""
    b, n = scores.shape
    if iou.shape != (b, n, n) or mask.shape != (b, n):
        raise ValueError(f"want iou (B, N, N) and mask (B, N) for scores "
                         f"(B, N) = {(b, n)}, got {tuple(iou.shape)} and "
                         f"{tuple(mask.shape)}")
    if not (iou.device == scores.device == mask.device):
        raise ValueError("inputs on different devices")
    dev = scores.device
    if dev.type == "cpu":
        return greedy_suppress_rows_ref(iou, scores, mask, iou_threshold)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if n > MAX_N:
        raise ValueError(f"row length {n} exceeds the kernel's {MAX_N}")
    iou = iou.to(torch.float32).contiguous()
    sc = scores.to(torch.float32).contiguous()
    mk = mask.to(torch.bool).contiguous()
    keep = torch.empty((b, n), dtype=torch.bool, device=dev)
    if keep.numel() == 0:
        return keep
    # scratch: each entry's 32-bit word row of suppression bits (the words
    # a row rounded up to a multiple of 4, for 16-byte copies) and each
    # row's order of visit
    wp = -(-((n + 31) // 32) // 4) * 4
    bits = torch.empty((b, n, wp), dtype=torch.int32, device=dev)
    order = torch.empty((b, n), dtype=torch.int32, device=dev)
    fn = _build.bind("nms", "greedy_suppress_rows_f32",
                     [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                              ctypes.c_float,
                                              ctypes.c_void_p])
    _build.count("greedy_suppress_rows")
    _build.check(fn(iou.data_ptr(), sc.data_ptr(), mk.data_ptr(),
                    keep.data_ptr(), bits.data_ptr(), order.data_ptr(), b, n,
                    float(iou_threshold),
                    torch.cuda.current_stream(dev).cuda_stream),
                 "greedy_suppress_rows_f32")
    return keep
