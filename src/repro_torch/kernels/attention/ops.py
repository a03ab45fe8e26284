"""Wrapper of the flash-attention CUDA kernel (``csrc/attention.cu``),
which replaces the Pallas kernel ``repro/kernels/attention/attention.py``
``mha_pallas`` as the reference's ``ops.py`` ``flash_attention`` calls it.

The kernel reads the ``(B, S, H, D)`` tensors through their strides (no
``(B*H, S, D)`` fold copy), maps query head ``h`` to KV head
``h // (Hq // Hkv)`` (no ``repeat``) and bounds-checks ragged tails (no
padding to a block multiple).

For tensors on the CPU the wrapper runs the plain PyTorch version
(``ref.py``); for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.attention.ref import flash_attention_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
HEAD_DIMS = (16, 32, 64, 128)  # the kernel's template instances
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BLOCK_Q = 64  # query rows per CTA (kBQ in the source)
_MAX_GRID_Y = 65535


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0, scale: float | None = None
                    ) -> torch.Tensor:
    """Multi-head attention with optional GQA, causality and window.

    q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D), float32 or bfloat16;
    returns (B, Sq, Hq, D) in q's dtype.  Scores, softmax and the value
    product run in float32.  ``q_offset`` is the absolute position of
    ``q[:, 0]`` (decode and chunked prefill, where Sq != Skv).
    """
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B, Sq, Hq, D) and k, v (B, Skv, Hkv, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit k {tuple(k.shape)}: "
                         f"batch and head size must agree and Hq must be a "
                         f"multiple of Hkv")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v on different devices")
    if window is not None and window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    if scale is None:
        scale = d ** -0.5
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"the kernel takes float32 or bfloat16 q, k, v of "
                         f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head size {d} not in the kernel's {HEAD_DIMS}")
    n_qt = -(-sq // _BLOCK_Q)
    if b * hq > 2**31 - 1 or n_qt > _MAX_GRID_Y:
        raise ValueError(f"B*Hq={b * hq} or Sq={sq} exceeds the kernel's grid")
    # the kernel reads through strides, but the head axis must be dense
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn = _build.bind("attention", "flash_attention_fwd",
                     [_P] * 4 + [_I] * 7 + [_L] * 9
                     + [ctypes.c_float, _I, _I, _I, _P])
    _build.count("flash_attention")
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    _DTYPES[q.dtype], d, b, sq, skv, hq, hkv,
                    *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                    float(scale), int(bool(causal)),
                    -1 if window is None else int(window), int(q_offset),
                    torch.cuda.current_stream(q.device).cuda_stream),
                 "flash_attention_fwd")
    return out
