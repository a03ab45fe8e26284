"""Wrappers of the flash-attention CUDA kernels, which replace the Pallas
kernel ``repro/kernels/attention/attention.py`` ``mha_pallas`` as the
reference's ``ops.py`` ``flash_attention`` calls it.

Two kernels serve it, by dtype and head size (:func:`route`):

- ``csrc/attention_wgmma.cu``: bf16 at D in ``WGMMA_HEAD_DIMS`` (64,
  128), on the tensor cores (TMA, ``wgmma``, a warp-specialised K/V
  ring), counted as ``flash_attention_wgmma``.  It loads through TMA
  only, so a view that TMA cannot map is copied first
  (:func:`tma_operand`);
- ``csrc/attention.cu``: float32 at every D in ``HEAD_DIMS`` and bf16 at
  D 16 and 32, float32 FMAs on the CUDA cores, counted as
  ``flash_attention``.  The reference's float32 tolerance (atol 2e-5,
  rtol 1e-4) rules out the TF32 tensor cores for float32.  Where a few
  heads leave the card's SMs short of work, a cluster of up to
  ``SIMT_MAX_SPLIT`` CTAs shares each 64-row tile (``ref.py``'s
  ``split_factor`` and ``flash_attention_split_ref`` show the plan and its
  arithmetic).

Both read the ``(B, S, H, D)`` tensors through their strides (no
``(B*H, S, D)`` fold copy), map query head ``h`` to KV head
``h // (Hq // Hkv)`` (no ``repeat``) and mask ragged tails (no padding to
a block multiple).  Both load whole 16-byte chunks of a row (TMA, or
``cp.async``), so a view whose rows do not start on 16 bytes is copied
first (:func:`tma_operand`).

For tensors on the CPU the wrapper runs the plain PyTorch version
(``ref.py``); for CUDA tensors it launches a kernel or raises.  Under
autograd it raises on either device (there is no backward).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.attention.ref import (SIMT_MAX_SPLIT,
                                               flash_attention_ref)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
HEAD_DIMS = (16, 32, 64, 128)  # the SIMT kernel's template instances
WGMMA_HEAD_DIMS = (64, 128)  # the tensor-core kernel's
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535
_TMA_ALIGN = 16  # bytes: TMA's granule for the base address and strides


class _Kernel(NamedTuple):
    symbol: str  # the C entry
    name: str  # its launch count's
    block_q: int  # query rows a CTA (kBQ in its source)
    argtypes: list


_TAIL = [_L] * 9 + [ctypes.c_float, _I, _I, _I, _P]
KERNELS = {  # the SIMT entry also takes a dtype code
    "wgmma": _Kernel("flash_attention_wgmma_fwd", "flash_attention_wgmma",
                     128, [_P] * 4 + [_I] * 6 + _TAIL),
    "simt": _Kernel("flash_attention_fwd", "flash_attention", 64,
                    [_P] * 4 + [_I] * 7 + _TAIL),
}


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel that serves ``dtype`` at head size ``d``: ``"wgmma"``
    or ``"simt"``; raises ``ValueError`` for what neither takes."""
    if dtype not in _DTYPES:
        raise ValueError(f"the kernels take float32 or bfloat16 q, k, v, "
                         f"got {dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head size {d} not in the kernels' {HEAD_DIMS}")
    return ("wgmma" if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS
            else "simt")


def tma_ok(x: torch.Tensor) -> bool:
    """Whether TMA can map the (B, S, H, D) view ``x`` as it lies: a dense
    D axis, a 16-byte-aligned base, and the stride of every axis it steps
    (extent > 1) a positive multiple of 16 bytes."""
    size = x.element_size()
    return (x.stride(-1) == 1 and x.data_ptr() % _TMA_ALIGN == 0
            and all(st > 0 and st * size % _TMA_ALIGN == 0
                    for n, st in zip(x.shape[:3], x.stride()[:3]) if n > 1))


def tma_operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself where TMA can map it (and 16-byte ``cp.async`` can
    read its rows), else a packed copy (a copy of the operand for either
    kernel, not another kernel)."""
    return x if tma_ok(x) else x.clone(memory_format=torch.contiguous_format)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int | None) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B, Sq, Hq, D) and k, v (B, Skv, Hkv, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, d = q.shape[0], q.shape[2], q.shape[3]
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not fit k {tuple(k.shape)}: "
                         f"batch and head size must agree and Hq must be a "
                         f"multiple of Hkv")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v on different devices")
    if window is not None and window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no backward: train with "
            "attention_impl='chunked' (or 'naive')")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0, scale: float | None = None
                    ) -> torch.Tensor:
    """Multi-head attention with optional GQA, causality and window.

    q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D), float32 or bfloat16;
    returns (B, Sq, Hq, D) in q's dtype.  Scores, softmax and the value
    product run in float32.  ``q_offset`` is the absolute position of
    ``q[:, 0]`` (decode and chunked prefill, where Sq != Skv).

    The kernels have no backward (nor has the reference's Pallas kernel),
    so with grad enabled and an input that requires grad this raises
    ``RuntimeError``, on the CPU too: a kernel's output would carry no
    gradient back to q, k or v.
    """
    _check(q, k, v, window)
    if scale is None:
        scale = q.shape[3] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, scale=scale)
    return _launch(route(q.dtype, q.shape[3]), q, k, v, causal=causal,
                   window=window, q_offset=q_offset, scale=scale)


def launch(kernel: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           *, causal: bool = True, window: int | None = None,
           q_offset: int = 0, scale: float | None = None) -> torch.Tensor:
    """Attention on CUDA tensors by the named kernel, ``"wgmma"`` or
    ``"simt"`` (:func:`flash_attention` picks by :func:`route`; this entry
    also lets the SIMT kernel be held against the tensor-core one)."""
    _check(q, k, v, window)
    return _launch(kernel, q, k, v, causal=causal, window=window,
                   q_offset=q_offset, scale=scale)


def _launch(kernel: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            *, causal: bool, window: int | None, q_offset: int,
            scale: float | None) -> torch.Tensor:
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"the kernels take q, k, v of one dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if route(q.dtype, d) != "wgmma" and kernel == "wgmma":
        raise ValueError(f"the tensor-core kernel takes bf16 at D in "
                         f"{WGMMA_HEAD_DIMS}, got {q.dtype} at D {d}")
    kern = KERNELS[kernel]
    if scale is None:
        scale = d ** -0.5
    n_qt = -(-sq // kern.block_q)
    if (b * hq * n_qt * SIMT_MAX_SPLIT > 2**31 - 1 if kernel == "simt"
            else b * hq > 2**31 - 1 or n_qt > _MAX_GRID_Y):
        raise ValueError(f"B*Hq={b * hq} or Sq={sq} exceeds the kernel's grid")
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if kernel == "wgmma" and skv == 0:
        return out.zero_()  # every row is fully masked (a map needs a key)
    q, k, v = (tma_operand(x) for x in (q, k, v))
    head = (d,) if kernel == "wgmma" else (_DTYPES[q.dtype], d)
    fn = _build.bind("attention", kern.symbol, kern.argtypes)
    _build.count(kern.name)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    *head, b, sq, skv, hq, hkv,
                    *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                    float(scale), int(bool(causal)),
                    -1 if window is None else int(window), int(q_offset),
                    torch.cuda.current_stream(q.device).cuda_stream),
                 kern.symbol)
    return out
