"""Wrapper of the group-norm + Mish CUDA kernel
(``csrc/groupnorm_mish.cu``): ``[residual +] mish(groupnorm(x))`` over
NCHW ``x``, the norm-activation tail of every conv block of the CSP
detector.

On the card the kernel runs for float32 without gradients and raises for
anything else (it has no backward and no bf16 instance): a detector that
trains or computes in bf16 there asks for the plain tail through its
config (``norm_act_impl="plain"``).  Off the card (the CPU, the meta
device) the wrapper is the plain composition (``ref.py``), which the
kernel matches up to the order of the group moments' float32 sums.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.groupnorm.ref import groupnorm_mish_ref
from repro_torch.models import layers as L

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def groupnorm_mish(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   *, residual: torch.Tensor | None = None,
                   eps: float = 1e-5) -> torch.Tensor:
    """``[residual +] mish(groupnorm(x))`` for ``x`` (N, C, H, W) with the
    group norm's (C,) ``scale`` and ``bias`` over ``L.num_groups(C)``
    groups, as ``L.groupnorm``."""
    if x.dim() != 4:
        raise ValueError(f"want NCHW x, got shape {tuple(x.shape)}")
    c = x.shape[1]
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"want ({c},) scale and bias, got "
                         f"{tuple(scale.shape)}, {tuple(bias.shape)}")
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"residual {tuple(residual.shape)} is not x's "
                         f"{tuple(x.shape)}")
    if x.device.type != "cuda":
        return groupnorm_mish_ref(x, scale, bias, residual=residual, eps=eps)
    ins = (x, scale, bias) if residual is None else (x, scale, bias, residual)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        raise RuntimeError("groupnorm_mish has no backward: train the "
                           "detector with norm_act_impl='plain'")
    if x.dtype != torch.float32 or (residual is not None
                                    and residual.dtype != torch.float32):
        raise TypeError(f"groupnorm_mish takes float32, got {x.dtype}: run "
                        f"the detector with norm_act_impl='plain'")
    if any(t.device != x.device for t in ins):
        raise ValueError("x, scale, bias and residual lie on different "
                         "devices")
    if not x.is_contiguous() or (residual is not None
                                 and not residual.is_contiguous()):
        raise ValueError("the kernel takes contiguous NCHW x and residual")
    g = L.num_groups(c)
    n, _, h, w = x.shape
    if (c // g) * h * w >= 2 ** 31 or n * g > 65535:
        raise ValueError(f"shape {tuple(x.shape)} over {g} groups is beyond "
                         f"the kernel's grid")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    scale = scale.to(torch.float32).contiguous()
    bias = bias.to(torch.float32).contiguous()
    fn = _build.bind("groupnorm", "groupnorm_mish_f32",
                     [_P, _P, _P, _P, _P, _LL, _I, _LL, _I, ctypes.c_float,
                      _P])
    _build.count("groupnorm_mish")
    _build.check(fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                    None if residual is None else residual.data_ptr(),
                    out.data_ptr(), n, c, h * w, g, eps,
                    torch.cuda.current_stream(x.device).cuda_stream),
                 "groupnorm_mish_f32")
    return out
