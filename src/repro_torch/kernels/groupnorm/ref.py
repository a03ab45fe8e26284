"""Plain PyTorch version of the group-norm + Mish kernel: the
composition ``models/detector.py::_conv_bn`` ran before the kernel,
``L.mish(L.groupnorm(...))``, with the CSP bottleneck's residual added
after it."""

from __future__ import annotations

import torch

from repro_torch.models import layers as L


def groupnorm_mish_ref(x: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, *,
                       residual: torch.Tensor | None = None,
                       eps: float = 1e-5) -> torch.Tensor:
    m = L.mish(L.groupnorm({"scale": scale, "bias": bias}, x, eps))
    return m if residual is None else residual + m
