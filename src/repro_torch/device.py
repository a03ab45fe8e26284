"""Device resolution and the float32 policy of the port's entry points.

Entry points run on the GPU unless the caller names another device.
There is no silent fallback: with no device given and no CUDA device
present, :func:`resolve_device` raises, so a run that was meant for the
card can never carry on on the CPU unnoticed.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else
    ``cuda``; raises ``RuntimeError`` when ``cuda`` is asked for (or
    defaulted to) and no CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def set_fp32_policy() -> None:
    """Keep float32 work in full float32: no TF32 in cuDNN convolutions
    or in matrix products (PyTorch enables TF32 for cuDNN by default)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def set_bf16_policy() -> None:
    """bfloat16 matrix products accumulate and reduce in float32: no
    reduced-precision reductions of split-K partial sums (which PyTorch
    allows by default)."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
