"""The layers the CSP detector uses (port of the matching subset of
``repro.models.layers``).

Params are plain nested dicts of tensors, as in the reference.  The
public layout follows the reference too: activations are channel-last
``(N, H, W, C)``.  Internally the convolutions run channel-first, so
:func:`conv2d` takes and returns NCHW and its weight is OIHW; the
detector permutes once at its boundary (``models/detector.py``).
Weights are drawn from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
Params = dict


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32

    def cast_in(self, x: Tensor) -> Tensor:
        return x.to(self.compute_dtype)


F32 = DtypePolicy()


def _uniform_init(gen: torch.Generator, shape, scale, dtype, device):
    w = torch.rand(shape, generator=gen, dtype=torch.float32,
                   device=gen.device) * (2.0 * scale) - scale
    return w.to(device=device, dtype=dtype)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------


def init_groupnorm(d: int, groups: int = 32, dtype=torch.float32,
                   device="cpu") -> Params:
    del groups  # the group count is a call-time choice
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def num_groups(c: int, preferred: int = 32) -> int:
    """Largest divisor of ``c`` that is <= preferred."""
    g = min(preferred, c)
    while c % g:
        g -= 1
    return g


def groupnorm(p: Params, x: Tensor, eps: float = 1e-5,
              groups: int | None = None) -> Tensor:
    """GroupNorm over the channel axis of NCHW ``x``, in float32."""
    c = x.shape[1]
    g = groups if groups is not None else num_groups(c)
    y = F.group_norm(x.to(torch.float32), g, p["scale"].to(torch.float32),
                     p["bias"].to(torch.float32), eps)
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# Convolutions
# --------------------------------------------------------------------------


def init_conv(gen: torch.Generator, kh: int, kw: int, c_in: int, c_out: int,
              *, bias: bool = True, dtype=torch.float32, device="cpu",
              groups: int = 1) -> Params:
    """Conv params with an OIHW weight, uniform in +-sqrt(1 / fan_in)."""
    fan_in = kh * kw * c_in // groups
    scale = math.sqrt(1.0 / fan_in)
    p = {"w": _uniform_init(gen, (c_out, c_in // groups, kh, kw), scale,
                            dtype, device)}
    if bias:
        p["b"] = torch.zeros((c_out,), dtype=dtype, device=device)
    return p


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA "SAME" padding of one spatial axis: the output has
    ceil(size / stride) positions and an odd extra pad goes to the end
    (bottom/right), unlike torch's symmetric ``padding=``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(p: Params, x: Tensor, *, stride: int = 1, groups: int = 1,
           policy: DtypePolicy = F32) -> Tensor:
    """"SAME"-padded convolution of NCHW ``x`` with an OIHW weight."""
    kh, kw = p["w"].shape[2], p["w"].shape[3]
    top, bottom = _same_pads(x.shape[2], kh, stride)
    left, right = _same_pads(x.shape[3], kw, stride)
    x = policy.cast_in(x)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    b = p["b"].to(policy.compute_dtype) if "b" in p else None
    return F.conv2d(x, p["w"].to(policy.compute_dtype), b, stride=stride,
                    padding=0, groups=groups)


def upsample_nearest(x: Tensor, factor: int = 2) -> Tensor:
    """Nearest-neighbour upsampling of NCHW ``x`` by ``factor``."""
    return x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)


# --------------------------------------------------------------------------
# Activations
# --------------------------------------------------------------------------


def mish(x: Tensor) -> Tensor:
    return x * torch.tanh(F.softplus(x))
