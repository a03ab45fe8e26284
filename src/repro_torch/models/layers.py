"""The layers the CSP detector, the LM, the action head, the vision
backbones and the diffusion models use (port of the matching subset of
``repro.models.layers``).

Params are plain nested dicts of tensors, as in the reference.  The
public layout follows the reference too: activations are channel-last
``(N, H, W, C)``, and a dense weight is ``(d_in, d_out)``.  Internally
the convolutions run channel-first, so :func:`conv2d` takes and returns
NCHW and its weight is OIHW; the detector permutes once at its boundary
(``models/detector.py``).  Weights are drawn from an explicit
``torch.Generator``.
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
BF16 = DtypePolicy(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)


def _uniform_init(gen: torch.Generator, shape, scale, dtype, device):
    w = torch.rand(shape, generator=gen, dtype=torch.float32,
                   device=gen.device) * (2.0 * scale) - scale
    return w.to(device=device, dtype=dtype)


# --------------------------------------------------------------------------
# Dense / embedding
# --------------------------------------------------------------------------


def init_dense(gen: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = True, dtype=torch.float32, device="cpu"
               ) -> Params:
    """A ``(d_in, d_out)`` weight, uniform in +-sqrt(1 / d_in)."""
    p = {"w": _uniform_init(gen, (d_in, d_out), math.sqrt(1.0 / d_in),
                            dtype, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense(p: Params, x: Tensor, policy: DtypePolicy = F32) -> Tensor:
    """``x @ w (+ b)`` in the compute dtype; a bf16 product accumulates in
    float32 and rounds once, as the reference's ``preferred_element_type``
    does."""
    y = torch.matmul(policy.cast_in(x), p["w"].to(policy.compute_dtype))
    if "b" in p:
        y = y + p["b"].to(policy.compute_dtype)
    return y


def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   dtype=torch.float32, device="cpu") -> Params:
    emb = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                      device=gen.device)
    return {"emb": emb.to(device=device, dtype=dtype) * 0.02}


def embedding(p: Params, ids: Tensor, policy: DtypePolicy = F32) -> Tensor:
    return p["emb"].to(policy.compute_dtype)[ids]


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------


def init_rmsnorm(d: int, dtype=torch.float32, device="cpu") -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: Tensor, eps: float = 1e-6) -> Tensor:
    """RMSNorm over the last axis, in float32, cast back to ``x``'s dtype."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(x.dtype)


def init_layernorm(d: int, dtype=torch.float32, device="cpu") -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p: Params, x: Tensor, eps: float = 1e-6) -> Tensor:
    """LayerNorm over the last axis with the reference's constants: eps
    1e-6 (torch's default is 1e-5) and the population variance
    (``jnp.var``; ``torch.var`` defaults to the unbiased one), in
    float32, cast back to ``x``'s dtype."""
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)
            + p["bias"].to(torch.float32)).to(x.dtype)


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


def init_batchnorm(d: int, dtype=torch.float32, device="cpu") -> Params:
    """BatchNorm's affine params in ``dtype``, its running stats in
    float32 (the reference's layout)."""
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device),
            "mean": torch.zeros((d,), dtype=torch.float32, device=device),
            "var": torch.ones((d,), dtype=torch.float32, device=device)}


def batchnorm(p: Params, x: Tensor, *, train: bool, eps: float = 1e-5,
              momentum: float = 0.9) -> tuple[Tensor, Params]:
    """BatchNorm over the channel axis of NCHW ``x``; returns (y, the
    updated running stats), functionally, as the reference does.

    In train mode ``y`` uses the batch's mean and population variance
    (``jnp.var``; ``F.batch_norm`` keeps the unbiased one) and the new
    stats are ``momentum * old + (1 - momentum) * batch``, in float32
    and out of autograd's graph; in eval mode ``y`` uses the running
    stats and ``p`` comes back as it is.  Nothing is updated in place,
    so a remat recompute of the layer changes nothing."""
    x32 = x.to(torch.float32)
    if train:
        dims = (0,) + tuple(range(2, x.dim()))
        mu = torch.mean(x32, dim=dims)
        var = torch.var(x32, dim=dims, correction=0)
        new_stats = {
            **p,
            "mean": momentum * p["mean"].detach()
            + (1 - momentum) * mu.detach(),
            "var": momentum * p["var"].detach()
            + (1 - momentum) * var.detach(),
        }
    else:
        mu, var = p["mean"], p["var"]
        new_stats = p
    shape = (1, -1) + (1,) * (x.dim() - 2)
    y = (x32 - mu.reshape(shape)) * torch.rsqrt(var.reshape(shape) + eps)
    y = (y * p["scale"].to(torch.float32).reshape(shape)
         + p["bias"].to(torch.float32).reshape(shape))
    return y.to(x.dtype), new_stats


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


def conv2d(p: Params, x: Tensor, *, stride: int = 1, padding: str = "SAME",
           groups: int = 1, policy: DtypePolicy = F32) -> Tensor:
    """Convolution of NCHW ``x`` with an OIHW weight, with XLA's
    ``"SAME"`` padding (the default) or ``"VALID"`` (none: the output
    has floor((size - k) / stride) + 1 positions)."""
    x = policy.cast_in(x)
    if padding == "SAME":
        kh, kw = p["w"].shape[2], p["w"].shape[3]
        top, bottom = _same_pads(x.shape[2], kh, stride)
        left, right = _same_pads(x.shape[3], kw, stride)
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
    elif padding != "VALID":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    b = p["b"].to(policy.compute_dtype) if "b" in p else None
    return F.conv2d(x, p["w"].to(policy.compute_dtype), b, stride=stride,
                    padding=0, groups=groups)


def max_pool(x: Tensor, window: int, stride: int) -> Tensor:
    """Max pooling of NCHW ``x`` with XLA's ``"SAME"`` padding by
    ``-inf``: the odd extra pad goes to the bottom and right
    (``F.max_pool2d``'s ``padding=`` is symmetric and would shift every
    window of a stride-2 pool on an even input by one)."""
    top, bottom = _same_pads(x.shape[2], window, stride)
    left, right = _same_pads(x.shape[3], window, stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=-math.inf)
    return F.max_pool2d(x, window, stride, padding=0)


def avg_pool_global(x: Tensor) -> Tensor:
    """Mean over the spatial axes of NCHW ``x``: (N, C)."""
    return torch.mean(x, dim=(2, 3))


def upsample_nearest(x: Tensor, factor: int = 2) -> Tensor:
    """Nearest-neighbour upsampling of NCHW ``x`` by ``factor``."""
    return x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)


# --------------------------------------------------------------------------
# Activations
# --------------------------------------------------------------------------


def mish(x: Tensor) -> Tensor:
    return x * torch.tanh(F.softplus(x))


def silu(x: Tensor) -> Tensor:
    return F.silu(x)


def gelu(x: Tensor) -> Tensor:
    """GELU with the tanh approximation, the reference's
    ``jax.nn.gelu(x, approximate=True)`` (torch's default is exact)."""
    return F.gelu(x, approximate="tanh")


def timestep_embedding(t: Tensor, dim: int,
                       max_period: float = 10000.0) -> Tensor:
    """Sinusoidal timestep embedding (diffusion): ``(B,)`` -> float32
    ``(B, dim)``, the cosines first, then the sines.  The frequencies'
    exponent is divided by a tensor, as the reference divides (PyTorch
    would multiply by the reciprocal of a Python divisor)."""
    half = dim // 2
    expo = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                device=t.device)
    freqs = torch.exp(expo / torch.tensor(float(half), device=t.device))
    args = t.to(torch.float32)[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


# --------------------------------------------------------------------------
# Rotary position embeddings
# --------------------------------------------------------------------------


def rope_frequencies(d_head: int, theta: float = 10000.0,
                     device="cpu") -> Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: Tensor, positions: Tensor, theta: float = 10000.0) -> Tensor:
    """x: (B, S, H, D) with D even; positions: (B, S) or (S,).

    The head splits in halves (not interleaved pairs); the rotation runs
    in float32 and casts back to ``x``'s dtype."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)  # (D/2,)
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].to(torch.float32) * freqs  # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return y.to(x.dtype)
