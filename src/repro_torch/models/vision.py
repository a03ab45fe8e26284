"""Vision backbones: ViT-B/16, ConvNeXt-B, ResNet-50/152 (port of
``repro.models.vision``).

Params are the reference's nested dicts (exact configs live in
``repro_torch.configs``), with two layout changes: a conv weight is
OIHW (stacked ones ``(L, O, I, kh, kw)``), and ``None`` stands where the
reference has ``None`` (ConvNeXt's first downsample, a ResNet stage of
depth 1).  Repeated homogeneous blocks stay stacked on a leading axis,
as the reference scans them; here a Python loop runs over their
``unbind`` slices.  The reference's ``constrain(...)`` sharding hints
are the identity on one device and are dropped
(``repro_torch.distributed.sharding.constrain`` is the identity until the
multi-device path gives it meaning).

The public functions take channel-last ``(B, H, W, 3)`` images and
return channel-last feature maps, as the reference does.  Inside,
ConvNeXt stays channel-last (its norms and dense layers act on C) and
hands :func:`~repro_torch.models.layers.conv2d` the ``permute(0, 3, 1,
2)`` view, a channels-last NCHW tensor that cuDNN takes without a copy;
ResNet runs on that NCHW view throughout (batchnorm over axis 1).

API per family:
    <family>_init(gen, cfg, device) -> params
    <family>_apply(params, images, cfg, train=False) -> (logits, params')
``params'`` carries refreshed BatchNorm running stats (ResNet, train
mode; the stacked blocks' stats come back stacked); for stat-free
models and in eval mode it is ``params`` itself.  With ``cfg.remat`` and
grad enabled, each scanned block is recomputed in the backward
(non-reentrant ``torch.utils.checkpoint``), where the reference wraps
the scan body in ``jax.checkpoint``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.transformer import _leaf_to_torch, _remat

Tensor = torch.Tensor
Params = dict


def _unstack(tree: Params) -> list[Params]:
    """A stacked tree -> one tree per slice of the leading axis
    (``unbind``: their gradients stack back in one pass)."""
    leaves, treedef = pytree.flatten(tree)
    return [treedef.unflatten(list(s))
            for s in zip(*(t.unbind(0) for t in leaves))]


def _nchw(x: Tensor) -> Tensor:
    """Channel-last ``(B, H, W, C)`` -> the NCHW view of the same memory."""
    return x.permute(0, 3, 1, 2)


def _nhwc(x: Tensor) -> Tensor:
    return x.permute(0, 2, 3, 1)


# ==========================================================================
# ViT
# ==========================================================================


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    name: str
    img_res: int
    patch: int
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    n_classes: int = 1000
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    remat: bool = True

    @property
    def policy(self) -> L.DtypePolicy:
        return L.DtypePolicy(self.param_dtype, self.compute_dtype)

    @property
    def n_params(self) -> int:
        d, f = self.d_model, self.d_ff
        per = 4 * d * d + 2 * d * f + 4 * d
        stem = self.patch * self.patch * 3 * d
        seq = (self.img_res // self.patch) ** 2 + 1
        return self.n_layers * per + stem + seq * d + d * self.n_classes


def vit_init(gen: torch.Generator, cfg: ViTConfig,
             device: str | torch.device | None = None) -> Params:
    """Random parameters in the reference's layout, drawn from ``gen``
    with the reference's distributions, on ``device`` (the card unless
    the caller names another)."""
    device = resolve_device(device)
    dt = cfg.param_dtype
    d, lyr = cfg.d_model, cfg.n_layers
    n_tokens = (cfg.img_res // cfg.patch) ** 2 + 1

    def stacked(shape, scale):
        return L._uniform_init(gen, (lyr,) + shape, scale, dt, device)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    s = (1.0 / d) ** 0.5
    sf = (1.0 / cfg.d_ff) ** 0.5
    pos = torch.randn((1, n_tokens, d), generator=gen, dtype=torch.float32,
                      device=gen.device)
    return {
        "patch": L.init_conv(gen, cfg.patch, cfg.patch, 3, d, dtype=dt,
                             device=device),
        "cls": zeros(1, 1, d),
        "pos": pos.to(device=device, dtype=dt) * 0.02,
        "layers": {
            "ln1": {"scale": ones(lyr, d), "bias": zeros(lyr, d)},
            "wqkv": stacked((d, 3 * d), s),
            "wo": stacked((d, d), s),
            "ln2": {"scale": ones(lyr, d), "bias": zeros(lyr, d)},
            "w1": stacked((d, cfg.d_ff), s),
            "b1": zeros(lyr, cfg.d_ff),
            "w2": stacked((cfg.d_ff, d), sf),
            "b2": zeros(lyr, d),
        },
        "ln_f": L.init_layernorm(d, dt, device),
        "head": L.init_dense(gen, d, cfg.n_classes, dtype=dt, device=device),
    }


def _mha_full(x: Tensor, wqkv: Tensor, wo: Tensor, n_heads: int,
              policy: L.DtypePolicy) -> Tensor:
    """Self-attention of ``x`` (B, S, D) through the fused ``wqkv``
    (D, 3D), split in the reference's ``(b, s, 3, h, dh)`` order; the
    scores and the softmax in float32, then ``wo``."""
    b, s, d = x.shape
    dh = d // n_heads
    qkv = L.dense({"w": wqkv}, x, policy).reshape(b, s, 3, n_heads, dh)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    att = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                       k.to(torch.float32)) * (dh ** -0.5)
    att = torch.softmax(att, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", att, v.to(torch.float32))
    out = out.to(policy.compute_dtype).reshape(b, s, d)
    return L.dense({"w": wo}, out, policy)


def _vit_block(x: Tensor, lp: Params, n_heads: int,
               pol: L.DtypePolicy) -> Tensor:
    x = x + _mha_full(L.layernorm(lp["ln1"], x), lp["wqkv"], lp["wo"],
                      n_heads, pol)
    h = L.gelu(L.dense({"w": lp["w1"], "b": lp["b1"]},
                       L.layernorm(lp["ln2"], x), pol))
    return x + L.dense({"w": lp["w2"], "b": lp["b2"]}, h, pol)


def vit_apply(params: Params, images: Tensor, cfg: ViTConfig,
              train: bool = False) -> tuple[Tensor, Params]:
    """images (B, H, W, 3) -> (float32 logits (B, n_classes), params)."""
    del train  # no batch stats
    pol = cfg.policy
    x = L.conv2d(params["patch"], _nchw(images), stride=cfg.patch,
                 padding="VALID", policy=pol)
    b, d = x.shape[:2]
    x = x.flatten(2).transpose(1, 2)  # (B, h * w, D), row-major patches
    cls = params["cls"].to(pol.compute_dtype).expand(b, 1, d)
    x = torch.cat([cls, x], dim=1) + params["pos"].to(pol.compute_dtype)
    for lp in _unstack(params["layers"]):
        x = _remat(cfg.remat, _vit_block, x, lp, cfg.n_heads, pol)
    x = L.layernorm(params["ln_f"], x)
    logits = L.dense(params["head"], x[:, 0], pol).to(torch.float32)
    return logits, params


# ==========================================================================
# ConvNeXt
# ==========================================================================


@dataclasses.dataclass(frozen=True)
class ConvNeXtConfig:
    name: str
    img_res: int
    depths: Sequence[int] = (3, 3, 27, 3)
    dims: Sequence[int] = (128, 256, 512, 1024)
    n_classes: int = 1000
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    remat: bool = True

    @property
    def policy(self) -> L.DtypePolicy:
        return L.DtypePolicy(self.param_dtype, self.compute_dtype)

    @property
    def n_params(self) -> int:
        total = 4 * 4 * 3 * self.dims[0]
        prev = self.dims[0]
        for depth, dim in zip(self.depths, self.dims):
            if dim != prev:
                total += 2 * 2 * prev * dim
            total += depth * (7 * 7 * dim + dim * 4 * dim * 2 + 3 * dim)
            prev = dim
        return total + self.dims[-1] * self.n_classes


def _convnext_block_init(gen, dim: int, dt, device) -> Params:
    return {
        "dw": L.init_conv(gen, 7, 7, dim, dim, dtype=dt, device=device,
                          groups=dim),
        "ln": L.init_layernorm(dim, dt, device),
        "pw1": L.init_dense(gen, dim, 4 * dim, dtype=dt, device=device),
        "pw2": L.init_dense(gen, 4 * dim, dim, dtype=dt, device=device),
        "gamma": torch.full((dim,), 1e-6, dtype=dt, device=device),
    }


def _stack_params(plist: list[Params]) -> Params:
    """Trees of one structure -> one tree of their leaves stacked."""
    flat = [pytree.flatten(p) for p in plist]
    treedef = flat[0][1]
    return treedef.unflatten([torch.stack(xs)
                              for xs in zip(*(f[0] for f in flat))])


def convnext_init(gen: torch.Generator, cfg: ConvNeXtConfig,
                  device: str | torch.device | None = None) -> Params:
    """Random parameters in the reference's layout (``downsample[i]`` is
    ``None`` where a stage keeps its width), on ``device`` (the card
    unless the caller names another)."""
    device = resolve_device(device)
    dt = cfg.param_dtype
    p: Params = {
        "stem": L.init_conv(gen, 4, 4, 3, cfg.dims[0], dtype=dt,
                            device=device),
        "stem_ln": L.init_layernorm(cfg.dims[0], dt, device),
        "stages": [],
        "downsample": [],
        "ln_f": L.init_layernorm(cfg.dims[-1], dt, device),
        "head": L.init_dense(gen, cfg.dims[-1], cfg.n_classes, dtype=dt,
                             device=device),
    }
    prev = cfg.dims[0]
    for depth, dim in zip(cfg.depths, cfg.dims):
        if dim != prev:
            p["downsample"].append({
                "ln": L.init_layernorm(prev, dt, device),
                "conv": L.init_conv(gen, 2, 2, prev, dim, dtype=dt,
                                    device=device),
            })
        else:
            p["downsample"].append(None)
        p["stages"].append(_stack_params(
            [_convnext_block_init(gen, dim, dt, device)
             for _ in range(depth)]))
        prev = dim
    return p


def _convnext_block(x: Tensor, bp: Params, pol: L.DtypePolicy) -> Tensor:
    """One block on channel-last ``x``: depthwise 7x7, LayerNorm over C,
    the pointwise MLP, the scaled residual."""
    h = _nhwc(L.conv2d(bp["dw"], _nchw(x), groups=x.shape[-1], policy=pol))
    h = L.layernorm(bp["ln"], h)
    h = L.gelu(L.dense(bp["pw1"], h, pol))
    h = L.dense(bp["pw2"], h, pol)
    return x + h * bp["gamma"].to(pol.compute_dtype)


def convnext_features(params: Params, images: Tensor, cfg: ConvNeXtConfig,
                      train: bool = False) -> tuple[list, Params]:
    """Per-stage channel-last feature maps (strides 4/8/16/32) for
    detection heads, and ``params``."""
    del train
    pol = cfg.policy
    x = _nhwc(L.conv2d(params["stem"], _nchw(images), stride=4,
                       padding="VALID", policy=pol))
    x = L.layernorm(params["stem_ln"], x)
    feats = []
    for ds, stage in zip(params["downsample"], params["stages"]):
        if ds is not None:
            x = L.layernorm(ds["ln"], x)
            x = _nhwc(L.conv2d(ds["conv"], _nchw(x), stride=2,
                               padding="VALID", policy=pol))
        for bp in _unstack(stage):
            x = _remat(cfg.remat, _convnext_block, x, bp, pol)
        feats.append(x)
    return feats, params


def convnext_apply(params: Params, images: Tensor, cfg: ConvNeXtConfig,
                   train: bool = False) -> tuple[Tensor, Params]:
    pol = cfg.policy
    feats, _ = convnext_features(params, images, cfg, train)
    x = L.avg_pool_global(_nchw(feats[-1]))
    x = L.layernorm(params["ln_f"], x)
    logits = L.dense(params["head"], x, pol).to(torch.float32)
    return logits, params


# ==========================================================================
# ResNet
# ==========================================================================


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    name: str
    img_res: int
    depths: Sequence[int] = (3, 4, 6, 3)
    width: int = 64
    n_classes: int = 1000
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    remat: bool = True

    @property
    def policy(self) -> L.DtypePolicy:
        return L.DtypePolicy(self.param_dtype, self.compute_dtype)

    @property
    def n_params(self) -> int:
        total = 7 * 7 * 3 * self.width
        c_in = self.width
        for i, depth in enumerate(self.depths):
            mid = self.width * (2 ** i)
            out = mid * 4
            total += c_in * mid + 3 * 3 * mid * mid + mid * out + c_in * out
            total += (depth - 1) * (out * mid + 3 * 3 * mid * mid + mid * out)
            c_in = out
        return total + c_in * self.n_classes


def _bottleneck_init(gen, c_in: int, mid: int, project: bool, dt,
                     device) -> Params:
    out = mid * 4

    def conv(k, ci, co):
        return L.init_conv(gen, k, k, ci, co, bias=False, dtype=dt,
                           device=device)

    p = {
        "conv1": conv(1, c_in, mid),
        "bn1": L.init_batchnorm(mid, dt, device),
        "conv2": conv(3, mid, mid),
        "bn2": L.init_batchnorm(mid, dt, device),
        "conv3": conv(1, mid, out),
        "bn3": L.init_batchnorm(out, dt, device),
    }
    if project:
        p["proj"] = conv(1, c_in, out)
        p["bn_proj"] = L.init_batchnorm(out, dt, device)
    return p


def resnet_init(gen: torch.Generator, cfg: ResNetConfig,
                device: str | torch.device | None = None) -> Params:
    """Random parameters in the reference's layout (a stage's ``rest``
    is ``None`` at depth 1), on ``device`` (the card unless the caller
    names another)."""
    device = resolve_device(device)
    dt = cfg.param_dtype
    p: Params = {
        "stem": L.init_conv(gen, 7, 7, 3, cfg.width, bias=False, dtype=dt,
                            device=device),
        "bn_stem": L.init_batchnorm(cfg.width, dt, device),
        "stages": [],
        "head": L.init_dense(gen, cfg.width * 8 * 4, cfg.n_classes,
                             dtype=dt, device=device),
    }
    c_in = cfg.width
    for i, depth in enumerate(cfg.depths):
        mid = cfg.width * (2 ** i)
        first = _bottleneck_init(gen, c_in, mid, True, dt, device)
        rest = [_bottleneck_init(gen, mid * 4, mid, False, dt, device)
                for _ in range(1, depth)]
        p["stages"].append({"first": first,
                            "rest": _stack_params(rest) if rest else None})
        c_in = mid * 4
    return p


def _bottleneck_apply(bp: Params, x: Tensor, stride: int, train: bool,
                      pol: L.DtypePolicy) -> tuple[Tensor, Params]:
    """One bottleneck on NCHW ``x``; returns (y, ``bp`` with its
    batchnorms' refreshed stats)."""
    new = dict(bp)
    h = L.conv2d(bp["conv1"], x, policy=pol)
    h, new["bn1"] = L.batchnorm(bp["bn1"], h, train=train)
    h = torch.relu(h)
    h = L.conv2d(bp["conv2"], h, stride=stride, policy=pol)
    h, new["bn2"] = L.batchnorm(bp["bn2"], h, train=train)
    h = torch.relu(h)
    h = L.conv2d(bp["conv3"], h, policy=pol)
    h, new["bn3"] = L.batchnorm(bp["bn3"], h, train=train)
    if "proj" in bp:
        sc = L.conv2d(bp["proj"], x, stride=stride, policy=pol)
        sc, new["bn_proj"] = L.batchnorm(bp["bn_proj"], sc, train=train)
    else:
        sc = x
    return torch.relu(h + sc), new


def _stack_stats(stacked: Params, news: list[Params]) -> Params:
    """The stacked blocks' tree with each batchnorm's ``mean``/``var``
    replaced by the stack of the blocks' refreshed ones; the other
    leaves are the stacked tree's own (the scan returns them as they
    came)."""
    out = dict(stacked)
    for k, v in stacked.items():
        if isinstance(v, dict) and "mean" in v:
            out[k] = {**v, **{s: torch.stack([n[k][s] for n in news])
                              for s in ("mean", "var")}}
    return out


def _resnet_features(params: Params, images: Tensor, cfg: ResNetConfig,
                     train: bool) -> tuple[list, Params]:
    """:func:`resnet_features` with NCHW feature maps."""
    pol = cfg.policy
    new_params = dict(params)
    x = L.conv2d(params["stem"], _nchw(images), stride=2, policy=pol)
    x, new_params["bn_stem"] = L.batchnorm(params["bn_stem"], x, train=train)
    x = L.max_pool(torch.relu(x), 3, 2)

    feats = []
    new_stages = []
    for i, stage in enumerate(params["stages"]):
        stride = 2 if i > 0 else 1
        ns = dict(stage)
        x, ns["first"] = _bottleneck_apply(stage["first"], x, stride, train,
                                           pol)
        if stage["rest"] is not None:
            news = []
            for bp in _unstack(stage["rest"]):
                x, nbp = _remat(cfg.remat, _bottleneck_apply, bp, x, 1,
                                train, pol)
                news.append(nbp)
            if train:
                ns["rest"] = _stack_stats(stage["rest"], news)
        new_stages.append(ns)
        feats.append(x)
    new_params["stages"] = new_stages
    return feats, (new_params if train else params)


def resnet_features(params: Params, images: Tensor, cfg: ResNetConfig,
                    train: bool = False) -> tuple[list, Params]:
    """Per-stage channel-last feature maps (strides 4/8/16/32) for
    detection heads, and the params with refreshed batchnorm stats (in
    train mode)."""
    feats, new_params = _resnet_features(params, images, cfg, train)
    return [_nhwc(f) for f in feats], new_params


def resnet_apply(params: Params, images: Tensor, cfg: ResNetConfig,
                 train: bool = False) -> tuple[Tensor, Params]:
    pol = cfg.policy
    feats, new_params = _resnet_features(params, images, cfg, train)
    x = L.avg_pool_global(feats[-1])
    logits = L.dense(params["head"], x, pol).to(torch.float32)
    return logits, new_params


# ==========================================================================
# dispatch and conversion
# ==========================================================================

_INIT = {ViTConfig: vit_init, ConvNeXtConfig: convnext_init,
         ResNetConfig: resnet_init}


# ==========================================================================
# MoonViT (Kimi-VL's native-resolution vision tower)
# ==========================================================================


@dataclasses.dataclass(frozen=True)
class MoonViTConfig:
    """MoonViT's widths (Kimi-VL's ``vision_config``).  A crop of S x S
    pixels is (S / patch)^2 patches; the merger folds each
    ``merge`` x ``merge`` block of patches into one token of
    ``merge^2 * d_model`` features."""

    patch: int = 14
    d_model: int = 1152
    n_layers: int = 27
    n_heads: int = 16
    d_ff: int = 4304
    pos_grid: int = 64  # the learnable position table is pos_grid^2
    rope_theta: float = 10000.0
    ln_eps: float = 1e-5
    merge: int = 2

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads


def moonvit_patches(crops: Tensor, patch: int) -> Tensor:
    """(b, S, S, 3) intensities in [0, 1] (8-bit pixels over 255) ->
    (b, (S / patch)^2, 3 patch^2) rows, each normalised as ``(x - 0.5) /
    0.5`` in float32, in the (channel, row, column) order of an OIHW
    kernel flattened."""
    b, s, _, c = crops.shape
    g = s // patch
    x = (crops.to(torch.float32) - 0.5) / 0.5
    x = x.view(b, g, patch, g, patch, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, g * g, c * patch * patch)


def moonvit_pos(table: Tensor, gh: int, gw: int) -> Tensor:
    """The (G, G, d) position table bicubically interpolated (corners
    not aligned) to a (gh, gw) patch grid, in float32, as (gh gw, d)."""
    t = table.to(torch.float32).permute(2, 0, 1)[None]
    if tuple(t.shape[-2:]) != (gh, gw):
        t = torch.nn.functional.interpolate(t, size=(gh, gw), mode="bicubic",
                                            align_corners=False)
    return t[0].permute(1, 2, 0).reshape(gh * gw, -1)


def moonvit_rope(gh: int, gw: int, d_head: int, theta: float,
                 device) -> Tensor:
    """(gh gw, d_head / 2) unit complex turns of the 2D RoPE: a head's
    feature pairs (2j, 2j + 1) are interleaved; pair 2k turns by the
    patch's column times theta^(-4k / d_head) and pair 2k + 1 by its row
    times the same frequency."""
    freqs = 1.0 / theta ** (torch.arange(0, d_head, 4, dtype=torch.float32,
                                         device=device)[: d_head // 4]
                            / d_head)
    pos = torch.arange(gh * gw, device=device)
    cols = (pos % gw).to(torch.float32)[:, None] * freqs
    rows = (pos // gw).to(torch.float32)[:, None] * freqs
    angles = torch.stack([cols, rows], -1).reshape(gh * gw, d_head // 2)
    return torch.polar(torch.ones_like(angles), angles)


def rotate_pairs(x: Tensor, turn: Tensor) -> Tensor:
    """Turn each interleaved feature pair (2j, 2j + 1) of ``x`` (..., D)
    by the unit complex ``turn`` (broadcast to (..., D / 2)), in float32,
    cast back to ``x``'s dtype."""
    xc = torch.view_as_complex(
        x.to(torch.float32).unflatten(-1, (-1, 2)).contiguous())
    return torch.view_as_real(xc * turn).flatten(-2).to(x.dtype)


def _linear(p: Params, x: Tensor) -> Tensor:
    return torch.addmm(p["b"], x.flatten(0, -2), p["w"]).unflatten(
        0, x.shape[:-1])


def _layer_norm(p: Params, x: Tensor, eps: float) -> Tensor:
    """LayerNorm over the last axis (population variance, float32
    statistics inside PyTorch's kernel), in ``x``'s dtype."""
    return torch.nn.functional.layer_norm(x, x.shape[-1:], p["scale"],
                                          p["bias"], eps)


def _moonvit_block(p: Params, x: Tensor, turn: Tensor,
                   cfg: MoonViTConfig) -> Tensor:
    b, n, d = x.shape
    h = cfg.n_heads
    y = _layer_norm(p["ln0"], x, cfg.ln_eps)
    q, k, v = _linear(p["wqkv"], y).view(b, n, 3, h, cfg.d_head).unbind(2)
    turn = turn[None, :, None, :]
    q, k = rotate_pairs(q, turn), rotate_pairs(k, turn)
    o = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    x = x + _linear(p["wo"], o.transpose(1, 2).reshape(b, n, d))
    y = _layer_norm(p["ln1"], x, cfg.ln_eps)
    y = torch.nn.functional.gelu(_linear(p["fc0"], y), approximate="tanh")
    return x + _linear(p["fc1"], y)


def moonvit_apply(params: Params, crops: Tensor, cfg: MoonViTConfig,
                  dtype=torch.bfloat16, pos: Tensor | None = None) -> Tensor:
    """MoonViT on a batch of equal crops (b, S, S, 3) in [0, 1] ->
    (b, (S / patch / merge)^2, merge^2 d_model) merged tokens, in
    ``dtype``: the patch embedding, the interpolated position table
    (``pos``, the (g^2, d) table :func:`moonvit_pos` gives for the crops'
    patch grid, where a caller keeps it), ``n_layers`` pre-LN blocks
    with 2D RoPE and full attention within a crop, the final LayerNorm
    and the 2 x 2 merger (the four patches of a block in row-major
    order, their features side by side)."""
    b, s = crops.shape[:2]
    g = s // cfg.patch
    x = moonvit_patches(crops, cfg.patch).to(dtype)
    w = params["patch"]["w"]
    x = torch.addmm(params["patch"]["b"], x.flatten(0, 1),
                    w.reshape(w.shape[0], -1).t()).view(b, g * g, -1)
    if pos is None:
        pos = moonvit_pos(params["pos"], g, g)
    x = x + pos.to(dtype)
    turn = moonvit_rope(g, g, cfg.d_head, cfg.rope_theta, x.device)
    for p in params["blocks"]:
        x = _moonvit_block(p, x, turn, cfg)
    x = _layer_norm(params["final_ln"], x, cfg.ln_eps)
    m = cfg.merge
    x = x.view(b, g // m, m, g // m, m, cfg.d_model).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (g // m) ** 2, m * m * cfg.d_model)


def init_params(gen: torch.Generator, cfg,
                device: str | torch.device | None = None) -> Params:
    """The init of ``cfg``'s family (ViT, ConvNeXt or ResNet)."""
    return _INIT[type(cfg)](gen, cfg, device)


def from_jax_config(cfg):
    """The reference's vision config -> the port's (dtypes by name)."""
    cls = {c.__name__: c for c in _INIT}[type(cfg).__name__]
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cls)}
    for f in ("param_dtype", "compute_dtype"):
        kw[f] = getattr(torch, np.dtype(kw[f]).name)
    return cls(**kw)


# the keys whose ``"w"`` is a convolution's kernel: the backbones' (ViT's
# patch embedding, the stems, ConvNeXt's depthwise and downsample convs,
# the bottlenecks' convs) and the detection heads' (``conv`` of a
# conv-norm pair, ``out``)
CONV_KEYS = frozenset({"patch", "stem", "dw", "conv", "conv1", "conv2",
                       "conv3", "proj", "out"})


def from_jax_params(tree, device: str | torch.device | None = None
                    ) -> Params:
    """The reference's vision (or backbone detector) parameter pytree,
    as numpy arrays, -> the port's on ``device`` (the card unless the
    caller names another).

    A ``"w"`` under a key of :data:`CONV_KEYS` is a conv kernel and goes
    from HWIO to OIHW (a stacked one from ``(L, kh, kw, I, O)`` to ``(L,
    O, I, kh, kw)``); ``None`` stays ``None``; every other leaf is copied
    as it is, bfloat16 bit for bit."""
    device = resolve_device(device)

    def copy(t, parent):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: copy(v, k) if k != "w" or parent not in CONV_KEYS
                    else conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [copy(v, parent) for v in t]
        return _leaf_to_torch(t, device)

    def conv(w):
        w = _leaf_to_torch(w, device)
        if w.dim() not in (4, 5):
            raise ValueError(f"a conv kernel of shape {tuple(w.shape)}")
        lead = w.dim() - 4
        return w.permute(*range(lead), lead + 3, lead + 2, lead,
                         lead + 1).contiguous()

    return copy(tree, None)
