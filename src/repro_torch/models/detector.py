"""CSP-style one-shot detector ladder (port of ``repro.models.detector``).

A CSP backbone + FPN neck + anchor-free dense head, with width/depth
multipliers and input sizes matching the paper's Table II ladder
(Tiny-416, CSP-512, CSP-640, P5-896, P6-1280).  Head: per cell
(dx, dy, dw, dh, objectness, class logits) at 3 scales (strides
8/16/32; P6 adds 64).

Layouts follow the reference at the public functions: images are
``(B, S, S, 3)`` and every head is ``(B, S/stride, S/stride, 5 +
n_classes)``.  Inside :func:`apply` the activations are NCHW, since the
convolutions are PyTorch's (left to cuDNN, as the reference leaves them
to XLA).  Parameters keep the reference's dict structure with OIHW conv
weights; :func:`from_jax_params` converts the reference's HWIO tree.

:class:`BackboneDetectorConfig` mounts the same heads on a ResNet or a
ConvNeXt backbone (``repro_torch.models.vision``, whose
``from_jax_params`` converts such a detector's tree).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.device import resolve_device
from repro_torch.kernels.groupnorm import ops as gn_ops
from repro_torch.kernels.groupnorm.ref import groupnorm_mish_ref
from repro_torch.models import layers as L
from repro_torch.models import vision as V

Tensor = torch.Tensor
Params = dict


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    name: str
    input_size: int  # square input resolution
    width_mult: float = 1.0
    depth_mult: float = 1.0
    n_classes: int = 80
    p6: bool = False  # extra stride-64 stage (YOLOv4-P6)
    base_width: int = 64
    base_depth: int = 3
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    # the conv blocks' norm-activation tail on the card: "fused" (the
    # float32 kernel, no backward) | "plain" (training, bf16)
    norm_act_impl: str = "fused"

    @property
    def policy(self) -> L.DtypePolicy:
        return L.DtypePolicy(self.param_dtype, self.compute_dtype)

    def width(self, mult: int) -> int:
        return max(16, int(self.base_width * self.width_mult * mult) // 16 * 16)

    @property
    def depth(self) -> int:
        return max(1, round(self.base_depth * self.depth_mult))

    @property
    def strides(self) -> tuple[int, ...]:
        return (8, 16, 32, 64) if self.p6 else (8, 16, 32)


# paper Table II ladder ------------------------------------------------------

PAPER_LADDER = (
    DetectorConfig("yolo-tiny-416", 416, width_mult=0.25, depth_mult=0.34),
    DetectorConfig("yolo-csp-512", 512, width_mult=0.50, depth_mult=0.50),
    DetectorConfig("yolo-csp-640", 640, width_mult=0.50, depth_mult=0.50),
    DetectorConfig("yolo-p5-896", 896, width_mult=1.00, depth_mult=0.67),
    DetectorConfig("yolo-p6-1280", 1280, width_mult=1.00, depth_mult=1.00, p6=True),
)


def _conv_bn_init(gen, k, c_in, c_out, dt, device):
    return {"conv": L.init_conv(gen, k, k, c_in, c_out, bias=False, dtype=dt,
                                device=device),
            "gn": L.init_groupnorm(c_out, dtype=dt, device=device)}


def _conv_bn(p, x, cfg, stride=1, residual=None):
    """Convolution, group norm and Mish, then ``residual`` added; the
    last three in one kernel on the card (``kernels/groupnorm``) unless
    ``cfg.norm_act_impl`` is ``"plain"``."""
    x = L.conv2d(p["conv"], x, stride=stride, policy=cfg.policy)
    tracing.count("norm_act.calls")
    scale, bias = p["gn"]["scale"], p["gn"]["bias"]
    if cfg.norm_act_impl == "fused":
        return gn_ops.groupnorm_mish(x, scale, bias, residual=residual)
    if cfg.norm_act_impl != "plain":
        raise ValueError(f"unknown norm_act_impl {cfg.norm_act_impl!r}")
    return groupnorm_mish_ref(x, scale, bias, residual=residual)


def _csp_block_init(gen, c, n, dt, device):
    half = c // 2
    return {
        "split1": _conv_bn_init(gen, 1, c, half, dt, device),
        "split2": _conv_bn_init(gen, 1, c, half, dt, device),
        "bottlenecks": [
            {"c1": _conv_bn_init(gen, 1, half, half, dt, device),
             "c2": _conv_bn_init(gen, 3, half, half, dt, device)}
            for _ in range(n)
        ],
        "fuse": _conv_bn_init(gen, 1, c, c, dt, device),
    }


def _csp_block(p, x, cfg):
    a = _conv_bn(p["split1"], x, cfg)
    b = _conv_bn(p["split2"], x, cfg)
    for bp in p["bottlenecks"]:
        b = _conv_bn(bp["c2"], _conv_bn(bp["c1"], b, cfg), cfg, residual=b)
    return _conv_bn(p["fuse"], torch.cat([a, b], dim=1), cfg)


def init_params(gen: torch.Generator, cfg: DetectorConfig,
                device: str | torch.device = "cpu") -> Params:
    """Random parameters drawn from ``gen`` (the reference's structure;
    the values differ from ``jax.random``'s, see :func:`from_jax_params`
    for the reference's own)."""
    dt = cfg.param_dtype
    w = cfg.width
    n_scales = len(cfg.strides)
    chans = [w(2 ** (i + 1)) for i in range(n_scales)]  # e.g. 128/256/512(/1024)

    p: Params = {
        "stem": _conv_bn_init(gen, 3, 3, w(1), dt, device),
        "stem2": _conv_bn_init(gen, 3, w(1), chans[0] // 2, dt, device),
        "stages": [], "laterals": [], "fpn": [], "heads": [],
    }
    c_prev = chans[0] // 2
    for c in chans:
        p["stages"].append({
            "down": _conv_bn_init(gen, 3, c_prev, c, dt, device),
            "csp": _csp_block_init(gen, c, cfg.depth, dt, device),
        })
        c_prev = c
    # FPN top-down: lateral 1x1 on upper, merge with lower
    for i in range(n_scales - 1):
        c_hi, c_lo = chans[i + 1], chans[i]
        p["laterals"].append(_conv_bn_init(gen, 1, c_hi, c_lo, dt, device))
        p["fpn"].append(_csp_block_init(gen, c_lo, max(1, cfg.depth // 2), dt,
                                        device))
    # heads (one per scale)
    out_d = 5 + cfg.n_classes
    for c in chans:
        p["heads"].append({
            "conv": _conv_bn_init(gen, 3, c, c, dt, device),
            "out": L.init_conv(gen, 1, 1, c, out_d, dtype=dt, device=device),
        })
    return p


def from_jax_params(tree, device: str | torch.device = "cpu") -> Params:
    """The reference's parameter pytree (as numpy arrays) -> the port's.

    Keeps the dict/list structure; 4-D conv weights go from HWIO to
    OIHW, every other leaf is copied as it is.
    """
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_jax_params(v, device) for v in tree]
    arr = np.asarray(tree)
    if arr.ndim == 4:
        arr = arr.transpose(3, 2, 0, 1)
    return torch.tensor(np.ascontiguousarray(arr), device=device)


def apply(params: Params, images: Tensor, cfg: DetectorConfig) -> list[Tensor]:
    """images: (B, S, S, 3) -> list of per-scale raw heads
    (B, S/stride, S/stride, 5 + n_classes), finest first."""
    pol = cfg.policy
    # a contiguous NCHW copy: the permuted view is channels-last in memory,
    # which steers convolution and group norm to their channels-last CPU
    # kernels, and those gave results that varied from process to process
    x = images.permute(0, 3, 1, 2).contiguous()
    x = _conv_bn(params["stem"], x, cfg, stride=2)
    x = _conv_bn(params["stem2"], x, cfg, stride=2)
    feats = []
    for st in params["stages"]:
        x = _conv_bn(st["down"], x, cfg, stride=2)
        x = _csp_block(st["csp"], x, cfg)
        feats.append(x)
    # top-down FPN
    for i in reversed(range(len(feats) - 1)):
        up = L.upsample_nearest(
            _conv_bn(params["laterals"][i], feats[i + 1], cfg), 2)
        feats[i] = _csp_block(params["fpn"][i], feats[i] + up, cfg)
    outs = []
    for f, hp in zip(feats, params["heads"]):
        h = _conv_bn(hp["conv"], f, cfg)
        outs.append(L.conv2d(hp["out"], h, policy=pol).to(torch.float32)
                    .permute(0, 2, 3, 1))
    return outs


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------


def decode(outs: list[Tensor], cfg: DetectorConfig,
           conf_threshold: float = 0.3, max_det: int = 128,
           valid: Tensor | None = None):
    """Raw heads -> (boxes_xyxy (B, N, 4) in pixels, scores (B, N),
    classes (B, N)); N = max_det, padded with score 0.

    ``valid`` is an optional (B,) bool mask for shape-bucketed batched
    inference: rows padded onto the batch decode with every score forced
    to 0.  The top ``max_det`` come from a stable descending sort, so
    equal scores keep the lower index first, as ``lax.top_k`` does.
    """
    all_boxes, all_scores, all_cls = [], [], []
    for out, stride in zip(outs, cfg.strides):
        b, gh, gw, _ = out.shape
        xy = torch.sigmoid(out[..., 0:2])  # offset within cell
        wh = torch.exp(torch.clamp(out[..., 2:4], -6, 6)) * stride
        obj = torch.sigmoid(out[..., 4])
        cls_logit = out[..., 5:]
        gy, gx = torch.meshgrid(torch.arange(gh, device=out.device),
                                torch.arange(gw, device=out.device),
                                indexing="ij")
        cx = (gx[None] + xy[..., 0]) * stride
        cy = (gy[None] + xy[..., 1]) * stride
        boxes = torch.stack([cx - wh[..., 0] / 2, cy - wh[..., 1] / 2,
                             cx + wh[..., 0] / 2, cy + wh[..., 1] / 2], dim=-1)
        cls_prob = torch.softmax(cls_logit, dim=-1)
        score = obj * cls_prob.amax(dim=-1)
        cls_id = torch.argmax(cls_logit, dim=-1)
        all_boxes.append(boxes.reshape(b, -1, 4))
        all_scores.append(score.reshape(b, -1))
        all_cls.append(cls_id.reshape(b, -1))
    boxes = torch.cat(all_boxes, dim=1)
    scores = torch.cat(all_scores, dim=1)
    cls = torch.cat(all_cls, dim=1)
    zero = torch.zeros_like(scores)
    scores = torch.where(scores >= conf_threshold, scores, zero)
    if valid is not None:
        scores = torch.where(valid[:, None], scores, zero)
    k = min(max_det, scores.shape[1])
    sorted_scores, order = torch.sort(scores, dim=1, descending=True,
                                      stable=True)
    top_scores, idx = sorted_scores[:, :k], order[:, :k]
    top_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    top_cls = torch.gather(cls, 1, idx)
    return top_boxes, top_scores, top_cls


def detection_loss(params: Params, batch: dict, cfg: DetectorConfig
                   ) -> Tensor:
    """Dense detection loss against per-scale target maps (the
    reference's): objectness BCE over every cell, L1 on (dx, dy, log w,
    log h) and class cross-entropy over the positive cells, averaged over
    the scales.

    ``batch``: images (B, S, S, 3) and, per scale i, ``targets_i``
    (B, S/stride, S/stride, 5 + n_classes) with [dx, dy, log w, log h,
    obj, one-hot class] (``repro_torch.data.pipeline.rasterize_targets``).
    """
    outs = apply(params, batch["images"], cfg)
    total = 0.0
    for i, out in enumerate(outs):
        tgt = batch[f"targets_{i}"]
        obj_t = tgt[..., 4]
        obj_logit = out[..., 4]
        obj_loss = torch.mean(
            torch.clamp(obj_logit, min=0) - obj_logit * obj_t
            + torch.log1p(torch.exp(-torch.abs(obj_logit))))
        pos = obj_t > 0.5
        n_pos = torch.clamp(pos.sum(dtype=torch.float32), min=1.0)
        box_err = torch.abs(out[..., 0:4] - tgt[..., 0:4]).sum(-1)
        box_loss = torch.where(pos, box_err, 0.0).sum() / n_pos
        cls_ll = torch.log_softmax(out[..., 5:], dim=-1)
        cls_loss = -torch.where(pos[..., None], tgt[..., 5:] * cls_ll,
                                0.0).sum() / n_pos
        total = total + obj_loss + 0.5 * box_loss + 0.5 * cls_loss
    return total / len(outs)


def flops_per_image(cfg: DetectorConfig) -> float:
    """Analytic MAC estimate (x2 = FLOPs) used by the latency profiles."""
    s = cfg.input_size
    total = 0.0
    # stem
    total += (s / 2) ** 2 * 9 * 3 * cfg.width(1)
    total += (s / 4) ** 2 * 9 * cfg.width(1) * cfg.width(2) // 2
    res = s / 4
    c_prev = cfg.width(2) // 2
    for i in range(len(cfg.strides)):
        c = cfg.width(2 ** (i + 1))
        res /= 2
        total += res ** 2 * 9 * c_prev * c  # downsample
        half = c // 2
        total += res ** 2 * (2 * c * half + c * c)  # csp split+fuse
        total += cfg.depth * res ** 2 * (half * half + 9 * half * half)
        c_prev = c
    return float(total * 2)


# --------------------------------------------------------------------------
# detection heads on the assigned vision backbones (beyond-paper ladder)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BackboneDetectorConfig:
    """Anchor-free detection head mounted on a classification backbone:
    the backbone's stride-8/16/32 pyramid levels feed the CSP detector's
    per-scale heads (a 1x1 lateral to ``head_width``, a 3x3 conv, the
    1x1 output), so the allocator sees extra (accuracy, latency) rungs.
    """

    name: str
    backbone_cfg: Any  # vision.ResNetConfig | vision.ConvNeXtConfig
    input_size: int
    n_classes: int = 80
    head_width: int = 128
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    norm_act_impl: str = "fused"  # as DetectorConfig's

    @property
    def policy(self) -> L.DtypePolicy:
        return L.DtypePolicy(self.param_dtype, self.compute_dtype)

    @property
    def strides(self) -> tuple[int, ...]:
        return (8, 16, 32)


def _backbone_feature_fn(cfg: BackboneDetectorConfig):
    if isinstance(cfg.backbone_cfg, V.ResNetConfig):
        return V.resnet_init, V.resnet_features
    if isinstance(cfg.backbone_cfg, V.ConvNeXtConfig):
        return V.convnext_init, V.convnext_features
    raise TypeError(type(cfg.backbone_cfg))


def backbone_detector_init(gen: torch.Generator,
                           cfg: BackboneDetectorConfig,
                           device: str | torch.device | None = None
                           ) -> Params:
    """Random backbone and head parameters in the reference's layout, on
    ``device`` (the card unless the caller names another)."""
    device = resolve_device(device)
    init_fn, _ = _backbone_feature_fn(cfg)
    backbone = init_fn(gen, cfg.backbone_cfg, device)
    bb = cfg.backbone_cfg
    if isinstance(bb, V.ResNetConfig):
        chans = [bb.width * (2 ** i) * 4 for i in (1, 2, 3)]
    else:
        chans = list(bb.dims[1:])
    dt, hw = cfg.param_dtype, cfg.head_width
    heads = [{"lateral": _conv_bn_init(gen, 1, c, hw, dt, device),
              "conv": _conv_bn_init(gen, 3, hw, hw, dt, device),
              "out": L.init_conv(gen, 1, 1, hw, 5 + cfg.n_classes, dtype=dt,
                                 device=device)}
             for c in chans]
    return {"backbone": backbone, "heads": heads}


def backbone_detector_apply(params: Params, images: Tensor,
                            cfg: BackboneDetectorConfig) -> list[Tensor]:
    """images (B, S, S, 3) -> per-scale raw heads (B, S/stride,
    S/stride, 5 + n_classes) at strides 8/16/32, finest first."""
    _, feat_fn = _backbone_feature_fn(cfg)
    pol = cfg.policy
    feats, _ = feat_fn(params["backbone"], images, cfg.backbone_cfg,
                       train=False)
    outs = []
    for f, hp in zip(feats[1:], params["heads"]):  # strides 8/16/32
        # a contiguous NCHW copy, as :func:`apply` takes its input
        h = _conv_bn(hp["lateral"], f.permute(0, 3, 1, 2).contiguous(), cfg)
        h = _conv_bn(hp["conv"], h, cfg)
        outs.append(L.conv2d(hp["out"], h, policy=pol).to(torch.float32)
                    .permute(0, 2, 3, 1))
    return outs
