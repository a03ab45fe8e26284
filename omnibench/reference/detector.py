"""The CSP detector of the paper's Table II ladder in plain PyTorch: the
parameter layout, the forward (CSP backbone, FPN neck, per-scale heads)
and the decode of every cell.

Written from the architecture (``repro_torch.models.detector`` follows
the same equations): convolutions with XLA's "SAME" padding and OIHW
weights, group norm over the largest divisor of the channels that is at
most 32, Mish, nearest upsampling.  Float32; the caller sets TF32.
Imports nothing of the program.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Rung:
    name: str
    input_size: int
    width_mult: float
    depth_mult: float
    p6: bool
    n_classes: int = 80

    def width(self, k: int) -> int:
        return max(16, int(64 * self.width_mult * k) // 16 * 16)

    @property
    def depth(self) -> int:
        return max(1, round(3 * self.depth_mult))

    @property
    def strides(self) -> tuple[int, ...]:
        return (8, 16, 32, 64) if self.p6 else (8, 16, 32)

    @property
    def channels(self) -> list[int]:
        return [self.width(2 ** (i + 1)) for i in range(len(self.strides))]


def param_spec(r: Rung) -> list[tuple[tuple, str, tuple]]:
    """Every leaf of the rung's parameter tree in order: (path, kind,
    shape), ``kind`` one of ``conv`` (uniform in +-sqrt(1 / fan_in)),
    ``ones``, ``zeros``.  The path indexes the nested dicts and lists of
    the tree (the program's layout)."""
    out: list = []

    def conv_bn(path, k, c_in, c_out):
        out.append((path + ("conv", "w"), "conv", (c_out, c_in, k, k)))
        out.append((path + ("gn", "scale"), "ones", (c_out,)))
        out.append((path + ("gn", "bias"), "zeros", (c_out,)))

    def csp(path, c, n):
        half = c // 2
        conv_bn(path + ("split1",), 1, c, half)
        conv_bn(path + ("split2",), 1, c, half)
        for b in range(n):
            conv_bn(path + ("bottlenecks", b, "c1"), 1, half, half)
            conv_bn(path + ("bottlenecks", b, "c2"), 3, half, half)
        conv_bn(path + ("fuse",), 1, c, c)

    chans = r.channels
    conv_bn(("stem",), 3, 3, r.width(1))
    conv_bn(("stem2",), 3, r.width(1), chans[0] // 2)
    c_prev = chans[0] // 2
    for i, c in enumerate(chans):
        conv_bn(("stages", i, "down"), 3, c_prev, c)
        csp(("stages", i, "csp"), c, r.depth)
        c_prev = c
    for i in range(len(chans) - 1):
        conv_bn(("laterals", i), 1, chans[i + 1], chans[i])
        csp(("fpn", i), chans[i], max(1, r.depth // 2))
    for i, c in enumerate(chans):
        conv_bn(("heads", i, "conv"), 3, c, c)
        out.append((("heads", i, "out", "w"), "conv",
                    (5 + r.n_classes, c, 1, 1)))
        out.append((("heads", i, "out", "b"), "zeros", (5 + r.n_classes,)))
    return out


def build_tree(leaves: list[tuple[tuple, torch.Tensor]]) -> dict:
    """The nested dict/list tree of (path, tensor) pairs."""
    root: dict = {}
    for path, t in leaves:
        node = root
        for key, nxt in zip(path[:-1], path[1:]):
            if isinstance(node, dict):
                if key not in node:
                    node[key] = [] if isinstance(nxt, int) else {}
                node = node[key]
            else:
                while len(node) <= key:
                    node.append([] if isinstance(nxt, int) else {})
                node = node[key]
        node[path[-1]] = t
    return root


def _same(x, k: int, stride: int):
    pads = []
    for size in (x.shape[3], x.shape[2]):
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


def _groups(c: int) -> int:
    g = min(32, c)
    while c % g:
        g -= 1
    return g


def _conv(p, x, stride=1):
    k = p["w"].shape[2]
    return F.conv2d(_same(x, k, stride), p["w"], p.get("b"), stride=stride)


def _conv_bn(p, x, stride=1):
    x = _conv(p["conv"], x, stride)
    x = F.group_norm(x, _groups(x.shape[1]), p["gn"]["scale"], p["gn"]["bias"],
                     1e-5)
    return x * torch.tanh(F.softplus(x))


def _csp(p, x):
    a = _conv_bn(p["split1"], x)
    b = _conv_bn(p["split2"], x)
    for bp in p["bottlenecks"]:
        b = b + _conv_bn(bp["c2"], _conv_bn(bp["c1"], b))
    return _conv_bn(p["fuse"], torch.cat([a, b], dim=1))


def forward(params: dict, images: torch.Tensor) -> list[torch.Tensor]:
    """(B, S, S, 3) float32 -> per-scale heads (B, S/s, S/s, 5 + classes),
    finest first."""
    x = images.permute(0, 3, 1, 2).contiguous()
    x = _conv_bn(params["stem"], x, 2)
    x = _conv_bn(params["stem2"], x, 2)
    feats = []
    for st in params["stages"]:
        x = _csp(st["csp"], _conv_bn(st["down"], x, 2))
        feats.append(x)
    for i in reversed(range(len(feats) - 1)):
        up = _conv_bn(params["laterals"][i], feats[i + 1])
        up = up.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        feats[i] = _csp(params["fpn"][i], feats[i] + up)
    return [_conv(hp["out"], _conv_bn(hp["conv"], f)).permute(0, 2, 3, 1)
            for f, hp in zip(feats, params["heads"])]


def decode_cells(outs: list[torch.Tensor], strides) -> dict:
    """Every cell of every scale of one image (batch 1): its box
    (x0, y0, x1, y1) in PI pixels, score (objectness times the largest
    class probability), class, and the margin of its best class logit
    over the second."""
    boxes, scores, classes, margins = [], [], [], []
    for out, stride in zip(outs, strides):
        o = out[0]
        gh, gw = o.shape[:2]
        xy = torch.sigmoid(o[..., 0:2])
        wh = torch.exp(torch.clamp(o[..., 2:4], -6, 6)) * stride
        gy, gx = torch.meshgrid(torch.arange(gh, device=o.device),
                                torch.arange(gw, device=o.device),
                                indexing="ij")
        cx = (gx + xy[..., 0]) * stride
        cy = (gy + xy[..., 1]) * stride
        boxes.append(torch.stack([cx - wh[..., 0] / 2, cy - wh[..., 1] / 2,
                                  cx + wh[..., 0] / 2, cy + wh[..., 1] / 2],
                                 dim=-1).reshape(-1, 4))
        logit = o[..., 5:]
        top2 = torch.topk(logit, 2, dim=-1)
        scores.append((torch.sigmoid(o[..., 4])
                       * torch.softmax(logit, dim=-1).amax(-1)).reshape(-1))
        classes.append(top2.indices[..., 0].reshape(-1))
        margins.append((top2.values[..., 0] - top2.values[..., 1]).reshape(-1))
    return dict(boxes=torch.cat(boxes), scores=torch.cat(scores),
                classes=torch.cat(classes), margins=torch.cat(margins))
