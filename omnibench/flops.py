"""The benchmark's own count of the detector's work: the floating-point
operations of every convolution of one image (backbone, FPN neck and
heads), 2 x C_out x C_in x k x k x H_out x W_out each, worked out from
the rung's shapes.  Group norm, Mish, upsampling and the decode are
elementwise and left out, as a profiler's operation count leaves them
out.  Frozen here so that it reads the same work whatever a later change
does to the implementation.
"""

from __future__ import annotations

from omnibench.reference.detector import Rung, param_spec


def _out(size: int, stride: int) -> int:
    return -(-size // stride)


def conv_flops_per_image(r: Rung, size: int | None = None) -> int:
    """FLOPs of the convolutions of one ``size`` x ``size`` image
    (default: the rung's input size)."""
    s = size or r.input_size
    res = {"stem": _out(s, 2)}
    res["stem2"] = _out(res["stem"], 2)
    stage_res = []
    cur = res["stem2"]
    for _ in r.strides:
        cur = _out(cur, 2)
        stage_res.append(cur)
    total = 0
    for path, kind, shape in param_spec(r):
        if kind != "conv":
            continue
        head = path[0]
        if head in ("stem", "stem2"):
            hw = res[head]
        elif head == "laterals":
            hw = stage_res[path[1] + 1]
        else:  # stages, fpn, heads: at their own scale's resolution
            hw = stage_res[path[1]]
        c_out, c_in, kh, kw = shape
        total += 2 * c_out * c_in * kh * kw * hw * hw
    return total

