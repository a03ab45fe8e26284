"""``project_srois_batched``'s share of its roofline over the traced ticks:
the least time the card could take for each launch (the bytes of the
distinct texels its crops read, read once, plus the crops written once,
at 3.35 TB/s, or its float32 operations at 67 TFLOP/s, whichever is
larger: ``chip_smoke.py::project_bound``'s arithmetic), summed, over the
kernel's device time in the trace."""

import torch

from omnibench.peaks import F32_FLOPS, HBM_BYTES_S
from omnibench.reference.geometry import gnomonic_map


def bound_s(shape, idx, centers, fovs, s: int, device) -> float:
    _, h, w, c = shape
    ids = []
    for k in range(len(idx)):
        u, v = gnomonic_map(float(centers[k][0]), float(centers[k][1]),
                            (float(fovs[k][0]), float(fovs[k][1])), s, h, w,
                            device)
        u0 = torch.remainder(torch.floor(u).long(), w)
        u1 = torch.remainder(u0 + 1, w)
        v0 = torch.clamp(torch.floor(v).long(), 0, h - 1)
        v1 = torch.clamp(v0 + 1, 0, h - 1)
        base = int(idx[k]) * h * w
        ids += [base + v0 * w + u0, base + v0 * w + u1, base + v1 * w + u0,
                base + v1 * w + u1]
    b = len(idx)
    texels = int(torch.unique(torch.cat([t.reshape(-1) for t in ids])).numel())
    n_bytes = texels * c * 4 + b * (4 + 16) + b * s * s * c * 4
    return max(n_bytes / HBM_BYTES_S, b * s * s * (60 + 9 * c) / F32_FLOPS)


def read(run):
    red = run.trace
    if not red:
        return None
    kernel = sum(t for name, t in red["device_ops"].items()
                 if "project_srois" in name)
    launches = [g for tick in sorted(run.pod.launches)
                for g in run.pod.launches[tick]]
    if kernel <= 0 or not launches:
        return None
    dev = run.pod.device
    return 100.0 * sum(bound_s(*g, dev) for g in launches) / kernel
