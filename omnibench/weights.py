"""Seeded weights, made on the device in a few large calls.

Every uniform leaf of every tree (the convolution and dense weights,
uniform in +-sqrt(1 / fan_in) as the ladders initialise them) is drawn
from one ``torch.rand`` call on a generator of the run's device, every
normal leaf from one ``torch.randn``; the norm scales are views of one
buffer of ones and every bias a view of one buffer of zeros.  The same
trees go to the program and to the reference.
"""

from __future__ import annotations

import math

import torch

from omnibench.reference import detector as ref_det


def make_trees(specs, seed: int, device) -> list[dict]:
    """One float32 tree per spec (a list of (path, kind, shape) or (path,
    kind, shape, scale) leaves; ``conv`` is uniform in +-sqrt(1 /
    fan_in), ``uniform`` in +-scale, ``normal`` a standard normal times
    scale, ``ones`` and ``zeros`` as named): every uniform leaf from one
    ``torch.rand`` call, every normal leaf from one ``torch.randn``."""
    leaves = []
    for t, spec in enumerate(specs):
        for leaf in spec:
            path, kind, shape = leaf[:3]
            scale = leaf[3] if len(leaf) > 3 else 0.0
            if kind == "conv":
                kind, scale = "uniform", math.sqrt(1.0 / math.prod(shape[1:]))
            leaves.append((t, path, kind, shape, scale))
    n = {"uniform": 0, "normal": 0, "ones": 0, "zeros": 0}
    for _, _, kind, shape, _ in leaves:
        n[kind] += math.prod(shape)
    gen = torch.Generator(device=device).manual_seed(seed)
    scale = torch.empty(n["uniform"], dtype=torch.float32)
    nscale = torch.empty(n["normal"], dtype=torch.float32)
    at = {"uniform": 0, "normal": 0}
    for _, _, kind, shape, sc in leaves:
        if kind in at:
            k = math.prod(shape)
            (scale if kind == "uniform" else nscale)[at[kind]:at[kind] + k] = sc
            at[kind] += k
    flat = {"uniform": torch.rand(n["uniform"], generator=gen,
                                  dtype=torch.float32, device=device),
            "normal": torch.randn(n["normal"], generator=gen,
                                  dtype=torch.float32, device=device),
            "ones": torch.ones(n["ones"], dtype=torch.float32, device=device),
            "zeros": torch.zeros(n["zeros"], dtype=torch.float32,
                                 device=device)}
    flat["uniform"].mul_(2.0).sub_(1.0).mul_(scale.to(device))
    flat["normal"].mul_(nscale.to(device))
    at = dict.fromkeys(flat, 0)
    trees = [[] for _ in specs]
    for t, path, kind, shape, _ in leaves:
        k = math.prod(shape)
        trees[t].append((path, flat[kind][at[kind]:at[kind] + k].view(shape)))
        at[kind] += k
    return [ref_det.build_tree(leaves) for leaves in trees]


def ladder_weights(rungs, seed: int, device) -> list[dict]:
    """One float32 parameter tree per detector rung, from ``seed``."""
    return make_trees([ref_det.param_spec(r) for r in rungs], seed, device)
