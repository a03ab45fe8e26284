"""Faults planted under the timed path of a region-description pod, for
the test that sees ``correct`` come out false: each is applied to a
built pod after its warm-up ticks and before the window, for the run
only (the pod's own ``restore`` puts the module back)."""

from __future__ import annotations


def logit_raised(pod) -> None:
    """Every decode step serves its logits with one id's raised by 1."""
    from repro_torch.models import kimi_vl

    def wrapper(orig):
        def step(*args, **kwargs):
            out = orig(*args, **kwargs)
            out[:, 0] += 1.0
            return out
        return step
    pod.spans.on_module(kimi_vl, "decode_step", wrapper)


def cache_skipped(pod) -> None:
    """Each decode step attends over its own token alone, not over the
    request's cached positions."""
    from repro_torch.models import kimi_vl

    def wrapper(orig):
        def attend(lp, x, pos, turn, cache, valid, cfg):
            own = valid & (valid.cumsum(-1) == valid.sum(-1, keepdim=True))
            return orig(lp, x, pos, turn, cache, own, cfg)
        return attend
    pod.spans.on_module(kimi_vl, "_mla_decode", wrapper)


def bias_ignored(pod) -> None:
    """Every MoE layer picks its experts by the sigmoid scores alone,
    without the correction bias."""
    import torch

    from repro_torch.models import kimi_vl

    def wrapper(orig):
        def route(p, x, cfg):
            return orig(dict(p, bias=torch.zeros_like(p["bias"])), x, cfg)
        return route
    pod.spans.on_module(kimi_vl, "route", wrapper)
