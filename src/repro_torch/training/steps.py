"""The LM and detector train and serve steps (port of
``repro.training.steps``).

Each builder returns ``step(state, batch) -> (state, metrics)`` (train)
or ``step(params, batch) -> dict`` (serve) with the reference's batch
and result keys.  The state is ``{"params", "opt", "step"}`` (plain
dicts; ``step`` a 0-d int32 tensor).  A train step takes its gradients
with ``torch.autograd.grad`` on detached copies of the parameters (the
state's tensors never require grad), then clips and updates under
``no_grad``; it returns new tensors and changes none it was given.
The serve steps run without autograd; the LM decode step writes the new
token into the cache tensors it is given, in place, and returns them.
Given ``routes`` (a list the caller owns), an MoE model's serving steps
append each layer's :class:`~repro_torch.models.transformer.Routing`
there, call after call.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch import pytree
from repro_torch.models import detector as det_mod
from repro_torch.models import transformer as lm_mod
from repro_torch.training import optimizer as opt_mod


def make_state(params, optimizer: opt_mod.Optimizer):
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=pytree.device(params))}


def _finish(state, optimizer, grads, loss):
    grads, gnorm = opt_mod.clip_by_global_norm(grads, 1.0)
    new_params, new_opt = optimizer.update(grads, state["params"],
                                           state["opt"])
    metrics = {"loss": loss, "grad_norm": gnorm, "step": state["step"] + 1}
    return ({"params": new_params, "opt": new_opt,
             "step": state["step"] + 1}, metrics)


def value_and_grad(loss_fn: Callable, params):
    """(``loss_fn(params)`` detached, its gradient as a tree like
    ``params``); a parameter the loss does not reach gets zeros, as
    ``jax.grad`` gives."""
    leaves, treedef = pytree.flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        loss = loss_fn(treedef.unflatten(live))
        grads = torch.autograd.grad(loss, live, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), treedef.unflatten(list(grads))


def _train_step(loss_fn: Callable, optimizer: opt_mod.Optimizer
                ) -> Callable:
    def step(state, batch):
        loss, grads = value_and_grad(lambda p: loss_fn(p, batch),
                                     state["params"])
        with torch.no_grad():
            return _finish(state, optimizer, grads, loss)

    return step


# -- LM ---------------------------------------------------------------------


def lm_train_step(cfg: lm_mod.TransformerConfig,
                  optimizer: opt_mod.Optimizer) -> Callable:
    """batch ``{"tokens", "targets": (B, S) integer}`` -> (state,
    ``{"loss", "grad_norm", "step"}``)."""
    return _train_step(lambda p, b: lm_mod.lm_loss(p, b, cfg), optimizer)


def lm_prefill_step(cfg: lm_mod.TransformerConfig, max_len: int,
                    routes: list | None = None) -> Callable:
    """batch ``{"tokens": (B, S)}`` -> ``{"logits": (B, V), "k", "v":
    (L, B, S_cache, KVH, Dh), "length": 0-d int32}``."""
    @torch.no_grad()
    def step(params, batch):
        logits, cache = lm_mod.prefill(params, batch["tokens"], cfg, max_len,
                                       routes)
        return {"logits": logits, "k": cache.k, "v": cache.v,
                "length": cache.length}

    return step


def lm_decode_step(cfg: lm_mod.TransformerConfig,
                   routes: list | None = None) -> Callable:
    """batch ``{"token": (B,), "cache_k", "cache_v", "cache_len"}`` -> the
    same result keys as :func:`lm_prefill_step`."""
    @torch.no_grad()
    def step(params, batch):
        cache = lm_mod.KVCache(batch["cache_k"], batch["cache_v"],
                               batch["cache_len"])
        logits, new_cache = lm_mod.decode_step(params, batch["token"], cache,
                                               cfg, routes)
        return {"logits": logits, "k": new_cache.k, "v": new_cache.v,
                "length": new_cache.length}

    return step


# -- detector -----------------------------------------------------------------


def detector_train_step(cfg: det_mod.DetectorConfig,
                        optimizer: opt_mod.Optimizer) -> Callable:
    """batch ``{"images": (B, S, S, 3), "targets_i": ...}`` -> (state,
    ``{"loss", "grad_norm", "step"}``)."""
    return _train_step(lambda p, b: det_mod.detection_loss(p, b, cfg),
                       optimizer)


def detector_serve_step(cfg: det_mod.DetectorConfig) -> Callable:
    """batch ``{"images"}`` -> ``{"boxes", "scores", "classes"}``."""
    @torch.no_grad()
    def step(params, batch):
        outs = det_mod.apply(params, batch["images"], cfg)
        boxes, scores, cls = det_mod.decode(outs, cfg)
        return {"boxes": boxes, "scores": scores, "classes": cls}

    return step
