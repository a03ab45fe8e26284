"""The LM, vision, diffusion and detector train and serve steps (port of
``repro.training.steps``).

Each builder returns ``step(state, batch) -> (state, metrics)`` (train)
or ``step(params, batch) -> dict`` (serve) with the reference's batch
and result keys.  The state is ``{"params", "opt", "step"}`` (plain
dicts; ``step`` a 0-d int32 tensor).  A train step takes its gradients
with ``torch.autograd.grad`` on detached copies of the parameters (the
state's tensors never require grad), then clips and updates one leaf at
a time under ``no_grad``, each gradient freed once its leaf is done; it
returns new tensors and changes none it was given.
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
from repro_torch.models import diffusion as diff_mod
from repro_torch.models import transformer as lm_mod
from repro_torch.models import vision as vis_mod
from repro_torch.training import optimizer as opt_mod


def make_state(params, optimizer: opt_mod.Optimizer):
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=pytree.device(params))}


def _finish(state, optimizer, grads: list, treedef, loss, extra=None):
    """The update of a train step from the gradient leaves ``grads``
    (``jax.tree.flatten`` order, ``treedef`` their tree), clipped to a
    global norm of 1, one leaf at a time
    (:func:`~repro_torch.training.optimizer.clip_and_update`: each entry
    of ``grads`` is cleared once its leaf is done, so the caller keeps no
    other reference to a gradient)."""
    new_params, new_opt, gnorm = opt_mod.clip_and_update(
        optimizer, grads, treedef, state["params"], state["opt"], 1.0)
    metrics = {"loss": loss, "grad_norm": gnorm, "step": state["step"] + 1}
    if extra:
        metrics.update(extra)
    return ({"params": new_params, "opt": new_opt,
             "step": state["step"] + 1}, metrics)


def _grads(loss_fn: Callable, params, has_aux: bool = False):
    """(``loss_fn(params)`` detached, or ``(loss, aux)`` with ``has_aux``,
    its gradient leaves as a list in ``jax.tree.flatten`` order, their
    tree); a parameter the loss does not reach gets zeros, as
    ``jax.grad`` gives."""
    leaves, treedef = pytree.flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        out = loss_fn(treedef.unflatten(live))
        loss, aux = out if has_aux else (out, None)
        grads = list(torch.autograd.grad(loss, live, allow_unused=True,
                                         materialize_grads=True))
    if has_aux:
        return (loss.detach(), pytree.tree_map(torch.Tensor.detach, aux)), \
            grads, treedef
    return loss.detach(), grads, treedef


def value_and_grad(loss_fn: Callable, params, has_aux: bool = False):
    """(``loss_fn(params)`` detached, its gradient as a tree like
    ``params``); a parameter the loss does not reach gets zeros, as
    ``jax.grad`` gives.  With ``has_aux``, ``loss_fn`` returns ``(loss,
    aux)`` and the first item is ``(loss, aux)``, aux's tensors detached,
    as ``jax.value_and_grad(..., has_aux=True)`` gives."""
    out, grads, treedef = _grads(loss_fn, params, has_aux)
    return out, treedef.unflatten(grads)


def _train_step(loss_fn: Callable, optimizer: opt_mod.Optimizer
                ) -> Callable:
    def step(state, batch):
        loss, grads, treedef = _grads(lambda p: loss_fn(p, batch),
                                      state["params"])
        with torch.no_grad():
            return _finish(state, optimizer, grads, treedef, loss)

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


# -- vision -------------------------------------------------------------------

_VIS_APPLY = {
    vis_mod.ViTConfig: vis_mod.vit_apply,
    vis_mod.ConvNeXtConfig: vis_mod.convnext_apply,
    vis_mod.ResNetConfig: vis_mod.resnet_apply,
}


def vision_apply(params, images, cfg, train=False):
    return _VIS_APPLY[type(cfg)](params, images, cfg, train)


def vision_train_step(cfg, optimizer: opt_mod.Optimizer) -> Callable:
    """batch ``{"images": (B, H, W, 3), "labels": (B,) integer}`` ->
    (state, ``{"loss", "grad_norm", "step", "accuracy"}``).  The forward
    runs in train mode; a ResNet's state then takes its batchnorm
    running stats from the forward's refreshed tree
    (:func:`_merge_bn_stats`: their gradients are 0, as the loss reads
    the batch's stats, so AdamW leaves them as they were)."""
    def loss_fn(p, batch):
        logits, new_p = vision_apply(p, batch["images"], cfg, train=True)
        labels = batch["labels"].long()
        ll = torch.log_softmax(logits, dim=-1)
        loss = -torch.mean(ll.gather(-1, labels[:, None]))
        acc = torch.mean((logits.argmax(-1) == labels).to(torch.float32))
        return loss, (acc, new_p)

    def step(state, batch):
        (loss, (acc, new_p)), grads, treedef = _grads(
            lambda p: loss_fn(p, batch), state["params"], has_aux=True)
        with torch.no_grad():
            new_state, metrics = _finish(state, optimizer, grads, treedef,
                                         loss, {"accuracy": acc})
        if isinstance(cfg, vis_mod.ResNetConfig):
            new_state["params"] = _merge_bn_stats(new_state["params"], new_p)
        return new_state, metrics

    return step


def _merge_bn_stats(trained, updated):
    """Take 'mean'/'var' leaves from ``updated``, everything else trained."""

    def walk(t, u):
        if isinstance(t, dict):
            return {k: (u[k] if k in ("mean", "var") else walk(t[k], u[k]))
                    for k in t}
        if isinstance(t, list):
            return [walk(a, b) for a, b in zip(t, u)]
        return t

    return walk(trained, updated)


def vision_serve_step(cfg) -> Callable:
    """batch ``{"images"}`` -> ``{"logits": (B, n_classes) float32}``."""
    @torch.no_grad()
    def step(params, batch):
        logits, _ = vision_apply(params, batch["images"], cfg, train=False)
        return {"logits": logits}

    return step


# -- diffusion ----------------------------------------------------------------


def diffusion_train_step(cfg, optimizer: opt_mod.Optimizer) -> Callable:
    """batch ``{"latents": (B, R, R, C), "seed": integer, "ctx", and
    "pooled" (MMDiT) or "add_emb" (UNet)}`` -> (state, ``{"loss",
    "grad_norm", "step"}``).  The loss draws its timesteps and noise
    from ``(batch["seed"], state["step"])``
    (:func:`~repro_torch.models.diffusion.diffusion_draws`), as the
    reference folds the step into ``PRNGKey(seed)``."""
    loss = (diff_mod.flux_rf_loss if isinstance(cfg, diff_mod.MMDiTConfig)
            else diff_mod.unet_eps_loss)

    def step(state, batch):
        loss_v, grads, treedef = _grads(
            lambda p: loss(p, batch, cfg, state["step"]), state["params"])
        with torch.no_grad():
            return _finish(state, optimizer, grads, treedef, loss_v)

    return step


def diffusion_denoise_step(cfg) -> Callable:
    """One sampler step (a ``steps``-step generation calls this in a
    loop): batch ``{"latents", "t", "ctx"}`` with ``"dt", "pooled",
    "guidance"`` (MMDiT, an Euler step) or ``"t_prev", "add_emb"`` (UNet,
    a DDIM step) -> ``{"latents"}``."""
    is_flux = isinstance(cfg, diff_mod.MMDiTConfig)

    @torch.no_grad()
    def step(params, batch):
        if is_flux:
            x = diff_mod.flux_euler_step(
                params, batch["latents"], batch["t"], batch["dt"],
                batch["ctx"], batch["pooled"], batch["guidance"], cfg)
        else:
            x = diff_mod.unet_ddim_step(
                params, batch["latents"], batch["t"], batch["t_prev"],
                batch["ctx"], batch["add_emb"], cfg)
        return {"latents": x}

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
