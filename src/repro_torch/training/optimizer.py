"""Optimizers on raw parameter trees (port of ``repro.training.optimizer``):
AdamW with linear warmup, SGD with momentum, and clipping by the global
norm.

Parameters, gradients and optimizer state are nested dicts and lists of
tensors (:mod:`repro_torch.pytree`), walked in ``jax.tree.flatten``'s
order; every state leaf has its parameter's shape, and ``step`` is a 0-d
int32 tensor, the reference's layout.  ``update`` is functional: it
returns new tensors and changes none it was given.  Run it under
``torch.no_grad()``.

The arithmetic is the reference's, operation for operation, in float32
(``state_dtype``).  Two places keep PyTorch from rounding otherwise: a
quotient by a number is taken against a tensor on the operands' device
(PyTorch multiplies a tensor by the reciprocal of a Python scalar
divisor, one rounding more), and a bf16 gradient times the float32 clip
scale is promoted to float32, as JAX promotes it (PyTorch would keep a
0-d tensor's product in bf16).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import pytree

Params = Any
OptState = dict


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], OptState]
    update: Callable[[Params, Params, OptState], tuple[Params, OptState]]
    # update(grads, params, state) -> (new_params, new_state)


def _tree_zeros(params, dtype=None):
    return pytree.tree_map(
        lambda p: torch.zeros_like(p, dtype=dtype or p.dtype), params)


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=pytree.device(params))


def adamw(lr: float = 1e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          warmup_steps: int = 0, state_dtype=torch.float32) -> Optimizer:
    """AdamW with optional linear warmup; moments in float32 by default."""

    def init(params):
        return {"mu": _tree_zeros(params, state_dtype),
                "nu": _tree_zeros(params, state_dtype),
                "step": _step0(params)}

    def update(grads, params, state):
        step = state["step"] + 1
        stepf = step.to(torch.float32)
        if warmup_steps > 0:
            sched = torch.clamp(
                stepf / torch.full_like(stepf, max(warmup_steps, 1)),
                max=1.0)
        else:
            sched = torch.ones_like(stepf)
        lr_t = lr * sched
        bc1 = 1.0 - b1 ** stepf
        bc2 = 1.0 - b2 ** stepf

        def upd(g, p, mu, nu):
            g32 = g.to(state_dtype)
            mu_n = b1 * mu + (1 - b1) * g32
            nu_n = b2 * nu + (1 - b2) * (g32 * g32)
            mhat = mu_n / bc1
            vhat = nu_n / bc2
            delta = mhat / (torch.sqrt(vhat) + eps)
            if weight_decay:
                delta = delta + weight_decay * p.to(state_dtype)
            return ((p.to(state_dtype) - lr_t * delta).to(p.dtype), mu_n,
                    nu_n)

        flat_g, treedef = pytree.flatten(grads)
        out = [upd(*a) for a in zip(flat_g, treedef.flatten_up_to(params),
                                    treedef.flatten_up_to(state["mu"]),
                                    treedef.flatten_up_to(state["nu"]))]
        return (treedef.unflatten([o[0] for o in out]),
                {"mu": treedef.unflatten([o[1] for o in out]),
                 "nu": treedef.unflatten([o[2] for o in out]),
                 "step": step})

    return Optimizer(init, update)


def sgd(lr: float = 0.1, momentum: float = 0.9,
        weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"vel": _tree_zeros(params), "step": _step0(params)}

    def update(grads, params, state):
        def upd(g, p, v):
            g = g + weight_decay * p if weight_decay else g
            v_n = momentum * v + g
            return (p - lr * v_n).to(p.dtype), v_n

        flat_g, treedef = pytree.flatten(grads)
        out = [upd(*a) for a in zip(flat_g, treedef.flatten_up_to(params),
                                    treedef.flatten_up_to(state["vel"]))]
        return (treedef.unflatten([o[0] for o in out]),
                {"vel": treedef.unflatten([o[1] for o in out]),
                 "step": state["step"] + 1})

    return Optimizer(init, update)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in float32, the
    leaves added in ``jax.tree.leaves``' order from 0."""
    return torch.sqrt(sum(torch.sum(l.to(torch.float32) ** 2)
                          for l in pytree.leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before).  The scaled leaves are float32 where a gradient is bf16."""
    norm = global_norm(grads)
    scale = torch.clamp(torch.full_like(norm, max_norm)
                        / torch.clamp(norm, min=1e-12), max=1.0)
    return pytree.tree_map(
        lambda g: g.to(torch.promote_types(g.dtype, scale.dtype)) * scale,
        grads), norm
