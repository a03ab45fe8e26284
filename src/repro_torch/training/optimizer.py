"""Optimizers on raw parameter trees (port of ``repro.training.optimizer``):
AdamW with linear warmup, SGD with momentum, and clipping by the global
norm.

Parameters, gradients and optimizer state are nested dicts and lists of
tensors (:mod:`repro_torch.pytree`), walked in ``jax.tree.flatten``'s
order; every state leaf has its parameter's shape, and ``step`` is a 0-d
int32 tensor, the reference's layout.  ``update`` is functional: it
returns new tensors and changes none it was given.  Run it under
``torch.no_grad()``.  The train steps take :func:`clip_and_update`:
:func:`clip_by_global_norm` then ``update``, the same bits, one leaf at
a time.

The arithmetic is the reference's, operation for operation, with JAX's
type rules where PyTorch's differ:

* a Python float (``b1``, ``1 - b1``, ``lr``, ``momentum``,
  ``weight_decay``) is weakly typed in JAX: it takes the dtype of the
  tensor it meets, so against a bf16 moment or parameter it is rounded to
  bf16 first (0.9 becomes 0.8984375).  PyTorch keeps a Python scalar at
  float32 precision; :func:`_weak` makes it a 0-d tensor of the other
  operand's dtype, which PyTorch then rounds alike;
* a 0-d float32 array (``bc1``, ``bc2``, ``lr_t``) is strongly typed in
  JAX and promotes a bf16 operand to float32; PyTorch keeps a 0-d
  tensor's result in the other operand's dtype, so the bf16 moment is
  widened first (``mu_n.float() / bc1``);
* a bf16 gradient times the float32 clip scale is promoted to float32,
  as JAX promotes it;
* a quotient by a number is taken against a tensor on the operands'
  device (PyTorch multiplies a tensor by the reciprocal of a Python
  scalar divisor, one rounding more);
* the square root is rounded to nearest, as XLA's and the card's are
  (:func:`_sqrt`: ATen's CPU kernel takes MKL's vector square root from
  128 elements on, which is within an ulp but not always the nearest).

On float32 trees the first two rules change nothing.  The moments stay in
``state_dtype`` and the new parameter is cast to the parameter's dtype.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import pytree

Params = Any
OptState = dict


# a leaf of more elements than this is updated in slices of at most this
# many (_leaf_update): upd's float32 temporaries (up to ~32 bytes an
# element) and the clipped gradient's float32 copy then hold one slice
# at a time, ~2.4 GB at this count
SLICE_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], OptState]
    update: Callable[[Params, Params, OptState], tuple[Params, OptState]]
    # update(grads, params, state) -> (new_params, new_state)
    rule: Callable | None = None
    # rule(state) -> (upd, slot keys, the new state's other entries):
    # upd(g, p, *slots) -> (new_p, *new_slots) updates one leaf, each
    # slot a leaf of the state's tree under that key (update_leaves)


def _tree_zeros(params, dtype=None):
    return pytree.tree_map(
        lambda p: torch.zeros_like(p, dtype=dtype or p.dtype), params)


def _weak(x: float, like: torch.Tensor) -> torch.Tensor:
    """The Python float ``x`` as JAX's weak type enters an operation with
    ``like``: a 0-d tensor of ``like``'s dtype on its device."""
    return torch.full((), x, dtype=like.dtype, device=like.device)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The square root of each element, rounded to nearest: numpy's for a
    plain CPU tensor, ``torch.sqrt`` elsewhere (the card rounds to
    nearest; a fake tensor, as the launch layer's counter runs the step
    on, has no values)."""
    if x.device.type == "cpu" and type(x) is torch.Tensor:
        return torch.from_numpy(np.asarray(np.sqrt(x.numpy())))
    return torch.sqrt(x)


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

    def rule(state):
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
            g32, ps = g.to(state_dtype), p.to(state_dtype)
            mu_n = _weak(b1, mu) * mu + _weak(1 - b1, g32) * g32
            nu_n = _weak(b2, nu) * nu + _weak(1 - b2, g32) * (g32 * g32)
            # bc1, bc2 and lr_t are float32 0-d arrays in the reference:
            # they widen a bf16 moment, and so delta, to float32
            mhat = mu_n.float() / bc1
            vhat = nu_n.float() / bc2
            delta = mhat / (_sqrt(vhat) + eps)
            if weight_decay:
                delta = delta + _weak(weight_decay, ps) * ps
            return (ps - lr_t * delta).to(p.dtype), mu_n, nu_n

        return upd, ("mu", "nu"), {"step": step}

    return Optimizer(init, _tree_update(rule), rule)


def sgd(lr: float = 0.1, momentum: float = 0.9,
        weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"vel": _tree_zeros(params), "step": _step0(params)}

    def rule(state):
        def upd(g, p, v):
            g = g + _weak(weight_decay, p) * p if weight_decay else g
            v_n = _weak(momentum, v) * v + g
            return (p - _weak(lr, v_n) * v_n).to(p.dtype), v_n

        return upd, ("vel",), {"step": state["step"] + 1}

    return Optimizer(init, _tree_update(rule), rule)


def _tree_update(rule: Callable) -> Callable:
    def update(grads, params, state):
        flat_g, treedef = pytree.flatten(grads)
        return update_leaves(rule, flat_g, treedef, params, state)

    return update


def update_leaves(rule: Callable, grads: list, treedef, params, state,
                  scale: torch.Tensor | None = None):
    """``rule``'s update of ``params`` and ``state`` from the gradient
    leaves ``grads`` (``jax.tree.flatten`` order, ``treedef`` their
    tree), one leaf at a time: each gradient times ``scale`` as
    :func:`clip_by_global_norm` scales it (where given), then the leaf's
    ``upd``.  Each entry of ``grads`` is set to ``None`` once its leaf is
    done, so a gradient that the caller holds nowhere else is freed
    before the next leaf.  A leaf of more than :data:`SLICE_ELEMS`
    elements runs in slices of at most that many (:func:`_leaf_update`).
    Returns (new params, new state)."""
    upd, slots, rest = rule(state)
    flat_p = treedef.flatten_up_to(params)
    flat_s = [treedef.flatten_up_to(state[k]) for k in slots]
    out = []
    for i, p in enumerate(flat_p):
        g, grads[i] = grads[i], None
        out.append(_leaf_update(upd, g, p, [s[i] for s in flat_s], scale))
        del g
    new_state = {k: treedef.unflatten([o[j + 1] for o in out])
                 for j, k in enumerate(slots)}
    return treedef.unflatten([o[0] for o in out]), {**new_state, **rest}


def _leaf_update(upd, g, p, slots, scale) -> tuple:
    """``upd`` of one leaf, whole or, past :data:`SLICE_ELEMS` elements, in
    slices: runs of whole rows of the first dimension whose rows (the
    elements after it) fit in that count, at each index of the
    dimensions before it (an expert stack ``(L, E, D, F)`` in runs of
    its ``D`` axis, layer by layer and expert by expert), each written
    into outputs of the leaf's shape.  ``upd`` works element by element,
    so the slices give the whole leaf's bits; its temporaries (and the
    clipped gradient's float32 copy) then hold one slice at a time."""
    def part(sl):
        gs, ps, ss = (g, p, slots) if sl is None else (
            g[sl], p[sl], [s[sl] for s in slots])
        if scale is not None:
            gs = gs.to(torch.promote_types(gs.dtype, scale.dtype)) * scale
        return upd(gs, ps, *ss)

    if g.numel() <= SLICE_ELEMS:
        return part(None)
    dim = next(d for d in range(g.dim())
               if math.prod(g.shape[d + 1:]) <= SLICE_ELEMS)
    rows = SLICE_ELEMS // math.prod(g.shape[dim + 1:])
    out = None
    for lead in itertools.product(*map(range, g.shape[:dim])):
        for lo in range(0, g.shape[dim], rows):
            sl = lead + (slice(lo, lo + rows),)
            got = part(sl)
            if out is None:
                out = [torch.empty(g.shape, dtype=t.dtype, device=t.device)
                       for t in got]
            for o, t in zip(out, got):
                o[sl] = t
            del got
    return tuple(out)


def _norm(leaves) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(l.to(torch.float32) ** 2)
                          for l in leaves))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in float32, the
    leaves added in ``jax.tree.leaves``' order from 0."""
    return _norm(pytree.leaves(tree))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(torch.full_like(norm, max_norm)
                       / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before).  The scaled leaves are float32 where a gradient is bf16."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return pytree.tree_map(
        lambda g: g.to(torch.promote_types(g.dtype, scale.dtype)) * scale,
        grads), norm


def clip_and_update(optimizer: Optimizer, grads: list, treedef, params,
                    state, max_norm: float):
    """``clip_by_global_norm`` then ``optimizer.update``, the same bits,
    one leaf at a time (:func:`update_leaves`): the global norm of the
    gradient leaves ``grads`` first, then each leaf clipped and updated,
    its entry of ``grads`` cleared once done.  The train steps' update:
    at its peak it holds the caller's state, the new state and the
    gradients not yet used, in place of the whole trees of gradients,
    clipped gradients and new state.  Returns (new params, new state,
    the norm)."""
    norm = _norm(grads)
    new_params, new_state = update_leaves(
        optimizer.rule, grads, treedef, params, state,
        _clip_scale(norm, max_norm))
    return new_params, new_state, norm
