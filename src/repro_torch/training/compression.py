"""Gradient compression with error feedback (port of
``repro.training.compression``).

Two transforms of a gradient tree (:mod:`repro_torch.pytree`), each
carrying the rounding or dropped part to the next step in a
:class:`CompressionState`, so that nothing is lost, only delayed:

  * ``bf16_compress / bf16_decompress`` — the payload in bf16 (2x);
  * ``topk_compress / topk_decompress`` — per leaf, the ``ratio * size``
    entries of largest magnitude as (values, int32 indices).

``compression_ratio`` gives the payload's bytes over the dense float32
gradients'.  The reference's ``compressed_psum_step`` (the all-reduce
over a mesh axis) comes with the multi-device path.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import pytree


@dataclasses.dataclass
class CompressionState:
    residual: Any  # a tree matching the gradients', float32

    @staticmethod
    def zeros_like(grads) -> "CompressionState":
        return CompressionState(pytree.tree_map(
            lambda g: torch.zeros_like(g, dtype=torch.float32), grads))


def _compress(comp, grads, state: CompressionState):
    flat_g, treedef = pytree.flatten(grads)
    pairs = [comp(g, r) for g, r in
             zip(flat_g, treedef.flatten_up_to(state.residual))]
    return (treedef.unflatten([p[0] for p in pairs]),
            CompressionState(treedef.unflatten([p[1] for p in pairs])))


# -- bf16 with error feedback -------------------------------------------------


def bf16_compress(grads, state: CompressionState):
    def comp(g, r):
        total = g.to(torch.float32) + r
        q = total.to(torch.bfloat16)
        return q, total - q.to(torch.float32)

    return _compress(comp, grads, state)


def bf16_decompress(payload):
    return pytree.tree_map(lambda q: q.to(torch.float32), payload)


# -- top-k with error feedback ------------------------------------------------


def topk_compress(grads, state: CompressionState, ratio: float = 0.1):
    """Returns ((values, indices) tree, new state).  The indices are
    ``jax.lax.top_k``'s: by magnitude, the lower index first among equal
    magnitudes (a stable descending sort; ``torch.topk`` promises no
    order of ties)."""

    def comp(g, r):
        total = g.to(torch.float32) + r
        flat = total.reshape(-1)
        k = max(1, int(flat.numel() * ratio))
        idx = torch.sort(flat.abs(), descending=True, stable=True)[1][:k]
        picked = flat[idx]
        kept = torch.zeros_like(flat)
        kept[idx] = picked
        return (picked, idx.to(torch.int32)), \
            total - kept.reshape(total.shape)

    return _compress(comp, grads, state)


def topk_decompress(payload, like):
    """(values, indices) tree -> dense float32 tree shaped like ``like``."""
    flat_p, treedef = pytree.flatten(
        payload, is_leaf=lambda x: isinstance(x, tuple))
    out = []
    for (vals, idx), tpl in zip(flat_p, treedef.flatten_up_to(like)):
        dense = torch.zeros(tpl.numel(), dtype=torch.float32,
                            device=vals.device)
        dense[idx.long()] = vals
        out.append(dense.reshape(tpl.shape))
    return treedef.unflatten(out)


def compression_ratio(payload, like) -> float:
    """Wire bytes of payload / wire bytes of dense float32 grads."""
    def nbytes(x):
        return x.numel() * x.element_size()

    dense = sum(nbytes(l) for l in pytree.leaves(like))
    wire = sum(nbytes(l) for l in pytree.leaves(payload))
    return wire / dense
