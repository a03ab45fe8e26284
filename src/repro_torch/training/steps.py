"""The LM serving steps (port of ``repro.training.steps``
``lm_prefill_step`` and ``lm_decode_step``).

Each of them returns ``step(params, batch) -> dict`` with the reference's
batch and result keys.  The steps run without autograd; the decode step
writes the new token into the cache tensors it is given, in place, and
returns them.  Given ``routes`` (a list the caller owns), an MoE model's
steps append each layer's :class:`~repro_torch.models.transformer.Routing`
there, call after call (the experts picked and the picks dropped).  The
training steps wait for the training slice (ROADMAP, queue 1, slice F).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import transformer as lm_mod


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
