"""Temporal action-recognition head over per-frame patch embeddings
(port of ``repro.models.action``).

The second analytics workload (``repro_torch.serving.tasks``): a tubelet
of ``clip_len`` consecutive SRoI crops is embedded frame by frame with a
ViT patch stem (a stride-``patch`` convolution without padding, then the
spatial mean), and a small temporal transformer (``vision._mha_full``
over the ``clip_len`` frame embeddings) classifies the action.

API:
    init_params(gen, cfg, device) -> params
    apply(params, clips, cfg) -> (B, n_actions) float32 logits
    from_jax_params(tree, device) -> params
``clips`` is ``(B, T, S, S, 3)`` channel-last, as in the reference, with
``T == cfg.clip_len``.  The stem runs channel-first: the clip is permuted
once to a contiguous NCHW tensor and the conv weight is OIHW.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models.vision import _mha_full

Tensor = torch.Tensor
Params = dict


@dataclasses.dataclass(frozen=True)
class ActionConfig:
    name: str
    input_size: int
    clip_len: int
    patch: int = 16
    d_model: int = 64
    n_layers: int = 1
    n_heads: int = 2
    d_ff: int = 128
    n_actions: int = 16
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32

    @property
    def policy(self) -> L.DtypePolicy:
        return L.DtypePolicy(self.param_dtype, self.compute_dtype)

    @property
    def n_patches(self) -> int:
        return (self.input_size // self.patch) ** 2

    @property
    def n_params(self) -> int:
        d, f = self.d_model, self.d_ff
        per = 4 * d * d + 2 * d * f + 4 * d
        stem = self.patch * self.patch * 3 * d
        return self.n_layers * per + stem + self.clip_len * d \
            + d * self.n_actions

    @property
    def flops_per_clip(self) -> float:
        """Rough forward FLOPs for one tubelet (profile costing)."""
        d, f, t = self.d_model, self.d_ff, self.clip_len
        stem = 2.0 * t * self.n_patches * self.patch ** 2 * 3 * d
        attn = self.n_layers * (2.0 * t * 4 * d * d + 4.0 * t * t * d)
        mlp = self.n_layers * 4.0 * t * d * f
        return stem + attn + mlp + 2.0 * d * self.n_actions


def init_params(gen: torch.Generator, cfg: ActionConfig,
                device: str | torch.device = "cpu") -> Params:
    """Random parameters drawn from ``gen`` with the reference's
    structure and scales (the values differ from ``jax.random``'s; see
    :func:`from_jax_params` for the reference's own).  The per-layer
    tensors are stacked on a leading ``n_layers`` axis, as the
    reference's ``lax.scan`` wants them."""
    dt = cfg.param_dtype
    d, lyr = cfg.d_model, cfg.n_layers

    def stacked(shape, scale):
        w = torch.rand((lyr,) + shape, generator=gen, dtype=torch.float32,
                       device=gen.device) * (2.0 * scale) - scale
        return w.to(device=device, dtype=dt)

    def ones_zeros(n):
        return {"scale": torch.ones((lyr, n), dtype=dt, device=device),
                "bias": torch.zeros((lyr, n), dtype=dt, device=device)}

    s = math.sqrt(1.0 / d)
    sf = math.sqrt(1.0 / cfg.d_ff)
    patch = L.init_conv(gen, cfg.patch, cfg.patch, 3, d, dtype=dt,
                        device=device)
    tpos = torch.randn((1, cfg.clip_len, d), generator=gen,
                       dtype=torch.float32, device=gen.device)
    return {
        "patch": patch,
        "tpos": tpos.to(device=device, dtype=dt) * 0.02,
        "layers": {
            "ln1": ones_zeros(d),
            "wqkv": stacked((d, 3 * d), s),
            "wo": stacked((d, d), s),
            "ln2": ones_zeros(d),
            "w1": stacked((d, cfg.d_ff), s),
            "b1": torch.zeros((lyr, cfg.d_ff), dtype=dt, device=device),
            "w2": stacked((cfg.d_ff, d), sf),
            "b2": torch.zeros((lyr, d), dtype=dt, device=device),
        },
        "ln_f": L.init_layernorm(d, dt, device),
        "head": L.init_dense(gen, d, cfg.n_actions, dtype=dt, device=device),
    }


def from_jax_params(tree, device: str | torch.device = "cpu") -> Params:
    """The reference's parameter pytree (as numpy arrays) -> the port's:
    the stem's HWIO weight becomes OIHW; the stacked ``(L, ...)`` layer
    tensors and every other leaf are copied as they are."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.ndim == 4:
        arr = arr.transpose(3, 2, 0, 1)
    return torch.tensor(np.ascontiguousarray(arr), device=device)


def apply(params: Params, clips: Tensor, cfg: ActionConfig) -> Tensor:
    """Classify tubelets: ``(B, T, S, S, 3)`` -> ``(B, n_actions)``."""
    pol = cfg.policy
    b, t, s = clips.shape[:3]
    # a contiguous NCHW copy of the B*T frames (a permuted view would be
    # channels-last in memory, which gave run-to-run drift on the CPU)
    x = clips.reshape(b * t, s, s, 3).permute(0, 3, 1, 2).contiguous()
    x = L.conv2d(params["patch"], x, stride=cfg.patch, padding="VALID",
                 policy=pol)
    # spatial mean -> one embedding per frame of the clip
    x = x.mean(dim=(2, 3)).reshape(b, t, cfg.d_model)
    x = x + params["tpos"].to(pol.compute_dtype)
    lp = params["layers"]
    for i in range(cfg.n_layers):
        h1 = L.layernorm({"scale": lp["ln1"]["scale"][i],
                          "bias": lp["ln1"]["bias"][i]}, x)
        x = x + _mha_full(h1, lp["wqkv"][i], lp["wo"][i], cfg.n_heads, pol)
        h2 = L.layernorm({"scale": lp["ln2"]["scale"][i],
                          "bias": lp["ln2"]["bias"][i]}, x)
        y = L.gelu(L.dense({"w": lp["w1"][i], "b": lp["b1"][i]}, h2, pol))
        x = x + L.dense({"w": lp["w2"][i], "b": lp["b2"][i]}, y, pol)
    x = L.layernorm(params["ln_f"], x)
    return L.dense(params["head"], x.mean(dim=1), pol).to(torch.float32)
