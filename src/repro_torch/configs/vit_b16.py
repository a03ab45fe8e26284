"""vit-b16 [arXiv:2010.11929; paper] (port of ``repro.configs.vit_b16``).

img_res=224 patch=16 n_layers=12 d_model=768 n_heads=12 d_ff=3072, bf16
weights and compute.  cls_384 keeps patch 16 (576 + 1 tokens); each
resolution builds its own position table (:func:`config_for_res`).
"""

import dataclasses

import torch

from repro_torch.configs.base import VISION_SHAPES
from repro_torch.models.vision import ViTConfig

FAMILY = "vision"
SHAPES = VISION_SHAPES
SKIP: dict = {}


def full_config() -> ViTConfig:
    return ViTConfig(
        name="vit-b16",
        img_res=224,
        patch=16,
        n_layers=12,
        d_model=768,
        n_heads=12,
        d_ff=3072,
        n_classes=1000,
        param_dtype=torch.bfloat16,
        compute_dtype=torch.bfloat16,
        remat=True,
    )


def config_for_res(res: int) -> ViTConfig:
    return dataclasses.replace(full_config(), img_res=res)


def smoke_config() -> ViTConfig:
    return ViTConfig(
        name="vit-smoke",
        img_res=64,
        patch=16,
        n_layers=2,
        d_model=32,
        n_heads=4,
        d_ff=64,
        n_classes=10,
        remat=False,
    )
