"""convnext-b [arXiv:2201.03545; paper] (port of
``repro.configs.convnext_b``).

img_res=224 depths=(3,3,27,3) dims=(128,256,512,1024), bf16 weights and
compute.
"""

import torch

from repro_torch.configs.base import VISION_SHAPES
from repro_torch.models.vision import ConvNeXtConfig

FAMILY = "vision"
SHAPES = VISION_SHAPES
SKIP: dict = {}


def full_config() -> ConvNeXtConfig:
    return ConvNeXtConfig(
        name="convnext-b",
        img_res=224,
        depths=(3, 3, 27, 3),
        dims=(128, 256, 512, 1024),
        n_classes=1000,
        param_dtype=torch.bfloat16,
        compute_dtype=torch.bfloat16,
        remat=True,
    )


def smoke_config() -> ConvNeXtConfig:
    return ConvNeXtConfig(
        name="convnext-smoke",
        img_res=64,
        depths=(2, 2, 3, 2),
        dims=(16, 32, 64, 128),
        n_classes=10,
        remat=False,
    )
