"""resnet-152 [arXiv:1512.03385; paper] (port of
``repro.configs.resnet_152``).

img_res=224 depths=(3,8,36,3) width=64 bottleneck blocks, bf16 weights and
compute (batchnorm running stats in float32).
"""

import torch

from repro_torch.configs.base import VISION_SHAPES
from repro_torch.models.vision import ResNetConfig

FAMILY = "vision"
SHAPES = VISION_SHAPES
SKIP: dict = {}


def full_config() -> ResNetConfig:
    return ResNetConfig(
        name="resnet-152",
        img_res=224,
        depths=(3, 8, 36, 3),
        width=64,
        n_classes=1000,
        param_dtype=torch.bfloat16,
        compute_dtype=torch.bfloat16,
        remat=True,
    )


def smoke_config() -> ResNetConfig:
    return ResNetConfig(
        name="resnet152-smoke",
        img_res=64,
        depths=(2, 2, 3, 2),
        width=16,
        n_classes=10,
        remat=False,
    )
