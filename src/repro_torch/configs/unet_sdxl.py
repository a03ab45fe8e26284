"""unet-sdxl: SDXL UNet backbone [arXiv:2307.01952; paper] (port of
``repro.configs.unet_sdxl``).

img_res=1024 latent_res=128 ch=320 ch_mult=(1,2,4) n_res_blocks=2
transformer_depth=(1,2,10) ctx_dim=2048.  Level 0 is attention-free
(DownBlock2D semantics, as in the published SDXL config); text
conditioning is a precomputed-embedding stub.
"""

import torch

from repro_torch.configs.base import DIFFUSION_SHAPES
from repro_torch.models.diffusion import UNetConfig

FAMILY = "diffusion"
SHAPES = DIFFUSION_SHAPES
SKIP: dict = {}

VAE_FACTOR = 8


def full_config() -> UNetConfig:
    return UNetConfig(
        name="unet-sdxl",
        latent_res=128,
        latent_ch=4,
        ch=320,
        ch_mult=(1, 2, 4),
        n_res_blocks=2,
        transformer_depth=(1, 2, 10),
        ctx_dim=2048,
        n_ctx_tokens=77,
        d_add=2816,
        head_dim=64,
        param_dtype=torch.bfloat16,
        compute_dtype=torch.bfloat16,
        remat=True,
    )


def smoke_config() -> UNetConfig:
    return UNetConfig(
        name="sdxl-smoke",
        latent_res=16,
        latent_ch=4,
        ch=32,
        ch_mult=(1, 2, 4),
        n_res_blocks=2,
        transformer_depth=(1, 1, 2),
        ctx_dim=24,
        n_ctx_tokens=7,
        d_add=20,
        head_dim=16,
        remat=False,
    )
