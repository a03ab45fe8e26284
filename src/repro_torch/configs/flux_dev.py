"""flux-dev: MMDiT rectified-flow image model [BFL tech report;
unverified] (port of ``repro.configs.flux_dev``).

img_res=1024 latent_res=128 n_double_blocks=19 n_single_blocks=38
d_model=3072 n_heads=24 (~12B params).  Latents are 8x-downsampled VAE
codes with 16 channels; text conditioning arrives as precomputed T5/CLIP
embeddings.
"""

import torch

from repro_torch.configs.base import DIFFUSION_SHAPES
from repro_torch.models.diffusion import MMDiTConfig

FAMILY = "diffusion"
SHAPES = DIFFUSION_SHAPES
SKIP: dict = {}

VAE_FACTOR = 8


def full_config() -> MMDiTConfig:
    return MMDiTConfig(
        name="flux-dev",
        latent_res=128,
        latent_ch=16,
        patch=2,
        d_model=3072,
        n_heads=24,
        n_double_blocks=19,
        n_single_blocks=38,
        d_ctx=4096,
        n_ctx_tokens=512,
        d_pooled=768,
        param_dtype=torch.bfloat16,
        compute_dtype=torch.bfloat16,
        remat=True,
    )


def smoke_config() -> MMDiTConfig:
    return MMDiTConfig(
        name="flux-smoke",
        latent_res=8,
        latent_ch=4,
        patch=2,
        d_model=64,
        n_heads=4,
        n_double_blocks=2,
        n_single_blocks=3,
        d_ctx=32,
        n_ctx_tokens=8,
        d_pooled=16,
        remat=False,
    )
