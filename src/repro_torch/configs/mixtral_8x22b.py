"""mixtral-8x22b: MoE 8 experts top-2 with sliding-window attention
[arXiv:2401.04088; hf] (port of ``repro.configs.mixtral_8x22b``).

56L d_model=6144 48H (GQA kv=8) d_ff=16384 (per expert) vocab=32768,
bf16 weights and compute.  The window (4096, the Mistral lineage's)
bounds the decode cache: a ring of ``WINDOW`` slots.
"""

import torch

from repro_torch.configs.base import LM_SHAPES
from repro_torch.models.transformer import TransformerConfig

FAMILY = "lm"
SHAPES = LM_SHAPES
SKIP: dict = {}  # the window makes long_500k feasible

WINDOW = 4096


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name="mixtral-8x22b",
        n_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_head=128,
        d_ff=0,
        vocab_size=32768,
        moe=True,
        n_experts=8,
        moe_top_k=2,
        d_ff_expert=16384,
        window=WINDOW,
        param_dtype=torch.bfloat16,
        compute_dtype=torch.bfloat16,
        attention_impl="chunked",
        attn_chunk=1024,
        ce_chunk=256,
        remat=True,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="mixtral-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=0,
        vocab_size=128,
        moe=True,
        n_experts=4,
        moe_top_k=2,
        d_ff_expert=96,
        window=16,
        attention_impl="chunked",
        attn_chunk=16,
        ce_chunk=16,
        remat=False,
    )
