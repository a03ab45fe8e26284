"""smollm-135m: dense llama-arch small model
[hf:HuggingFaceTB/SmolLM-135M; hf] (port of
``repro.configs.smollm_135m``).

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152, bf16 weights and
compute.  Its workload shapes are ``configs.base.LM_SHAPES``.
"""

import torch

from repro_torch.configs.base import FULL_ATTENTION_SKIP, LM_SHAPES
from repro_torch.models.transformer import TransformerConfig

FAMILY = "lm"
SHAPES = LM_SHAPES
SKIP = FULL_ATTENTION_SKIP


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name="smollm-135m",
        n_layers=30,
        d_model=576,
        n_heads=9,
        n_kv_heads=3,
        d_head=64,
        d_ff=1536,
        vocab_size=49152,
        param_dtype=torch.bfloat16,
        compute_dtype=torch.bfloat16,
        attention_impl="chunked",
        attn_chunk=1024,
        ce_chunk=512,
        remat=True,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="smollm-smoke",
        n_layers=3,
        d_model=48,
        n_heads=3,
        n_kv_heads=3,
        d_head=16,
        d_ff=96,
        vocab_size=128,
        attention_impl="chunked",
        attn_chunk=32,
        ce_chunk=16,
        remat=False,
    )
