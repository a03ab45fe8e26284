"""qwen3-moe-235b-a22b: MoE 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf]
(port of ``repro.configs.qwen3_moe_235b_a22b``).

94L d_model=4096 64H (GQA kv=4) d_ff=1536 (per expert) vocab=151936,
bf16 weights and compute; full attention.
"""

import torch

from repro_torch.models.transformer import TransformerConfig


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen3-moe-235b-a22b",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        d_head=128,
        d_ff=0,
        vocab_size=151936,
        moe=True,
        n_experts=128,
        moe_top_k=8,
        d_ff_expert=1536,
        param_dtype=torch.bfloat16,
        compute_dtype=torch.bfloat16,
        attention_impl="chunked",
        attn_chunk=1024,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen3-smoke",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=4,
        d_head=8,
        d_ff=0,
        vocab_size=256,
        moe=True,
        n_experts=8,
        moe_top_k=2,
        d_ff_expert=48,
        attention_impl="chunked",
        attn_chunk=16,
    )
