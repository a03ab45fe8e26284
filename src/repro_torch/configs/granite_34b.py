"""granite-34b: dense llama-arch code model [arXiv:2405.04324; hf] (port
of ``repro.configs.granite_34b``).

88L d_model=6144 48H (GQA kv=1, i.e. MQA) d_ff=24576 vocab=49152, bf16
weights and compute; full attention.  Its skip table comes with the
port's first benchmark (``configs/base.py``).
"""

import torch

from repro_torch.models.transformer import TransformerConfig


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name="granite-34b",
        n_layers=88,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        d_head=128,
        d_ff=24576,
        vocab_size=49152,
        param_dtype=torch.bfloat16,
        compute_dtype=torch.bfloat16,
        attention_impl="chunked",
        attn_chunk=1024,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="granite-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_head=16,
        d_ff=256,
        vocab_size=128,
        attention_impl="chunked",
        attn_chunk=32,
    )
