"""Kimi-VL-A3B-Instruct [hf:moonshotai/Kimi-VL-A3B-Instruct]: MoonViT
(native-resolution ViT with 2D RoPE) + 2 x 2 patch merger + MLP
projector + a DeepSeek-V3-style LM.

LM: 27L d_model=2048 16H, MLA (kv_lora_rank 512, q_lora_rank null,
nope 128 + rope 64, v 128), layer 0 dense (11264), then 64 routed
experts of 1408 (6 a token, sigmoid router with a correction bias,
routed scaling 2.446) and 2 shared; vocab 163840, untied head, rope
theta 800000.  MoonViT: patch 14, 27L d=1152 16H, MLP 4304 (tanh GELU),
a 64 x 64 position table.  bf16 weights and compute, ~16.4B parameters.
"""

import copy

from repro_torch.models.kimi_vl import KimiVLConfig, config_from_dict

# the published ``config.json``: the LM's keys at the top level,
# MoonViT's under ``vision_config``
PUBLISHED = {
    "vocab_size": 163840,
    "hidden_size": 2048,
    "intermediate_size": 11264,
    "moe_intermediate_size": 1408,
    "num_hidden_layers": 27,
    "num_attention_heads": 16,
    "num_key_value_heads": 16,
    "n_shared_experts": 2,
    "n_routed_experts": 64,
    "routed_scaling_factor": 2.446,
    "kv_lora_rank": 512,
    "q_lora_rank": None,
    "qk_rope_head_dim": 64,
    "v_head_dim": 128,
    "qk_nope_head_dim": 128,
    "topk_method": "noaux_tc",
    "n_group": 1,
    "topk_group": 1,
    "num_experts_per_tok": 6,
    "first_k_dense_replace": 1,
    "norm_topk_prob": True,
    "scoring_func": "sigmoid",
    "rms_norm_eps": 1e-5,
    "rope_theta": 800000,
    "rope_scaling": None,
    "tie_word_embeddings": False,
    "vision_config": {
        "patch_size": 14,
        "hidden_size": 1152,
        "num_hidden_layers": 27,
        "num_attention_heads": 16,
        "intermediate_size": 4304,
        "init_pos_emb_height": 64,
        "init_pos_emb_width": 64,
        "merge_kernel_size": [2, 2],
        "rope_theta": 10000.0,
        "layer_norm_eps": 1e-5,
    },
}


def full_config() -> KimiVLConfig:
    return config_from_dict(PUBLISHED, "kimi-vl-a3b")


def tiny_dict() -> dict:
    """The CPU tests' size: 1 dense and 2 MoE layers, 8 experts with
    top-2 and one shared expert, small MLA ranks, a 2-block MoonViT."""
    d = copy.deepcopy(PUBLISHED)
    d.update(vocab_size=96, hidden_size=32, intermediate_size=48,
             moe_intermediate_size=16, num_hidden_layers=3,
             num_attention_heads=4, num_key_value_heads=4,
             n_shared_experts=1, n_routed_experts=8, num_experts_per_tok=2,
             kv_lora_rank=16, qk_rope_head_dim=8, v_head_dim=8,
             qk_nope_head_dim=8)
    d["vision_config"].update(patch_size=4, hidden_size=24,
                              num_hidden_layers=2, num_attention_heads=2,
                              intermediate_size=40, init_pos_emb_height=6,
                              init_pos_emb_width=6)
    return d


def tiny_config() -> KimiVLConfig:
    return config_from_dict(tiny_dict(), "kimi-vl-tiny")
