"""The benchmark's own count of the region-description pod's work: the
floating-point operations of every matrix product one request needs at
its rung (2 x m x n x k each), worked out from the configuration's
published keys.  Norms, RoPE, the softmax, the router's sort and the
elementwise SwiGLU are left out, as a profiler's operation count leaves
them out.  Attention counts the positions a query sees (the causal
half in the prefill, the cached positions in a decode step), and the
MoE layers count the ``num_experts_per_tok`` routed experts and the
shared ones a token runs, whatever batch the implementation pads them
to.  Frozen here so that it reads the same work whatever a later change
does to the implementation.
"""

from __future__ import annotations


def vision_flops(c: dict, size: int) -> int:
    """MoonViT, the merger and the projector on one ``size``^2 crop."""
    v = c["vision_config"]
    p, d, ff = v["patch_size"], v["hidden_size"], v["intermediate_size"]
    n = (size // p) ** 2
    total = 2 * n * 3 * p * p * d
    per_block = (2 * n * d * 3 * d          # qkv
                 + 2 * 2 * n * n * d        # scores and values
                 + 2 * n * d * d            # output
                 + 2 * 2 * n * d * ff)      # MLP
    total += v["num_hidden_layers"] * per_block
    m = v["merge_kernel_size"][0] * v["merge_kernel_size"][1] * d
    n_img = n * d // m
    return total + 2 * n_img * m * m + 2 * n_img * m * c["hidden_size"]


def image_tokens(c: dict, size: int) -> int:
    v = c["vision_config"]
    g = size // v["patch_size"] // v["merge_kernel_size"][0]
    return g * g


def _mlp_flops(c: dict, layer: int) -> int:
    """One token through layer ``layer``'s feed-forward."""
    dm = c["hidden_size"]
    if layer < c["first_k_dense_replace"]:
        return 2 * 3 * dm * c["intermediate_size"]
    experts = c["num_experts_per_tok"] + c["n_shared_experts"]
    return (2 * dm * c["n_routed_experts"]
            + 2 * 3 * dm * c["moe_intermediate_size"] * experts)


def prefill_flops(c: dict, t: int) -> int:
    """The LM over ``t`` prompt positions (keys and values
    decompressed), the head on the last position only."""
    dm, h = c["hidden_size"], c["num_attention_heads"]
    nope, rope, vd = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                      c["v_head_dim"])
    r = c["kv_lora_rank"]
    proj = 2 * (dm * h * (nope + rope) + dm * (r + rope)
                + r * h * (nope + vd) + h * vd * dm)
    seen = t * (t + 1) // 2
    attn = 2 * h * (nope + rope) * seen + 2 * h * vd * seen
    total = sum(t * (proj + _mlp_flops(c, i)) + attn
                for i in range(c["num_hidden_layers"]))
    return total + 2 * dm * c["vocab_size"]


def decode_flops(c: dict, t: int, steps: int) -> int:
    """``steps`` decode steps after a ``t``-position prefill, each one
    token through the latent cache (``W_kvb`` absorbed: the query into
    the latent, the latent output back per head) and the head."""
    dm, h = c["hidden_size"], c["num_attention_heads"]
    nope, rope, vd = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                      c["v_head_dim"])
    r = c["kv_lora_rank"]
    proj = 2 * (dm * h * (nope + rope) + dm * (r + rope) + h * nope * r
                + h * r * vd + h * vd * dm)
    total = 0
    for s in range(steps):
        seen = t + s + 1
        attn = 2 * h * (r + rope) * seen + 2 * h * r * seen
        total += sum(proj + attn + _mlp_flops(c, i)
                     for i in range(c["num_hidden_layers"]))
        total += 2 * dm * c["vocab_size"]
    return total


def request_flops(c: dict, size: int) -> int:
    """One request at a ``size`` rung: vision, the prefill over the
    prompt and image tokens, and the answer's decode steps."""
    t = c["prompt"]["pre"] + image_tokens(c, size) + c["prompt"]["post"]
    return (vision_flops(c, size) + prefill_flops(c, t)
            + decode_flops(c, t, c["answer_tokens"]))
