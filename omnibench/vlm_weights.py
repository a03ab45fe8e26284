"""Seeded weights of Kimi-VL-A3B, made in the configuration's dtype on
the device leaf by leaf, so that no float32 copy of the whole model is
ever held (at the published widths the model is 16.4B parameters: 33 GB
in bfloat16, 66 GB in float32).

The tree's layout is the port's (``repro_torch.models.kimi_vl``'s
``param_spec``), frozen here from the configuration's published keys:
linear weights ``(d_in, d_out)`` uniform in +-sqrt(1 / d_in) (experts
stacked on a leading axis, a SwiGLU's gate and up side by side, gate
first), biases and the router's correction bias uniform in +-0.02, norm
scales 1 and LayerNorm biases 0, the embedding a standard normal and
MoonViT's position table a normal times 0.02.  Each leaf is drawn in
float32 from one generator on the device, in spec order, and cast.
"""

from __future__ import annotations

import math

import torch


def param_spec(c: dict) -> list[tuple]:
    """``(path, shape, kind, scale)`` of every leaf of configuration
    ``c`` (the published ``config.json`` keys)."""
    v = c["vision_config"]
    out = []

    def lin(path, d_in, d_out, bias=False, lead=()):
        out.append((path + ("w",) if bias else path, lead + (d_in, d_out),
                    "uniform", math.sqrt(1.0 / d_in)))
        if bias:
            out.append((path + ("b",), (d_out,), "uniform", 0.02))

    def norm(path, d, bias=False):
        out.append((path + ("scale",), (d,), "ones", 0.0))
        if bias:
            out.append((path + ("bias",), (d,), "zeros", 0.0))

    p, d = v["patch_size"], v["hidden_size"]
    out.append((("vision", "patch", "w"), (d, 3, p, p), "uniform",
                math.sqrt(1.0 / (3 * p * p))))
    out.append((("vision", "patch", "b"), (d,), "uniform", 0.02))
    out.append((("vision", "pos"), (v["init_pos_emb_height"],
                                    v["init_pos_emb_width"], d),
                "normal", 0.02))
    for i in range(v["num_hidden_layers"]):
        b = ("vision", "blocks", i)
        norm(b + ("ln0",), d, True)
        lin(b + ("wqkv",), d, 3 * d, True)
        lin(b + ("wo",), d, d, True)
        norm(b + ("ln1",), d, True)
        lin(b + ("fc0",), d, v["intermediate_size"], True)
        lin(b + ("fc1",), v["intermediate_size"], d, True)
    norm(("vision", "final_ln"), d, True)
    m = v["merge_kernel_size"][0] * v["merge_kernel_size"][1] * d
    dm = c["hidden_size"]
    norm(("projector", "ln"), d, True)
    lin(("projector", "fc1"), m, m, True)
    lin(("projector", "fc2"), m, dm, True)
    out.append((("lm", "embed"), (c["vocab_size"], dm), "normal", 1.0))
    h = c["num_attention_heads"]
    nope, rope = c["qk_nope_head_dim"], c["qk_rope_head_dim"]
    r, e, f = c["kv_lora_rank"], c["n_routed_experts"], \
        c["moe_intermediate_size"]
    for i in range(c["num_hidden_layers"]):
        b = ("lm", "layers", i)
        norm(b + ("attn_norm",), dm)
        lin(b + ("wq",), dm, h * (nope + rope))
        lin(b + ("wkva",), dm, r + rope)
        norm(b + ("kv_norm",), r)
        lin(b + ("wkvb",), r, h * (nope + c["v_head_dim"]))
        lin(b + ("wo",), h * c["v_head_dim"], dm)
        norm(b + ("mlp_norm",), dm)
        if i < c["first_k_dense_replace"]:
            lin(b + ("mlp", "gate_up"), dm, 2 * c["intermediate_size"])
            lin(b + ("mlp", "down"), c["intermediate_size"], dm)
        else:
            fs = c["n_shared_experts"] * f
            lin(b + ("moe", "router"), dm, e)
            out.append((b + ("moe", "bias"), (e,), "uniform", 0.02))
            lin(b + ("moe", "gate_up"), dm, 2 * f, lead=(e,))
            lin(b + ("moe", "down"), f, dm, lead=(e,))
            lin(b + ("moe", "shared_gate_up"), dm, 2 * fs)
            lin(b + ("moe", "shared_down"), fs, dm)
    norm(("lm", "final_norm"), dm)
    lin(("lm", "head"), dm, c["vocab_size"])
    return out


def build_tree(leaves) -> dict:
    """Nested dicts (lists where a path step is an int) from ``(path,
    tensor)`` pairs in spec order."""
    root: dict = {}
    for path, t in leaves:
        node = root
        for k, nxt in zip(path[:-1], path[1:]):
            if isinstance(nxt, int):
                node = node.setdefault(k, [])
            elif isinstance(k, int):
                if len(node) <= k:
                    node.append({})
                node = node[k]
            else:
                node = node.setdefault(k, {})
        node[path[-1]] = t
    return root


def make(c: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The weight tree of configuration ``c`` from ``seed``, in ``dtype``
    on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    leaves = []
    for path, shape, kind, scale in param_spec(c):
        if kind == "uniform":
            t = torch.rand(shape, generator=gen, device=device)
            t = t.mul_(2 * scale).sub_(scale)
        elif kind == "normal":
            t = torch.randn(shape, generator=gen, device=device).mul_(scale)
        elif kind == "ones":
            t = torch.ones(shape, device=device)
        else:
            t = torch.zeros(shape, device=device)
        leaves.append((path, t.to(dtype)))
        del t
    return build_tree(leaves)
