"""Plain reference of Kimi-VL-A3B's forward: MoonViT, the projector and
the language model, in float32 with TF32 off, one sequence at a time,
with no cache, no batching and no kernel: the benchmark's copy of the
port's ``models/kimi_vl_ref.py``, importing nothing of the program.

It reads the configuration as the published ``config.json`` keys (the
LM's at the top level, MoonViT's under ``vision_config``) and a
parameter tree in the layout ``omnibench/vlm_weights.py`` makes; weights
of any dtype are read in float32.

The equations are Kimi-VL's published ``modeling_kimi_vl.py`` and
DeepSeek-V3's ``modeling_deepseek.py``.  Departures from the published
description:

* ``noaux_tc`` with ``n_group`` 1 and ``topk_group`` 1 reduces to the
  top ``k`` of ``s + b`` over all experts; it is written so.  The
  routing can be given (``forward``'s ``routes``): the comparison with a
  bfloat16 computation takes its picks, as it takes its generated ids,
  and reads how far they fall short of the float32 top k.  Among
  equal values the lower expert index is taken first (a stable sort);
  the published code leaves ties to ``torch.topk``.
* RoPE turns interleaved pairs in the stored order.  DeepSeek-V3's code
  first de-interleaves ``q_pe`` and ``k_pe`` and then turns halves: the
  same rotation of each pair, stored in another order, and the score is
  the same.
* MoonViT's attention is full within one crop (the published model
  packs several images with block-diagonal masks: one crop a sequence
  is the same).
* A crop holds intensities in [0, 1] (8-bit pixels over 255), so the
  published ``(x / 255 - 0.5) / 0.5`` is ``(x - 0.5) / 0.5`` here.
* The prompt and class ids, the answer length and the weights are the
  benchmark's own (seeded; no trained weights are used).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


@contextlib.contextmanager
def full_float32():
    """Float32 products in full float32 (no TF32), restored after."""
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    old = (mm.allow_tf32, cudnn.allow_tf32)
    mm.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        mm.allow_tf32, cudnn.allow_tf32 = old


def f32(t: Tensor) -> Tensor:
    return t.to(torch.float32)


def layer_norm(p: dict, x: Tensor, eps: float) -> Tensor:
    return F.layer_norm(x, x.shape[-1:], f32(p["scale"]), f32(p["bias"]),
                        eps)


def rms_norm(p: dict, x: Tensor, eps: float) -> Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * f32(p["scale"])


def turn_pairs(x: Tensor, angles: Tensor) -> Tensor:
    """Turn each interleaved pair (2j, 2j + 1) of the last axis by
    ``angles`` (..., D / 2)."""
    a, b = x[..., 0::2], x[..., 1::2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    out = torch.empty_like(x)
    out[..., 0::2] = a * cos - b * sin
    out[..., 1::2] = a * sin + b * cos
    return out


def attend(q: Tensor, k: Tensor, v: Tensor, scale: float,
           causal: bool) -> Tensor:
    """(H, T, dk), (H, T, dk), (H, T, dv) -> (H, T, dv)."""
    s = q @ k.transpose(-1, -2) * scale
    if causal:
        t = s.shape[-1]
        s = s.masked_fill(torch.ones(t, t, dtype=torch.bool,
                                     device=s.device).triu(1),
                          float("-inf"))
    return torch.softmax(s, -1) @ v


# --------------------------------------------------------------------------
# MoonViT and the projector
# --------------------------------------------------------------------------


def vision_block(p: dict, x: Tensor, angles: Tensor, vc: dict) -> Tensor:
    n, d = x.shape
    h = vc["num_attention_heads"]
    y = layer_norm(p["ln0"], x, vc["layer_norm_eps"])
    qkv = (y @ f32(p["wqkv"]["w"]) + f32(p["wqkv"]["b"])).view(n, 3, h, -1)
    q, k, v = (qkv[:, i].transpose(0, 1) for i in range(3))
    q, k = turn_pairs(q, angles), turn_pairs(k, angles)
    o = attend(q, k, v, q.shape[-1] ** -0.5, False).transpose(0, 1)
    x = x + o.reshape(n, d) @ f32(p["wo"]["w"]) + f32(p["wo"]["b"])
    y = layer_norm(p["ln1"], x, vc["layer_norm_eps"])
    y = F.gelu(y @ f32(p["fc0"]["w"]) + f32(p["fc0"]["b"]),
               approximate="tanh")
    return x + y @ f32(p["fc1"]["w"]) + f32(p["fc1"]["b"])


def vision_angles(gh: int, gw: int, d_head: int, theta: float,
                  device) -> Tensor:
    """2D RoPE: pair 2k by the column, pair 2k + 1 by the row, both at
    theta^(-4k / d_head)."""
    k = torch.arange(d_head // 4, dtype=torch.float64, device=device)
    freqs = (1.0 / theta ** (4 * k / d_head)).to(torch.float32)
    out = torch.empty(gh * gw, d_head // 2, device=device)
    pos = torch.arange(gh * gw, device=device)
    out[:, 0::2] = (pos % gw).to(torch.float32)[:, None] * freqs
    out[:, 1::2] = (pos // gw).to(torch.float32)[:, None] * freqs
    return out


def vision(params: dict, crop: Tensor, cfg: dict) -> Tensor:
    """One (S, S, 3) crop of intensities in [0, 1] (8-bit pixels over
    255) -> (n_img, hidden_size) image tokens: MoonViT, the 2 x 2 merger
    and the projector."""
    vc = cfg["vision_config"]
    vp = params["vision"]
    patch, m = vc["patch_size"], vc["merge_kernel_size"][0]
    x = (f32(crop) - 0.5) / 0.5
    x = F.conv2d(x.permute(2, 0, 1)[None], f32(vp["patch"]["w"]),
                 f32(vp["patch"]["b"]), stride=patch)[0]
    d, gh, gw = x.shape
    table = f32(vp["pos"]).permute(2, 0, 1)[None]
    if tuple(table.shape[-2:]) != (gh, gw):
        table = F.interpolate(table, size=(gh, gw), mode="bicubic",
                              align_corners=False)
    x = (x + table[0]).permute(1, 2, 0).reshape(gh * gw, d)
    angles = vision_angles(gh, gw, d // vc["num_attention_heads"],
                           vc["rope_theta"], x.device)
    for p in vp["blocks"]:
        x = vision_block(p, x, angles, vc)
    x = layer_norm(vp["final_ln"], x, vc["layer_norm_eps"])
    # the merger: each m x m block of patches, row-major, one row
    x = x.view(gh // m, m, gw // m, m, d).permute(0, 2, 1, 3, 4)
    x = x.reshape(-1, m * m, d)
    pp = params["projector"]
    x = layer_norm(pp["ln"], x, vc["layer_norm_eps"]).flatten(1)
    x = F.gelu(x @ f32(pp["fc1"]["w"]) + f32(pp["fc1"]["b"]))
    return x @ f32(pp["fc2"]["w"]) + f32(pp["fc2"]["b"])


# --------------------------------------------------------------------------
# the language model
# --------------------------------------------------------------------------


def lm_angles(t: int, dim: int, theta: float, device) -> Tensor:
    i = torch.arange(0, dim, 2, dtype=torch.float64, device=device)
    freqs = (1.0 / theta ** (i / dim)).to(torch.float32)
    return torch.arange(t, device=device).to(torch.float32)[:, None] * freqs


def mla(lp: dict, x: Tensor, cfg: dict) -> Tensor:
    """Causal multi-head latent attention over (T, d), keys and values
    decompressed."""
    t = x.shape[0]
    h = cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    r = cfg["kv_lora_rank"]
    ang = lm_angles(t, rope, cfg["rope_theta"], x.device)
    q = (x @ f32(lp["wq"])).view(t, h, nope + rope)
    q_pe = turn_pairs(q[..., nope:], ang[:, None])
    kva = x @ f32(lp["wkva"])
    c = rms_norm(lp["kv_norm"], kva[:, :r], cfg["rms_norm_eps"])
    k_pe = turn_pairs(kva[:, r:], ang)
    kv = (c @ f32(lp["wkvb"])).view(t, h, nope + cfg["v_head_dim"])
    qf = torch.cat([q[..., :nope], q_pe], -1).transpose(0, 1)
    kf = torch.cat([kv[..., :nope], k_pe[:, None].expand(t, h, rope)],
                   -1).transpose(0, 1)
    o = attend(qf, kf, kv[..., nope:].transpose(0, 1),
               (nope + rope) ** -0.5, True)
    return o.transpose(0, 1).reshape(t, -1) @ f32(lp["wo"])


def swiglu(gate_up: Tensor, down: Tensor, x: Tensor) -> Tensor:
    gu = x @ f32(gate_up)
    g, u = gu[..., :gu.shape[-1] // 2], gu[..., gu.shape[-1] // 2:]
    return (F.silu(g) * u) @ f32(down)


def route(p: dict, x: Tensor, cfg: dict, forced: Tensor | None = None
          ) -> tuple[Tensor, Tensor, float]:
    """Top-k expert ids (T, k) by sigmoid score plus correction bias, and
    their gates: the unbiased scores, normalised, times the routed
    scaling factor.  With ``forced`` (T, k), those ids are taken in the
    place of the top k (another computation's picks, judged here), and
    the third value is how far they fall short of a top k: the largest
    of ``max(s + b outside them) - min(s + b inside them)`` over the
    tokens, 0 where they are a top k."""
    s = torch.sigmoid(x @ f32(p["router"]))
    choice = s + f32(p["bias"])
    k = cfg["num_experts_per_tok"]
    gap = 0.0
    if forced is None:
        idx = torch.sort(choice, dim=-1, descending=True,
                         stable=True).indices[:, :k]
    else:
        idx = forced.to(device=x.device, dtype=torch.long)
        inside = torch.zeros_like(choice, dtype=torch.bool).scatter_(
            1, idx, True)
        lo = choice.masked_fill(~inside, float("inf")).amin(-1)
        hi = choice.masked_fill(inside, float("-inf")).amax(-1)
        gap = float((hi - lo).clamp(min=0).max()) if len(idx) else 0.0
    w = s.gather(1, idx)
    return idx, w / (w.sum(-1, keepdim=True) + 1e-20) \
        * cfg["routed_scaling_factor"], gap


def moe(p: dict, x: Tensor, cfg: dict, forced: Tensor | None = None
        ) -> tuple[Tensor, float]:
    """Every token through its k experts (none dropped) plus the shared
    experts; returns the output and the routing gap of :func:`route`."""
    idx, w, gap = route(p, x, cfg, forced)
    y = swiglu(p["shared_gate_up"], p["shared_down"], x)
    for e in range(p["gate_up"].shape[0]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            y = y.index_add(0, tok, w[tok, slot, None]
                            * swiglu(p["gate_up"][e], p["down"][e], x[tok]))
    return y, gap


def lm_layer(lp: dict, x: Tensor, cfg: dict, forced: Tensor | None = None
             ) -> tuple[Tensor, float]:
    """One decoder layer over the (T, d) residual stream; returns it and
    the routing gap (0 for a dense layer)."""
    eps = cfg["rms_norm_eps"]
    x = x + mla(lp, rms_norm(lp["attn_norm"], x, eps), cfg)
    y = rms_norm(lp["mlp_norm"], x, eps)
    if "mlp" in lp:
        return x + swiglu(lp["mlp"]["gate_up"], lp["mlp"]["down"], y), 0.0
    out, gap = moe(lp["moe"], y, cfg, forced)
    return x + out, gap


def lm_head(lm: dict, x: Tensor, cfg: dict) -> Tensor:
    return rms_norm(lm["final_norm"], x, cfg["rms_norm_eps"]) \
        @ f32(lm["head"])


def embeds(params: dict, crop: Tensor, pre_ids: Tensor, post_ids: Tensor,
           answer_ids: Tensor, cfg: dict) -> Tensor:
    """``[pre_ids] + image tokens + [post_ids] + [answer_ids]`` as
    (T, hidden_size)."""
    emb = params["lm"]["embed"]
    return torch.cat([f32(emb[pre_ids]), vision(params, crop, cfg),
                      f32(emb[post_ids]), f32(emb[answer_ids])])


def forward(params: dict, crop: Tensor, pre_ids: Tensor, post_ids: Tensor,
            answer_ids: Tensor, cfg: dict, routes=None) -> tuple[Tensor, float]:
    """The logits (T, vocab_size) of every position of one request's
    whole sequence, the answer ids fed as they were generated.  With
    ``routes`` (one (T, k) tensor of expert ids a layer, None for a dense
    layer), the MoE layers take those picks (:func:`route`); the second
    value is the largest routing gap."""
    gap = 0.0
    with full_float32():
        x = embeds(params, crop, pre_ids, post_ids, answer_ids, cfg)
        for i, lp in enumerate(params["lm"]["layers"]):
            x, g = lm_layer(lp, x, cfg, None if routes is None else routes[i])
            gap = max(gap, g)
        return lm_head(params["lm"], x, cfg), gap
