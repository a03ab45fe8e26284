"""Kimi-VL-A3B: MoonViT, its MLP projector and a DeepSeek-V3-style
language model (multi-head latent attention, a sigmoid router with a
correction bias, routed and shared SwiGLU experts), served as the pod's
region-description task.

The LM's layer, with ``h`` (T, d_model) and ``H`` heads:

* ``q = h W_q`` -> H x (nope + rope); ``[c, k_pe] = h W_kva`` ->
  ``kv_lora_rank`` + ``rope``; ``c = RMSNorm(c)``; ``[k_nope, v] =
  c W_kvb`` -> H x (nope + v).  RoPE (``rope_theta``, interleaved pairs)
  turns ``q_pe`` and the head-shared ``k_pe``; the score is
  ``(q_nope . k_nope + q_pe . k_pe) / sqrt(nope + rope)``, causal; the
  output is ``concat_h(softmax . v_h) W_o``.
* The prefill runs on decompressed keys and values.  Decode keeps only
  ``[c, k_pe]`` (576 values a token and layer at the published widths)
  in the cache and absorbs ``W_kvb`` into the query and the output:
  ``q_c = q_nope W_uk^T`` scores against ``c``, and ``softmax . c`` goes
  through ``W_uv`` per head.
* Layer ``< first_k_dense_replace``: a dense SwiGLU.  Every other layer:
  ``s = sigmoid(h W_r)`` in float32, the top ``k`` experts by ``s + b``
  (``b`` the correction bias; among equal values the lower index first),
  gates ``s[top] / sum s[top] * routed_scaling_factor``, and ``y =
  sum_k w_k E_k(h) + S(h)``.  No token is dropped: the picks, sorted by
  expert, run as grouped products over every expert's own rows.

Weights and activations are bfloat16; products accumulate in float32
(the backend turns off bfloat16's reduced-precision reductions); norms,
the router, RoPE and the softmax run in float32.  A weight is
``(d_in, d_out)``; experts stack on a leading axis, and a SwiGLU's gate
and up projections sit side by side (``gate_up``: gate first).

``kimi_vl_ref.py`` is the plain float32 reference of the same
equations, with no cache and no batching.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.models.vision import (MoonViTConfig, _layer_norm,
                                       moonvit_apply, rotate_pairs)

Tensor = torch.Tensor
Params = dict


@dataclasses.dataclass(frozen=True)
class KimiLMConfig:
    """The LM's published widths (Kimi-VL-A3B's ``text_config``)."""

    vocab_size: int = 163840
    d_model: int = 2048
    n_layers: int = 27
    n_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    first_k_dense_replace: int = 1
    d_ff_dense: int = 11264
    n_experts: int = 64
    top_k: int = 6
    n_shared_experts: int = 2
    d_ff_expert: int = 1408
    routed_scaling_factor: float = 2.446
    rope_theta: float = 800000.0
    rms_eps: float = 1e-5

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Values a token and layer in the decode cache."""
        return self.kv_lora_rank + self.qk_rope_head_dim


@dataclasses.dataclass(frozen=True)
class KimiVLConfig:
    name: str
    vision: MoonViTConfig
    lm: KimiLMConfig
    dtype: torch.dtype = torch.bfloat16


def config_from_dict(d: dict, name: str = "kimi-vl") -> KimiVLConfig:
    """A configuration from the published ``config.json`` keys (the
    LM's at the top level, MoonViT's under ``vision_config``)."""
    v = d["vision_config"]
    vision = MoonViTConfig(
        patch=v["patch_size"], d_model=v["hidden_size"],
        n_layers=v["num_hidden_layers"], n_heads=v["num_attention_heads"],
        d_ff=v["intermediate_size"], pos_grid=v["init_pos_emb_height"],
        rope_theta=v["rope_theta"], ln_eps=v["layer_norm_eps"],
        merge=v["merge_kernel_size"][0])
    lm = KimiLMConfig(
        vocab_size=d["vocab_size"], d_model=d["hidden_size"],
        n_layers=d["num_hidden_layers"], n_heads=d["num_attention_heads"],
        kv_lora_rank=d["kv_lora_rank"],
        qk_nope_head_dim=d["qk_nope_head_dim"],
        qk_rope_head_dim=d["qk_rope_head_dim"], v_head_dim=d["v_head_dim"],
        first_k_dense_replace=d["first_k_dense_replace"],
        d_ff_dense=d["intermediate_size"], n_experts=d["n_routed_experts"],
        top_k=d["num_experts_per_tok"],
        n_shared_experts=d["n_shared_experts"],
        d_ff_expert=d["moe_intermediate_size"],
        routed_scaling_factor=d["routed_scaling_factor"],
        rope_theta=d["rope_theta"], rms_eps=d["rms_norm_eps"])
    return KimiVLConfig(name=name, vision=vision, lm=lm)


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------


def param_spec(cfg: KimiVLConfig) -> list[tuple]:
    """Every leaf as ``(path, shape, kind, scale)``: ``uniform`` in
    +-scale, ``normal`` a standard normal times scale, ``ones``,
    ``zeros``.  Linear weights are uniform in +-sqrt(1 / d_in), biases
    and the router's correction bias uniform in +-0.02, the embedding a
    standard normal, the position table normal times 0.02."""
    v, m = cfg.vision, cfg.lm
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

    p, d = v.patch, v.d_model
    out.append((("vision", "patch", "w"), (d, 3, p, p), "uniform",
                math.sqrt(1.0 / (3 * p * p))))
    out.append((("vision", "patch", "b"), (d,), "uniform", 0.02))
    out.append((("vision", "pos"), (v.pos_grid, v.pos_grid, d), "normal",
                0.02))
    for i in range(v.n_layers):
        b = ("vision", "blocks", i)
        norm(b + ("ln0",), d, True)
        lin(b + ("wqkv",), d, 3 * d, True)
        lin(b + ("wo",), d, d, True)
        norm(b + ("ln1",), d, True)
        lin(b + ("fc0",), d, v.d_ff, True)
        lin(b + ("fc1",), v.d_ff, d, True)
    norm(("vision", "final_ln"), d, True)
    dm = v.merge ** 2 * d
    norm(("projector", "ln"), d, True)
    lin(("projector", "fc1"), dm, dm, True)
    lin(("projector", "fc2"), dm, m.d_model, True)
    out.append((("lm", "embed"), (m.vocab_size, m.d_model), "normal", 1.0))
    for i in range(m.n_layers):
        b = ("lm", "layers", i)
        norm(b + ("attn_norm",), m.d_model)
        lin(b + ("wq",), m.d_model, m.n_heads * m.qk_head_dim)
        lin(b + ("wkva",), m.d_model, m.latent_dim)
        norm(b + ("kv_norm",), m.kv_lora_rank)
        lin(b + ("wkvb",), m.kv_lora_rank,
            m.n_heads * (m.qk_nope_head_dim + m.v_head_dim))
        lin(b + ("wo",), m.n_heads * m.v_head_dim, m.d_model)
        norm(b + ("mlp_norm",), m.d_model)
        if i < m.first_k_dense_replace:
            lin(b + ("mlp", "gate_up"), m.d_model, 2 * m.d_ff_dense)
            lin(b + ("mlp", "down"), m.d_ff_dense, m.d_model)
        else:
            fs = m.n_shared_experts * m.d_ff_expert
            lin(b + ("moe", "router"), m.d_model, m.n_experts)
            out.append((b + ("moe", "bias"), (m.n_experts,), "uniform",
                        0.02))
            lin(b + ("moe", "gate_up"), m.d_model, 2 * m.d_ff_expert,
                lead=(m.n_experts,))
            lin(b + ("moe", "down"), m.d_ff_expert, m.d_model,
                lead=(m.n_experts,))
            lin(b + ("moe", "shared_gate_up"), m.d_model, 2 * fs)
            lin(b + ("moe", "shared_down"), fs, m.d_model)
    norm(("lm", "final_norm"), m.d_model)
    lin(("lm", "head"), m.d_model, m.vocab_size)
    return out


def build_tree(leaves) -> Params:
    """Nested dicts (and lists, where a path step is an int) from
    ``(path, tensor)`` pairs in spec order."""
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
        last = path[-1]
        if isinstance(node, list):
            node.append(t)
        else:
            node[last] = t
    return root


def init_params(gen: torch.Generator, cfg: KimiVLConfig, device="cpu",
                dtype=None) -> Params:
    """Seeded weights in ``dtype`` (default the configuration's), each
    leaf drawn in float32 from ``gen`` in spec order."""
    dtype = dtype or cfg.dtype
    leaves = []
    for path, shape, kind, scale in param_spec(cfg):
        if kind == "uniform":
            t = torch.rand(shape, generator=gen, device=gen.device) \
                * (2 * scale) - scale
        elif kind == "normal":
            t = torch.randn(shape, generator=gen, device=gen.device) * scale
        elif kind == "ones":
            t = torch.ones(shape)
        else:
            t = torch.zeros(shape)
        leaves.append((path, t.to(device=device, dtype=dtype)))
    return build_tree(leaves)


# --------------------------------------------------------------------------
# vision tower and projector
# --------------------------------------------------------------------------


def project_tokens(p: Params, merged: Tensor, cfg: KimiVLConfig) -> Tensor:
    """The projector: LayerNorm over each patch's features, the merged
    block viewed as one row, Linear, exact GELU, Linear to d_model."""
    d = cfg.vision.d_model
    x = _layer_norm(p["ln"], merged.unflatten(-1, (-1, d)),
                    cfg.vision.ln_eps).flatten(-2)
    x = F.gelu(torch.addmm(p["fc1"]["b"], x.flatten(0, -2), p["fc1"]["w"]))
    x = torch.addmm(p["fc2"]["b"], x, p["fc2"]["w"])
    return x.unflatten(0, merged.shape[:-1])


def image_tokens(params: Params, crops: Tensor, cfg: KimiVLConfig,
                 pos: Tensor | None = None) -> Tensor:
    """(b, S, S, 3) crops in [0, 1] -> (b, n_img, d_model) tokens
    (``pos``: the crops' interpolated position table, where kept)."""
    merged = moonvit_apply(params["vision"], crops, cfg.vision, cfg.dtype,
                           pos)
    return project_tokens(params["projector"], merged, cfg)


def prompt_embeds(params: Params, pre_ids: Tensor, img: Tensor,
                  post_ids: Tensor) -> Tensor:
    """``[pre_ids] + image tokens + [post_ids]`` as (b, T, d_model)."""
    emb = params["lm"]["embed"]
    b = img.shape[0]
    return torch.cat([emb[pre_ids].expand(b, -1, -1), img,
                      emb[post_ids].expand(b, -1, -1)], 1)


# --------------------------------------------------------------------------
# language model
# --------------------------------------------------------------------------


def _rms_norm(p: Params, x: Tensor, eps: float) -> Tensor:
    """RMSNorm over the last axis (float32 statistics inside PyTorch's
    kernel), in ``x``'s dtype."""
    return F.rms_norm(x, x.shape[-1:], p["scale"], eps)


def rope_turn(positions: Tensor, dim: int, theta: float) -> Tensor:
    """(..., dim / 2) unit complex turns of 1D RoPE on interleaved
    pairs: pair i turns by position times theta^(-2i / dim)."""
    freqs = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=positions.device) / dim)
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.polar(torch.ones_like(angles), angles)


def swiglu(gate_up: Tensor, down: Tensor, x: Tensor) -> Tensor:
    g, u = (x @ gate_up).chunk(2, -1)
    return (F.silu(g) * u) @ down


def route(p: Params, x: Tensor, cfg: KimiLMConfig) -> tuple[Tensor, Tensor]:
    """(N, d) -> the top-k expert ids (N, k) by ``sigmoid(x W_r) + b``
    (ties: the lower index first) and their gates (N, k), float32."""
    s = torch.sigmoid(x.to(torch.float32) @ p["router"].to(torch.float32))
    choice = s + p["bias"].to(torch.float32)
    idx = torch.sort(choice, dim=-1, descending=True,
                     stable=True).indices[:, :cfg.top_k]
    w = s.gather(1, idx)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scaling_factor
    return idx, w


def routed_experts(p: Params, x: Tensor, idx: Tensor, w: Tensor) -> Tensor:
    """``sum_k w_k E_k(x)`` (N, d) in float32, dropping no token: the
    token-expert picks, sorted by expert, run as two grouped products
    (``torch._grouped_mm``: each expert's rows against its own weights,
    the groups' ends on the device), so no count comes to the host: the
    busiest expert's count goes to the tracer as ``moe.expert_tokens_max``
    at the caller's next :func:`tracing.flush_counts`."""
    n, k = idx.shape
    e = p["gate_up"].shape[0]
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    # (``torch.bincount`` would read the largest id back to the host)
    counts = torch.zeros(e, dtype=torch.long, device=x.device).index_add_(
        0, flat, torch.ones_like(flat))
    ends = torch.cumsum(counts, 0).to(torch.int32)
    tracing.count_later("moe.expert_tokens_max", counts.max())
    tracing.count("moe.expert_tokens", n * k)
    tok = order // k
    g, u = torch._grouped_mm(x[tok], p["gate_up"], offs=ends).chunk(2, -1)
    out = torch._grouped_mm(F.silu(g) * u, p["down"], offs=ends)
    picks = out.to(torch.float32) * w.reshape(-1)[order, None]
    return torch.zeros((n, x.shape[-1]), dtype=torch.float32,
                       device=x.device).index_add_(0, tok, picks)


def mlp(lp: Params, x: Tensor, cfg: KimiLMConfig) -> Tensor:
    """The layer's feed-forward on (..., d): the dense SwiGLU, or the
    routed experts plus the shared ones."""
    if "mlp" in lp:
        return swiglu(lp["mlp"]["gate_up"], lp["mlp"]["down"], x)
    p = lp["moe"]
    flat = x.reshape(-1, x.shape[-1])
    idx, w = route(p, flat, cfg)
    y = routed_experts(p, flat, idx, w) \
        + swiglu(p["shared_gate_up"], p["shared_down"], flat).to(torch.float32)
    return y.to(x.dtype).view(x.shape)


def _mla_prefill(lp: Params, x: Tensor, turn: Tensor,
                 cfg: KimiLMConfig) -> tuple:
    """Attention over (b, T, d) normed rows at positions 0..T-1 (their
    RoPE ``turn``) on decompressed keys and values; returns (output, the
    (b, T, latent_dim) latents ``[c, roped k_pe]`` the decode cache
    keeps)."""
    b, t, _ = x.shape
    h, nope, rope = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q_nope, q_pe = (x @ lp["wq"]).view(b, t, h, -1).split([nope, rope], -1)
    q_pe = rotate_pairs(q_pe, turn[:, None])
    c, k_pe = (x @ lp["wkva"]).split([cfg.kv_lora_rank, rope], -1)
    c = _rms_norm(lp["kv_norm"], c, cfg.rms_eps)
    k_pe = rotate_pairs(k_pe, turn)
    k_nope, v = (c @ lp["wkvb"]).view(b, t, h, -1).split(
        [nope, cfg.v_head_dim], -1)
    q = torch.cat([q_nope, q_pe], -1).transpose(1, 2)
    k = torch.cat([k_nope, k_pe[:, :, None].expand(b, t, h, rope)],
                  -1).transpose(1, 2)
    o = F.scaled_dot_product_attention(q, k, v.transpose(1, 2),
                                       is_causal=True,
                                       scale=cfg.qk_head_dim ** -0.5)
    o = o.transpose(1, 2).reshape(b, t, h * cfg.v_head_dim)
    return o @ lp["wo"], torch.cat([c, k_pe], -1)


def prefill(lm: Params, embeds: Tensor, cfg: KimiLMConfig
            ) -> tuple[Tensor, Tensor]:
    """The LM over (b, T, d) embeddings of equal length at positions
    0..T-1.  Returns the float32 logits of the last position (b, V) and
    the (n_layers, b, T, latent_dim) latents for the decode cache."""
    x = embeds
    latents = []
    turn = rope_turn(torch.arange(x.shape[1], device=x.device),
                     cfg.qk_rope_head_dim, cfg.rope_theta)
    for lp in lm["layers"]:
        a, lat = _mla_prefill(lp, _rms_norm(lp["attn_norm"], x, cfg.rms_eps),
                              turn, cfg)
        latents.append(lat)
        x = x + a
        x = x + mlp(lp, _rms_norm(lp["mlp_norm"], x, cfg.rms_eps), cfg)
    x = _rms_norm(lm["final_norm"], x[:, -1], cfg.rms_eps)
    return (x @ lm["head"]).to(torch.float32), torch.stack(latents)


def _mla_decode(lp: Params, x: Tensor, pos: Tensor, turn: Tensor,
                cache: Tensor, valid: Tensor, cfg: KimiLMConfig) -> Tensor:
    """One token a row, (B, d) normed, at positions ``pos`` (B,) (their
    RoPE ``turn``): its latent goes into ``cache`` (B, Lmax, latent_dim)
    at ``pos``, and it attends over the row's cached latents (``valid``
    (B, Lmax)) with ``W_kvb`` absorbed."""
    bsz = x.shape[0]
    h, nope, rope = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    r = cfg.kv_lora_rank
    q_nope, q_pe = (x @ lp["wq"]).view(bsz, h, -1).split([nope, rope], -1)
    q_pe = rotate_pairs(q_pe, turn[:, None])
    c, k_pe = (x @ lp["wkva"]).split([r, rope], -1)
    c = _rms_norm(lp["kv_norm"], c, cfg.rms_eps)
    cache[torch.arange(bsz, device=x.device), pos] = torch.cat(
        [c, rotate_pairs(k_pe, turn)], -1)
    wkvb = lp["wkvb"].view(r, h, nope + cfg.v_head_dim)
    w_uk, w_uv = wkvb[..., :nope], wkvb[..., nope:]
    q_c = torch.einsum("bhn,chn->bhc", q_nope, w_uk)
    s = torch.bmm(torch.cat([q_c, q_pe], -1), cache.transpose(1, 2))
    s = s.to(torch.float32) * cfg.qk_head_dim ** -0.5
    s = s.masked_fill(~valid[:, None], float("-inf"))
    o_c = torch.bmm(torch.softmax(s, -1).to(x.dtype), cache[..., :r])
    o = torch.einsum("bhc,chn->bhn", o_c, w_uv).reshape(bsz, -1)
    return o @ lp["wo"]


def decode_step(lm: Params, ids: Tensor, pos: Tensor, cache: Tensor,
                cfg: KimiLMConfig) -> Tensor:
    """One decode step of B rows: token ``ids`` (B,) at positions
    ``pos`` (B,) through the latent cache (n_layers, B, Lmax,
    latent_dim), whose rows hold their earlier positions (a ragged
    batch: each row attends over its own ``pos + 1`` positions).
    Returns the float32 logits (B, V)."""
    x = lm["embed"][ids]
    valid = torch.arange(cache.shape[2], device=ids.device)[None] \
        <= pos[:, None]
    turn = rope_turn(pos, cfg.qk_rope_head_dim, cfg.rope_theta)
    for i, lp in enumerate(lm["layers"]):
        x = x + _mla_decode(lp, _rms_norm(lp["attn_norm"], x, cfg.rms_eps),
                            pos, turn, cache[i], valid, cfg)
        x = x + mlp(lp, _rms_norm(lp["mlp_norm"], x, cfg.rms_eps), cfg)
    x = _rms_norm(lm["final_norm"], x, cfg.rms_eps)
    return (x @ lm["head"]).to(torch.float32)


def generate(params: Params, chunks, cfg: KimiVLConfig, steps: int):
    """Greedy decoding of a ragged batch: ``chunks`` is a list of
    (first ids (b,), latents (n_layers, b, T, latent_dim)) from
    :func:`prefill`.  The rows of every chunk go into one latent cache
    (n_layers, B, max T + steps, latent_dim) and decode together for
    ``steps`` steps, each feeding the row's last id.  Returns the fed
    ids (steps, B), each step's logits (a list of (B, V)) and the
    cache."""
    m = cfg.lm
    lens = torch.cat([torch.full((lat.shape[1],), lat.shape[2],
                                 dtype=torch.long, device=lat.device)
                      for _, lat in chunks])
    lmax = max(lat.shape[2] for _, lat in chunks) + steps
    first = chunks[0][1]
    cache = first.new_zeros((m.n_layers, len(lens), lmax, m.latent_dim))
    r = 0
    for _, lat in chunks:
        cache[:, r:r + lat.shape[1], :lat.shape[2]] = lat
        r += lat.shape[1]
    ids = torch.cat([g for g, _ in chunks])
    fed, logits = [], []
    pos = lens
    for t in range(steps):
        with tracing.span("vlm.decode", t):
            out = decode_step(params["lm"], ids, pos, cache, m)
        fed.append(ids)
        logits.append(out)
        ids = out.argmax(-1)
        pos = pos + 1
    return torch.stack(fed), logits, cache
