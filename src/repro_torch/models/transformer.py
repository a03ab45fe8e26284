"""Decoder-only LM, dense path (port of ``repro.models.transformer``).

Llama-style blocks: RMSNorm -> attention (+RoPE, GQA) -> residual,
RMSNorm -> SwiGLU MLP -> residual; KV-cache prefill and decode, with a
ring-buffer cache bounded by the window for sliding-window models.

Three attention implementations, as in the reference:

  * ``naive``   — the materialised softmax (test oracle), the kernel's
    plain version ``kernels/attention/ref.py``;
  * ``chunked`` — the online softmax over KV chunks in plain PyTorch;
  * ``flash``   — the hand-written CUDA kernel
    (``repro_torch.kernels.attention``), the reference's ``pallas``.

The parameters keep the reference's stacked ``(L, ...)`` layout, with
dense weights as ``(d_in, d_out)``, so :func:`from_jax_params` is a copy;
the layers run as a Python loop.  ``decode_step`` computes its attention
with plain einsums, as the reference does, and updates the cache tensors
in place.  Serving only: the MoE blocks and the training losses are not
ported yet (ROADMAP, queue 1, slice F).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.attention.ops import flash_attention
from repro_torch.kernels.attention.ref import flash_attention_ref
from repro_torch.models import layers as L

Tensor = torch.Tensor
Params = dict

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    moe: bool = False  # the MoE blocks are not ported: True raises
    # attention
    window: int | None = None  # sliding-window size (tokens), None = full
    rope_theta: float = 10000.0
    attention_impl: str = "chunked"  # naive | chunked | flash
    attn_chunk: int = 1024
    # numerics
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    norm_eps: float = 1e-6

    @property
    def policy(self) -> L.DtypePolicy:
        return L.DtypePolicy(self.param_dtype, self.compute_dtype)

    @property
    def n_params(self) -> int:
        """Total parameter count of the dense model."""
        _dense_only(self)
        d, dh = self.d_model, self.d_head
        attn = d * (self.n_heads * dh) * 2 + d * (self.n_kv_heads * dh) * 2
        per_layer = attn + 3 * d * self.d_ff + 2 * d
        emb = self.vocab_size * d * 2  # untied in/out embeddings
        return self.n_layers * per_layer + emb + d


def from_jax_config(cfg) -> TransformerConfig:
    """The reference's ``TransformerConfig`` -> the port's.

    Dtypes map by name; ``attention_impl="pallas"`` becomes ``"flash"``.
    The fields the port does not have are dropped: the MoE sizes (MoE is
    not ported), the loss's ``ce_chunk`` (training is not), and
    ``remat``, ``sequence_parallel`` and ``moe_a2a``, autodiff and mesh
    choices with no effect on the function.
    """
    kw = {f.name: getattr(cfg, f.name)
          for f in dataclasses.fields(TransformerConfig)}
    for f in ("param_dtype", "compute_dtype"):
        kw[f] = getattr(torch, np.dtype(kw[f]).name)
    if kw["attention_impl"] == "pallas":
        kw["attention_impl"] = "flash"
    return TransformerConfig(**kw)


@dataclasses.dataclass
class KVCache:
    k: Tensor  # (L, B, S_cache, KVH, Dh)
    v: Tensor  # (L, B, S_cache, KVH, Dh)
    length: Tensor  # 0-d int32: number of tokens already absorbed


def _dense_only(cfg: TransformerConfig) -> None:
    if cfg.moe:
        raise NotImplementedError(
            "the MoE blocks are not ported yet (ROADMAP, queue 1, slice F)")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: TransformerConfig,
                device: str | torch.device | None = None) -> Params:
    """Random parameters in the reference's layout, drawn from ``gen``
    (uniform in +-sqrt(1 / fan_in), embeddings normal * 0.02) and stored
    in ``cfg.param_dtype`` on ``device`` (the card unless the caller
    names another, :func:`repro_torch.device.resolve_device`)."""
    _dense_only(cfg)
    device = resolve_device(device)
    dt = cfg.param_dtype
    d, dh, lyr, f = cfg.d_model, cfg.d_head, cfg.n_layers, cfg.d_ff

    def stacked(shape, fan_in):
        scale = (1.0 / fan_in) ** 0.5
        w = torch.rand((lyr,) + shape, generator=gen, dtype=torch.float32,
                       device=gen.device) * (2.0 * scale) - scale
        return w.to(device=device, dtype=dt)

    layers = {
        "attn": {
            "wq": stacked((d, cfg.n_heads * dh), d),
            "wk": stacked((d, cfg.n_kv_heads * dh), d),
            "wv": stacked((d, cfg.n_kv_heads * dh), d),
            "wo": stacked((cfg.n_heads * dh, d), cfg.n_heads * dh),
        },
        "ln1": {"scale": torch.ones((lyr, d), dtype=dt, device=device)},
        "ln2": {"scale": torch.ones((lyr, d), dtype=dt, device=device)},
        "mlp": {
            "w_gate": stacked((d, f), d),
            "w_up": stacked((d, f), d),
            "w_down": stacked((f, d), f),
        },
    }
    return {
        "embed": L.init_embedding(gen, cfg.vocab_size, d, dt, device),
        "layers": layers,
        "ln_f": L.init_rmsnorm(d, dt, device),
        "unembed": L.init_dense(gen, d, cfg.vocab_size, bias=False, dtype=dt,
                                device=device),
    }


def _leaf_to_torch(arr, device) -> Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (JAX's is ml_dtypes'), and
        # torch.tensor refuses it: move the bits
        bits = torch.from_numpy(np.array(arr).view(np.uint16))
        return bits.view(torch.bfloat16).to(device)
    return torch.tensor(np.ascontiguousarray(arr), device=device)


def from_jax_params(tree, device: str | torch.device | None = None
                    ) -> Params:
    """The reference's parameter pytree (numpy arrays, or anything
    ``np.asarray`` takes) -> the port's on ``device`` (the card unless the
    caller names another): the same nested dicts, every leaf copied as it
    is, bfloat16 leaves bit for bit."""
    device = resolve_device(device)

    def copy(t):
        return {k: copy(v) for k, v in t.items()} if isinstance(t, dict) \
            else _leaf_to_torch(t, device)
    return copy(tree)


def _layer_params(params: Params, i: int) -> Params:
    """Layer ``i``'s slice of the stacked layer parameters."""
    def pick(t):
        return {k: pick(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    return pick(params["layers"])


# --------------------------------------------------------------------------
# attention impls
# --------------------------------------------------------------------------


def _chunked_attention(q, k, v, *, causal, window, q_offset, scale, chunk):
    """Online softmax over KV chunks (flash attention in plain PyTorch)."""
    b, sq, h, dh = q.shape
    skv = k.shape[1]
    chunk = min(chunk, skv)
    q32 = q.to(torch.float32)
    qpos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, dh), dtype=torch.float32, device=q.device)
    for lo in range(0, skv, chunk):
        kb = k[:, lo:lo + chunk].to(torch.float32)
        vb = v[:, lo:lo + chunk].to(torch.float32)
        s = torch.einsum("bqhd,bkhd->bhqk", q32, kb) * scale
        kpos = lo + torch.arange(kb.shape[1], device=q.device)
        mask = torch.ones((sq, kb.shape[1]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        s = s.masked_fill(~mask[None, None], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None]).masked_fill(~mask[None, None], 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def attention(q, k, v, cfg: TransformerConfig, *, causal=True, window=None,
              q_offset=0):
    """Dispatch on cfg.attention_impl. q: (B,Sq,H,Dh); k/v: (B,Skv,KVH,Dh)."""
    scale = cfg.d_head ** -0.5
    kw = dict(causal=causal, window=window, q_offset=q_offset, scale=scale)
    if cfg.attention_impl == "flash":
        return flash_attention(q, k, v, **kw)
    if cfg.attention_impl == "naive":
        return flash_attention_ref(q, k, v, **kw)
    if cfg.attention_impl != "chunked":
        raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return _chunked_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset, scale=scale,
                              chunk=cfg.attn_chunk)


# --------------------------------------------------------------------------
# blocks / forward
# --------------------------------------------------------------------------


def dense_mlp(p: Params, x: Tensor, cfg: TransformerConfig) -> Tensor:
    pol = cfg.policy
    h = L.silu(L.dense({"w": p["w_gate"]}, x, pol)) \
        * L.dense({"w": p["w_up"]}, x, pol)
    return L.dense({"w": p["w_down"]}, h, pol)


def _qkv(lp: Params, x: Tensor, cfg: TransformerConfig, positions: Tensor):
    """RMSNorm, the q/k/v projections and RoPE of one block."""
    b, s, _ = x.shape
    pol = cfg.policy
    h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    q = L.dense({"w": lp["attn"]["wq"]}, h, pol).reshape(
        b, s, cfg.n_heads, cfg.d_head)
    k = L.dense({"w": lp["attn"]["wk"]}, h, pol).reshape(
        b, s, cfg.n_kv_heads, cfg.d_head)
    v = L.dense({"w": lp["attn"]["wv"]}, h, pol).reshape(
        b, s, cfg.n_kv_heads, cfg.d_head)
    return (L.apply_rope(q, positions, cfg.rope_theta),
            L.apply_rope(k, positions, cfg.rope_theta), v)


def _finish_block(lp: Params, x: Tensor, attn_out: Tensor,
                  cfg: TransformerConfig) -> Tensor:
    """Output projection and residual, then the MLP half of the block."""
    b, s = x.shape[:2]
    attn_out = attn_out.reshape(b, s, cfg.n_heads * cfg.d_head)
    x = x + L.dense({"w": lp["attn"]["wo"]}, attn_out, cfg.policy)
    h2 = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    return x + dense_mlp(lp["mlp"], h2, cfg)


def _layer(lp: Params, x: Tensor, cfg: TransformerConfig, positions: Tensor
           ) -> tuple[Tensor, tuple[Tensor, Tensor]]:
    """One decoder block of causal self-attention (train/prefill).
    Returns (x_out, (k, v))."""
    q, k, v = _qkv(lp, x, cfg, positions)
    attn_out = attention(q, k, v, cfg, causal=True, window=cfg.window)
    return _finish_block(lp, x, attn_out, cfg), (k, v)


def forward(params: Params, tokens: Tensor, cfg: TransformerConfig,
            positions: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Full forward pass -> (final hidden states (B,S,D), total aux loss,
    always 0 on the dense path)."""
    _dense_only(cfg)
    s = tokens.shape[1]
    if positions is None:
        positions = torch.arange(s, device=tokens.device)
    x = L.embedding(params["embed"], tokens, cfg.policy)
    for i in range(cfg.n_layers):
        x, _ = _layer(_layer_params(params, i), x, cfg, positions)
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def logits_fn(params: Params, tokens: Tensor, cfg: TransformerConfig
              ) -> Tensor:
    """(B, S) -> (B, S, V) float32 logits.  Only for small shapes."""
    hidden, _ = forward(params, tokens, cfg)
    return L.dense(params["unembed"], hidden, cfg.policy).to(torch.float32)


# --------------------------------------------------------------------------
# prefill / decode (serving)
# --------------------------------------------------------------------------


def cache_length(cfg: TransformerConfig, max_len: int) -> int:
    return min(cfg.window, max_len) if cfg.window is not None else max_len


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype=None, device: str | torch.device | None = None
               ) -> KVCache:
    """An empty cache on ``device`` (the card unless the caller names
    another)."""
    device = resolve_device(device)
    s = cache_length(cfg, max_len)
    dt = dtype or cfg.compute_dtype
    shape = (cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.d_head)
    return KVCache(torch.zeros(shape, dtype=dt, device=device),
                   torch.zeros(shape, dtype=dt, device=device),
                   torch.zeros((), dtype=torch.int32, device=device))


def prefill(params: Params, tokens: Tensor, cfg: TransformerConfig,
            max_len: int) -> tuple[Tensor, KVCache]:
    """Process the prompt; returns (last-token logits (B, V) float32,
    primed cache).

    For windowed models the cache keeps the last ``window`` positions
    (ring layout: slot = pos % window)."""
    _dense_only(cfg)
    b, s = tokens.shape
    dev = tokens.device
    positions = torch.arange(s, device=dev)
    x = L.embedding(params["embed"], tokens, cfg.policy)
    cache = init_cache(cfg, b, max_len, device=dev)
    s_cache = cache.k.shape[2]
    if cfg.window is not None and s > s_cache:
        # ring layout: absolute position p lives at slot p % window
        slots = torch.arange(s - s_cache, s, device=dev) % s_cache
    for i in range(cfg.n_layers):
        x, (k, v) = _layer(_layer_params(params, i), x, cfg, positions)
        if cfg.window is not None and s > s_cache:
            cache.k[i][:, slots] = k[:, -s_cache:]
            cache.v[i][:, slots] = v[:, -s_cache:]
        else:
            n = min(s, s_cache)
            cache.k[i][:, :n] = k[:, :n]
            cache.v[i][:, :n] = v[:, :n]
    x = L.rmsnorm(params["ln_f"], x[:, -1:], cfg.norm_eps)
    logits = L.dense(params["unembed"], x, cfg.policy).to(torch.float32)
    cache.length.fill_(s)
    return logits[:, 0], cache


def decode_step(params: Params, token: Tensor, cache: KVCache,
                cfg: TransformerConfig) -> tuple[Tensor, KVCache]:
    """One decode step.  ``token``: (B,) integer.  Returns (logits (B, V)
    float32, the cache with the new token written into it in place and
    its length advanced).  Windowed models use ring-buffer slots."""
    _dense_only(cfg)
    b = token.shape[0]
    pos = cache.length.to(torch.int64)  # 0-d: absolute position of the token
    s_cache = cache.k.shape[2]
    positions = pos.reshape(1, 1).expand(b, 1)
    x = L.embedding(params["embed"], token[:, None], cfg.policy)

    windowed = cfg.window is not None
    slot = pos % s_cache if windowed else torch.clamp(pos, max=s_cache - 1)
    # absolute position of each cache slot; % is floor-mod, as jnp's
    slots = torch.arange(s_cache, device=token.device)
    abs_pos = pos - (pos - slots) % s_cache if windowed else slots
    valid = (abs_pos <= pos) & (abs_pos >= 0)  # >= 0: unwritten ring slots
    if windowed:
        valid &= abs_pos > pos - cfg.window
    rep = cfg.n_heads // cfg.n_kv_heads
    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        q, k, v = _qkv(lp, x, cfg, positions)
        kc, vc = cache.k[i], cache.v[i]
        kc.index_copy_(1, slot.reshape(1), k.to(kc.dtype))
        vc.index_copy_(1, slot.reshape(1), v.to(vc.dtype))
        kr = kc.repeat_interleave(rep, dim=2) if rep > 1 else kc
        vr = vc.repeat_interleave(rep, dim=2) if rep > 1 else vc
        # RoPE on cached keys was applied at insert time with their own
        # positions; scores need no further correction.
        s_ = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          kr.to(torch.float32)) * (cfg.d_head ** -0.5)
        s_ = s_.masked_fill(~valid[None, None, None, :], NEG_INF)
        p_ = torch.softmax(s_, dim=-1)
        attn_out = torch.einsum("bhqk,bkhd->bqhd", p_, vr.to(torch.float32))
        x = _finish_block(lp, x, attn_out.to(cfg.compute_dtype), cfg)
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    logits = L.dense(params["unembed"], x, cfg.policy).to(torch.float32)
    cache.length.add_(1)
    return logits[:, 0], cache
