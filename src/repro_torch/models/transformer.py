"""Decoder-only LM: dense / GQA / MQA / sliding-window / MoE (port of
``repro.models.transformer``).

Llama-style blocks: RMSNorm -> attention (+RoPE, GQA) -> residual,
RMSNorm -> SwiGLU MLP or top-k MoE -> residual; KV-cache prefill and
decode, with a ring-buffer cache bounded by the window for
sliding-window models.

Three attention implementations, as in the reference:

  * ``naive``   — the materialised softmax (test oracle), the kernel's
    plain version ``kernels/attention/ref.py``;
  * ``chunked`` — the online softmax over KV chunks in plain PyTorch;
  * ``flash``   — the hand-written CUDA kernel
    (``repro_torch.kernels.attention``), the reference's ``pallas``.

MoE (:func:`moe_block`): the reference's sort-based grouped dispatch
(tokens stably sorted by expert id, a static capacity a expert, one
grouped product a projection), with capacity overflow dropping picks.

The parameters keep the reference's stacked ``(L, ...)`` layout, with
dense weights as ``(d_in, d_out)``, so :func:`from_jax_params` is a copy;
the layers run as a Python loop.  ``decode_step`` computes its attention
with plain einsums, as the reference does, and updates the cache tensors
in place.

Training: :func:`lm_loss` (:func:`chunked_ce_loss`, the cross-entropy in
sequence chunks that never holds the (tokens, vocab) logits, plus the
MoE aux loss).  With ``cfg.remat`` set and grad enabled, autograd saves
no activation inside a layer, an attention chunk or a CE chunk: each is
recomputed in the backward (``torch.utils.checkpoint``, non-reentrant),
at the reference's three ``jax.checkpoint`` sites.  Flash attention has
no backward (the reference's Pallas kernel neither), so training runs
``chunked`` or ``naive``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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
    # MoE
    moe: bool = False
    n_experts: int = 0
    moe_top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    # attention
    window: int | None = None  # sliding-window size (tokens), None = full
    rope_theta: float = 10000.0
    attention_impl: str = "chunked"  # naive | chunked | flash
    attn_chunk: int = 1024
    # loss
    ce_chunk: int = 512
    # numerics
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    norm_eps: float = 1e-6
    remat: bool = True  # recompute layers and chunks in the backward

    @property
    def policy(self) -> L.DtypePolicy:
        return L.DtypePolicy(self.param_dtype, self.compute_dtype)

    def _count(self, experts: int) -> int:
        d, dh = self.d_model, self.d_head
        attn = d * (self.n_heads * dh) * 2 + d * (self.n_kv_heads * dh) * 2
        if self.moe:
            mlp = experts * 3 * d * self.d_ff_expert + d * self.n_experts
        else:
            mlp = 3 * d * self.d_ff
        per_layer = attn + mlp + 2 * d
        emb = self.vocab_size * d * 2  # untied in/out embeddings
        return self.n_layers * per_layer + emb + d

    @property
    def n_params(self) -> int:
        """Total parameter count."""
        return self._count(self.n_experts)

    @property
    def n_active_params(self) -> int:
        """Parameters a token passes through (MoE: its top-k experts)."""
        return self._count(self.moe_top_k)


def from_jax_config(cfg) -> TransformerConfig:
    """The reference's ``TransformerConfig`` -> the port's.

    Dtypes map by name; ``attention_impl="pallas"`` becomes ``"flash"``.
    The fields the port does not have are dropped, each with no effect on
    what one device computes:

      * ``sequence_parallel``: shards the residual stream's sequence axis
        over the mesh's ``model`` axis, a layout of a mesh;
      * ``moe_a2a``: the reference's all-to-all expert parallelism, which
        it takes only when the mesh's ``model`` axis is larger than 1
        (``_use_moe_a2a``); on one device it runs :func:`moe_block`.
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


@dataclasses.dataclass
class Routing:
    """One MoE call's routing: each token's experts ``(T, k)`` in top-k
    order, and which of those picks kept a capacity slot (the others were
    dropped)."""
    expert_ids: Tensor
    keep: Tensor


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: TransformerConfig,
                device: str | torch.device | None = None) -> Params:
    """Random parameters in the reference's layout, drawn from ``gen``
    (uniform in +-sqrt(1 / fan_in), embeddings normal * 0.02) and stored
    in ``cfg.param_dtype`` on ``device`` (the card unless the caller
    names another, :func:`repro_torch.device.resolve_device`).  MoE
    layers get ``"moe"`` (router and expert stacks) in place of
    ``"mlp"``."""
    device = resolve_device(device)
    dt = cfg.param_dtype
    d, dh, lyr = cfg.d_model, cfg.d_head, cfg.n_layers

    def stacked(shape, fan_in):
        scale = (1.0 / fan_in) ** 0.5
        w = torch.rand((lyr,) + shape, generator=gen, dtype=torch.float32,
                       device=gen.device) * (2.0 * scale) - scale
        return w.to(device=device, dtype=dt)

    def per_layer(shape, fan_in):
        # as stacked(), but one layer's float32 draw at a time: a whole
        # expert stack is 25.8 GB of float32 at mixtral's width and 8 layers
        scale = (1.0 / fan_in) ** 0.5
        out = torch.empty((lyr,) + shape, dtype=dt, device=device)
        for i in range(lyr):
            w = torch.rand(shape, generator=gen, dtype=torch.float32,
                           device=gen.device)
            out[i] = w.mul_(2.0 * scale).sub_(scale)
        return out

    layers = {
        "attn": {
            "wq": stacked((d, cfg.n_heads * dh), d),
            "wk": stacked((d, cfg.n_kv_heads * dh), d),
            "wv": stacked((d, cfg.n_kv_heads * dh), d),
            "wo": stacked((cfg.n_heads * dh, d), cfg.n_heads * dh),
        },
        "ln1": {"scale": torch.ones((lyr, d), dtype=dt, device=device)},
        "ln2": {"scale": torch.ones((lyr, d), dtype=dt, device=device)},
    }
    if cfg.moe:
        e, fe = cfg.n_experts, cfg.d_ff_expert
        layers["moe"] = {
            "router": stacked((d, e), d),
            "w_gate": per_layer((e, d, fe), d),
            "w_up": per_layer((e, d, fe), d),
            "w_down": per_layer((e, fe, d), fe),
        }
    else:
        f = cfg.d_ff
        layers["mlp"] = {
            "w_gate": stacked((d, f), d),
            "w_up": stacked((d, f), d),
            "w_down": stacked((f, d), f),
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


def _remat(on: bool, fn, *args):
    """``fn(*args)``; with ``on`` and grad enabled, autograd keeps only
    its inputs and recomputes the rest in the backward."""
    if on and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _attention_chunk(q32, k, v, m, l, acc, lo, chunk, qpos, causal, window,
                     scale):
    """One KV chunk ``[lo, lo + chunk)`` of the online softmax: the
    running max, sum and accumulator after it."""
    kb = k[:, lo:lo + chunk].to(torch.float32)
    vb = v[:, lo:lo + chunk].to(torch.float32)
    s = torch.einsum("bqhd,bkhd->bhqk", q32, kb) * scale
    kpos = lo + torch.arange(kb.shape[1], device=q32.device)
    mask = torch.ones((q32.shape[1], kb.shape[1]), dtype=torch.bool,
                      device=q32.device)
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
    return m_new, l, acc


def _chunked_attention(q, k, v, *, causal, window, q_offset, scale, chunk,
                       remat=False):
    """Online softmax over KV chunks (flash attention in plain PyTorch).
    With ``remat``, each chunk's scores are recomputed in the backward,
    not saved: saved, they would be the whole (Sq, Skv) softmax."""
    b, sq, h, dh = q.shape
    skv = k.shape[1]
    chunk = min(chunk, skv)
    q32 = q.to(torch.float32)
    qpos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, dh), dtype=torch.float32, device=q.device)
    for lo in range(0, skv, chunk):
        m, l, acc = _remat(remat, _attention_chunk, q32, k, v, m, l, acc, lo,
                           chunk, qpos, causal, window, scale)
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
                              chunk=cfg.attn_chunk, remat=cfg.remat)


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


def _expert_products(a: Tensor, w: Tensor, cdt: torch.dtype) -> Tensor:
    """``(E, C, d_in) x (E, d_in, d_out) -> (E, C, d_out)`` float32: the
    operands in the compute dtype, products summed in float32 and not
    rounded, as the reference's ``preferred_element_type=jnp.float32``
    einsums.  On the card a bf16 product runs on the tensor cores with a
    float32 output; on the CPU, and wherever autograd records the product
    (``torch.bmm``'s float32-output form has no derivative), the operands
    are widened to float32, which holds the products of bf16 values
    exactly.  Widened, the backward is the reference's too: the float32
    cotangent against the widened operand, rounded to the compute dtype."""
    a, w = a.to(cdt), w.to(cdt)
    if a.device.type == "cuda" and cdt != torch.float32 and not (
            torch.is_grad_enabled() and (a.requires_grad or w.requires_grad)):
        return torch.bmm(a, w, out_dtype=torch.float32)
    return torch.bmm(a.to(torch.float32), w.to(torch.float32))


def moe_capacity(cfg: TransformerConfig, t: int) -> int:
    """The slots of each expert in a call of ``t`` tokens: ceil(t k / E)
    times the capacity factor, truncated, at least 1 (the reference's
    expression)."""
    return max(1, int(-(-t * cfg.moe_top_k // cfg.n_experts)
                      * cfg.capacity_factor))


def moe_block(p: Params, x: Tensor, cfg: TransformerConfig,
              routes: list | None = None) -> tuple[Tensor, Tensor]:
    """Top-k MoE with grouped dispatch.  ``x``: (T, D) flattened tokens.
    Returns (out (T, D) in x's dtype, the Switch-style load-balancing aux
    loss); with ``routes`` (a list) the call also appends its
    :class:`Routing`.

    The reference's function at one shard (G = 1): it splits the tokens
    into one group per data-parallel device (``gcd(T, pod * data)``,
    1 without a mesh), and the port runs on one device.  So every token
    of the call (a prefill's whole batch, a decode step's B tokens) shares
    the capacity of each expert (:func:`moe_capacity`).  Picks are ranked
    within their expert by a stable sort on expert id (token order);
    those past the capacity are dropped and contribute 0, their gates not
    renormalised.  The three expert products
    sum in float32 (:func:`_expert_products`), ``silu(gate) * up`` is
    taken in float32 and cast, and the combine runs in the compute dtype.
    """
    t, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    pol, cdt, dev = cfg.policy, cfg.compute_dtype, x.device

    logits = L.dense({"w": p["router"]}, x, pol).to(torch.float32)  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k puts the lower expert first among equal probabilities
    # (bf16 router logits tie at full width); torch.topk promises no
    # order, a stable descending sort keeps the index order of ties
    gate_vals, expert_ids = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_ids = gate_vals[:, :k], expert_ids[:, :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # load-balancing aux loss
    me = probs.mean(dim=0)
    counts = torch.bincount(expert_ids.reshape(-1), minlength=e).to(
        torch.float32)
    aux = e * torch.sum(me * counts / (t * k))

    capacity = moe_capacity(cfg, t)

    # each pick's rank within its expert: stable sort by expert id, then
    # the offset from the expert's first pick (searchsorted, left side)
    fe = expert_ids.reshape(-1)
    order = torch.argsort(fe, stable=True)
    se = fe[order]
    start = torch.searchsorted(se, torch.arange(e, device=dev), side="left")
    pos = torch.arange(t * k, device=dev) - start[se]
    slot_sorted = torch.where(pos < capacity, se * capacity + pos,
                              e * capacity)
    slot = torch.empty_like(slot_sorted)
    slot[order] = slot_sorted
    slot = slot.view(t, k)  # (token, pick) order; e * capacity: dropped
    keep = slot < e * capacity
    gathered = torch.zeros((e * capacity + 1, d), dtype=x.dtype, device=dev)
    gathered[slot.reshape(-1)] = x.repeat_interleave(k, dim=0)
    grouped = gathered[:-1].view(e, capacity, d)

    hidden = _expert_products(grouped, p["w_gate"], cdt)
    F.silu(hidden, inplace=True)
    hidden.mul_(_expert_products(grouped, p["w_up"], cdt))
    hidden = hidden.to(cdt)
    expert_out = _expert_products(hidden, p["w_down"], cdt).to(cdt)
    del hidden  # before the combine's buffers: 1.3 GB at mixtral's prefill
    expert_out = expert_out.view(e * capacity, d)

    # the combine, in the compute dtype, adding each token's k
    # contributions in increasing expert order, one rounding an addition,
    # as the reference's scatter-add over the expert-sorted picks does
    # (and deterministic, where an atomic scatter-add is not)
    by_expert = expert_ids.argsort(dim=1)
    slot_e = slot.gather(1, by_expert)
    contrib = expert_out[torch.clamp(slot_e, max=e * capacity - 1)] \
        * gate_vals.gather(1, by_expert).to(cdt)[..., None]
    contrib = torch.where(keep.gather(1, by_expert)[..., None], contrib,
                          torch.zeros((), dtype=cdt, device=dev))
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    if routes is not None:
        routes.append(Routing(expert_ids, keep))
    return out.to(x.dtype), aux


def _finish_block(lp: Params, x: Tensor, attn_out: Tensor,
                  cfg: TransformerConfig, routes: list | None = None
                  ) -> tuple[Tensor, Tensor | None]:
    """Output projection and residual, then the MLP or MoE half of the
    block.  Returns (x_out, the MoE aux loss or None)."""
    b, s, d = x.shape
    attn_out = attn_out.reshape(b, s, cfg.n_heads * cfg.d_head)
    x = x + L.dense({"w": lp["attn"]["wo"]}, attn_out, cfg.policy)
    h2 = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    if not cfg.moe:
        return x + dense_mlp(lp["mlp"], h2, cfg), None
    out, aux = moe_block(lp["moe"], h2.reshape(b * s, d), cfg, routes)
    return x + out.reshape(b, s, d), aux


def _layer(lp: Params, x: Tensor, cfg: TransformerConfig, positions: Tensor,
           routes: list | None = None
           ) -> tuple[Tensor, Tensor | None, tuple[Tensor, Tensor]]:
    """One decoder block of causal self-attention (train/prefill).
    Returns (x_out, the MoE aux loss or None, (k, v))."""
    q, k, v = _qkv(lp, x, cfg, positions)
    attn_out = attention(q, k, v, cfg, causal=True, window=cfg.window)
    x, aux = _finish_block(lp, x, attn_out, cfg, routes)
    return x, aux, (k, v)


def forward(params: Params, tokens: Tensor, cfg: TransformerConfig,
            positions: Tensor | None = None, routes: list | None = None
            ) -> tuple[Tensor, Tensor]:
    """Full forward pass -> (final hidden states (B,S,D), total MoE aux
    loss, 0 on the dense path).  With ``routes`` (a list) each MoE layer
    appends its :class:`Routing`; not under remat, whose backward would
    run each layer again."""
    s = tokens.shape[1]
    remat = cfg.remat and torch.is_grad_enabled()
    if remat and routes is not None:
        raise ValueError("routes are not recorded under remat")
    if positions is None:
        positions = torch.arange(s, device=tokens.device)
    x = L.embedding(params["embed"], tokens, cfg.policy)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        x, aux, _ = _remat(remat, _layer, _layer_params(params, i), x, cfg,
                           positions, routes)
        if aux is not None:
            total = total + aux
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return x, total


def _ce_chunk(h: Tensor, w: Tensor, t: Tensor, cdt: torch.dtype
              ) -> tuple[Tensor, Tensor]:
    """One chunk's (summed NLL, count of targets): float32 logits of the
    chunk's hidden states, ``logsumexp`` minus the target's logit; a
    target < 0 counts nothing.  The logits are the reference's
    ``preferred_element_type=float32`` product: operands in the compute
    dtype, widened to float32 (exact products), float32 sums.  So each
    chunk's gradient of ``w`` rounds to ``w``'s dtype before the chunks'
    are added, as the reference's scan adds them."""
    logits = torch.matmul(h.to(cdt).to(torch.float32),
                          w.to(cdt).to(torch.float32))
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, t.clamp(min=0)[..., None].long())[..., 0]
    valid = t >= 0
    nll = torch.where(valid, lse - picked, 0.0)
    return nll.sum(), valid.sum(dtype=torch.float32)


def chunked_ce_loss(hidden: Tensor, unembed_w: Tensor, targets: Tensor,
                    cfg: TransformerConfig) -> Tensor:
    """Mean cross-entropy without the (B, S, V) logits: the unembedding
    and ``logsumexp`` run ``cfg.ce_chunk`` positions at a time (the
    sequence padded to whole chunks with target -1), each chunk under
    remat (:func:`_ce_chunk`)."""
    b, s, _ = hidden.shape
    chunk = min(cfg.ce_chunk, s)
    pad = (-s) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad), value=-1)
    tot_nll = torch.zeros((), dtype=torch.float32, device=hidden.device)
    tot_cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, s + pad, chunk):
        nll, cnt = _remat(cfg.remat, _ce_chunk, hidden[:, lo:lo + chunk],
                          unembed_w, targets[:, lo:lo + chunk],
                          cfg.compute_dtype)
        tot_nll = tot_nll + nll
        tot_cnt = tot_cnt + cnt
    return tot_nll / torch.clamp(tot_cnt, min=1.0)


def lm_loss(params: Params, batch: dict, cfg: TransformerConfig) -> Tensor:
    """The training loss: CE of ``batch["targets"]`` given
    ``batch["tokens"]`` (both (B, S)), plus 0.01 times the MoE aux loss."""
    hidden, aux = forward(params, batch["tokens"], cfg)
    loss = chunked_ce_loss(hidden, params["unembed"]["w"], batch["targets"],
                           cfg)
    return loss + 0.01 * aux


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
            max_len: int, routes: list | None = None
            ) -> tuple[Tensor, KVCache]:
    """Process the prompt; returns (last-token logits (B, V) float32,
    primed cache).  With ``routes`` (a list) each MoE layer appends its
    :class:`Routing`.

    For windowed models the cache keeps the last ``window`` positions
    (ring layout: slot = pos % window)."""
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
        x, _, (k, v) = _layer(_layer_params(params, i), x, cfg, positions,
                              routes)
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
                cfg: TransformerConfig, routes: list | None = None
                ) -> tuple[Tensor, KVCache]:
    """One decode step.  ``token``: (B,) integer.  Returns (logits (B, V)
    float32, the cache with the new token written into it in place and
    its length advanced).  Windowed models use ring-buffer slots.  An MoE
    layer dispatches the step's B tokens together (their shared capacity
    is ``int(ceil(B k / E) * capacity_factor)``); with ``routes`` (a list)
    each appends its :class:`Routing`."""
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
        x, _ = _finish_block(lp, x, attn_out.to(cfg.compute_dtype), cfg,
                             routes)
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    logits = L.dense(params["unembed"], x, cfg.policy).to(torch.float32)
    cache.length.add_(1)
    return logits[:, 0], cache
