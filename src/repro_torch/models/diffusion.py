"""Diffusion backbones: MMDiT (flux-dev) and UNet (SDXL) (port of
``repro.models.diffusion``).

Both act on VAE latents (the VAE is out of scope: ``latent_res`` is
given directly); the text conditioning arrives as precomputed context
token embeddings and pooled vectors, as in the reference.

flux-dev (MMDiT, rectified flow): a 2x2 patchify, 19 *double* blocks
(separate img/txt streams, AdaLN-Zero modulation from the timestep,
guidance and pooled embedding, **joint** attention over the txt tokens
then the img tokens), 38 *single* blocks (the fused stream, parallel
attention and MLP), axial 2D sin-cos positions on the image tokens, the
rectified-flow loss and an Euler sampling step.

unet-sdxl (epsilon prediction, DDIM sampling): channels 320 x (1, 2, 4),
2 res-blocks a level, transformer depth (1, 2, 10) with level 0
attention-free (its ``attn`` entries are ``None``), cross-attention to
the 2048-d context, GroupNorm(32), SiLU; the time and pooled "add"
embeddings enter each res-block as a scale and shift.

Params are the reference's nested dicts with one layout change: a conv
weight is OIHW.  Repeated homogeneous blocks (flux's double and single
stacks, a spatial transformer's blocks) stay stacked on a leading axis,
as the reference scans them; here a Python loop runs over their
``unbind`` slices, and with ``cfg.remat`` and grad enabled each block is
recomputed in the backward (non-reentrant ``torch.utils.checkpoint``),
where the reference wraps the scan body in ``jax.checkpoint``.  The
reference's ``constrain(...)`` sharding hints are the identity on one
device and are left out (``repro_torch.distributed.sharding.constrain``
is the identity until the multi-device path gives it meaning).

The public functions take and return channel-last latents ``(B, R, R,
C)``, as the reference does.  The UNet runs on the NCHW view inside:
the res-block's scale and shift broadcast as ``[:, :, None, None]`` and
split on the channel axis, a skip is concatenated on channels (``x``
first), and a spatial transformer reads its tokens ``(b, h * w, c)`` in
row-major ``(h, w)`` order through a ``permute`` before the ``reshape``.

Attention is the reference's plain ``_mha`` (float32 scores, softmax and
values, then the compute dtype): the reference's diffusion models reach
no Pallas kernel, so the port launches none here.

The training losses draw their timesteps and noise through
:func:`diffusion_draws`, from a ``torch.Generator`` seeded by the batch's
``seed`` and the train step, where the reference draws them from
``jax.random.fold_in(PRNGKey(seed), step)``; the draws differ between the
packages, so parity tests feed both the reference's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.transformer import _leaf_to_torch, _remat
from repro_torch.models.vision import _nchw, _nhwc, _unstack

Tensor = torch.Tensor
Params = dict


# ==========================================================================
# shared helpers
# ==========================================================================


def _mha(q: Tensor, k: Tensor, v: Tensor, n_heads: int,
         policy: L.DtypePolicy) -> Tensor:
    """Full attention, (B, Sq, D) x (B, Skv, D): the scores, the softmax
    and the values in float32, the result cast to the compute dtype."""
    b, sq, d = q.shape
    dh = d // n_heads
    qh = q.reshape(b, sq, n_heads, dh)
    kh = k.reshape(b, k.shape[1], n_heads, dh)
    vh = v.reshape(b, v.shape[1], n_heads, dh)
    att = torch.einsum("bqhd,bkhd->bhqk", qh.to(torch.float32),
                       kh.to(torch.float32)) * (dh ** -0.5)
    att = torch.softmax(att, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", att, vh.to(torch.float32))
    return out.to(policy.compute_dtype).reshape(b, sq, d)


def axial_2d_sincos(h: int, w: int, d: int,
                    device: str | torch.device = "cpu") -> Tensor:
    """(h*w, d) fixed 2D sin-cos position embedding, h-major: the first
    half of each row encodes the row index, the second the column."""
    def one_axis(n, dim):
        pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
        expo = -math.log(10000.0) * torch.arange(
            dim // 2, dtype=torch.float32, device=device)
        freq = torch.exp(expo / torch.tensor(float(dim // 2), device=device))
        ang = pos * freq[None]
        return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)

    dh = d // 2
    em_h = one_axis(h, dh)  # (h, dh)
    em_w = one_axis(w, d - dh)
    return torch.cat([em_h.repeat_interleave(w, dim=0), em_w.repeat(h, 1)],
                     dim=-1)


def _modulate(x: Tensor, shift: Tensor, scale: Tensor) -> Tensor:
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def _rmsnorm(x: Tensor) -> Tensor:
    """RMSNorm over the last axis with a unit scale (the reference's
    ``rmsnorm({"scale": ones}, x)``)."""
    return L.rmsnorm({"scale": x.new_ones(x.shape[-1])}, x)


# ==========================================================================
# MMDiT / flux-dev
# ==========================================================================


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    name: str
    latent_res: int
    latent_ch: int = 16
    patch: int = 2
    d_model: int = 3072
    n_heads: int = 24
    n_double_blocks: int = 19
    n_single_blocks: int = 38
    d_ctx: int = 4096
    n_ctx_tokens: int = 512
    d_pooled: int = 768
    mlp_ratio: int = 4
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    remat: bool = True

    @property
    def policy(self) -> L.DtypePolicy:
        return L.DtypePolicy(self.param_dtype, self.compute_dtype)

    @property
    def n_params(self) -> int:
        d = self.d_model
        f = d * self.mlp_ratio
        dbl = 2 * (4 * d * d + 2 * d * f + 6 * d * d)  # qkv+o, mlp, 6 mods
        sgl = 4 * d * d + 2 * d * f + 3 * d * d
        patch_d = self.patch * self.patch * self.latent_ch
        return (self.n_double_blocks * dbl + self.n_single_blocks * sgl
                + patch_d * d * 2 + self.d_ctx * d + self.d_pooled * d
                + 256 * d)


def _adaln_init(shape_lead: tuple, d: int, n_mods: int, dt, device
                ) -> Params:
    """AdaLN-Zero modulation: weight and bias zero."""
    return {"w": torch.zeros(shape_lead + (d, n_mods * d), dtype=dt,
                             device=device),
            "b": torch.zeros(shape_lead + (n_mods * d,), dtype=dt,
                             device=device)}


def mmdit_init(gen: torch.Generator, cfg: MMDiTConfig,
               device: str | torch.device | None = None) -> Params:
    """Random parameters in the reference's layout, drawn from ``gen``
    with the reference's distributions (every ``mod`` and ``final_mod``
    zero), on ``device`` (the card unless the caller names another).
    The double and single blocks are drawn stacked, one leaf at a time."""
    device = resolve_device(device)
    dt = cfg.param_dtype
    d = cfg.d_model
    f = d * cfg.mlp_ratio
    s = (1.0 / d) ** 0.5
    patch_d = cfg.patch * cfg.patch * cfg.latent_ch

    def su(n, shape, scale):
        return L._uniform_init(gen, (n,) + shape, scale, dt, device)

    def stream(n):
        return {"mod": _adaln_init((n,), d, 6, dt, device),
                "wqkv": su(n, (d, 3 * d), s),
                "wo": su(n, (d, d), s),
                "w1": su(n, (d, f), s),
                "w2": su(n, (f, d), (1.0 / f) ** 0.5)}

    nd, ns = cfg.n_double_blocks, cfg.n_single_blocks

    def dense(d_in, d_out):
        return L.init_dense(gen, d_in, d_out, dtype=dt, device=device)

    return {
        "img_in": dense(patch_d, d),
        "txt_in": dense(cfg.d_ctx, d),
        "time_mlp1": dense(256, d),
        "time_mlp2": dense(d, d),
        "pooled_in": dense(cfg.d_pooled, d),
        "guidance_mlp": dense(256, d),
        "double": {"img": stream(nd), "txt": stream(nd)},
        "single": {"mod": _adaln_init((ns,), d, 3, dt, device),
                   "wqkv": su(ns, (d, 3 * d), s),
                   "w1": su(ns, (d, f), s),
                   "wo2": su(ns, (d + f, d), (1.0 / (d + f)) ** 0.5)},
        "final_mod": _adaln_init((), d, 2, dt, device),
        "img_out": dense(d, patch_d),
    }


def perturb_modulation(params: Params, gen: torch.Generator) -> Params:
    """``params`` with every ``mod`` and ``final_mod`` weight and bias
    drawn from ``gen``, uniform in +-sqrt(1 / d_model) (as the other
    dense leaves), in place of the zeros of AdaLN-Zero.

    At init every gate is 0, so the blocks add nothing and their weights'
    gradients are 0: a check of the blocks (a parity test, a precision
    policy's) runs on these params, where a broken block shows."""
    d = params["img_in"]["w"].shape[1]

    def draw(m):
        return {k: L._uniform_init(gen, tuple(v.shape), (1.0 / d) ** 0.5,
                                   v.dtype, v.device) for k, v in m.items()}

    return {**params,
            "double": {k: {**v, "mod": draw(v["mod"])}
                       for k, v in params["double"].items()},
            "single": {**params["single"],
                       "mod": draw(params["single"]["mod"])},
            "final_mod": draw(params["final_mod"])}


def _double_block(img: Tensor, txt: Tensor, lp: Params, vec: Tensor,
                  n_heads: int, pol: L.DtypePolicy) -> tuple[Tensor, Tensor]:
    b, n_txt, d = txt.shape

    def stream_qkv(sp, x):
        mods = L.dense(sp["mod"], vec, pol).reshape(b, 6, d)
        h = _modulate(_rmsnorm(x), mods[:, 0], mods[:, 1])
        return L.dense({"w": sp["wqkv"]}, h, pol), mods

    qkv_i, mod_i = stream_qkv(lp["img"], img)
    qkv_t, mod_t = stream_qkv(lp["txt"], txt)
    qkv = torch.cat([qkv_t, qkv_i], dim=1)  # txt first (flux order)
    q, k, v = qkv.chunk(3, dim=-1)
    att = _mha(q, k, v, n_heads, pol)
    att_t, att_i = att[:, :n_txt], att[:, n_txt:]

    def stream_out(sp, x, att, mods):
        x = x + mods[:, 2][:, None] * L.dense({"w": sp["wo"]}, att, pol)
        h = _modulate(_rmsnorm(x), mods[:, 3], mods[:, 4])
        h = L.gelu(L.dense({"w": sp["w1"]}, h, pol))
        h = L.dense({"w": sp["w2"]}, h, pol)
        return x + mods[:, 5][:, None] * h

    return (stream_out(lp["img"], img, att_i, mod_i),
            stream_out(lp["txt"], txt, att_t, mod_t))


def _single_block(x: Tensor, lp: Params, vec: Tensor, n_heads: int,
                  pol: L.DtypePolicy) -> Tensor:
    b, _, d = x.shape
    mods = L.dense(lp["mod"], vec, pol).reshape(b, 3, d)
    h = _modulate(_rmsnorm(x), mods[:, 0], mods[:, 1])
    q, k, v = L.dense({"w": lp["wqkv"]}, h, pol).chunk(3, dim=-1)
    att = _mha(q, k, v, n_heads, pol)
    mlp_h = L.gelu(L.dense({"w": lp["w1"]}, h, pol))
    fused = torch.cat([att, mlp_h], dim=-1)
    return x + mods[:, 2][:, None] * L.dense({"w": lp["wo2"]}, fused, pol)


def mmdit_apply(params: Params, latents: Tensor, t: Tensor, ctx: Tensor,
                pooled: Tensor, guidance: Tensor, cfg: MMDiTConfig
                ) -> Tensor:
    """Predict the rectified-flow velocity field.

    latents: (B, R, R, C); t/guidance: (B,); ctx: (B, T, d_ctx);
    pooled: (B, d_pooled).  Returns float32 (B, R, R, C)."""
    pol = cfg.policy
    cd = pol.compute_dtype
    b, r, _, c = latents.shape
    p = cfg.patch
    hp = r // p
    d = cfg.d_model

    # patchify
    x = latents.reshape(b, hp, p, hp, p, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, hp * hp, p * p * c)
    img = L.dense(params["img_in"], x, pol)
    img = img + axial_2d_sincos(hp, hp, d, latents.device)[None].to(cd)
    txt = L.dense(params["txt_in"], ctx, pol)

    # modulation vector
    temb = L.timestep_embedding(t * 1000.0, 256)
    vec = L.dense(params["time_mlp2"], L.silu(
        L.dense(params["time_mlp1"], temb.to(cd), pol)), pol)
    vec = vec + L.dense(params["pooled_in"], pooled.to(cd), pol)
    gemb = L.timestep_embedding(guidance * 1000.0, 256)
    vec = vec + L.dense(params["guidance_mlp"], gemb.to(cd), pol)
    vec = L.silu(vec)

    n_txt = txt.shape[1]
    for lp in _unstack(params["double"]):
        img, txt = _remat(cfg.remat, _double_block, img, txt, lp, vec,
                          cfg.n_heads, pol)
    fused = torch.cat([txt, img], dim=1)
    for lp in _unstack(params["single"]):
        fused = _remat(cfg.remat, _single_block, fused, lp, vec, cfg.n_heads,
                       pol)
    img = fused[:, n_txt:]

    mods = L.dense(params["final_mod"], vec, pol).reshape(b, 2, d)
    img = _modulate(_rmsnorm(img), mods[:, 0], mods[:, 1])
    out = L.dense(params["img_out"], img, pol)
    out = out.reshape(b, hp, hp, p, p, c).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(b, r, r, c).to(torch.float32)


def diffusion_draws(batch: dict, step) -> tuple[Tensor, Tensor]:
    """A train step's random draws: ``u`` (B,) uniform in [0, 1) and
    ``eps`` standard normal like ``batch["latents"]``, on its device.

    They come from a CPU ``torch.Generator`` seeded by ``(batch["seed"],
    step)`` (mixed into the 32 bits it keeps by numpy's
    ``SeedSequence``), so a step repeats bit for bit on every device and
    two steps differ.  Both are host integers: a Python or numpy int is
    taken as it is, a 0-d tensor is read to the host (which a fake
    tensor cannot be: the launch layer's cells pass ints).  The reference draws the same kinds from
    ``jax.random.fold_in(PRNGKey(seed), step)`` (other bits: the parity
    tests substitute the reference's draws for this function)."""
    x0 = batch["latents"]
    mixed = np.random.SeedSequence([int(batch["seed"]), int(step)])
    gen = torch.Generator().manual_seed(int(mixed.generate_state(1)[0]))
    u = torch.rand((x0.shape[0],), generator=gen, dtype=torch.float32)
    eps = torch.randn(tuple(x0.shape), generator=gen, dtype=x0.dtype)
    return u.to(x0.device), eps.to(x0.device)


def flux_rf_loss(params: Params, batch: dict, cfg: MMDiTConfig, step
                 ) -> Tensor:
    """Rectified-flow training loss: x_t = (1-t) x0 + t eps, v* = eps - x0,
    with ``t`` and ``eps`` from :func:`diffusion_draws` at ``step``."""
    x0 = batch["latents"]
    b = x0.shape[0]
    t, eps = diffusion_draws(batch, step)
    tb = t[:, None, None, None]
    xt = (1.0 - tb) * x0 + tb * eps
    guidance = batch.get("guidance")
    if guidance is None:
        guidance = torch.zeros((b,), dtype=torch.float32, device=x0.device)
    v = mmdit_apply(params, xt, t, batch["ctx"], batch["pooled"], guidance,
                    cfg)
    return torch.mean((v - (eps - x0).to(torch.float32)) ** 2)


def flux_euler_step(params: Params, xt: Tensor, t: Tensor, dt: Tensor,
                    ctx: Tensor, pooled: Tensor, guidance: Tensor,
                    cfg: MMDiTConfig) -> Tensor:
    """One Euler step of the rectified-flow ODE (a ``steps``-step sampler
    calls this ``steps`` times)."""
    v = mmdit_apply(params, xt, t, ctx, pooled, guidance, cfg)
    return xt - dt[:, None, None, None] * v.to(xt.dtype)


# ==========================================================================
# UNet / SDXL
# ==========================================================================


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    name: str
    latent_res: int
    latent_ch: int = 4
    ch: int = 320
    ch_mult: Sequence[int] = (1, 2, 4)
    n_res_blocks: int = 2
    transformer_depth: Sequence[int] = (1, 2, 10)
    ctx_dim: int = 2048
    n_ctx_tokens: int = 77
    d_add: int = 2816  # pooled text (1280) + 6 x 256 size conds
    head_dim: int = 64
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    remat: bool = True

    @property
    def policy(self) -> L.DtypePolicy:
        return L.DtypePolicy(self.param_dtype, self.compute_dtype)

    @property
    def time_dim(self) -> int:
        return self.ch * 4

    @property
    def n_params(self) -> int:
        # close-form count is messy; computed from the real tree at init.
        return -1


def _resblock_init(gen, c_in, c_out, time_dim, dt, device) -> Params:
    p = {
        "gn1": L.init_groupnorm(c_in, dtype=dt, device=device),
        "conv1": L.init_conv(gen, 3, 3, c_in, c_out, dtype=dt, device=device),
        "emb": L.init_dense(gen, time_dim, 2 * c_out, dtype=dt,
                            device=device),
        "gn2": L.init_groupnorm(c_out, dtype=dt, device=device),
        "conv2": L.init_conv(gen, 3, 3, c_out, c_out, dtype=dt,
                             device=device),
    }
    if c_in != c_out:
        p["skip"] = L.init_conv(gen, 1, 1, c_in, c_out, dtype=dt,
                                device=device)
    return p


def _resblock_apply(p: Params, x: Tensor, emb: Tensor,
                    pol: L.DtypePolicy) -> Tensor:
    """A res-block on NCHW ``x``, the embedding's scale and shift
    broadcast over the spatial axes."""
    h = L.conv2d(p["conv1"], L.silu(L.groupnorm(p["gn1"], x)), policy=pol)
    scale_shift = L.dense(p["emb"], L.silu(emb), pol)[:, :, None, None]
    scale, shift = scale_shift.chunk(2, dim=1)
    h = L.groupnorm(p["gn2"], h) * (1 + scale) + shift
    h = L.conv2d(p["conv2"], L.silu(h), policy=pol)
    skip = L.conv2d(p["skip"], x, policy=pol) if "skip" in p else x
    return skip + h


def _xformer_blocks_init(gen, depth: int, d: int, ctx_dim: int, dt,
                         device) -> Params:
    """``depth`` transformer blocks, drawn stacked on a leading axis."""
    s = (1.0 / d) ** 0.5
    sc = (1.0 / ctx_dim) ** 0.5

    def su(shape, scale):
        return L._uniform_init(gen, (depth,) + shape, scale, dt, device)

    def ln():
        return {"scale": torch.ones((depth, d), dtype=dt, device=device),
                "bias": torch.zeros((depth, d), dtype=dt, device=device)}

    return {
        "ln1": ln(),
        "wq1": {"w": su((d, d), s)},
        "wkv1": {"w": su((d, 2 * d), s)},
        "wo1": {"w": su((d, d), s)},
        "ln2": ln(),
        "wq2": {"w": su((d, d), s)},
        "wkv2": {"w": su((ctx_dim, 2 * d), sc)},
        "wo2": {"w": su((d, d), s)},
        "ln3": ln(),
        # GEGLU: 2 x 4d
        "ff1": {"w": su((d, 8 * d), s),
                "b": torch.zeros((depth, 8 * d), dtype=dt, device=device)},
        "ff2": {"w": su((4 * d, d), (1.0 / (4 * d)) ** 0.5),
                "b": torch.zeros((depth, d), dtype=dt, device=device)},
    }


def _xformer_block_apply(p: Params, x: Tensor, ctx: Tensor, n_heads: int,
                         pol: L.DtypePolicy) -> Tensor:
    """Self-attention, cross-attention to ``ctx``, then GEGLU, on tokens
    ``x`` (b, n, d)."""
    h = L.layernorm(p["ln1"], x)
    q = L.dense(p["wq1"], h, pol)
    k, v = L.dense(p["wkv1"], h, pol).chunk(2, dim=-1)
    x = x + L.dense(p["wo1"], _mha(q, k, v, n_heads, pol), pol)
    h = L.layernorm(p["ln2"], x)
    q = L.dense(p["wq2"], h, pol)
    k, v = L.dense(p["wkv2"], ctx, pol).chunk(2, dim=-1)
    x = x + L.dense(p["wo2"], _mha(q, k, v, n_heads, pol), pol)
    h = L.layernorm(p["ln3"], x)
    a, g = L.dense(p["ff1"], h, pol).chunk(2, dim=-1)
    return x + L.dense(p["ff2"], a * L.gelu(g), pol)


def _spatial_xformer_init(gen, c, ctx_dim, depth, dt, device) -> Params:
    return {
        "gn": L.init_groupnorm(c, dtype=dt, device=device),
        "proj_in": L.init_dense(gen, c, c, dtype=dt, device=device),
        "blocks": _xformer_blocks_init(gen, depth, c, ctx_dim, dt, device),
        "proj_out": L.init_dense(gen, c, c, dtype=dt, device=device),
    }


def _spatial_xformer_apply(p: Params, x: Tensor, ctx: Tensor,
                           cfg: UNetConfig, pol: L.DtypePolicy) -> Tensor:
    """A spatial transformer on NCHW ``x``: its tokens are the pixels in
    row-major ``(h, w)`` order."""
    b, c, h, w = x.shape
    n_heads = c // cfg.head_dim
    y = L.groupnorm(p["gn"], x).permute(0, 2, 3, 1).reshape(b, h * w, c)
    y = L.dense(p["proj_in"], y, pol)
    for bp in _unstack(p["blocks"]):
        y = _remat(cfg.remat, _xformer_block_apply, bp, y, ctx, n_heads, pol)
    y = L.dense(p["proj_out"], y, pol)
    return x + y.reshape(b, h, w, c).permute(0, 3, 1, 2)


def unet_init(gen: torch.Generator, cfg: UNetConfig,
              device: str | torch.device | None = None) -> Params:
    """Random parameters in the reference's layout (level 0's ``attn``
    entries ``None``, the last level's ``down`` and the first up level's
    ``up`` ``None``), on ``device`` (the card unless the caller names
    another)."""
    device = resolve_device(device)
    dt = cfg.param_dtype
    td = cfg.time_dim

    def dense(d_in, d_out):
        return L.init_dense(gen, d_in, d_out, dtype=dt, device=device)

    def conv3(c_in, c_out):
        return L.init_conv(gen, 3, 3, c_in, c_out, dtype=dt, device=device)

    def attn(li, c):
        if li == 0:
            return None
        return _spatial_xformer_init(gen, c, cfg.ctx_dim,
                                     cfg.transformer_depth[li], dt, device)

    chans = [cfg.ch * m for m in cfg.ch_mult]
    p: Params = {
        "conv_in": conv3(cfg.latent_ch, cfg.ch),
        "time1": dense(cfg.ch, td),
        "time2": dense(td, td),
        "add1": dense(cfg.d_add, td),
        "add2": dense(td, td),
        "down": [], "up": [],
    }
    # --- down path ---
    c_prev = cfg.ch
    skips = [cfg.ch]
    for li, c in enumerate(chans):
        level = {"res": [], "attn": [], "down": None}
        for _ in range(cfg.n_res_blocks):
            level["res"].append(_resblock_init(gen, c_prev, c, td, dt,
                                               device))
            level["attn"].append(attn(li, c))
            c_prev = c
            skips.append(c)
        if li < len(chans) - 1:
            level["down"] = conv3(c, c)
            skips.append(c)
        p["down"].append(level)
    # --- mid ---
    p["mid"] = {
        "res1": _resblock_init(gen, c_prev, c_prev, td, dt, device),
        "attn": _spatial_xformer_init(gen, c_prev, cfg.ctx_dim,
                                      cfg.transformer_depth[-1], dt, device),
        "res2": _resblock_init(gen, c_prev, c_prev, td, dt, device),
    }
    # --- up path ---
    for li in reversed(range(len(chans))):
        c = chans[li]
        level = {"res": [], "attn": [], "up": None}
        for _ in range(cfg.n_res_blocks + 1):
            c_skip = skips.pop()
            level["res"].append(_resblock_init(gen, c_prev + c_skip, c, td,
                                               dt, device))
            level["attn"].append(attn(li, c))
            c_prev = c
        if li > 0:
            level["up"] = conv3(c, c)
        p["up"].append(level)
    p["gn_out"] = L.init_groupnorm(cfg.ch, dtype=dt, device=device)
    p["conv_out"] = conv3(cfg.ch, cfg.latent_ch)
    return p


def unet_apply(params: Params, latents: Tensor, t: Tensor, ctx: Tensor,
               add_emb: Tensor, cfg: UNetConfig) -> Tensor:
    """Predict epsilon.  latents: (B, R, R, C); t: (B,) in [0, 1000);
    ctx: (B, 77, 2048); add_emb: (B, d_add).  Returns float32 (B, R, R,
    C)."""
    pol = cfg.policy
    cd = pol.compute_dtype
    temb = L.timestep_embedding(t, cfg.ch).to(cd)
    emb = L.dense(params["time2"],
                  L.silu(L.dense(params["time1"], temb, pol)), pol)
    emb = emb + L.dense(params["add2"], L.silu(
        L.dense(params["add1"], add_emb.to(cd), pol)), pol)

    x = L.conv2d(params["conv_in"], _nchw(latents), policy=pol)
    skips = [x]
    for level in params["down"]:
        for rb, at in zip(level["res"], level["attn"]):
            x = _resblock_apply(rb, x, emb, pol)
            if at is not None:
                x = _spatial_xformer_apply(at, x, ctx, cfg, pol)
            skips.append(x)
        if level["down"] is not None:
            x = L.conv2d(level["down"], x, stride=2, policy=pol)
            skips.append(x)

    x = _resblock_apply(params["mid"]["res1"], x, emb, pol)
    x = _spatial_xformer_apply(params["mid"]["attn"], x, ctx, cfg, pol)
    x = _resblock_apply(params["mid"]["res2"], x, emb, pol)

    for level in params["up"]:
        for rb, at in zip(level["res"], level["attn"]):
            x = torch.cat([x, skips.pop()], dim=1)
            x = _resblock_apply(rb, x, emb, pol)
            if at is not None:
                x = _spatial_xformer_apply(at, x, ctx, cfg, pol)
        if level["up"] is not None:
            x = L.conv2d(level["up"], L.upsample_nearest(x, 2), policy=pol)

    x = L.silu(L.groupnorm(params["gn_out"], x))
    return _nhwc(L.conv2d(params["conv_out"], x, policy=pol)).to(
        torch.float32)


def _abar(t: Tensor) -> Tensor:
    """The cosine schedule's cumulative alpha at ``t`` in [0, 1000)."""
    return torch.cos((t / 1000.0 + 0.008) / 1.008 * (math.pi / 2)) ** 2


def unet_eps_loss(params: Params, batch: dict, cfg: UNetConfig, step
                  ) -> Tensor:
    """DDPM epsilon-prediction MSE with a cosine schedule, with ``t`` and
    ``eps`` from :func:`diffusion_draws` at ``step``."""
    x0 = batch["latents"]
    u, eps = diffusion_draws(batch, step)
    t = u * 999.0
    abar = _abar(t)
    sq_a = torch.sqrt(abar)[:, None, None, None]
    sq_1a = torch.sqrt(1.0 - abar)[:, None, None, None]
    xt = sq_a * x0 + sq_1a * eps
    pred = unet_apply(params, xt, t, batch["ctx"], batch["add_emb"], cfg)
    return torch.mean((pred - eps.to(torch.float32)) ** 2)


def unet_ddim_step(params: Params, xt: Tensor, t: Tensor, t_prev: Tensor,
                   ctx: Tensor, add_emb: Tensor, cfg: UNetConfig) -> Tensor:
    """One DDIM step (eta = 0)."""
    a_t = _abar(t)[:, None, None, None]
    a_p = _abar(t_prev)[:, None, None, None]
    eps = unet_apply(params, xt, t, ctx, add_emb, cfg).to(xt.dtype)
    x0 = (xt - torch.sqrt(1 - a_t) * eps) / torch.sqrt(a_t)
    return torch.sqrt(a_p) * x0 + torch.sqrt(1 - a_p) * eps


# ==========================================================================
# dispatch and conversion
# ==========================================================================

_INIT = {MMDiTConfig: mmdit_init, UNetConfig: unet_init}


def init_params(gen: torch.Generator, cfg,
                device: str | torch.device | None = None) -> Params:
    """The init of ``cfg``'s family (MMDiT or UNet)."""
    return _INIT[type(cfg)](gen, cfg, device)


def from_jax_config(cfg):
    """The reference's diffusion config -> the port's (dtypes by name)."""
    cls = {c.__name__: c for c in _INIT}[type(cfg).__name__]
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cls)}
    for f in ("param_dtype", "compute_dtype"):
        kw[f] = getattr(torch, np.dtype(kw[f]).name)
    return cls(**kw)


# the keys whose ``"w"`` is a convolution's kernel: the UNet's stem and
# head, a res-block's two convs and its 1x1 skip, a level's stride-2
# ``down`` conv and its ``up`` conv
CONV_KEYS = frozenset({"conv_in", "conv1", "conv2", "skip", "down", "up",
                       "conv_out"})


def from_jax_params(tree, device: str | torch.device | None = None
                    ) -> Params:
    """The reference's MMDiT or UNet parameter pytree, as numpy arrays, ->
    the port's on ``device`` (the card unless the caller names another).

    A ``"w"`` under a key of :data:`CONV_KEYS` is a conv kernel and goes
    from HWIO to OIHW (it must be 4-D); ``None`` stays ``None``; every
    other leaf (dense weights, stacked leaves) is copied as it is,
    bfloat16 bit for bit."""
    device = resolve_device(device)

    def copy(t, parent):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: copy(v, k) if k != "w" or parent not in CONV_KEYS
                    else conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [copy(v, parent) for v in t]
        return _leaf_to_torch(t, device)

    def conv(w):
        w = _leaf_to_torch(w, device)
        if w.dim() != 4:
            raise ValueError(f"a conv kernel of shape {tuple(w.shape)}")
        return w.permute(3, 2, 0, 1).contiguous()

    return copy(tree, None)
