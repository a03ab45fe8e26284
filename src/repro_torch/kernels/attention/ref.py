"""Plain PyTorch versions of the flash-attention kernels (ports of
``repro/kernels/attention/ref.py`` ``mha_ref`` and
``repro/kernels/attention/ops.py`` ``flash_attention_ref``), and an
emulation of the tensor-core kernel's arithmetic
(:func:`flash_attention_tiled_ref`).

They materialise ``(Sq, Skv)`` (or ``(Sq, BLOCK_K)``) score matrices in
float32: fine at test shapes and for checking the kernels on the card,
never used by a kernel's path on a card.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor
NEG_INF = -1e30  # the reference's masked logit
BLOCK_K = 128  # keys a K/V tile of csrc/attention_wgmma.cu (kBK)


def mha_ref(q: Tensor, k: Tensor, v: Tensor, *, scale: float,
            causal: bool = False, window: int | None = None,
            q_offset: int = 0) -> Tensor:
    """(BH, Sq, D) x (BH, Skv, D) x (BH, Skv, D) -> (BH, Sq, D) in q's
    dtype.  Rows with every key masked give 0, not NaN."""
    sq, skv = q.shape[1], k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask[None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask[None], p, torch.zeros((), device=q.device))
    return torch.einsum("bqk,bkd->bqd", p, v.to(torch.float32)).to(q.dtype)


def flash_attention_ref(q: Tensor, k: Tensor, v: Tensor, *,
                        causal: bool = True, window: int | None = None,
                        q_offset: int = 0, scale: float | None = None
                        ) -> Tensor:
    """The kernel's function with its (B, S, H, D) GQA interface:
    q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D) -> (B, Sq, Hq, D)."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    rep = hq // hkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)

    def fold(x):
        return x.transpose(1, 2).reshape(b * hq, x.shape[1], d)

    out = mha_ref(fold(q), fold(k), fold(v), scale=scale, causal=causal,
                  window=window, q_offset=q_offset)
    return out.reshape(b, hq, sq, d).transpose(1, 2)


def flash_attention_tiled_ref(q: Tensor, k: Tensor, v: Tensor, *,
                              causal: bool = True, window: int | None = None,
                              q_offset: int = 0, scale: float | None = None,
                              split_p: bool = True) -> Tensor:
    """The tensor-core kernel's arithmetic in plain PyTorch, for bf16 q,
    k, v: an online softmax over ``BLOCK_K``-key tiles with float32
    scores, running max, denominator and accumulator, and the value
    product on bf16 operands with float32 sums.  With ``split_p`` the
    probabilities enter it as ``P_hi``, p truncated to bf16, plus
    ``P_lo = bf16(p - P_hi)``, as the kernel does; without, rounded once
    to bf16 (the rounding the kernel avoids).  The denominator sums the
    unrounded p.  Same interface as :func:`flash_attention_ref`."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    rep = hq // hkv
    qf = q.float().transpose(1, 2)  # (B, Hq, Sq, D)
    kf = k.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, hq, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, hq, sq), device=q.device)
    acc = torch.zeros((b, hq, sq, d), device=q.device)
    for j0 in range(0, skv, BLOCK_K):
        kb, vb = kf[:, :, j0:j0 + BLOCK_K], vf[:, :, j0:j0 + BLOCK_K]
        kpos = j0 + torch.arange(kb.shape[2], device=q.device)[None, :]
        mask = torch.ones((sq, kb.shape[2]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb) * scale
        s = s.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None]).masked_fill(~mask, 0.0)
        l = l * alpha + p.sum(dim=-1)
        if split_p:
            hi = (p.view(torch.int32) & -65536).view(torch.float32)
            pv = hi @ vb + (p - hi).to(torch.bfloat16).float() @ vb
        else:
            pv = p.to(torch.bfloat16).float() @ vb
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)
