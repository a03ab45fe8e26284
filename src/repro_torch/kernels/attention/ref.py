"""Plain PyTorch versions of the flash-attention kernels (ports of
``repro/kernels/attention/ref.py`` ``mha_ref`` and
``repro/kernels/attention/ops.py`` ``flash_attention_ref``), and
emulations of the kernels' arithmetic: the tensor-core kernel's
(:func:`flash_attention_tiled_ref`) and the float32 kernel's, with the
plan by which it splits a row tile's keys (:func:`kv_band`,
:func:`split_factor`, :func:`flash_attention_split_ref`).

They materialise ``(Sq, Skv)`` (or ``(Sq, BLOCK_K)``) score matrices in
float32: fine at test shapes and for checking the kernels on the card,
never used by a kernel's path on a card.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor
NEG_INF = -1e30  # the reference's masked logit
BLOCK_K = 128  # keys a K/V tile of csrc/attention_wgmma.cu (kBK)
# csrc/attention.cu: query rows a CTA (kBQ), keys a K/V tile (kBK), CTAs
# that may share a row tile (kMaxSplit)
SIMT_BLOCK_Q = SIMT_BLOCK_K = 64
SIMT_MAX_SPLIT = 8
H100_SMS = 132
LOG2E = 1.4426950408889634


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


def kv_band(i0: int, sq: int, skv: int, *, causal: bool,
            window: int | None, q_offset: int) -> tuple[int, int]:
    """The K/V tiles ``[begin, end)`` of ``SIMT_BLOCK_K`` keys that can
    hold an unmasked key for the ``SIMT_BLOCK_Q`` query rows from ``i0``
    (``attention.cu``'s ``kv_band``)."""
    q_lo = q_offset + i0
    q_hi = q_offset + min(i0 + SIMT_BLOCK_Q, sq) - 1
    n_kt = -(-skv // SIMT_BLOCK_K)
    end = n_kt
    if causal:
        end = 0 if q_hi < 0 else min(min(q_hi, skv - 1) // SIMT_BLOCK_K + 1,
                                     n_kt)
    begin = max(0, q_lo - (window - 1)) // SIMT_BLOCK_K if window else 0
    return min(begin, end), end


def split_factor(b: int, sq: int, skv: int, hq: int, *, causal: bool,
                 window: int | None, q_offset: int, n_sm: int = H100_SMS
                 ) -> int:
    """The CTAs that share each row tile (``attention.cu``'s
    ``choose_split``): the longest band is split in two until one CTA's
    share is at most half an SM's mean load, up to ``SIMT_MAX_SPLIT``."""
    bands = [kv_band(i0, sq, skv, causal=causal, window=window,
                     q_offset=q_offset)
             for i0 in range(0, sq, SIMT_BLOCK_Q)]
    total = sum(e - s for s, e in bands) * b * hq
    most = max(e - s for s, e in bands)
    split = 1
    while (split < SIMT_MAX_SPLIT and 2 * split <= most
           and -(-most // split) * 2 * n_sm > total):
        split *= 2
    return split


def flash_attention_split_ref(q: Tensor, k: Tensor, v: Tensor, *,
                              causal: bool = True, window: int | None = None,
                              q_offset: int = 0, scale: float | None = None,
                              split: int | None = None, rescale: bool = True
                              ) -> Tensor:
    """The float32 kernel's arithmetic in plain PyTorch (float32 math for
    float32 or bf16 inputs): each ``SIMT_BLOCK_Q``-row tile's band of
    ``SIMT_BLOCK_K``-key tiles dealt to ``split`` partial online softmaxes
    (tiles ``r``, ``r + split``, ...) in base 2 (scores times
    ``scale * log2(e)``, ``exp2``; a masked score is ``-inf``, the running
    max starts at -1e30), then the partials ``(m_r, l_r, acc_r)`` combined
    in rank order, each rescaled by ``exp2(m_r - m)``.  ``split=None``
    takes the kernel's choice on an H100 (:func:`split_factor`).  With
    ``rescale=False``, the control: partials added as they are.  Same
    interface as :func:`flash_attention_ref`."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if split is None:
        split = split_factor(b, sq, skv, hq, **kw)
    c2 = scale * LOG2E
    rep = hq // hkv
    qf = q.float().transpose(1, 2)  # (B, Hq, Sq, D)
    kf = k.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    out = torch.empty((b, hq, sq, d), device=q.device)
    for i0 in range(0, sq, SIMT_BLOCK_Q):
        qt = qf[:, :, i0:i0 + SIMT_BLOCK_Q]
        qpos = q_offset + i0 + torch.arange(qt.shape[2],
                                            device=q.device)[:, None]
        begin, end = kv_band(i0, sq, skv, **kw)
        parts = []
        for r in range(split):
            m = torch.full(qt.shape[:3], NEG_INF, device=q.device)
            l = torch.zeros(qt.shape[:3], device=q.device)
            acc = torch.zeros(qt.shape, device=q.device)
            for kt in range(begin + r, end, split):
                j0 = kt * SIMT_BLOCK_K
                kb = kf[:, :, j0:j0 + SIMT_BLOCK_K]
                kpos = j0 + torch.arange(kb.shape[2], device=q.device)[None]
                mask = torch.ones((qt.shape[2], kb.shape[2]),
                                  dtype=torch.bool, device=q.device)
                if causal:
                    mask &= kpos <= qpos
                if window is not None:
                    mask &= kpos > qpos - window
                s = torch.einsum("bhqd,bhkd->bhqk", qt, kb) * c2
                s = s.masked_fill(~mask, float("-inf"))
                m_new = torch.maximum(m, s.amax(dim=-1))
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new[..., None])
                l = l * alpha + p.sum(dim=-1)
                vb = vf[:, :, j0:j0 + SIMT_BLOCK_K]
                acc = acc * alpha[..., None] + p @ vb
                m = m_new
            parts.append((m, l, acc))
        mx = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        lsum = torch.zeros_like(mx)
        osum = torch.zeros_like(parts[0][2])
        for m, l, acc in parts:  # rank order
            w = torch.exp2(m - mx) if rescale else torch.ones_like(m)
            lsum = lsum + l * w
            osum = osum + acc * w[..., None]
        out[:, :, i0:i0 + SIMT_BLOCK_Q] = osum / torch.clamp(
            lsum, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)
