"""Plain PyTorch versions of the flash-attention kernel (ports of
``repro/kernels/attention/ref.py`` ``mha_ref`` and
``repro/kernels/attention/ops.py`` ``flash_attention_ref``).

They materialise the full ``(Sq, Skv)`` score matrix in float32: O(S^2)
memory, fine at test shapes and for checking the kernel on the card,
never used by the kernel's path on a card.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


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
