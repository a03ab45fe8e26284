"""Vision building blocks (port of the part of ``repro.models.vision``
that the action head uses).

Only :func:`_mha_full`, the full (unmasked) multi-head self-attention of
the ViT block, is ported here; ``repro.models.action`` runs it over a
clip's frame embeddings.  The ViT, ConvNeXt and ResNet backbones of the
reference module come with the vision models' slice of the port.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as L

Tensor = torch.Tensor


def _mha_full(x: Tensor, wqkv: Tensor, wo: Tensor, n_heads: int,
              policy: L.DtypePolicy) -> Tensor:
    """Self-attention of ``x`` (B, S, D) through the fused ``wqkv``
    (D, 3D), split in the reference's ``(b, s, 3, h, dh)`` order; the
    scores and the softmax in float32, then ``wo``."""
    b, s, d = x.shape
    dh = d // n_heads
    qkv = L.dense({"w": wqkv}, x, policy).reshape(b, s, 3, n_heads, dh)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    att = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                       k.to(torch.float32)) * (dh ** -0.5)
    att = torch.softmax(att, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", att, v.to(torch.float32))
    out = out.to(policy.compute_dtype).reshape(b, s, d)
    return L.dense({"w": wo}, out, policy)
