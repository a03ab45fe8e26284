"""The SphIoU kernel's arithmetic against the JAX package's SphIoU, on the
CPU.

``repro_torch/kernels/sphiou/csrc/sphiou.cu`` stages each box's constants
(theta, cos and sin of its latitude, half-FoVs, area) once a block,
computes both directions of a pair from one sine and cosine of
``dt = tb - ta`` (the reverse angle is ``-dt``: sine negated, cosine
kept) and one shared ``x``, and, on the self path, computes only the upper
32x32 tiles of each row's matrix and mirrors them.  ``_model`` below is
that scheme written in torch, test-only.  It is held to the reference
kernel (``repro.kernels.sphiou.ops.sphiou_matrix_batch``, in interpret
mode on the CPU) within its own 5e-6, and its bf16 form to the port's
bf16 plain version within 2^-6 (``test_torch_kernels.py`` says why).  The
inputs are seeded numpy draws, with zero-FoV padding rows.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sphiou import ops as jsph
from repro_torch.kernels.sphiou import ops as tsph
from repro_torch.kernels.sphiou.ref import sphiou_ref_batch_bf16

TILE = 32  # the kernel's tile edge (sphiou.cu kTile)
SHAPES = [(1, 1), (3, 37), (4, 128)]


def _boxes(b: int, n: int, seed: int) -> np.ndarray:
    """Detection-like rows: boxes around a few centres, the tail of each
    row zero-FoV padding, and row 0 all padding when b > 1."""
    rng = np.random.default_rng(seed)
    centers = np.stack([rng.uniform(-math.pi, math.pi, (b, 6)),
                        rng.uniform(-1.2, 1.2, (b, 6))], -1)
    pick = rng.integers(0, 6, (b, n))
    ctr = np.take_along_axis(centers, pick[..., None].repeat(2, -1), 1)
    boxes = np.concatenate([ctr + rng.normal(0, 0.1, (b, n, 2)),
                            rng.uniform(0.05, 1.2, (b, n, 2))], -1)
    valid = np.arange(n)[None] < rng.integers(n // 2 + 1, n + 1, (b, 1))
    if b > 1:
        valid[0] = False
    boxes[~valid] = 0.0
    return boxes.astype(np.float32)


def _rounder(bf16: bool):
    if bf16:
        return lambda t: t.to(torch.bfloat16).to(torch.float32)
    return lambda t: t


def _tables(boxes: torch.Tensor, bf16: bool) -> dict[str, torch.Tensor]:
    """Each box's constants, once (sphiou.cu box_consts)."""
    r = _rounder(bf16)
    t, p = r(boxes[..., 0]), r(boxes[..., 1])
    h, v = r(r(boxes[..., 2]) * 0.5), r(r(boxes[..., 3]) * 0.5)
    return dict(t=t, cp=r(torch.cos(p)), sp=r(torch.sin(p)), h=h, v=v,
                area=r(r(4.0 * h) * r(torch.sin(v))))


def _overlap(y, x, z, ha, va, hb, vb, r):
    """One direction's intersection, from B's centre in A's frame."""
    dlon = r(torch.atan2(y, x))
    dlat = r(torch.asin(torch.clamp(z, -1.0, 1.0)))
    lon_lo = torch.maximum(-ha, r(dlon - hb))
    lon_hi = torch.minimum(ha, r(dlon + hb))
    lat_lo = torch.maximum(-va, r(dlat - vb))
    lat_hi = torch.minimum(va, r(dlat + vb))
    lon_w = torch.clamp(r(lon_hi - lon_lo), min=0.0)
    lat_w = torch.where(lat_hi > lat_lo,
                        r(r(torch.sin(lat_hi)) - r(torch.sin(lat_lo))),
                        torch.zeros_like(lat_hi))
    return r(lon_w * torch.clamp(lat_w, min=0.0))


def _pair_iou(a: dict, b: dict, bf16: bool) -> torch.Tensor:
    """IoU of broadcast constant tables a and b from one sin and cos of
    dt, both directions (sphiou.cu pair_iou)."""
    r = _rounder(bf16)
    dt = r(b["t"] - a["t"])
    sdt, cdt = r(torch.sin(dt)), r(torch.cos(dt))
    x = r(r(r(a["cp"] * b["cp"]) * cdt) + r(a["sp"] * b["sp"]))
    ab = _overlap(r(b["cp"] * sdt), x,
                  r(r(r(-a["sp"] * b["cp"]) * cdt) + r(a["cp"] * b["sp"])),
                  a["h"], a["v"], b["h"], b["v"], r)
    ba = _overlap(r(a["cp"] * -sdt), x,
                  r(r(r(-b["sp"] * a["cp"]) * cdt) + r(b["cp"] * a["sp"])),
                  b["h"], b["v"], a["h"], a["v"], r)
    inter = r(0.5 * r(ab + ba))
    uni = r(r(a["area"] + b["area"]) - inter)
    return r(inter / torch.clamp(uni, min=float(r(torch.tensor(1e-12)))))


def _tile_of_block(k: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Upper tile (ti, tj) of self-path block k, as sphiou.cu computes it:
    tj from a float32 square root, then corrected."""
    k = np.asarray(k, np.int64)
    tj = ((np.sqrt(np.float32(8.0) * k.astype(np.float32) + np.float32(1.0))
           - np.float32(1.0)) * np.float32(0.5)).astype(np.int64)
    tj = np.where(tj * (tj + 1) // 2 > k, tj - 1, tj)
    tj = np.where((tj + 1) * (tj + 2) // 2 <= k, tj + 1, tj)
    return k - tj * (tj + 1) // 2, tj


def _model(a: torch.Tensor, b: torch.Tensor | None, bf16: bool
           ) -> torch.Tensor:
    """The kernel's scheme: the self path (``b is None``) computes the
    upper tiles only and mirrors them; the general path every pair."""
    ta = _tables(a, bf16)
    if b is not None:
        tb = _tables(b, bf16)
        return _pair_iou({k: v[:, :, None] for k, v in ta.items()},
                         {k: v[:, None, :] for k, v in tb.items()}, bf16)
    rows, n, _ = a.shape
    out = torch.full((rows, n, n), float("nan"))
    writes = torch.zeros((n, n), dtype=torch.int64)
    nt = -(-n // TILE)
    ti_all, tj_all = _tile_of_block(np.arange(nt * (nt + 1) // 2))
    for ti, tj in zip(ti_all.tolist(), tj_all.tolist()):
        i = torch.arange(ti * TILE, min(n, (ti + 1) * TILE))
        j = torch.arange(tj * TILE, min(n, (tj + 1) * TILE))
        v = _pair_iou({k: t[:, i, None] for k, t in ta.items()},
                      {k: t[:, None, j] for k, t in ta.items()}, bf16)
        upper = (j[None, :] >= i[:, None]) | (ti != tj)
        ii, jj = torch.nonzero(upper, as_tuple=True)
        out[:, i[ii], j[jj]] = v[:, ii, jj]
        writes[i[ii], j[jj]] += 1
        below = (j[None, :] > i[:, None]) | (ti != tj)
        ii, jj = torch.nonzero(below, as_tuple=True)
        out[:, j[jj], i[ii]] = v[:, ii, jj]
        writes[j[jj], i[ii]] += 1
    assert bool((writes == 1).all()), "an element written twice or never"
    return out


@pytest.mark.parametrize("nt", [1, 2, 3, 16, 256])
def test_upper_tiles_cover_the_triangle_once(nt):
    """Blocks 0..T-1 map to every upper tile once, up to the 256 tiles of a
    row of 8192 (the greedy kernel's longest)."""
    ti, tj = _tile_of_block(np.arange(nt * (nt + 1) // 2))
    assert (ti >= 0).all() and (ti <= tj).all() and (tj < nt).all()
    assert len(set(zip(ti.tolist(), tj.tolist()))) == nt * (nt + 1) // 2


@pytest.mark.parametrize("b,n", SHAPES)
def test_self_scheme_matches_reference(b, n):
    boxes = _boxes(b, n, seed=b * 1000 + n)
    ref = np.asarray(jsph.sphiou_matrix_batch(jnp.asarray(boxes),
                                              jnp.asarray(boxes)))
    got = _model(torch.from_numpy(boxes), None, bf16=False)
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-6, rtol=0)
    assert torch.equal(got, got.transpose(1, 2))
    if b > 1:  # the padding row scores 0 everywhere
        assert not got[0].any()


@pytest.mark.parametrize("b,n,m", [(1, 1, 3), (3, 37, 37), (4, 128, 45)])
def test_general_scheme_matches_reference(b, n, m):
    a, bb = _boxes(b, n, seed=n), _boxes(b, m, seed=m + 1)
    ref = np.asarray(jsph.sphiou_matrix_batch(jnp.asarray(a),
                                              jnp.asarray(bb)))
    got = _model(torch.from_numpy(a), torch.from_numpy(bb), bf16=False)
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-6, rtol=0)


@pytest.mark.parametrize("b,n", SHAPES)
def test_bf16_self_scheme_matches_plain_version(b, n):
    boxes = torch.from_numpy(_boxes(b, n, seed=b * 1000 + n + 7))
    ref = sphiou_ref_batch_bf16(boxes, boxes)
    got = _model(boxes, None, bf16=True)
    torch.testing.assert_close(got, ref, atol=2.0 ** -6, rtol=0)
    assert torch.equal(got, got.transpose(1, 2))


@pytest.mark.parametrize("b,n", SHAPES)
def test_bf16_plain_version_is_symmetric(b, n):
    """On self-IoU inputs the plain bf16 version is exactly symmetric, as
    the kernel's mirrored self path is by construction."""
    boxes = torch.from_numpy(_boxes(b, n, seed=b * 1000 + n + 7))
    ref = sphiou_ref_batch_bf16(boxes, boxes)
    assert torch.equal(ref, ref.transpose(1, 2))
    # the wrapper takes the same plain version on the CPU, whichever path
    assert torch.equal(tsph.sphiou_matrix_batch(boxes, boxes,
                                                dtype=torch.bfloat16), ref)
    assert torch.equal(tsph.sphiou_matrix_batch(boxes, boxes.clone(),
                                                dtype=torch.bfloat16), ref)
