"""``repro_torch.core.sphere`` against ``repro.core.sphere``: the torch
geometry within 1e-6, every float32 ``sph_nms_batch`` backend's keep
masks equal to the reference's, and the bf16 option (``iou_dtype``)
under the reference's flip gate."""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sphere as jsphere
from repro.core import sroi as jsroi
from repro_torch.core import sphere as tsphere
from repro_torch.core import sroi as tsroi


def _boxes(rng, shape):
    return np.stack([rng.uniform(-math.pi, math.pi, shape),
                     rng.uniform(-1.4, 1.4, shape),
                     rng.uniform(0.05, 1.2, shape),
                     rng.uniform(0.05, 1.2, shape)], axis=-1).astype(np.float32)


def test_transforms_match_reference():
    rng = np.random.default_rng(0)
    th = rng.uniform(-math.pi, math.pi, 50).astype(np.float32)
    ph = rng.uniform(-1.5, 1.5, 50).astype(np.float32)
    tth, tph = torch.from_numpy(th), torch.from_numpy(ph)
    pairs = [
        (tsphere.sph_to_cart(tth, tph), jsphere.sph_to_cart(th, ph)),
        (tsphere.rotation_to_origin(tth, tph),
         jsphere.rotation_to_origin(th, ph)),
        (tsphere.rotation_from_origin(tth, tph),
         jsphere.rotation_from_origin(th, ph)),
        (tsphere.wrap_angle(tth * 3), jsphere.wrap_angle(jnp.asarray(th) * 3)),
    ]
    pairs += list(zip(tsphere.cart_to_sph(tsphere.sph_to_cart(tth, tph)),
                      jsphere.cart_to_sph(jsphere.sph_to_cart(th, ph))))
    pairs += list(zip(tsphere.sph_to_erp(tth, tph, 384, 192),
                      jsphere.sph_to_erp(th, ph, 384, 192)))
    pairs += list(zip(tsphere.erp_to_sph(tth * 50 + 190, tph * 30 + 96, 384,
                                         192),
                      jsphere.erp_to_sph(th * 50 + 190, ph * 30 + 96, 384,
                                         192)))
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                                   rtol=1e-6)


def test_sph_iou_matrix_and_area_match_reference():
    rng = np.random.default_rng(1)
    a, b = _boxes(rng, 33), _boxes(rng, 21)
    got = tsphere.sph_iou_matrix(torch.from_numpy(a), torch.from_numpy(b))
    ref = jsphere.sph_iou_matrix(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    np.testing.assert_allclose(
        tsphere.normalized_object_area(torch.from_numpy(a)).numpy(),
        np.asarray(jsphere.normalized_object_area(jnp.asarray(a))),
        atol=1e-6)


@pytest.mark.parametrize("center", [(0.0, 0.0), (2.9, 0.8), (-1.0, -1.3)])
def test_pi_box_to_sphbb_matches_reference(center):
    rng = np.random.default_rng(2)
    x0 = rng.uniform(0, 48, (3, 5))
    y0 = rng.uniform(0, 48, (3, 5))
    rect = np.stack([x0, y0, x0 + rng.uniform(1, 16, (3, 5)),
                     y0 + rng.uniform(1, 16, (3, 5))], -1).astype(np.float32)
    fov = (math.radians(60), math.radians(45))
    got = tsphere.pi_box_to_sphbb(torch.from_numpy(rect), center[0],
                                  center[1], fov, (64, 64))
    ref = jsphere.pi_box_to_sphbb(jnp.asarray(rect), jnp.asarray(center[0]),
                                  jnp.asarray(center[1]), fov, (64, 64))
    assert got.dtype == torch.float32 and got.shape == (3, 5, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def _nms_case(seed, b=6, n=48):
    rng = np.random.default_rng(seed)
    boxes = np.stack([rng.uniform(-0.8, 0.8, (b, n)),
                      rng.uniform(-0.5, 0.5, (b, n)),
                      rng.uniform(0.3, 1.0, (b, n)),
                      rng.uniform(0.3, 1.0, (b, n))], -1)
    scores = np.round(rng.uniform(0.05, 1.0, (b, n)), 1)  # many ties
    mask = np.ones((b, n), bool)
    for r in range(b):
        mask[r, rng.integers(0, n + 1):] = False
    mask[1] = False
    boxes[~mask] = 0.0
    return boxes, scores, mask


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("max_out", [None, 3])
def test_sph_nms_batch_backends_match_reference(seed, max_out):
    boxes, scores, mask = _nms_case(seed)
    host = tsphere.sph_nms_batch(boxes, scores, mask, max_out=max_out,
                                 backend="host")
    np.testing.assert_array_equal(
        host, jsphere.sph_nms_batch(boxes, scores, mask, max_out=max_out,
                                    backend="host"))
    plain = tsphere.sph_nms_batch(boxes, scores, mask, max_out=max_out,
                                  backend="torch", device="cpu")
    np.testing.assert_array_equal(
        plain, jsphere.sph_nms_batch(boxes, scores, mask, max_out=max_out,
                                     backend="jit"))
    assert not plain[~mask].any()


def test_sph_nms_batch_auto_and_errors():
    boxes, scores, mask = _nms_case(4, b=2, n=8)
    np.testing.assert_array_equal(
        tsphere.sph_nms_batch(boxes, scores, mask),
        tsphere.sph_nms_batch(boxes, scores, mask, backend="host"))
    assert tsphere.sph_nms_batch(boxes[:, :0], scores[:, :0]).shape == (2, 0)
    with pytest.raises(ValueError):
        tsphere.sph_nms_batch(boxes, scores, backend="bogus")
    with pytest.raises(ValueError, match="iou_dtype"):
        tsphere.sph_nms_batch(boxes, scores, backend="torch", device="cpu",
                              iou_dtype="bfloat16")
    with pytest.raises(ValueError, match="iou_dtype"):
        tsphere.sph_nms_batch(boxes, scores, backend="host",
                              iou_dtype=torch.bfloat16)
    # float32 asked for by name is the default path
    np.testing.assert_array_equal(
        tsphere.sph_nms_batch(boxes, scores, mask, backend="torch",
                              device="cpu", iou_dtype=torch.float32),
        tsphere.sph_nms_batch(boxes, scores, mask, backend="torch",
                              device="cpu"))
    with pytest.raises(ValueError):
        tsphere.sph_nms_batch(boxes, scores, backend="cuda", device="cpu")
    if not torch.cuda.is_available():
        assert tsphere.nms_auto_backend(64, 64) == "host"
        with pytest.raises(RuntimeError):
            tsphere.sph_nms_batch(boxes, scores, backend="torch")


def test_sph_nms_single_row_and_incremental_match_reference():
    boxes, scores, mask = _nms_case(5, b=4, n=24)
    np.testing.assert_array_equal(
        tsphere.sph_nms(boxes[2], scores[2]),
        jsphere.sph_nms(boxes[2], scores[2]))
    np.testing.assert_array_equal(
        tsphere.sph_nms_host(boxes[2], scores[2]),
        jsphere.sph_nms_host(boxes[2], scores[2]))
    t_inc = tsphere.IncrementalNms(backend="host")
    j_inc = jsphere.IncrementalNms(backend="host")
    keys = list(range(4))
    for _ in range(2):
        np.testing.assert_array_equal(t_inc.suppress(keys, boxes, scores, mask),
                                      j_inc.suppress(keys, boxes, scores, mask))
    assert (t_inc.hits, t_inc.misses) == (j_inc.hits, j_inc.misses) == (4, 4)


def test_pad_detection_rows_matches_reference():
    rng = np.random.default_rng(6)
    rows_t, rows_j = [], []
    for k in (3, 0, 5):
        b = _boxes(rng, k).astype(np.float64)
        s = rng.uniform(0, 1, k)
        rows_t.append([tsroi.Detection(box=b[i], category=1, score=s[i])
                       for i in range(k)])
        rows_j.append([jsroi.Detection(box=b[i], category=1, score=s[i])
                       for i in range(k)])
    for got, ref in zip(tsphere.pad_detection_rows(rows_t, lambda n: 8, 4),
                        jsphere.pad_detection_rows(rows_j, lambda n: 8, 4)):
        np.testing.assert_array_equal(got, ref)


# the reference's bf16 gate (tests/test_fused_tick.py,
# benchmarks/kernels_bench.py): keep flips against float32 at most 1%, and
# none on a row with no IoU pair within 0.05 of the threshold
BF16_FLIP_BOUND = 0.01
BF16_NEAR_MARGIN = 0.05
FLIPPING_TRIAL = 0  # a box set where bf16 flips keep decisions (3 of 192)


def _bench_boxes(trial, b=8, n=24):
    """The reference bench's box sets (``benchmarks/kernels_bench.py``)."""
    rng = np.random.default_rng(trial)
    boxes = np.stack([rng.uniform(-3, 3, (b, n)),
                      rng.uniform(-1.2, 1.2, (b, n)),
                      rng.uniform(0.3, 1.2, (b, n)),
                      rng.uniform(0.3, 1.2, (b, n))], -1).astype(np.float32)
    return boxes, rng.uniform(0.1, 1, (b, n)).astype(np.float32)


def _far_rows(boxes):
    iou = np.stack([jsphere.sph_iou_matrix_np(r.astype(np.float64),
                                              r.astype(np.float64))
                    for r in boxes])
    near = np.abs(iou - 0.6) <= BF16_NEAR_MARGIN
    np.einsum("bii->bi", near)[:] = False  # self-IoU is always 1
    return ~near.any(axis=(1, 2))


@pytest.mark.parametrize("against", ["reference_bf16", "float32"])
def test_sph_nms_batch_bf16_flip_gate(against):
    """The ``torch`` backend's bf16 option against the reference's ``jit``
    bf16 path, and against the port's own float32 keep masks."""
    flips = total = 0
    for trial in range(10):
        boxes, scores = _bench_boxes(trial)
        got = tsphere.sph_nms_batch(boxes, scores, backend="torch",
                                    device="cpu", iou_dtype=torch.bfloat16)
        if against == "float32":
            want = tsphere.sph_nms_batch(boxes, scores, backend="torch",
                                         device="cpu")
        else:
            want = jsphere.sph_nms_batch(boxes, scores, backend="jit",
                                         iou_dtype=jnp.bfloat16)
        diff = got != want
        assert not (diff.any(axis=1) & _far_rows(boxes)).any(), \
            f"trial {trial}: bf16 flipped a row with no near-threshold pair"
        flips += int(diff.sum())
        total += diff.size
    assert flips / total <= BF16_FLIP_BOUND


def test_incremental_nms_passes_iou_dtype_on(monkeypatch):
    boxes, scores = _bench_boxes(FLIPPING_TRIAL)
    keys = list(range(len(boxes)))
    with pytest.raises(ValueError, match="iou_dtype"):
        tsphere.IncrementalNms(backend="host", iou_dtype=torch.bfloat16
                               ).suppress(keys, boxes, scores)
    # IncrementalNms takes no device: place its torch backend on the CPU
    monkeypatch.setattr(tsphere, "resolve_device",
                        lambda device=None: torch.device("cpu"))
    got = tsphere.IncrementalNms(backend="torch", iou_dtype=torch.bfloat16
                                 ).suppress(keys, boxes, scores)
    np.testing.assert_array_equal(
        got, tsphere.sph_nms_batch(boxes, scores, backend="torch",
                                   iou_dtype=torch.bfloat16))
    np.testing.assert_array_equal(
        got, jsphere.IncrementalNms(backend="jit", iou_dtype=jnp.bfloat16
                                    ).suppress(keys, boxes, scores))
    # a box set where bf16 flips a keep decision, so the option showed
    assert (got != tsphere.sph_nms_batch(boxes, scores, backend="torch")).any()
