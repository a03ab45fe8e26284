"""The port's kernels against the JAX package's, at small sizes.

On the CPU each wrapper of ``repro_torch.kernels`` runs its plain
PyTorch version; the reference runs its Pallas kernels in interpret
mode (``repro.kernels.*.ops`` picks that mode itself off the TPU).  The
tolerances are the reference's own (``tests/test_kernels.py``).  The
CUDA kernels themselves are held to their plain versions in
``test_torch_cuda.py``.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import projection as jproj
from repro.core import sphere as jsphere
from repro.kernels.gnomonic import ops as jgno
from repro.kernels.gnomonic.ref import gnomonic_sample_ref as jgno_ref
from repro.kernels.sphiou import ops as jsph
from repro_torch.core import projection as tproj
from repro_torch.kernels.gnomonic import ops as tgno
from repro_torch.kernels.nms import ops as tnms
from repro_torch.kernels.sphiou import ops as tsph

CENTERS = [(0.0, 0.0), (3.0, 0.4), (-2.8, -0.9), (1.5, 1.3), (math.pi, 0.0)]


def _erp(seed, shape=(128, 256, 3), dtype=np.float32):
    return np.random.default_rng(seed).random(shape).astype(dtype)


def _boxes(rng, shape):
    return np.stack([rng.uniform(-math.pi, math.pi, shape),
                     rng.uniform(-1.4, 1.4, shape),
                     rng.uniform(0.05, 1.2, shape),
                     rng.uniform(0.05, 1.2, shape)], axis=-1).astype(np.float32)


def _jax_maps(center, fov_deg, out, erp_shape):
    fov = (math.radians(fov_deg), math.radians(fov_deg))
    u, v = jproj.gnomonic_coords(jnp.asarray(center[0]), jnp.asarray(center[1]),
                                 fov, (out, out), erp_shape[:2])
    return np.asarray(u), np.asarray(v)


# -- gnomonic -----------------------------------------------------------------


@pytest.mark.parametrize("center", CENTERS)
@pytest.mark.parametrize("out,fov", [(64, 60), (32, 90), (48, 45)])
def test_gnomonic_sample_matches_reference(center, out, fov):
    """Same maps into both samplers: the Pallas kernel and the port."""
    erp = _erp(0)
    u, v = _jax_maps(center, fov, out, erp.shape)
    ref = np.asarray(jgno.gnomonic_sample(jnp.asarray(erp), u, v))
    got = tgno.gnomonic_sample(torch.from_numpy(erp), u, v)
    np.testing.assert_allclose(got.numpy(), ref, atol=3e-6, rtol=1e-5)


@pytest.mark.parametrize("center", CENTERS)
def test_gnomonic_coords_match_reference(center):
    erp_shape = (128, 256)
    fov = (math.radians(60), math.radians(50))
    ju, jv = jproj.gnomonic_coords(jnp.asarray(center[0]), jnp.asarray(center[1]),
                                   fov, (40, 48), erp_shape)
    tu, tv = tproj.gnomonic_coords(center[0], center[1], fov, (40, 48),
                                   erp_shape)
    w = erp_shape[1]
    du = (tu.numpy() - np.asarray(ju) + w / 2) % w - w / 2  # seam-aware
    np.testing.assert_allclose(du, 0.0, atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_gnomonic_sample_dtypes(dtype):
    erp = _erp(1, (64, 128, 3), dtype)
    u, v = _jax_maps((0.5, 0.2), 60, 32, erp.shape)
    ref = np.asarray(jgno_ref(jnp.asarray(erp), jnp.asarray(u), jnp.asarray(v)))
    got = tgno.gnomonic_sample(torch.from_numpy(erp), u, v)
    assert got.dtype == torch.from_numpy(erp).dtype
    np.testing.assert_allclose(got.float().numpy(), ref.astype(np.float32),
                               atol=5e-3)


def test_gnomonic_sample_pole():
    """The pole-centred PI that the TPU kernel sends to its oracle."""
    erp = _erp(2)
    u, v = _jax_maps((0.0, 1.5), 120, 16, erp.shape)
    ref = np.asarray(jgno_ref(jnp.asarray(erp), jnp.asarray(u), jnp.asarray(v)))
    got = tgno.gnomonic_sample(torch.from_numpy(erp), u, v)
    np.testing.assert_allclose(got.numpy(), ref, atol=3e-6)


def test_gnomonic_sample_seam_edges():
    """u exactly W, just below 0 and negative: the wrap never indexes
    outside the frame and agrees with the reference's jnp.mod."""
    erp = _erp(3, (16, 32, 3))
    w = erp.shape[1]
    u = np.array([[w, w - 1e-4, -1e-8, -0.25, 0.0, w - 1.0, -w - 0.5, 2 * w]],
                 np.float32)
    v = np.array([[0.0, 3.5, 7.25, -2.0, 15.0, 20.0, 8.0, 1.5]], np.float32)
    ref = np.asarray(jgno_ref(jnp.asarray(erp), jnp.asarray(u), jnp.asarray(v)))
    got = tgno.gnomonic_sample(torch.from_numpy(erp), u, v)
    np.testing.assert_allclose(got.numpy(), ref, atol=3e-6)
    # the Pallas wrapper pre-wraps u with np.mod in float32
    pallas = np.asarray(jgno.gnomonic_sample(jnp.asarray(erp), u[:, :6], v[:, :6]))
    np.testing.assert_allclose(got.numpy()[:, :6], pallas, atol=3e-6)


def test_project_sroi_matches_reference():
    erp = _erp(4)
    fov = (math.radians(60), math.radians(60))
    ref = np.asarray(jproj.project_sroi(jnp.asarray(erp), jnp.asarray(0.3),
                                        jnp.asarray(-0.1), fov, (40, 40)))
    for use_kernel in (False, True):
        got = tproj.project_sroi(torch.from_numpy(erp), 0.3, -0.1, fov,
                                 (40, 40), use_kernel=use_kernel)
        np.testing.assert_allclose(got.numpy(), ref, atol=5e-5)
    got = tgno.project_sroi_kernel(erp, 0.3, -0.1, fov, (40, 40), device="cpu")
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-5)


def test_cubemap_faces_and_resize_coords_match_reference():
    erp = _erp(12, (64, 128, 3))
    jfaces, jcenters = jproj.cubemap_faces(jnp.asarray(erp), 24)
    tfaces, tcenters = tproj.cubemap_faces(torch.from_numpy(erp), 24)
    assert [c[0] for c in tcenters] == [c[0] for c in jcenters]
    np.testing.assert_allclose([c[1:] for c in tcenters],
                               [[float(x) for x in c[1:]] for c in jcenters])
    assert tfaces.shape == (6, 24, 24, 3)
    np.testing.assert_allclose(tfaces.numpy(), np.asarray(jfaces), atol=5e-5)
    for got, ref in zip(tproj.erp_resize_coords((32, 48), (64, 128)),
                        jproj.erp_resize_coords((32, 48), (64, 128))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_project_srois_batched_matches_reference():
    rng = np.random.default_rng(5)
    frames = np.stack([_erp(6, (64, 128, 3)), _erp(7, (64, 128, 3))])
    idx = [0, 1, 1, 0, 1]
    centers = np.stack([rng.uniform(-3, 3, 5), rng.uniform(-1.4, 1.4, 5)], -1)
    fovs = rng.uniform(0.4, 1.6, (5, 2))
    ref = np.asarray(jgno.project_srois_batched(
        [jnp.asarray(frames[i]) for i in idx], centers, fovs, (32, 32)))
    got = tgno.project_srois_batched(torch.from_numpy(frames), idx, centers,
                                     fovs, (32, 32))
    assert got.shape == (5, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-5)


def test_project_srois_batched_rejects_bad_index():
    frames = torch.zeros((2, 8, 16, 3))
    with pytest.raises(IndexError):
        tgno.project_srois_batched(frames, [0, 2], [[0, 0]] * 2, [[1, 1]] * 2,
                                   (4, 4))


# -- sphiou -------------------------------------------------------------------


@pytest.mark.parametrize("n,m", [(1, 1), (7, 13), (64, 64), (100, 257),
                                 (256, 33)])
def test_sphiou_matrix_matches_reference(n, m):
    rng = np.random.default_rng(n * 1000 + m)
    a, b = _boxes(rng, n), _boxes(rng, m)
    ref = np.asarray(jsph.sphiou_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = tsph.sphiou_matrix(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-6)


@pytest.mark.parametrize("b,n,m", [(1, 8, 8), (3, 17, 9), (4, 64, 64)])
def test_sphiou_matrix_batch_matches_reference(b, n, m):
    rng = np.random.default_rng(b * 100 + n)
    a, bb = _boxes(rng, (b, n)), _boxes(rng, (b, m))
    ref = np.asarray(jsph.sphiou_matrix_batch(jnp.asarray(a), jnp.asarray(bb)))
    got = tsph.sphiou_matrix_batch(torch.from_numpy(a), torch.from_numpy(bb))
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-6)


def test_sphiou_diag_is_one_and_rows_independent():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(_boxes(rng, (3, 32)))
    got = tsph.sphiou_matrix_batch(a, a)
    for r in range(3):
        np.testing.assert_allclose(np.diag(got[r].numpy()), 1.0, atol=1e-4)
        np.testing.assert_allclose(got[r].numpy(),
                                   tsph.sphiou_matrix(a[r], a[r]).numpy(),
                                   atol=1e-6)


# -- greedy suppression -------------------------------------------------------


def _nms_case(seed, b=5, n=40, ties=True):
    rng = np.random.default_rng(seed)
    boxes = np.stack([rng.uniform(-0.8, 0.8, (b, n)),
                      rng.uniform(-0.5, 0.5, (b, n)),
                      rng.uniform(0.3, 1.0, (b, n)),
                      rng.uniform(0.3, 1.0, (b, n))], -1)
    scores = rng.uniform(0.05, 1.0, (b, n))
    if ties:
        scores = np.round(scores, 1)  # many equal scores per row
    mask = np.ones((b, n), bool)
    for r in range(b):
        mask[r, rng.integers(0, n + 1):] = False  # ragged rows
    mask[0] = False  # one fully padded row
    boxes[~mask] = 0.0
    return boxes, scores, mask


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("thr", [0.3, 0.6])
def test_greedy_matches_reference_loop(seed, thr):
    """Same float32 IoU into both greedy loops: keep masks equal."""
    boxes, scores, mask = _nms_case(seed)
    iou = np.asarray(jax_vmap_iou(boxes.astype(np.float32)))
    ref = np.asarray(jsphere._sph_nms_batch_device(
        jnp.asarray(boxes, jnp.float32), jnp.asarray(scores, jnp.float32),
        jnp.asarray(mask), jnp.asarray(thr, jnp.float32), use_pallas=False))
    got = tnms.greedy_suppress_rows(torch.from_numpy(iou),
                                    torch.from_numpy(scores.astype(np.float32)),
                                    torch.from_numpy(mask), thr)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert not got.numpy()[~mask].any()


def jax_vmap_iou(boxes):
    import jax

    return jax.vmap(jsphere.sph_iou_matrix)(jnp.asarray(boxes),
                                            jnp.asarray(boxes))
