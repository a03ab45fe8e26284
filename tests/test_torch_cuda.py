"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips where no CUDA device
is present; the file imports neither JAX nor the JAX package, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the gnomonic sampler and SphIoU are the reference's own
(``tests/test_kernels.py``); the batched projection is held to the
float64 map (``project_sroi_f64``) where a pole is in the crop, since
there two float32 maps differ by more than any fixed bound; the greedy
keep masks are equal exactly.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.core import projection as tproj
from repro_torch.core import sphere as tsphere
from repro_torch.core.sroi import SRoI
from repro_torch.data.synthetic import make_video, render_erp
from repro_torch.kernels import _build
from repro_torch.kernels.gnomonic import ops as tgno
from repro_torch.kernels.gnomonic.ref import (gnomonic_sample_ref,
                                              project_sroi_f64,
                                              project_srois_ref)
from repro_torch.kernels.nms import ops as tnms
from repro_torch.kernels.nms.ref import greedy_suppress_rows_ref
from repro_torch.kernels.sphiou import ops as tsph
from repro_torch.kernels.sphiou.ref import sphiou_ref_batch
from repro_torch.models import detector as tdet
from repro_torch.serving.scheduler import TorchDetectorBackend

CENTERS = [(0.0, 0.0), (3.0, 0.4), (-2.8, -0.9), (1.5, 1.3), (math.pi, 0.0),
           (0.0, 1.5)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _build.build_all()
    return torch.device("cuda")


def _erp(seed, shape):
    return torch.from_numpy(
        np.random.default_rng(seed).random(shape).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_cuda_gnomonic_sample(cuda, dtype):
    erp = _erp(8, (256, 512, 3)).to(cuda, dtype)
    for center in CENTERS:
        u, v = tproj.gnomonic_coords(center[0], center[1], (1.2, 1.2),
                                     (96, 96), (256, 512), cuda)
        got = tgno.gnomonic_sample(erp, u, v)
        assert got.dtype == dtype
        ref = gnomonic_sample_ref(erp, u, v)
        tol = 3e-6 if dtype == torch.float32 else 5e-3
        torch.testing.assert_close(got.float(), ref.float(), atol=tol,
                                   rtol=1e-5)


@pytest.mark.cuda
def test_cuda_gnomonic_sample_seam_edges(cuda):
    erp = _erp(3, (16, 32, 3)).to(cuda)
    w = erp.shape[1]
    u = torch.tensor([[w, w - 1e-4, -1e-8, -0.25, 0.0, w - 1.0, -w - 0.5,
                       2 * w]], device=cuda)
    v = torch.tensor([[0.0, 3.5, 7.25, -2.0, 15.0, 20.0, 8.0, 1.5]],
                     device=cuda)
    torch.testing.assert_close(tgno.gnomonic_sample(erp, u, v),
                               gnomonic_sample_ref(erp, u, v), atol=3e-6,
                               rtol=1e-5)


@pytest.mark.cuda
def test_cuda_project_srois_batched(cuda):
    frames = torch.stack([_erp(10, (128, 256, 3)),
                          _erp(11, (128, 256, 3))]).to(cuda)
    idx = [1, 0, 1, 1, 0]
    # four crops clear of the poles, and one with the north pole inside
    centers = np.array([[0.3, 0.2], [-2.9, -0.5], [3.1, 0.6], [1.0, -0.6],
                        [0.5, 1.3]], np.float32)
    fovs = np.array([[1.0, 0.8], [1.2, 1.2], [0.6, 0.9], [0.9, 0.7],
                     [1.2, 1.2]], np.float32)
    got = tgno.project_srois_batched(frames, idx, centers, fovs, (64, 64))
    ref = project_srois_ref(frames, torch.tensor(idx),
                            torch.from_numpy(centers), torch.from_numpy(fovs),
                            (64, 64))
    torch.testing.assert_close(got[:4], ref[:4], atol=5e-5, rtol=0)
    exact = project_sroi_f64(frames[idx[4]], float(centers[4, 0]),
                             float(centers[4, 1]), fovs[4].tolist(), 64)
    err_k = float((got[4].double() - exact).abs().max())
    err_p = float((ref[4].double() - exact).abs().max())
    assert err_k <= 2 * err_p + 5e-5


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(1, 1), (3, 37), (8, 128)])
def test_cuda_sphiou_and_greedy(cuda, b, n):
    rng = np.random.default_rng(b * 7 + n)
    boxes = np.stack([rng.uniform(-0.8, 0.8, (b, n)),
                      rng.uniform(-0.5, 0.5, (b, n)),
                      rng.uniform(0.3, 1.0, (b, n)),
                      rng.uniform(0.3, 1.0, (b, n))], -1)
    scores = np.round(rng.uniform(0.05, 1.0, (b, n)), 1)  # ties
    mask = np.arange(n)[None] < rng.integers(0, n + 1, (b, 1))
    boxes[~mask] = 0.0
    bx = torch.tensor(boxes, dtype=torch.float32, device=cuda)
    iou = tsph.sphiou_matrix_batch(bx, bx)
    torch.testing.assert_close(iou, sphiou_ref_batch(bx, bx), atol=5e-6,
                               rtol=0)
    sc = torch.tensor(scores, dtype=torch.float32, device=cuda)
    mk = torch.tensor(mask, device=cuda)
    keep = tnms.greedy_suppress_rows(iou, sc, mk, 0.6)
    assert torch.equal(keep, greedy_suppress_rows_ref(iou, sc, mk, 0.6))
    np.testing.assert_array_equal(
        tsphere.sph_nms_batch(boxes, scores, mask, backend="cuda"),
        tsphere.sph_nms_batch(boxes, scores, mask, backend="torch"))


@pytest.mark.cuda
def test_cuda_launches_are_counted(cuda):
    _build.reset_launch_counts()
    bx = torch.zeros((2, 4, 4), device=cuda)
    tsph.sphiou_matrix_batch(bx, bx)
    assert _build.launch_counts() == {"sphiou_matrix_batch": 1}
    tsph.sphiou_matrix_batch(bx.cpu(), bx.cpu())  # the plain version
    assert _build.launch_counts() == {"sphiou_matrix_batch": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("frames", ["dropped", "refilled"])
def test_cuda_backend_serves_each_frame_from_its_own_pixels(cuda, frames):
    """Frames not kept alive between calls, or one buffer refilled in
    place: the card's PI of each is the plain version's of that frame."""
    cfg = dataclasses.replace(tdet.PAPER_LADDER[0], input_size=64,
                              n_classes=16, width_mult=0.25, depth_mult=0.34)
    params = [tdet.init_params(torch.Generator().manual_seed(0), cfg)]
    gpu = TorchDetectorBackend([cfg], params)
    cpu = TorchDetectorBackend([cfg], params, device="cpu")
    video = make_video(n_frames=4, n_objects=20, seed=7)
    region = SRoI(center=(0.3, 0.1), fov=(1.2, 0.9))
    buf = np.zeros((192, 384, 3), np.float32)
    for f in (1, 2, 3):
        if frames == "dropped":
            got = gpu._project(render_erp(video, f, height=192, width=384),
                               region, 64)
        else:
            buf[...] = render_erp(video, f, height=192, width=384)
            got = gpu._project(buf, region, 64)
        want = cpu._project(render_erp(video, f, height=192, width=384),
                            region, 64)
        torch.testing.assert_close(got.cpu(), want, atol=5e-5, rtol=0)
