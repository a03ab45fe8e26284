"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips where no CUDA device
is present; the file imports neither JAX nor the JAX package, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the gnomonic sampler, SphIoU and flash attention are the
reference's own (``tests/test_kernels.py``), and bf16 flash attention is
also held to one bf16 ulp of its plain version plus 2e-5; the batched
projection is held to the float64 map (``project_sroi_f64``) where a
pole is in the crop, since there two float32 maps differ by more than
any fixed bound; the greedy keep masks are equal exactly; the bf16
SphIoU option is held to its bf16 plain version within 2^-6 (a few bf16
ulps of an IoU) and to the float32 kernel's keep masks by the
reference's flip gate.

The training path (no kernel: the reference's train steps reach none):
a train step on the card against the same step on the CPU, float32 with
TF32 off (loss and grad norm rtol 1e-5, the parameters as
``tests/test_torch_training.py`` bounds two AdamW runs: every one within
2 lr a step, 99.9% within 1e-3 lr) and bf16 (the MoE block's backward:
loss rtol 2^-6, each gradient leaf's cosine with the CPU's at least 0.99,
since a router logit one bf16 ulp apart can move a token to another
expert).
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
from repro_torch.kernels.attention import ops as tattn
from repro_torch.kernels.attention.ref import flash_attention_ref
from repro_torch.kernels.gnomonic import ops as tgno
from repro_torch.kernels.gnomonic.ref import (gnomonic_sample_ref,
                                              project_sroi_f64,
                                              project_srois_ref)
from repro_torch.kernels.nms import ops as tnms
from repro_torch.kernels.nms.ref import greedy_suppress_rows_ref
from repro_torch.kernels.sphiou import ops as tsph
from repro_torch.kernels.sphiou.ref import (sphiou_ref_batch,
                                            sphiou_ref_batch_bf16)
from repro_torch.configs import mixtral_8x22b as tmixtral
from repro_torch.configs import qwen3_moe_235b_a22b as tqwen
from repro_torch.models import detector as tdet
from repro_torch.models import transformer as tlm
from repro_torch.serving.scheduler import TorchDetectorBackend
from repro_torch import pytree
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import smollm_135m as tsmol
from repro_torch.data.pipeline import lm_batches, rasterize_targets
from repro_torch.training import optimizer as topt
from repro_torch.training import steps as tsteps

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


def _clustered_rows(b, n, seed):
    """Detection-like rows: boxes clustered around a few objects (so that
    suppression has overlaps to remove), scores with ties, ragged masks."""
    rng = np.random.default_rng(seed)
    centers = np.stack([rng.uniform(-math.pi, math.pi, (b, 8)),
                        rng.uniform(-1.0, 1.0, (b, 8))], -1)
    pick = rng.integers(0, 8, (b, n))
    ctr = np.take_along_axis(centers, pick[..., None].repeat(2, -1), 1)
    boxes = np.concatenate([ctr + rng.normal(0, 0.03, (b, n, 2)),
                            rng.uniform(0.05, 0.4, (b, n, 2))], -1)
    scores = np.round(rng.uniform(0.01, 1.0, (b, n)), 2)
    mask = np.arange(n)[None] < rng.integers(n // 2, n + 1, (b, 1))
    boxes[~mask] = 0.0
    return boxes, scores, mask


def _greedy_against_plain(cuda, boxes, scores, mask, thr):
    bx = torch.tensor(boxes, dtype=torch.float32, device=cuda)
    sc = torch.tensor(scores, dtype=torch.float32, device=cuda)
    mk = torch.tensor(mask, device=cuda)
    iou = tsph.sphiou_matrix_batch(bx, bx)
    keep = tnms.greedy_suppress_rows(iou, sc, mk, thr)
    assert torch.equal(keep, greedy_suppress_rows_ref(iou, sc, mk, thr))
    assert not keep[~mk].any()
    return keep


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(1, 1), (3, 33), (4, 128), (2, 1024),
                                 (2, 1025), (1, 8192)])
def test_cuda_greedy_row_lengths(cuda, b, n):
    """A batched tick's rows (4 x 128), rows either side of 1024 (word rows
    staged in shared memory up to there, read from L2 above) and the
    wrapper's largest, 8192: keep masks equal the plain version's."""
    boxes, scores, mask = _clustered_rows(b, n, seed=b * 10007 + n)
    for thr in (0.3, 0.6):
        _greedy_against_plain(cuda, boxes, scores, mask, thr)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [33, 128, 1025])
def test_cuda_greedy_nan_scores(cuda, n):
    """argmax ranks NaN above every number, so the reference (and the plain
    version) keeps a NaN-scored box first; then +inf; -0.0 and 0.0 are
    equal scores, the lower index first."""
    boxes, scores, mask = _clustered_rows(4, n, seed=n)
    scores[:, ::7] = np.nan
    scores[:, 3::11] = np.inf
    scores[:, 1::13] = 0.0
    scores[:, 2::13] = -0.0
    keep = _greedy_against_plain(cuda, boxes, scores, mask, 0.6).cpu().numpy()
    for r in range(4):
        nan = np.flatnonzero(np.isnan(scores[r]) & mask[r])
        assert keep[r, nan[0]]


@pytest.mark.cuda
def test_cuda_project_srois_tick_chunk(cuda):
    """A batched tick's largest chunk: 9 crops at 896 from 4 distinct
    1920x3840 frames.  At that width each crop is held to the float64 map,
    as chip_smoke.py holds the recorded shape."""
    rng = np.random.default_rng(12)
    frames = torch.from_numpy(
        rng.random((4, 1920, 3840, 3), dtype=np.float32)).to(cuda)
    idx = [i % 4 for i in range(9)]
    centers = np.stack([rng.uniform(-math.pi, math.pi, 9),
                        rng.uniform(-1.4, 1.4, 9)], -1).astype(np.float32)
    fovs = rng.uniform(math.radians(40), math.radians(110),
                       (9, 2)).astype(np.float32)
    got = tgno.project_srois_batched(frames, idx, centers, fovs, (896, 896))
    ref = project_srois_ref(frames, torch.tensor(idx),
                            torch.from_numpy(centers), torch.from_numpy(fovs),
                            (896, 896))
    assert got.shape == (9, 896, 896, 3)
    for i in range(9):
        exact = project_sroi_f64(frames[idx[i]], float(centers[i, 0]),
                                 float(centers[i, 1]), fovs[i].tolist(), 896)
        err_k = float((got[i].double() - exact).abs().max())
        err_p = float((ref[i].double() - exact).abs().max())
        assert err_k <= 2 * err_p + 5e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n", [(3, 37), (4, 128), (32, 512)])
def test_cuda_sphiou_self_and_general_paths(cuda, b, n, dtype):
    """The self path (one tensor twice, as NMS calls it), the general path
    (the same boxes in another tensor, and N != M), each against its plain
    version; the self path's output exactly symmetric.  Row 0 is all
    padding; the other rows end in padding."""
    boxes, _, _ = _clustered_rows(b, n, seed=b * 31 + n)
    boxes[0] = 0.0
    bx = torch.tensor(boxes, dtype=torch.float32, device=cuda)
    other = torch.tensor(_clustered_rows(b, n // 2 + 5, seed=n)[0],
                         dtype=torch.float32, device=cuda)
    plain, tol = ((sphiou_ref_batch, 5e-6) if dtype == torch.float32
                  else (sphiou_ref_batch_bf16, 2.0 ** -6))
    got = tsph.sphiou_matrix_batch(bx, bx, dtype=dtype)
    assert torch.equal(got, got.transpose(1, 2))
    assert not got[0].any()
    torch.testing.assert_close(got, plain(bx, bx), atol=tol, rtol=0)
    for x, y in ((bx, bx.clone()), (bx, other), (other, bx)):
        torch.testing.assert_close(tsph.sphiou_matrix_batch(x, y, dtype=dtype),
                                   plain(x, y), atol=tol, rtol=0)


@pytest.mark.cuda
def test_cuda_sphiou_trig_check(cuda):
    """sinf odd, cosf even and sincosf equal to both, bit for bit, at every
    finite float32: the kernel computes both directions of a pair from one
    sincosf of dt on that ground."""
    assert tsph.trig_check(cuda) == 0


# the reference's bf16 gate (tests/test_fused_tick.py)
BF16_FLIP_BOUND = 0.01
BF16_NEAR_MARGIN = 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(3, 37), (32, 512)])
def test_cuda_sphiou_bf16(cuda, b, n):
    rng = np.random.default_rng(b + n)
    boxes = np.stack([rng.uniform(-3, 3, (b, n)),
                      rng.uniform(-1.2, 1.2, (b, n)),
                      rng.uniform(0.05, 1.2, (b, n)),
                      rng.uniform(0.05, 1.2, (b, n))], -1)
    bx = torch.tensor(boxes, dtype=torch.float32, device=cuda)
    got = tsph.sphiou_matrix_batch(bx, bx, dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, sphiou_ref_batch_bf16(bx, bx),
                               atol=2.0 ** -6, rtol=0)


@pytest.mark.cuda
def test_cuda_sphiou_bf16_flip_gate(cuda):
    """bf16 keep masks against the float32 kernel's, on the reference
    bench's box sets (``benchmarks/kernels_bench.py``)."""
    flips = total = 0
    for trial in range(10):
        rng = np.random.default_rng(trial)
        boxes = np.stack([rng.uniform(-3, 3, (8, 24)),
                          rng.uniform(-1.2, 1.2, (8, 24)),
                          rng.uniform(0.3, 1.2, (8, 24)),
                          rng.uniform(0.3, 1.2, (8, 24))], -1
                         ).astype(np.float32)
        scores = rng.uniform(0.1, 1, (8, 24)).astype(np.float32)
        k32 = tsphere.sph_nms_batch(boxes, scores, backend="cuda")
        k16 = tsphere.sph_nms_batch(boxes, scores, backend="cuda",
                                    iou_dtype=torch.bfloat16)
        diff = k32 != k16
        iou = np.stack([tsphere.sph_iou_matrix_np(r.astype(np.float64),
                                                  r.astype(np.float64))
                        for r in boxes])
        near = np.abs(iou - 0.6) <= BF16_NEAR_MARGIN
        np.einsum("bii->bi", near)[:] = False
        assert not (diff.any(axis=1) & ~near.any(axis=(1, 2))).any()
        flips += int(diff.sum())
        total += diff.size
    assert flips / total <= BF16_FLIP_BOUND


FLASH_CASES = [
    dict(b=2, sq=64, skv=64, hq=4, hkv=4, d=32, causal=True, window=None),
    dict(b=1, sq=128, skv=128, hq=8, hkv=2, d=64, causal=True, window=None),
    dict(b=1, sq=96, skv=96, hq=2, hkv=2, d=32, causal=True, window=32),
    dict(b=2, sq=1, skv=200, hq=4, hkv=1, d=32, causal=True, window=None),
    dict(b=1, sq=64, skv=64, hq=2, hkv=2, d=32, causal=False, window=None),
    dict(b=1, sq=80, skv=160, hq=2, hkv=2, d=16, causal=True, window=64),
    # smollm-135m's attention shape, and a head size of 128
    dict(b=1, sq=1000, skv=1000, hq=9, hkv=3, d=64, causal=True, window=None),
    dict(b=1, sq=200, skv=200, hq=2, hkv=1, d=128, causal=True, window=None),
]
# and the reference's six at the head sizes the tensor-core kernel serves
# in bf16 (64 and 128)
FLASH_CASES += [dict(c, d=d) for d in (64, 128) for c in FLASH_CASES[:6]
                if c["d"] != d]
# granite-34b's MQA layout (48 query heads on one KV head) and
# mixtral-8x22b's (a group of 6, a window shorter than the sequence), at a
# small S
FLASH_CASES += [
    dict(b=1, sq=384, skv=384, hq=48, hkv=1, d=128, causal=True, window=None),
    dict(b=2, sq=700, skv=700, hq=12, hkv=2, d=128, causal=True, window=256),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_cuda_flash_attention(cuda, case, dtype):
    gen = torch.Generator(device=cuda).manual_seed(case["sq"] + case["d"])

    def mk(s, h):
        return torch.randn((case["b"], s, h, case["d"]), generator=gen,
                           device=cuda).to(dtype)
    q, k, v = mk(case["sq"], case["hq"]), mk(case["skv"], case["hkv"]), \
        mk(case["skv"], case["hkv"])
    qoff = case["skv"] - case["sq"] if case["causal"] else 0
    kw = dict(causal=case["causal"], window=case["window"], q_offset=qoff)
    _build.reset_launch_counts()
    got = tattn.flash_attention(q, k, v, **kw)
    # bf16 at D 64 and 128 on the tensor-core kernel, the rest on the SIMT
    kernel = tattn.KERNELS[tattn.route(dtype, case["d"])].name
    assert _build.launch_counts() == {kernel: 1}
    assert got.dtype == dtype and got.shape == q.shape
    ref = flash_attention_ref(q, k, v, **kw)
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=2e-5, rtol=1e-4)
    else:
        torch.testing.assert_close(got.float(), ref.float(), atol=3e-2,
                                   rtol=0)
        # and within one bf16 ulp of the plain version plus the float32
        # sums' own difference (chip_smoke.py's ATTN_BF16_ATOL)
        excess = (got.float() - ref.float()).abs() \
            - 2.0 ** -7 * ref.float().abs()
        assert float(excess.max()) <= 2e-5


@pytest.mark.cuda
def test_cuda_flash_wgmma_reads_packed_views(cuda):
    """bf16 q, k and v at D=64 as views into a packed qkv tensor, which
    TMA maps as they lie: the tensor-core kernel reads them without a
    copy, in one launch."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    qkv = torch.randn((2, 300, 9 + 3 + 3, 64), generator=gen,
                      device=cuda).to(torch.bfloat16)
    q, k, v = qkv[:, 40:, :9], qkv[:, :, 9:12], qkv[:, :, 12:]
    assert not q.is_contiguous()
    assert all(tattn.tma_operand(x) is x for x in (q, k, v))
    _build.reset_launch_counts()
    got = tattn.flash_attention(q, k, v, causal=True, q_offset=40)
    assert _build.launch_counts() == {"flash_attention_wgmma": 1}
    ref = flash_attention_ref(q, k, v, causal=True, q_offset=40).float()
    excess = (got.float() - ref).abs() - 2.0 ** -7 * ref.abs()
    assert float(excess.max()) <= 2e-5


@pytest.mark.cuda
def test_cuda_flash_attention_reads_strided_views(cuda):
    """q, k and v as views into a packed qkv tensor (no copy), and a q
    window of a longer sequence (q_offset)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    qkv = torch.randn((2, 70, 9 + 3 + 3, 32), generator=gen, device=cuda)
    q, k, v = qkv[:, 40:, :9], qkv[:, :, 9:12], qkv[:, :, 12:]
    assert not q.is_contiguous()
    got = tattn.flash_attention(q, k, v, causal=True, q_offset=40)
    torch.testing.assert_close(
        got, flash_attention_ref(q, k, v, causal=True, q_offset=40),
        atol=2e-5, rtol=1e-4)
    with pytest.raises(ValueError, match="head size"):
        tattn.flash_attention(qkv[..., :24], qkv[..., :24], qkv[..., :24])


@pytest.mark.cuda
def test_cuda_launches_are_counted(cuda):
    _build.reset_launch_counts()
    bx = torch.zeros((2, 4, 4), device=cuda)
    tsph.sphiou_matrix_batch(bx, bx)  # the self path
    assert _build.launch_counts() == {"sphiou_matrix_batch": 1}
    tsph.sphiou_matrix_batch(bx.cpu(), bx.cpu())  # the plain version
    assert _build.launch_counts() == {"sphiou_matrix_batch": 1}
    tsph.sphiou_matrix_batch(bx, bx.clone())  # the general path
    assert _build.launch_counts() == {"sphiou_matrix_batch": 2}
    tsph.sphiou_matrix_batch(bx, bx, dtype=torch.bfloat16)
    q = torch.zeros((1, 3, 2, 16), device=cuda)
    tattn.flash_attention(q, q, q)
    tattn.flash_attention(q.cpu(), q.cpu(), q.cpu())  # the plain version
    qb = torch.zeros((1, 3, 2, 64), device=cuda, dtype=torch.bfloat16)
    tattn.flash_attention(qb, qb, qb)
    tattn.flash_attention(qb.cpu(), qb.cpu(), qb.cpu())
    assert _build.launch_counts() == {"sphiou_matrix_batch": 2,
                                      "sphiou_matrix_batch_bf16": 1,
                                      "flash_attention": 1,
                                      "flash_attention_wgmma": 1}


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


class _Unstaged:
    """A backend without the staging hooks (``PodServer`` calls a hook
    only where the backend has one): every chunk uploads its frames."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        if name in ("stage_frames", "release_frames"):
            raise AttributeError(name)
        return getattr(self._inner, name)


def _card_pod(backend, videos):
    from repro_torch.core.omnisense import OmniSenseLoop
    from repro_torch.serving import profiles
    from repro_torch.serving.network import NetworkModel
    from repro_torch.serving.scheduler import OmniSenseLatencyModel
    from repro_torch.serving.server import PodServer

    variants = profiles.make_ladder(n_categories=16)[:2]
    lat = OmniSenseLatencyModel(profiles.paper_profile(), NetworkModel())
    loops = []
    for video in videos:
        loop = OmniSenseLoop(variants, lat, backend, budget_s=2.0,
                             n_categories=16, explore_costs=[0.1, 0.2])
        loop.seed_history(video.visible_objects(0))
        loops.append(loop)
    frames = {}

    def source(s, f):
        if (s, f) not in frames:
            frames[(s, f)] = render_erp(videos[s], f, height=192, width=384)
        return frames[(s, f)]

    return PodServer(loops, [backend] * len(videos), max_batch=8,
                     frame_source=source)


@pytest.mark.cuda
def test_cuda_staged_pod_tick_equals_unstaged(cuda):
    """``PodServer.step`` on the card: the tick whose frames were staged
    (one pinned, asynchronous upload per stream) detects exactly what the
    tick whose chunks upload their own frames detects; each tick uploads
    each distinct frame once, and no staged frame outlives its tick."""
    cfgs = [dataclasses.replace(tdet.PAPER_LADDER[i], input_size=64,
                                n_classes=16, width_mult=0.25,
                                depth_mult=0.34) for i in (0, 1)]
    params = [tdet.init_params(torch.Generator().manual_seed(i), c)
              for i, c in enumerate(cfgs)]
    staged_b = TorchDetectorBackend(cfgs, params, conf=0.01, max_det=4)
    plain_b = TorchDetectorBackend(cfgs, params, conf=0.01, max_det=4)
    videos = [make_video(n_frames=8, n_objects=20, seed=s) for s in (7, 8, 9)]
    staged = _card_pod(staged_b, videos)
    plain = _card_pod(_Unstaged(plain_b), videos)
    n = 0
    for f in (1, 2, 3):
        staged.step(f)
        plain.step(f)
        assert staged_b.frame_uploads == len(videos) * f
        assert not staged_b._staged
        for a, b in zip(staged.loops, plain.loops):
            got, want = a._history[-1], b._history[-1]
            assert [(d.category, d.score) for d in got] == \
                [(d.category, d.score) for d in want]
            for x, y in zip(got, want):
                np.testing.assert_array_equal(x.box, y.box)
            n += len(got)
    assert n > 0
    assert plain_b.frame_uploads >= staged_b.frame_uploads
    # one pinned buffer a stream, each refilled after its last copy ended
    pool = staged_b._pinned[(192, 384, 3)]
    assert len(pool) == len(videos)
    assert all(buf.is_pinned() and event.query() for buf, event in pool)


@pytest.mark.cuda
def test_cuda_measure_host_profile(cuda):
    from repro_torch.serving.profiles import measure_host_profile

    prof = measure_host_profile(reduced=True, repeats=2)
    assert list(prof) == [c.name for c in tdet.PAPER_LADDER[:3]]
    assert all(t > 0 and math.isfinite(t) for t in prof.values())


# -- the action head on the card ------------------------------------------------


def _action_items(frame, centers, fov=(1.1, 0.9)):
    return [(frame, SRoI(center=c, fov=fov)) for c in centers]


@pytest.mark.cuda
@pytest.mark.parametrize("rung", range(4))
def test_cuda_action_backend_matches_cpu(cuda, rung):
    """``TorchActionBackend`` on the card (the gnomonic sampling kernel)
    against the same backend on the CPU with the plain projection, at
    each ``ACTION_LADDER`` rung's published shape: a batch of 8 regions,
    over enough frames to fill the longest window, logits within 1e-4,
    equal categories; the kernel launched once a crop."""
    from repro_torch.models import action as tact
    from repro_torch.serving.tasks import (TorchActionBackend, action_ladder,
                                           default_action_configs)

    cfgs = default_action_configs()
    params = [tact.init_params(torch.Generator().manual_seed(50 + i), c)
              for i, c in enumerate(cfgs)]
    card = TorchActionBackend(cfgs, params)
    host = TorchActionBackend(cfgs, params, use_kernel=False, device="cpu")
    variant = action_ladder()[rung]
    cfg = cfgs[rung]
    centers = [(-2.8 + 0.7 * k, 0.5 * math.sin(k)) for k in range(8)]
    rng = np.random.default_rng(rung)
    _build.reset_launch_counts()
    for f in range(cfg.clip_len + 1):
        frame = rng.random((480, 960, 3)).astype(np.float32)
        card.set_frame(f)
        host.set_frame(f)
        got = card.infer_srois_batched(_action_items(frame, centers), variant)
        want = host.infer_srois_batched(_action_items(frame, centers),
                                        variant)
        assert [d[0].category for d in got] == [d[0].category for d in want]
        for a, b in zip(got, want):
            np.testing.assert_allclose(a[0].score, b[0].score, atol=1e-4)
    assert _build.launch_counts().get("gnomonic_sample") == \
        len(centers) * (cfg.clip_len + 1)
    keys = sorted(card._clips)
    assert keys == sorted(host._clips)
    clips = torch.stack([torch.stack(card._clips[k]) for k in keys])
    assert clips.is_cuda and clips.shape[1] == cfg.clip_len
    logits = tact.apply(card.params[rung], clips, cfg).cpu()
    ref = tact.apply(host.params[rung],
                     torch.stack([torch.stack(host._clips[k]) for k in keys]),
                     cfg)
    np.testing.assert_allclose(logits.numpy(), ref.numpy(), atol=1e-4)


@pytest.mark.cuda
def test_cuda_mixed_pod_step_uploads_each_frame_once(cuda):
    """A mixed detection + action pod through ``PodServer.step`` on the
    card: each stream's frame uploads once a tick (the detector's two
    streams to the detector backend, the action head's two to the action
    backend), no staged frame outlives its tick, the action path
    launches the gnomonic sampling kernel, and both tasks finish frames
    with finite results."""
    from repro_torch.models import action as tact
    from repro_torch.serving.server import PodServer
    from repro_torch.serving.tasks import (TorchActionBackend,
                                           build_task_streams,
                                           default_action_configs,
                                           shape_buckets_for,
                                           stream_tasks_for)

    tasks = stream_tasks_for("mixed", 4)
    videos = [make_video(n_frames=8, n_objects=20, seed=s)
              for s in (31, 32, 33, 34)]
    variants, loops, _, _ = build_task_streams(tasks, videos, [2.0] * 4)
    buckets = shape_buckets_for(tasks, 8)
    det_cfgs = [dataclasses.replace(c, width_mult=0.25, depth_mult=0.34)
                for c in tdet.PAPER_LADDER]
    det = TorchDetectorBackend(
        det_cfgs, [tdet.init_params(torch.Generator().manual_seed(i), c)
                   for i, c in enumerate(det_cfgs)],
        conf=0.01, max_det=8, buckets=buckets)
    act_cfgs = default_action_configs()
    act = TorchActionBackend(
        act_cfgs, [tact.init_params(torch.Generator().manual_seed(9 + i), c)
                   for i, c in enumerate(act_cfgs)], buckets=buckets)
    backends = [det if t == "detection" else act for t in tasks]
    for loop, backend, video in zip(loops, backends, videos):
        loop.backend = backend
        loop.seed_history(video.visible_objects(0))
    frames = {(s, f): render_erp(videos[s], f, height=480, width=960)
              for s in range(4) for f in (1, 2, 3)}
    server = PodServer(loops, backends, max_batch=8, buckets=buckets,
                       frame_source=lambda s, f: frames[(s, f)])
    _build.reset_launch_counts()
    for f in (1, 2, 3):
        server.step(f)
        assert det.frame_uploads == 2 * f
        assert act.frame_uploads == 2 * f
        assert not det._staged and not act._staged
    assert _build.launch_counts().get("gnomonic_sample", 0) > 0
    assert server.stats.frames_by_task == {"detection": 6,
                                           "action_recognition": 6}
    for loop in loops:
        for d in loop._history[-1]:
            assert np.isfinite(d.box).all() and math.isfinite(d.score)
    assert any(loop._history[-1] for loop in loops[1::2])


# -- the MoE block on the card -------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mod", [tmixtral, tqwen], ids=["mixtral", "qwen3"])
def test_cuda_moe_block_matches_cpu(cuda, mod, dtype):
    """``moe_block`` on the card (the expert products on the tensor cores
    with float32 outputs in bf16) against the same code on the CPU, at the
    smoke config's widths, 256 tokens, capacity factor 1.0 (picks
    dropped).  float32: the same routing and outputs within 1e-5.  bf16: a
    router logit one bf16 ulp apart can move a token to another expert,
    and its capacity slot moves the later tokens' drops, so at least 95%
    of the tokens route alike and those agree within 2^-6 (a few bf16
    ulps)."""
    cfg = dataclasses.replace(mod.smoke_config(), param_dtype=dtype,
                              compute_dtype=dtype, capacity_factor=1.0)
    params = tlm.init_params(torch.Generator().manual_seed(3), cfg,
                             device="cpu")
    lp = {k: v[0] for k, v in params["layers"]["moe"].items()}
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (256, cfg.d_model)).astype(np.float32)).to(dtype)
    host, card = [], []
    want, want_aux = tlm.moe_block(lp, x, cfg, host)
    got, aux = tlm.moe_block({k: v.to(cuda) for k, v in lp.items()},
                             x.to(cuda), cfg, card)
    assert got.is_cuda and got.dtype == dtype
    assert int((~host[0].keep).sum()) > 0
    same = ((card[0].expert_ids.cpu() == host[0].expert_ids)
            & (card[0].keep.cpu() == host[0].keep)).all(dim=1)
    if dtype == torch.float32:
        assert bool(same.all())
        torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)
        assert abs(float(aux) - float(want_aux)) <= 1e-6
    else:
        assert float(same.float().mean()) >= 0.95
        torch.testing.assert_close(got.cpu()[same].float(),
                                   want[same].float(), atol=2.0 ** -6,
                                   rtol=0)


# -- training on the card ---------------------------------------------------


@pytest.fixture
def fp32():
    """TF32 off in cuDNN and cuBLAS for the test, restored after."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = old


def _to(tree, device):
    return pytree.tree_map(lambda t: torch.as_tensor(t).to(device), tree)


def _two_steps(step, params, opt, batches, device):
    """(metrics, final state) of ``step`` over ``batches`` from
    ``params`` on ``device``."""
    state = tsteps.make_state(_to(params, device), opt)
    metrics = []
    for batch in batches:
        state, m = step(state, _to(batch, device))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state


def _assert_adamw_close(got, ref, lr, steps):
    diff = torch.cat([(g.cpu().float() - r.float()).abs().ravel()
                      for g, r in zip(pytree.leaves(got),
                                      pytree.leaves(ref))])
    assert float(diff.max()) <= 2 * lr * steps
    assert float(torch.quantile(diff, 0.999)) <= 1e-3 * lr


@pytest.mark.cuda
def test_cuda_lm_train_step_float32_matches_cpu(cuda, fp32):
    cfg = tsmol.smoke_config()
    params = tlm.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    opt = topt.adamw(lr=1e-3, warmup_steps=2)
    step = tsteps.lm_train_step(cfg, opt)
    batches = list(lm_batches(cfg.vocab_size, 4, 40, seed=1, n_batches=2))
    host, hstate = _two_steps(step, params, opt, batches, "cpu")
    card, cstate = _two_steps(step, params, opt, batches, cuda)
    assert cstate["params"]["embed"]["emb"].is_cuda
    for h, c in zip(host, card):
        for k in ("loss", "grad_norm"):
            assert c[k] == pytest.approx(h[k], rel=1e-5)
    _assert_adamw_close(cstate["params"], hstate["params"], 1e-3, 2)


@pytest.mark.cuda
def test_cuda_moe_train_step_bf16_matches_cpu(cuda):
    """mixtral's smoke config in bf16: the MoE block's backward on the
    card (``torch.bmm``'s float32-output form has no derivative, so under
    autograd the expert products widen to float32, as on the CPU)."""
    cfg = dataclasses.replace(tmixtral.smoke_config(),
                              param_dtype=torch.bfloat16,
                              compute_dtype=torch.bfloat16)
    params = tlm.init_params(torch.Generator().manual_seed(3), cfg,
                             device="cpu")
    batch = next(lm_batches(cfg.vocab_size, 4, 48, seed=2))
    grads = {}
    for dev in ("cpu", cuda):
        loss, g = tsteps.value_and_grad(
            lambda p: tlm.lm_loss(p, _to(batch, dev), cfg), _to(params, dev))
        grads[str(dev)] = (float(loss), g)
    (lh, gh), (lc, gc) = grads["cpu"], grads[str(cuda)]
    assert lc == pytest.approx(lh, rel=2.0 ** -6)
    for a, b in zip(pytree.leaves(gh), pytree.leaves(gc)):
        assert b.is_cuda and b.dtype == torch.bfloat16
        assert bool(torch.isfinite(b).all()) and bool((b != 0).any())
        cos = torch.nn.functional.cosine_similarity(
            a.float().ravel(), b.cpu().float().ravel(), dim=0)
        assert float(cos) >= 0.99
    # and the train step runs on the card
    opt = topt.adamw(lr=1e-3)
    state, m = tsteps.lm_train_step(cfg, opt)(
        tsteps.make_state(_to(params, cuda), opt), _to(batch, cuda))
    assert int(state["step"]) == 1 and np.isfinite(float(m["loss"]))


@pytest.mark.cuda
def test_cuda_detector_train_step_matches_cpu(cuda, fp32):
    cfg = tdet.PAPER_LADDER[0]  # yolo-tiny-416
    params = tdet.init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(5)
    batch = {"images": rng.random((2, cfg.input_size, cfg.input_size, 3)
                                  ).astype(np.float32)}
    batch.update(rasterize_targets(cfg, 2))
    opt = topt.adamw(lr=1e-3)
    step = tsteps.detector_train_step(cfg, opt)
    host, hstate = _two_steps(step, params, opt, [batch], "cpu")
    card, cstate = _two_steps(step, params, opt, [batch], cuda)
    assert card[0]["loss"] == pytest.approx(host[0]["loss"], rel=1e-5)
    assert card[0]["grad_norm"] == pytest.approx(host[0]["grad_norm"],
                                                 rel=1e-4)
    _assert_adamw_close(cstate["params"], hstate["params"], 1e-3, 1)


@pytest.mark.cuda
def test_cuda_checkpoint_round_trip(cuda, tmp_path):
    """A CUDA state (bf16 parameters, float32 moments, an int32 step)
    restores onto the card bit for bit; ``save_async`` snapshots before
    it returns."""
    cfg = tsmol.smoke_config()
    params = tlm.init_params(torch.Generator().manual_seed(0),
                             dataclasses.replace(
                                 cfg, param_dtype=torch.bfloat16), device=cuda)
    opt = topt.adamw()
    state = tsteps.make_state(params, opt)
    state["opt"]["mu"]["embed"]["emb"].normal_()
    want = [t.clone() for t in pytree.leaves(state)]
    mgr = CheckpointManager(tmp_path)
    mgr.save_async(5, state)
    state["params"]["embed"]["emb"].mul_(2)
    mgr.wait()
    got = mgr.restore(5, state)
    for g, w in zip(pytree.leaves(got), want):
        assert g.is_cuda and g.dtype == w.dtype and g.shape == w.shape
        ints = {2: torch.int16, 4: torch.int32}[w.element_size()]
        assert torch.equal(g.view(ints), w.view(ints))


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_autograd(cuda):
    q = torch.zeros((1, 16, 2, 64), device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    _build.reset_launch_counts()
    with pytest.raises(RuntimeError, match="no backward"):
        tattn.flash_attention(q, q, q)
    with pytest.raises(RuntimeError, match="no backward"):
        tattn.launch("wgmma", q, q, q)
    assert _build.launch_counts() == {}
    with torch.no_grad():
        assert tattn.flash_attention(q, q, q).shape == q.shape
