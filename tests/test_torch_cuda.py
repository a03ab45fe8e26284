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
expert).  The train steps' update, one leaf at a time
(``clip_and_update``), on a tree with one 2 GiB leaf: its peak under its
reckoning, the whole-tree composition it replaced over it, and both
bit-equal.

The vision family (no kernel: its attention is the plain one, its
convolutions cuDNN's): ``max_pool`` on the card equals the CPU's exactly,
``batchnorm`` within atol 1e-5 and rtol 1e-5 (float32 batch statistics
summed in another order); a ResNet and a ConvNeXt ``vision_train_step``
at their smoke configs, float32 with TF32 off, against the CPU's: loss
and grad norm rtol 1e-4, accuracy exactly, the parameters as two AdamW
runs above, the batchnorm running stats atol 1e-5.

The diffusion family (no kernel: its attention is the plain ``_mha``):
a denoise step and a ``diffusion_train_step`` of the flux-dev and
unet-sdxl smoke configs, float32 with TF32 off, against the CPU's (flux's
modulation drawn non-zero; the train step's draws come from a CPU
generator, so both devices draw the same): the denoised latents atol
1e-4, rtol 1e-4; loss and grad norm rtol 1e-4; the parameters as two
AdamW runs above.

The launch layer (no kernel: its cells' attention is plain or
``chunked``): a smoke cell counted on fake CUDA tensors, on real ones
and on fake CPU tensors alike, and the counter refusing a step that
launches a kernel.

The multi-device path (no kernel: the all-to-all block's products are
the MoE block's), on one card, so over an NCCL process group of world
size 1 (NCCL refuses two ranks on one GPU): ``moe_block_a2a`` on a
(1, 1) mesh against ``moe_block`` at the mixtral smoke config, in
float32 and bf16, with and without drops (output, aux and every
gradient of ``sum(out**2)`` bit for bit: at one model rank the exchange
moves nothing), and ``compressed_psum_step`` on the card equal to its
compressor's payload, bit for bit.

Kimi-VL-A3B (no kernel: its attention is PyTorch's SDPA and plain
products, its experts batched products): one MoonViT block, the dense
layer and one MoE layer at the published widths, two crops prefilled and
decoded together through the latent cache in bfloat16, against the
float32 reference teacher-forced with the port's ids and expert picks
(the picks within 2^-6 of the reference's top 6 in score, each answer
position's logits within 2^-5 in relative norm).

The serving policies and the LM paths never run before on the card: the
pod under ``deadline`` and ``async`` (then ``flush``) against the same
pod on the CPU (equal schedules, detections within 1e-3), the batched
projection at the 1280 rung's crop size against the float64 map, and
granite's MQA smoke config through the flash entry against ``chunked``
on the CPU (prefill and decode logits and the cache within 1e-4).
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
from repro_torch.models import layers as tlayers
from repro_torch.models import vision as tvis
from repro_torch.models import transformer as tlm
from repro_torch.serving.scheduler import TorchDetectorBackend
from repro_torch import pytree
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import convnext_b as tconvnext
from repro_torch.configs import flux_dev as tflux
from repro_torch.configs import unet_sdxl as tunet
from repro_torch.models import diffusion as tdiff
from repro_torch.configs import resnet_50 as tresnet50
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
# the float32 kernel's split and K/V ring: smollm-135m's layout at the
# float32 policy's 1 x 2048 prefill (a cluster of CTAs a row tile) and one
# past it, a q_offset with a window that crosses the split's tiles, and
# D=128 in float32
FLASH_CASES += [
    dict(b=1, sq=2048, skv=2048, hq=9, hkv=3, d=64, causal=True, window=None),
    dict(b=1, sq=2049, skv=2049, hq=9, hkv=3, d=64, causal=True, window=None),
    dict(b=1, sq=1000, skv=1500, hq=9, hkv=3, d=64, causal=True, window=700),
    dict(b=1, sq=1100, skv=1100, hq=4, hkv=2, d=128, causal=True,
         window=None),
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
@pytest.mark.parametrize("case,dtype", [
    (FLASH_CASES[-4], torch.float32),  # 1 x 2048: split across a cluster
    (FLASH_CASES[-2], torch.float32),  # q_offset and a window
    (dict(b=4, sq=2048, skv=2048, hq=9, hkv=3, d=64, causal=True,
          window=None), torch.float32),  # no split
    (dict(FLASH_CASES[-2], d=32), torch.bfloat16),
])
def test_cuda_flash_attention_is_bit_equal_across_launches(cuda, case, dtype):
    """The float32 kernel combines a row tile's partials in a fixed order,
    so two launches on the same inputs give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(7)

    def mk(s, h):
        return torch.randn((case["b"], s, h, case["d"]), generator=gen,
                           device=cuda).to(dtype)
    q, k, v = mk(case["sq"], case["hq"]), mk(case["skv"], case["hkv"]), \
        mk(case["skv"], case["hkv"])
    kw = dict(causal=case["causal"], window=case["window"],
              q_offset=case["skv"] - case["sq"])
    first = tattn.launch("simt", q, k, v, **kw)
    assert torch.equal(first, tattn.launch("simt", q, k, v, **kw))


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_copies_unaligned_views(cuda, dtype):
    """Both kernels read whole 16-byte chunks of a row: views whose base
    lies off 16 bytes are copied first (one launch all the same)."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    flat = torch.randn(2 * 90 * 15 * 32 + 1, generator=gen, device=cuda
                       ).to(dtype)[1:]
    qkv = flat.view(2, 90, 15, 32)
    q, k, v = qkv[:, 30:, :9], qkv[:, :, 9:12], qkv[:, :, 12:]
    assert not tattn.tma_ok(q)
    _build.reset_launch_counts()
    got = tattn.flash_attention(q, k, v, causal=True, q_offset=30)
    assert _build.launch_counts() == {"flash_attention": 1}
    ref = flash_attention_ref(q, k, v, causal=True, q_offset=30)
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=2e-5, rtol=1e-4)
    else:
        excess = (got.float() - ref.float()).abs() \
            - 2.0 ** -7 * ref.float().abs()
        assert float(excess.max()) <= 2e-5


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


def _card_pod(backend, videos, **kw):
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
                     frame_source=source, **kw)


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
@pytest.mark.parametrize("policy,ticks", [("deadline", 3), ("async", 4)])
def test_cuda_policy_pod_matches_cpu(cuda, policy, ticks):
    """``PodServer`` under ``deadline`` and ``async`` (then ``flush``) on
    the card against the same pod on the CPU, tick by tick: equal
    dispatches (variant and batch, in order) and each finished frame's
    detections within 1e-3; the async pod carries requests, and nothing
    is left queued, in flight or staged after the flush.

    After each tick the CPU loops take the card loops' detection history:
    SRoIs are predicted from it, and the float32 differences of the two
    devices' detections (~1e-5), fed back tick after tick through a
    random-weight detector, move the SRoIs and so the next tick's crops
    and plans apart.  Each tick is held on the same inputs instead."""
    cfgs = [dataclasses.replace(tdet.PAPER_LADDER[i], input_size=64,
                                n_classes=16, width_mult=0.25,
                                depth_mult=0.34) for i in (0, 1)]
    params = [tdet.init_params(torch.Generator().manual_seed(i), c,
                               device="cpu") for i, c in enumerate(cfgs)]
    videos = [make_video(n_frames=8, n_objects=20, seed=s) for s in (7, 8, 9)]
    pods, backends, done = [], [], []
    for dev in (cuda, "cpu"):
        backend = TorchDetectorBackend(cfgs, params, conf=0.01, max_det=4,
                                       device=dev)
        pod = _card_pod(backend, videos, policy=policy)
        rows = []
        for loop in pod.loops:
            inner = loop.finalize_detections

            def finalize(res, keep, inner=inner, rows=rows):
                inner(res, keep)
                rows.append(list(res.detections))

            loop.finalize_detections = finalize
        pods.append(pod)
        backends.append(backend)
        done.append(rows)
    n = 0
    for f in range(1, ticks + 2):  # the last round is the flush
        for pod, rows in zip(pods, done):
            rows.clear()
            n_tl = len(pod.timelines)
            pod.step(f) if f <= ticks else pod.flush()
            pod.tick_events = [(ev.variant, ev.b) for tl in
                               pod.timelines[n_tl:] for ev in tl.events]
        assert pods[0].tick_events == pods[1].tick_events
        assert len(done[0]) == len(done[1])
        for got, want in zip(*done):
            assert [d.category for d in got] == [d.category for d in want]
            for a, b in zip(got, want):
                np.testing.assert_allclose(a.box, b.box, atol=1e-3, rtol=0)
                assert a.score == pytest.approx(b.score, abs=1e-3)
            n += len(got)
        for card_loop, host_loop in zip(pods[0].loops, pods[1].loops):
            host_loop._history = [list(h) for h in card_loop._history]
    card, host = (p.stats for p in pods)
    assert card.frames == host.frames == len(videos) * ticks
    assert (card.dispatches, card.batch_sizes, card.carried_requests) == \
        (host.dispatches, host.batch_sizes, host.carried_requests)
    if policy == "async":
        assert card.carried_requests > 0
    for pod, backend in zip(pods, backends):
        assert not len(pod.queues) and not pod._inflight
        assert not backend._staged
    assert n > 0


@pytest.mark.cuda
def test_cuda_project_srois_batched_1280(cuda):
    """The batched projection at the 1280 rung's crop size (two crops, one
    with a pole inside) against the crops projected with a float64 map:
    at most twice as far from them as the plain version, + 5e-5."""
    frames = _erp(12, (480, 960, 3))[None].to(cuda)
    centers = np.array([[0.7, 0.1], [-2.2, 1.2]], np.float32)
    fovs = np.array([[1.1, 0.9], [1.4, 1.3]], np.float32)
    got = tgno.project_srois_batched(frames, [0, 0], centers, fovs,
                                     (1280, 1280))
    ref = project_srois_ref(frames, torch.tensor([0, 0]),
                            torch.from_numpy(centers), torch.from_numpy(fovs),
                            (1280, 1280))
    assert got.shape == (2, 1280, 1280, 3)
    for i in range(2):
        exact = project_sroi_f64(frames[0], float(centers[i, 0]),
                                 float(centers[i, 1]), fovs[i].tolist(), 1280)
        err_k = float((got[i].double() - exact).abs().max())
        err_p = float((ref[i].double() - exact).abs().max())
        assert err_k <= 2 * err_p + 5e-5


@pytest.mark.cuda
def test_cuda_granite_mqa_flash_matches_cpu_chunked(cuda):
    """granite's smoke config (MQA: 4 query heads on 1 KV head) with
    ``attention_impl="flash"`` on the card (the float32 kernel) against
    ``chunked`` on the CPU: the prefill's and 4 decode steps' logits and
    the one-head cache."""
    from repro_torch.configs import granite_34b as tgranite

    cfg = tgranite.smoke_config()
    assert cfg.n_kv_heads == 1
    params = tlm.init_params(torch.Generator().manual_seed(5), cfg,
                             device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 52),
                         generator=torch.Generator().manual_seed(6))
    outs = {}
    for dev, impl in ((cuda, "flash"), ("cpu", "chunked")):
        c = dataclasses.replace(cfg, attention_impl=impl)
        p = _to(params, dev)
        before = _build.launch_counts().get("flash_attention", 0)
        out = tsteps.lm_prefill_step(c, 52)(p, {"tokens": toks[:, :48]
                                                .to(dev)})
        if impl == "flash":
            assert _build.launch_counts().get("flash_attention", 0) == \
                before + cfg.n_layers
        logits = [out["logits"].cpu()]
        for i in range(48, 52):  # teacher-forced
            out = tsteps.lm_decode_step(c)(p, {
                "token": toks[:, i].to(dev), "cache_k": out["k"],
                "cache_v": out["v"], "cache_len": out["length"]})
            logits.append(out["logits"].cpu())
        outs[impl] = (logits, out["k"].cpu())
    (got, k_got), (want, k_want) = outs["flash"], outs["chunked"]
    assert k_got.shape == (cfg.n_layers, 2, 52, 1, cfg.d_head)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
    torch.testing.assert_close(k_got, k_want, atol=1e-4, rtol=0)


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


def _wide_tree(seed, dtype, device):
    """A 64x128 matrix and a 128 vector from a numpy seed, in ``dtype``."""
    rng = np.random.default_rng(seed)
    return {"a": {"w": torch.from_numpy(rng.standard_normal(
                      (64, 128)).astype(np.float32)).to(device, dtype),
                  "b": torch.from_numpy(rng.standard_normal(
                      128).astype(np.float32)).to(device, dtype)}}


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype", [
    ("adamw", torch.bfloat16), ("adamw", torch.float32),
    ("sgd", torch.bfloat16)])
def test_cuda_bf16_optimizer_update_matches_cpu(cuda, name, dtype):
    """AdamW with bf16 moments (over bf16 and float32 parameters) and SGD
    on bf16 parameters: 12 updates on the card against the same updates
    on the CPU, bit for bit.  Both round each operation alike: bf16
    products and sums (float32 arithmetic rounded once), IEEE float32
    quotients, and square roots rounded to nearest (the optimizer's own
    on the CPU, ``sqrtf`` on the card)."""
    opt = (topt.adamw(lr=0.05, weight_decay=0.1, warmup_steps=3,
                      state_dtype=torch.bfloat16) if name == "adamw"
           else topt.sgd(lr=0.05, momentum=0.9, weight_decay=0.01))
    runs = {}
    for dev in ("cpu", cuda):
        params = _wide_tree(0, dtype, dev)
        state = opt.init(params)
        with torch.no_grad():
            for i in range(12):
                params, state = opt.update(_wide_tree(100 + i, dtype, dev),
                                           params, state)
        runs[str(dev)] = (params, state)
    (hp, hs), (cp, cs) = runs["cpu"], runs[str(cuda)]
    for h, c in zip(pytree.leaves((hp, hs)), pytree.leaves((cp, cs))):
        assert c.is_cuda and c.dtype == h.dtype
        assert torch.equal(c.cpu(), h)
    assert int(cs["step"]) == 12


@pytest.mark.cuda
def test_cuda_moe_train_step_bf16_moments_matches_cpu(cuda):
    """One ``lm_train_step`` of mixtral's smoke config in bf16 with
    ``adamw(state_dtype=bfloat16)``, as the card trains mixtral-8x22b,
    against the CPU's, within the bf16 MoE step's tolerances above: loss
    and grad norm rtol 2^-6; each moment leaf's cosine with the CPU's at
    least 0.99 (the step-1 moments are the rounded gradient and its
    square); every parameter within 2 lr of the CPU's (one AdamW step)."""
    cfg = dataclasses.replace(tmixtral.smoke_config(),
                              param_dtype=torch.bfloat16,
                              compute_dtype=torch.bfloat16)
    params = tlm.init_params(torch.Generator().manual_seed(3), cfg,
                             device="cpu")
    batch = next(lm_batches(cfg.vocab_size, 4, 48, seed=2))
    lr = 1e-3
    opt = topt.adamw(lr=lr, warmup_steps=2, state_dtype=torch.bfloat16)
    step = tsteps.lm_train_step(cfg, opt)
    (hm,), hstate = _two_steps(step, params, opt, [batch], "cpu")
    (cm,), cstate = _two_steps(step, params, opt, [batch], cuda)
    for k in ("loss", "grad_norm"):
        assert cm[k] == pytest.approx(hm[k], rel=2.0 ** -6)
    for k in ("mu", "nu"):
        for h, c in zip(pytree.leaves(hstate["opt"][k]),
                        pytree.leaves(cstate["opt"][k])):
            assert c.is_cuda and c.dtype == torch.bfloat16
            cos = torch.nn.functional.cosine_similarity(
                h.float().ravel(), c.cpu().float().ravel(), dim=0)
            assert float(cos) >= 0.99
    for h, c in zip(pytree.leaves(hstate["params"]),
                    pytree.leaves(cstate["params"])):
        assert c.dtype == torch.bfloat16
        assert float((c.cpu().float() - h.float()).abs().max()) <= 2 * lr


# bytes a slice element of the leaf update's temporaries, at most: the
# clipped float32 gradient (4) and up to 8 float32 values of AdamW's upd
# alive at once (the new moments and parameter among them: 32), rounded
# up
LEAF_SLICE_BYTES = 40


@pytest.mark.cuda
def test_cuda_leaf_update_peak(cuda, monkeypatch):
    """The train steps' update (``clip_and_update``) on a tree with one
    2 GiB leaf (8 x 8192 x 8192 float32, updated in 8 slices of
    ``SLICE_ELEMS``) and two small ones, AdamW with float32 moments, on
    the card.  Its peak above what it starts with (the state and the
    gradients) stays under its reckoning: the new state, 12 bytes an
    element, plus ``LEAF_SLICE_BYTES`` a slice element.  The composition
    the train steps used before is the control: ``clip_by_global_norm``
    then ``update`` on whole leaves (no slice), whose clipped copy (4
    bytes an element) and the whole leaf's temporaries take it past that
    reckoning.  Both give the same bits."""
    shapes = {"big": (8, 8192, 8192), "b": (4096,), "w": (64, 128)}

    def tree(seed):
        gen = torch.Generator(device=cuda).manual_seed(seed)
        return {k: torch.randn(s, generator=gen, device=cuda)
                for k, s in shapes.items()}

    opt = topt.adamw(lr=1e-3, weight_decay=0.01)
    params = tree(0)
    state = opt.init(params)
    n = sum(t.numel() for t in pytree.leaves(params))
    reckoned = 12 * n + LEAF_SLICE_BYTES * topt.SLICE_ELEMS

    def peak(fn):
        torch.cuda.synchronize(cuda)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(cuda)
        base = torch.cuda.memory_allocated(cuda)
        out = fn()
        torch.cuda.synchronize(cuda)
        return out, torch.cuda.max_memory_allocated(cuda) - base

    with torch.no_grad():
        leaves, treedef = pytree.flatten(tree(1))
        (new_p, new_s, new_norm), new_peak = peak(
            lambda: topt.clip_and_update(opt, leaves, treedef, params, state,
                                         1.0))
        assert all(g is None for g in leaves)
        grads = tree(1)
        monkeypatch.setattr(topt, "SLICE_ELEMS", 1 << 62)

        def whole():
            clipped, norm = topt.clip_by_global_norm(grads, 1.0)
            return opt.update(clipped, params, state), norm

        ((old_p, old_s), old_norm), old_peak = peak(whole)
    assert new_peak <= reckoned < old_peak, (new_peak, reckoned, old_peak)
    assert torch.equal(new_norm, old_norm)
    for a, b in zip(pytree.leaves((new_p, new_s)),
                    pytree.leaves((old_p, old_s))):
        assert a.is_cuda and a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_detector_train_step_matches_cpu(cuda, fp32):
    # yolo-tiny-416; the plain norm-activation tail, as the kernel has no
    # backward
    cfg = dataclasses.replace(tdet.PAPER_LADDER[0], norm_act_impl="plain")
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


@pytest.mark.cuda
@pytest.mark.parametrize("size", [8, 15, 112])
def test_cuda_max_pool_equals_cpu(cuda, size):
    x = _erp(size, (2, 5, size, size))
    host = tlayers.max_pool(x, 3, 2)
    card = tlayers.max_pool(x.to(cuda), 3, 2)
    assert torch.equal(card.cpu(), host)


@pytest.mark.cuda
@pytest.mark.parametrize("train", [False, True])
def test_cuda_batchnorm_matches_cpu(cuda, train):
    rng = np.random.default_rng(4)
    p = {k: torch.from_numpy(rng.random(6).astype(np.float32) + 0.5)
         for k in ("scale", "bias", "mean", "var")}
    x = torch.from_numpy(rng.standard_normal((4, 6, 9, 9)).astype(
        np.float32) * 2 + 1)
    y_h, s_h = tlayers.batchnorm(p, x, train=train)
    y_c, s_c = tlayers.batchnorm(_to(p, cuda), x.to(cuda), train=train)
    torch.testing.assert_close(y_c.cpu(), y_h, atol=1e-5, rtol=1e-5)
    for k in ("mean", "var"):
        assert s_c[k].is_cuda and s_c[k].dtype == torch.float32
        torch.testing.assert_close(s_c[k].cpu(), s_h[k], atol=1e-5, rtol=0)


def _bn_leaves(tree):
    out = []

    def walk(t):
        if isinstance(t, dict):
            for k, v in t.items():
                (out.append(v) if k in ("mean", "var") else walk(v))
        elif isinstance(t, list):
            for v in t:
                walk(v)
    walk(tree)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("mod", [tresnet50, tconvnext])
def test_cuda_vision_train_step_matches_cpu(cuda, fp32, mod):
    cfg = mod.smoke_config()
    params = tvis.init_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    rng = np.random.default_rng(6)
    batch = {"images": rng.standard_normal(
        (4, cfg.img_res, cfg.img_res, 3)).astype(np.float32),
        "labels": rng.integers(0, cfg.n_classes, 4).astype(np.int32)}
    opt = topt.adamw(lr=1e-3)
    step = tsteps.vision_train_step(cfg, opt)
    host, hstate = _two_steps(step, params, opt, [batch], "cpu")
    card, cstate = _two_steps(step, params, opt, [batch], cuda)
    for k in ("loss", "grad_norm"):
        assert card[0][k] == pytest.approx(host[0][k], rel=1e-4)
    assert card[0]["accuracy"] == host[0]["accuracy"]
    _assert_adamw_close(cstate["params"], hstate["params"], 1e-3, 1)
    for c, h in zip(_bn_leaves(cstate["params"]),
                    _bn_leaves(hstate["params"])):
        assert c.is_cuda
        torch.testing.assert_close(c.cpu(), h, atol=1e-5, rtol=0)


def _diffusion_batches(cfg, seed):
    """(a denoise step's batch, a train step's batch) of ``cfg``, numpy."""
    rng = np.random.default_rng(seed)
    b, r = 2, cfg.latent_res

    def randn(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    lat = randn(b, r, r, cfg.latent_ch)
    if isinstance(cfg, tdiff.MMDiTConfig):
        cond = {"ctx": randn(b, cfg.n_ctx_tokens, cfg.d_ctx),
                "pooled": randn(b, cfg.d_pooled)}
        denoise = {"t": np.array([0.9, 0.4], np.float32),
                   "dt": np.full(b, 0.25, np.float32),
                   "guidance": np.full(b, 3.5, np.float32)}
    else:
        cond = {"ctx": randn(b, cfg.n_ctx_tokens, cfg.ctx_dim),
                "add_emb": randn(b, cfg.d_add)}
        denoise = {"t": np.array([750.0, 400.0], np.float32),
                   "t_prev": np.array([500.0, 150.0], np.float32)}
    return ({"latents": lat, **cond, **denoise},
            {"latents": lat, **cond, "seed": np.array(9, np.int32)})


@pytest.mark.cuda
@pytest.mark.parametrize("mod", [tflux, tunet])
def test_cuda_diffusion_steps_match_cpu(cuda, fp32, mod):
    cfg = mod.smoke_config()
    params = tdiff.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    if isinstance(cfg, tdiff.MMDiTConfig):
        params = tdiff.perturb_modulation(params,
                                          torch.Generator().manual_seed(1))
    dbatch, tbatch = _diffusion_batches(cfg, 8)
    denoise = tsteps.diffusion_denoise_step(cfg)
    host = denoise(params, _to(dbatch, "cpu"))["latents"]
    card = denoise(_to(params, cuda), _to(dbatch, cuda))["latents"]
    assert card.is_cuda and card.dtype == torch.float32
    torch.testing.assert_close(card.cpu(), host, atol=1e-4, rtol=1e-4)
    opt = topt.adamw(lr=1e-3)
    step = tsteps.diffusion_train_step(cfg, opt)
    host, hstate = _two_steps(step, params, opt, [tbatch], "cpu")
    card, cstate = _two_steps(step, params, opt, [tbatch], cuda)
    for k in ("loss", "grad_norm"):
        assert card[0][k] == pytest.approx(host[0][k], rel=1e-4)
    _assert_adamw_close(cstate["params"], hstate["params"], 1e-3, 1)


def _smoke_cell(arch_id: str, shape, **cfg_kw):
    from repro_torch.configs import base as tbase
    from repro_torch.launch import cells as tcells

    arch = tbase.get_arch(arch_id)
    arch = dataclasses.replace(
        arch, config=dataclasses.replace(arch.smoke, **cfg_kw))
    build = {"lm": tcells._lm_cell, "vision": tcells._vision_cell,
             "diffusion": tcells._diffusion_cell}[arch.family]
    return build(arch, shape)


_BF16 = dict(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
_CELL_SHAPES = {
    "smollm_135m": (dict(kind="train", seq_len=64, global_batch=2), {}),
    # bf16: on the card the experts' products take bmm's float32-output
    # overload (the CPU widens its operands instead)
    "mixtral_8x22b": (dict(kind="prefill", seq_len=64, global_batch=2),
                      _BF16),
    "resnet_50": (dict(kind="serve", img_res=64, batch=2), {}),
    "unet_sdxl": (dict(kind="generate", img_res=128, batch=2), {}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("arch_id", sorted(_CELL_SHAPES))
def test_cuda_cell_counts_fake_real_and_cpu_alike(cuda, arch_id):
    """A smoke cell's count on fake CUDA tensors equals its count on real
    seeded CUDA tensors (FLOPs in total and by dtype, bytes and ops) and
    on fake CPU tensors (FLOPs)."""
    from repro_torch.configs import base as tbase
    from repro_torch.launch import cells as tcells
    from repro_torch.launch import dryrun
    from repro_torch.launch.hloanalysis import analyze

    shape, cfg_kw = _CELL_SHAPES[arch_id]
    cell = _smoke_cell(arch_id, tbase.ShapeSpec("smoke", **shape), **cfg_kw)
    fake = dryrun.count_cell(cell, cuda)
    real = analyze(cell.step, *tcells.materialize(cell, device=cuda, seed=5))
    host = dryrun.count_cell(cell, "cpu")
    assert fake["flops"] > 0
    for key in ("flops", "flops_by_dtype", "hbm_bytes", "n_ops"):
        assert fake[key] == real[key], key
    # equal in total; not split alike: the CPU widens the MoE experts'
    # bf16 products to float32
    assert host["flops"] == fake["flops"]


@pytest.mark.cuda
def test_cuda_analyze_refuses_a_flash_launch(cuda):
    """A step that launches ``flash_attention`` is refused: the kernel's
    work is invisible to the counter."""
    from repro_torch.launch.hloanalysis import analyze

    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(1, 128, 2, 64, generator=gen, device=cuda,
                           dtype=torch.bfloat16) for _ in range(3))
    before = dict(_build.launch_counts())
    with pytest.raises(RuntimeError, match="flash_attention_wgmma"):
        analyze(lambda *a: tattn.flash_attention(*a, causal=True), q, k, v)
    assert _build.launch_counts()["flash_attention_wgmma"] == \
        before.get("flash_attention_wgmma", 0) + 1


# -- the multi-device path, world size 1 -------------------------------------


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from repro_torch.distributed import collectives as tcoll

    mesh = tcoll.init_mesh((1, 1), ("data", "model"), "cuda", rank=0,
                           store=str(tmp_path_factory.mktemp("nccl")
                                     / "store"))
    yield mesh
    dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cf", [1.0, 16.0])
def test_cuda_moe_a2a_world1_is_moe_block(nccl_mesh, dtype, cf):
    from repro_torch.distributed.sharding import use_mesh

    cfg = dataclasses.replace(tmixtral.smoke_config(), capacity_factor=cf,
                              param_dtype=dtype, compute_dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = tlm._layer_params(tlm.init_params(gen, cfg, "cuda"), 0)["moe"]
    x = torch.randn(256, cfg.d_model, generator=gen, device="cuda",
                    dtype=dtype)
    res = []
    with use_mesh(nccl_mesh):
        for blk in (tlm.moe_block, tlm.moe_block_a2a):
            pg = {k: v.clone().requires_grad_() for k, v in p.items()}
            out, aux = blk(pg, x, cfg)
            (out.float() ** 2).sum().backward()
            res.append([out.detach(), aux.detach()]
                       + [pg[k].grad for k in sorted(pg)])
    assert all(torch.equal(a, b) for a, b in zip(*res))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "topk"])
def test_cuda_compressed_psum_world1(nccl_mesh, mode):
    from repro_torch.training import compression as tcomp

    gen = torch.Generator(device="cuda").manual_seed(1)
    g = {"a": torch.randn(64, 96, generator=gen, device="cuda"),
         "b": torch.randn(333, generator=gen, device="cuda")}
    st = tcomp.CompressionState.zeros_like(g)
    mean, new = tcomp.compressed_psum_step(g, st, "data", mode, nccl_mesh)
    if mode == "bf16":
        payload, want_st = tcomp.bf16_compress(g, st)
        want = tcomp.bf16_decompress(payload)
    else:
        payload, want_st = tcomp.topk_compress(g, st)
        want = tcomp.topk_decompress(payload, g)
    for k in g:
        assert mean[k].device.type == "cuda"
        assert torch.equal(mean[k], want[k]), k
        assert torch.equal(new.residual[k], want_st.residual[k]), k


@pytest.mark.cuda
def test_cuda_kimi_vl_layers_at_published_widths(cuda):
    """Kimi-VL-A3B at its published widths cut to one MoonViT block, the
    dense layer and one MoE layer: two crops (448 and 672 px, 256 and
    576 image tokens) prefilled and decoded together for 3 steps through
    the latent cache in bfloat16, against the float32 reference's full
    forward of each, teacher-forced with the port's ids and expert picks.
    The picks fall short of the reference's own top 6 by under 2^-6 in
    ``s + b`` (bfloat16 moves a score by ~2^-9), and every answer
    position's logit row lies within 2^-5 of the reference's in relative
    norm (bf16 products round to 2^-9, two layers and the vision block
    compounding them)."""
    import copy

    from repro_torch.configs import kimi_vl_a3b
    from repro_torch.models import kimi_vl as K
    from repro_torch.models import kimi_vl_ref as R
    from repro_torch.device import set_bf16_policy

    set_bf16_policy()
    d = copy.deepcopy(kimi_vl_a3b.PUBLISHED)
    d["num_hidden_layers"] = 2
    d["vision_config"]["num_hidden_layers"] = 1
    cfg = K.config_from_dict(d)
    params = K.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                           device=cuda)
    pre, post = (torch.arange(5, 21, device=cuda),
                 torch.arange(40, 48, device=cuda))
    g = torch.Generator(device=cuda).manual_seed(1)
    crops = [torch.rand((1, s, s, 3), generator=g, device=cuda)
             for s in (448, 672)]
    calls = []
    route = K.route

    def tapped(p, x, c):
        out = route(p, x, c)
        calls.append(out[0])
        return out

    K.route = tapped
    try:
        chunks, pre_routes = [], []
        with torch.inference_mode():
            for c in crops:
                emb = K.prompt_embeds(params, pre, K.image_tokens(params, c,
                                                                  cfg), post)
                calls.clear()
                last, lat = K.prefill(params["lm"], emb, cfg.lm)
                pre_routes.append(calls[0])
                chunks.append((last.argmax(-1), lat, last))
            calls.clear()
            fed, logits, _ = K.generate(params, [(a, b) for a, b, _ in
                                                 chunks], cfg, 3)
    finally:
        K.route = route
    for r, crop in enumerate(crops):
        forced = [None, torch.cat([pre_routes[r]]
                                  + [calls[s][r:r + 1] for s in range(3)])]
        want, gap = R.forward(params, crop[0], pre, post, fed[:, r], d,
                              forced)
        assert gap < 2 ** -6
        got = torch.stack([chunks[r][2][0]] + [s[r] for s in logits])
        rel = (got - want[-4:]).norm(dim=-1) / want[-4:].norm(dim=-1)
        assert float(rel.max()) < 2 ** -5, rel
