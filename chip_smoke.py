#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU, end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from the sources in the checkout (one ``nvcc``
   per source, all started together), and print the ``-Xptxas -v``
   report (registers, spills, shared memory) of the tensor-core flash
   kernel, the greedy suppression's two kernels, the batched projection
   and the SphIoU kernels (self and general path);
3. each kernel against its plain PyTorch version on the card, at the
   main path's shapes: max |err| against the stated tolerance, the
   kernel's, the plain version's and (where one PyTorch call computes
   the same function) that call's time in ms, and the least time the
   card could take (``bound_ms``).  The batched projection and the greedy
   suppression are also checked and timed at a batched tick's own shapes
   (9 crops at 896 and at 416; 4 rows of 128 on the float32 IoU and on
   the bf16 option's), the gnomonic outputs are printed as digests (two
   builds that print the same digest agree bit for bit), and the greedy
   kernel is held to its plain version on rows with NaN, +inf and signed
   zero scores.  SphIoU's two entries (float32 and bf16) are checked and
   timed at 32x512 and at a tick's 4x128 on the self path (the boxes
   against themselves, as NMS calls it; its output must be exactly
   symmetric) and on the general path (a copy of the boxes), after a
   check over every finite float32 of the trig identities the kernel
   rests on.  Flash attention's two kernels are
   checked on the reference's six test cases (the SIMT kernel in float32
   and bf16 at their head sizes, the tensor-core kernel in bf16 at D=64
   and D=128), at smollm-135m's 4x2048 shape (float32 on the SIMT
   kernel, bf16 on both), at the float32 policy's 1x2048 (the SIMT
   kernel's path shape, timed beside SDPA in float32), at 32k (the
   tensor-core kernel against the SIMT one), and, at D=128, at
   mixtral-8x22b's prefill layout (2x8192, 48/8 heads, window 4096) and
   granite-34b's MQA layout (1x4096, 48/1 heads), each with a control
   that drops one K/V tile and must fail; then the tensor-core kernel,
   the SIMT kernel, SDPA (with a boolean band mask for a window) and the
   plain version are timed in turn.  The bf16 SphIoU option is also checked
   against the float32 kernel's keep masks (the reference's flip gate);
4. a small input through the per-request path on the card and on the
   CPU: the same SRoIs and plans, PIs, detector heads and detection
   scores within tolerance;
5. the main path at full width: the five-rung ``PAPER_LADDER``
   (416-1280 px inputs, published widths, 80 classes, random weights
   from a seeded generator) on synthetic 1920x3840 ERP video.  One
   stream runs ``OmniSenseLoop.process_frame`` for 2 frames (the
   per-request path: gnomonic sampling kernel), and one of its SRoIs goes
   through ``infer_sroi`` at every rung; then 4 streams run 3 pod
   ticks through ``PodServer.step`` under the sync policy (the tick's
   frames staged once, from pinned memory; emission; the variant queues
   drained into bucketed ``launch_srois_batched`` chunks with the fused
   projection and crop cache; ingestion with ``_suppress_tick``'s one
   batched NMS over the padded rows), and each tick's padded rows once
   more through the bf16 SphIoU option (``iou_dtype=torch.bfloat16``),
   its keep flips against the server's float32 suppression reported.
   Each tick line gives the wall ms split into emission, drain and
   ingestion, the requests per variant, the detections before and after
   NMS, the frame uploads (one a stream) and crop-cache hits, and the NMS
   backend and padded rows.  Launch counts are set to 0 just before each
   of the two paths and read just after; every kernel must have run.
   Then the serve launcher (``repro_torch.launch.serve``) runs its
   oracle pod under ``--policy async --pod-allocate``;
6. the mixed-task pod: 4 streams (``stream_tasks_for("mixed", 4)``) on
   the same synthetic 1920x3840 video, built through the task registry
   (``build_task_streams``: the union ladder, each task's latency model)
   and served by the real backends: the 2 detection streams by
   ``TorchDetectorBackend`` on the full ``PAPER_LADDER``, the 2 action
   streams by ``TorchActionBackend`` on all four ``ACTION_LADDER`` rungs
   at their published shapes (d_model 64, seeded random weights).  3
   ticks through ``PodServer.step`` (sync policy, ``max_batch`` 8); each
   tick line gives the wall ms split into emission, drain and ingestion,
   the requests per (task, variant), the action predictions, the
   detections before and after NMS, the frame uploads (one a stream) and
   the action path's ``gnomonic_sample`` launches, counted apart from the
   detection streams'.  Then every action rung runs a batch of 8 at its
   published shape through ``infer_srois_batched``, with the kernel and
   with the plain projection on the card: logits within
   ``ACTION_LOGIT_ATOL``, equal categories, and the kernel's crops held to
   the float64 map.  Then the replay lane on the oracle backends (host
   only): ``repro_torch.launch.replay record`` and ``check`` of a closed
   corpus (8 streams, async, ``--pod-allocate``), a mixed-task open-loop
   corpus (``--slo 2.0 --admission slo``) and a 2-pod fleet corpus
   (``--routing affinity``), each of which must replay bit-identically,
   and the serve launcher's ``--open-loop --pods 2 --tasks mixed`` fleet;
7. the LM serving path at full width: smollm-135m (``full_config()``,
   published widths, 30 layers, bf16 weights from a seeded generator)
   with ``attention_impl="flash"``: ``lm_prefill_step`` on 4 prompts of
   2048 tokens, 32 greedy ``lm_decode_step``s, then one prefill of
   32768 tokens (``prefill_32k``'s length; its batch cut from 32 to 1).
   Prefill ms per request, decode ms per token, the generated tokens'
   digest and the kernels' launches are printed (the tensor-core kernel
   2 x 30 times, the SIMT kernel never); logits must be finite,
   the 4x2048 prefill's logits must agree with the same step under
   ``attention_impl="chunked"``, the attention of each of its layers and
   the 32k prefill's layer-0 attention with the chunked plain version
   within one bf16 ulp and ``ATTN_BF16_ATOL``, a limit that a control
   with one K/V tile dropped must fail.  Launch counts are set to 0 before
   the path and read after it.  Then the same model under the float32
   policy (the reference's float32 path) prefills 1 x 2048 tokens, which
   runs the SIMT kernel 30 times, counted on its own and held to the
   chunked plain version's logits;
8. the MoE LM serving path at published widths (``MOE_RUNS``; its cuts
   are in ``run_moe_path``): mixtral-8x22b (8 of 56 layers, 8 experts
   top-2, window 4096) prefills 2 prompts of 8192 tokens and decodes 32
   greedy tokens; qwen3-moe-235b-a22b (2 of 94 layers, 128 experts
   top-8) prefills 1 x 4096.  Prefill ms per request, decode ms per
   token, the generated tokens' digest, the picks each layer dropped in
   prefill and in decode, and the launches are printed (the tensor-core
   kernel once a layer of each prefill, the SIMT kernel never); logits
   must be finite, each layer's attention within one bf16 ulp and
   ``ATTN_BF16_ATOL`` of the chunked plain version (the control drops a
   tile inside the window of the last rows), and layer 0's MoE block
   within its bf16 roundings (``MOE_U``) of a per-token float32
   formulation, which a control with one kept pick zeroed must fail.
   The logits against the chunked step are held to ``LM_LOGIT_ATOL``
   where every layer routed alike;
9. training (no kernel: the reference's train steps reach none, and
   ``flash_attention`` has no backward): smollm-135m ``full_config()``
   (30 layers, bf16, ``chunked`` attention, remat, ``ce_chunk`` 512)
   trains ``TRAIN_STEPS`` ``lm_train_step``s of ``adamw(lr=1e-3,
   warmup_steps=10)`` on 8 x 4096 ``lm_batches`` through ``Prefetcher``
   (``train_4k``'s global batch of 256 cut to ``TRAIN_BATCH``).  Each step
   prints its ms (host clock, ended by ``torch.cuda.synchronize()``),
   tokens/s, loss and grad norm, then the peak memory.  Checks: (a) at the
   initial weights every gradient leaf is finite and every parameter group
   (embed, each projection and norm of layers 0 and 29, ``ln_f``,
   unembed) non-zero; (b) step 1's per-token NLL within ``TRAIN_NLL_ATOL``
   (mean |diff|) of the float32 policy's on the widened weights, a limit
   that the control (targets shifted by one token) must fail; (c) a
   ``save_async`` after step ``TRAIN_SAVE_AT``, restored into a fresh
   ``make_state`` template, equals the saved state bit for bit, leaf by
   leaf; (d) the later steps run again from it, their losses printed
   beside the uninterrupted run's (bit-equal or not).  Then
   yolo-p6-1280 (width and depth 1.0, P6 head) trains
   ``DET_TRAIN_STEPS`` ``detector_train_step``s in float32 (TF32 off) on
   ``detector_batches`` of the synthetic video at 1920x3840, batch 8 (cut
   to 4 if peak memory passes ``DET_TRAIN_MAX_GB``): ms a step, images/s,
   loss, grad norm, peak memory; every gradient finite, every conv's
   non-zero.  Launch counts are set to 0 before each of the two and read
   after: none may have launched a kernel.

``--flash-only`` stops after the flash kernels' checks and times (phase 3
for attention alone), for comparing versions of the kernels; it prints no
result line.

``--frame-kernels-only`` stops after the frame loop's kernels (phase 3 for
the gnomonic sampler, the batched projection, SphIoU and the greedy
suppression), for the same use; it prints no result line either.

``--profile`` also profiles the last pod tick, the last mixed tick, one
LM prefill step and four decode steps of smollm-135m and of mixtral-8x22b,
and one train step of smollm-135m and of yolo-p6-1280:
the card's busy share of each, its host-to-device copies, its top kernels
and the frame loop's kernels among them.

The last lines are the kernels' JSON record (with each kernel's launches
by path: the frame loop of phase 5, the mixed pod of phase 6, the LM of
phase 7, the MoE LM of phase 8, the LM's and the detector's training of
phase 9, both 0), the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout of the repository, it exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s,
# float32 FLOP/s outside the tensor cores, and the dense bf16 tensor-core
# rate (attention's work is matrix products, which the card runs there)
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_TC_FLOPS = 989e12

# the reference's bf16 SphIoU gate (tests/test_fused_tick.py): keep flips
# against float32 at most 1%, and none on a row with no IoU pair within
# 0.05 of the 0.6 threshold
BF16_FLIP_BOUND = 0.01
BF16_NEAR_MARGIN = 0.05
# the bf16 SphIoU kernel against its bf16 plain version: both round every
# intermediate to bf16; one float32 ulp of a transcendental can round to
# the other bf16 neighbour, which moves an IoU by a few bf16 ulps
BF16_IOU_ATOL = 2.0 ** -6
# smollm-135m's last-token logits, flash kernel against the chunked plain
# version: both round activations to bf16 in each of 30 layers, at other
# places (the kernel's output once, the chunked version's after its own
# sum order); on the CPU at S=256 the two plain versions differ by 0.031
LM_LOGIT_ATOL = 0.1
# the same under the float32 policy (the SIMT kernel against the chunked
# plain version, TF32 off): only the sums' order differs; on the H100 the
# logits read 2.8e-6 apart
LM_F32_LOGIT_ATOL = 1e-4
# flash attention in bf16 against the float32 plain version rounded to
# bf16: both sum in float32 and round once, so where they agree they
# differ by one bf16 ulp of the value at most (2^-7 of it) plus the
# difference of the two float32 sums.  The check holds
# max(|got - ref| - ATTN_BF16_RTOL |ref|) to ATTN_BF16_ATOL, and also
# holds a control to it, the plain version with one 64-key K/V tile
# dropped, which must fail: a limit that a kernel skipping a tile would
# pass checks nothing.  ATTN_BF16_ATOL is the reference's float32 atol;
# on the H100 the excess read at most 2.6e-7 and the control at least
# 1.3e-3 (at 32k, where one tile is the smallest share of a row)
ATTN_BF16_RTOL = 2.0 ** -7
ATTN_BF16_ATOL = 2e-5
ATTN_DROPPED_TILE = 64

# the pod tick's top batch bucket: the server's and the backend's ladders
MAX_BATCH = 8
# the action head's logits, with the gnomonic sampling kernel against the
# plain projection, both on the card: the crops differ only by the
# sampler's float32 rounding (within 3e-6), which the head's float32
# layers carry through; the CPU parity tests hold the head to the
# reference's within the same 1e-4
ACTION_LOGIT_ATOL = 1e-4

# the kernels and what each replaces in the JAX package
KERNELS = {
    "gnomonic_sample": (
        "src/repro_torch/kernels/gnomonic/csrc/gnomonic.cu",
        "src/repro/kernels/gnomonic/gnomonic.py:123"),
    "project_srois_batched": (
        "src/repro_torch/kernels/gnomonic/csrc/gnomonic.cu",
        "src/repro/kernels/gnomonic/ops.py:80"),
    "sphiou_matrix_batch": (
        "src/repro_torch/kernels/sphiou/csrc/sphiou.cu",
        "src/repro/kernels/sphiou/sphiou.py:120"),
    "greedy_suppress_rows": (
        "src/repro_torch/kernels/nms/csrc/greedy.cu",
        "src/repro/core/sphere.py:417"),
    "sphiou_matrix_batch_bf16": (
        "src/repro_torch/kernels/sphiou/csrc/sphiou.cu",
        "src/repro/kernels/sphiou/sphiou.py:120 (dtype=bfloat16)"),
    "flash_attention": (
        "src/repro_torch/kernels/attention/csrc/attention.cu",
        "src/repro/kernels/attention/attention.py:130"),
    "flash_attention_wgmma": (
        "src/repro_torch/kernels/attention/csrc/attention_wgmma.cu",
        "src/repro/kernels/attention/attention.py:130 (bf16, D 64 and 128)"),
}
# the CUDA functions of the frame loop's kernels, as a profile names them
PORT_KERNEL_FUNCTIONS = ("gnomonic_sample_kernel", "project_srois_kernel",
                         "sphiou_self_kernel", "sphiou_cross_kernel",
                         "greedy_")
# the kernels the LM serving paths run, dense and MoE (bf16 on the
# tensor-core kernel, the float32 policy on the SIMT one); the frame loop
# runs the others
LM_KERNELS = ("flash_attention", "flash_attention_wgmma")


class PhaseError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events).

    A spin kernel ahead of the start event holds the device while the
    host enqueues the calls, so for a function that does not
    synchronise the events see its kernels back to back, not the host's
    launch overhead between them."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~30 ms at the H100's clock
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def print_ptxas(lines: list[str], kernel: str | tuple[str, ...]) -> None:
    """The ``nvcc -Xptxas -v`` lines of the functions whose mangled name
    holds ``kernel`` (or one of several; registers, spills, shared
    memory), and any warning."""
    names = (kernel,) if isinstance(kernel, str) else kernel
    on = False
    for ln in lines:
        if "Compiling entry function" in ln or "Function properties" in ln:
            on = any(k in ln for k in names)
        elif ln.startswith("ptxas info") and "Used" not in ln:
            on = False
        if on or "warning" in ln.lower():
            print(f"ptxas {ln}")


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float = PEAK_F32_FLOPS
             ) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def texel_ids(u, v, h: int, w: int):
    """Flat indices of the ERP texels a bilinear pass over maps (u, v)
    reads (with repeats)."""
    import torch

    u0 = torch.remainder(torch.floor(u).long(), w)
    u1 = torch.remainder(u0 + 1, w)
    v0 = torch.clamp(torch.floor(v).long(), 0, h - 1)
    v1 = torch.clamp(v0 + 1, 0, h - 1)
    return torch.cat([(v0 * w + u0).flatten(), (v0 * w + u1).flatten(),
                      (v1 * w + u0).flatten(), (v1 * w + u1).flatten()])


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------


def check_gnomonic(records: dict) -> None:
    import hashlib

    import torch
    import torch.nn.functional as F

    from repro_torch.core.projection import gnomonic_coords, sample_erp_bilinear
    from repro_torch.kernels.gnomonic import ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    h, w, c = 1920, 3840, 3
    erp = torch.rand((h, w, c), generator=gen, device=dev)
    # seam-padded NCHW copy for the library yardstick (F.grid_sample)
    erp_nchw = torch.cat([erp, erp[:, :1]], dim=1).permute(2, 0, 1)[None]
    erp_nchw = erp_nchw.contiguous()
    # the action head's crops (96 and 128), then the detector's
    cases = [("96", (1.2, 0.3), 63, 96), ("128", (-0.7, -0.2), 63, 128),
             ("416", (0.3, 0.2), 60, 416), ("640", (math.pi, -0.4), 75, 640),
             ("1280", (-2.0, 0.1), 100, 1280),
             ("640-pole", (0.0, 1.5), 90, 640)]
    for label, (ct, cp), fov_deg, s in cases:
        fov = (math.radians(fov_deg), math.radians(fov_deg))
        u, v = gnomonic_coords(ct, cp, fov, (s, s), (h, w), dev)
        got = ops.gnomonic_sample(erp, u, v)
        ref = sample_erp_bilinear(erp, u, v)
        err = float((got - ref).abs().max())
        check(bool(torch.allclose(got, ref, atol=3e-6, rtol=1e-5)),
              f"gnomonic_sample {label}: max |err| {err}")
        grid = torch.stack([torch.remainder(u, w) / w * 2 - 1,
                            v / (h - 1) * 2 - 1], dim=-1)[None]
        ms = time_ms(lambda: ops.gnomonic_sample(erp, u, v))
        plain_ms = time_ms(lambda: sample_erp_bilinear(erp, u, v))
        lib_ms = time_ms(lambda: F.grid_sample(
            erp_nchw, grid, mode="bilinear", padding_mode="border",
            align_corners=True))
        # bytes: the distinct texels read, the two maps, the PI written
        n_texels = int(torch.unique(texel_ids(u, v, h, w)).numel())
        n_bytes = n_texels * c * 4 + 2 * s * s * 4 + s * s * c * 4
        b_ms, b_by = bound_ms(n_bytes, s * s * (9 * c + 10))
        digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16]
        print(f"kernel gnomonic_sample {label}: {s}x{s} PI from {h}x{w}x{c} "
              f"f32, max|err| {err:.3g} (tol 3e-6 + 1e-5 rel), "
              f"ms {ms:.4f}, plain_ms {plain_ms:.4f}, library_ms "
              f"{lib_ms:.4f} (F.grid_sample), bound_ms {b_ms:.5f} ({b_by}); "
              f"output sha256 {digest}")
        if label == "1280":
            records["gnomonic_sample"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, shape=f"{s}x{s} from "
                f"{h}x{w}x{c} f32")
    # float16 frames: the kernel blends in f32 and writes f16
    u, v = gnomonic_coords(0.5, 0.2, (1.0, 1.0), (640, 640), (h, w), dev)
    half = erp.half()
    err16 = float((ops.gnomonic_sample(half, u, v).float()
                   - sample_erp_bilinear(half, u, v)).abs().max())
    check(err16 <= 5e-3, f"gnomonic_sample f16: max |err| {err16}")
    print(f"kernel gnomonic_sample f16 640: max|err| {err16:.3g} (tol 5e-3)")


def check_project_srois(records: dict) -> None:
    import hashlib

    import numpy as np
    import torch

    from repro_torch.core.projection import gnomonic_coords
    from repro_torch.kernels.gnomonic import ops
    from repro_torch.kernels.gnomonic.ref import (project_sroi_f64,
                                                  project_srois_ref)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    h, w, c = 1920, 3840, 3
    frames = torch.rand((4, h, w, c), generator=gen, device=dev)
    rng = np.random.default_rng(2)
    # the recorded shape, two more, and tick 3's largest chunk (9 crops at
    # 896) and its 416 chunk (9 crops)
    for b, s in ((8, 640), (8, 1280), (4, 416), (9, 896), (9, 416)):
        idx = [i % 4 for i in range(b)]
        # float32 geometry, as both versions read it; |phi| up to 1.4 with
        # FoVs up to 110 degrees puts poles inside some crops
        centers = np.stack([rng.uniform(-math.pi, math.pi, b),
                            rng.uniform(-1.4, 1.4, b)], -1).astype(np.float32)
        fovs = rng.uniform(math.radians(40), math.radians(110),
                           (b, 2)).astype(np.float32)
        got = ops.project_srois_batched(frames, idx, centers, fovs, (s, s))
        ref = project_srois_ref(
            frames, torch.tensor(idx), torch.from_numpy(centers),
            torch.from_numpy(fovs), (s, s))
        err = float((got - ref).abs().max())
        # Tolerance: the two versions fuse the float32 map differently,
        # and at this width (and more so near a pole) a few ulps of (u, v)
        # move a noise frame's PI by more than any fixed bound, so each
        # is held to the crops projected with a float64 map
        # (project_sroi_f64): the kernel may be at most twice as far from
        # it as the plain version, + 5e-5.
        err_k = err_p = 0.0
        for i in range(b):
            exact = project_sroi_f64(frames[idx[i]], float(centers[i, 0]),
                                     float(centers[i, 1]), fovs[i].tolist(), s)
            err_k = max(err_k, float((got[i].double() - exact).abs().max()))
            err_p = max(err_p, float((ref[i].double() - exact).abs().max()))
        # the output's digest: two builds that agree on it agree bit for bit
        digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16]
        print(f"kernel project_srois_batched B={b} S={s}: max|kernel - "
              f"plain| {err:.3g}; against the float64 map: kernel "
              f"{err_k:.3g}, plain {err_p:.3g} (tol 2 x plain + 5e-5); "
              f"output sha256 {digest}")
        check(err_k <= 2 * err_p + 5e-5,
              f"project_srois_batched {b}x{s}: {err_k} from the float64 map, "
              f"the plain version {err_p}")
        ms = time_ms(lambda: ops.project_srois_batched(frames, idx, centers,
                                                       fovs, (s, s)), reps=100)
        plain_ms = time_ms(lambda: project_srois_ref(
            frames, torch.tensor(idx), torch.from_numpy(centers),
            torch.from_numpy(fovs), (s, s)), reps=5)
        # bytes: the distinct texels the crops read (per frame, from the
        # plain version's maps), the geometry, and the PIs written
        texels = []
        for i in range(b):
            u, v = gnomonic_coords(float(centers[i, 0]), float(centers[i, 1]),
                                   fovs[i].tolist(), (s, s), (h, w), dev)
            texels.append(texel_ids(u, v, h, w) + idx[i] * h * w)
        n_texels = int(torch.unique(torch.cat(texels)).numel())
        n_bytes = n_texels * c * 4 + b * (4 + 16) + b * s * s * c * 4
        b_ms, b_by = bound_ms(n_bytes, b * s * s * (60 + 9 * c))
        print(f"kernel project_srois_batched B={b} S={s}: 4 distinct "
              f"{h}x{w}x{c} frames, ms {ms:.4f}, plain_ms {plain_ms:.4f}, "
              f"library_ms null, bound_ms {b_ms:.5f} ({b_by})")
        if (b, s) == (8, 640):
            records["project_srois_batched"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None,
                shape=f"B={b} S={s} from 4x{h}x{w}x{c} f32")


def nms_inputs(b: int, n: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    # detection-like SphBBs: clustered around a few objects per row, so
    # suppression has overlaps to remove
    centers = np.stack([rng.uniform(-math.pi, math.pi, (b, 8)),
                        rng.uniform(-1.0, 1.0, (b, 8))], -1)
    pick = rng.integers(0, 8, (b, n))
    ctr = np.take_along_axis(centers, pick[..., None].repeat(2, -1), 1)
    boxes = np.concatenate([ctr + rng.normal(0, 0.03, (b, n, 2)),
                            rng.uniform(0.05, 0.4, (b, n, 2))], -1)
    scores = rng.uniform(0.01, 1.0, (b, n))
    mask = np.arange(n)[None] < rng.integers(n // 2, n + 1, (b, 1))
    boxes[~mask] = 0.0
    return boxes, scores, mask


def check_sphiou_paths(bx, dtype) -> tuple[dict, list[str]]:
    """One SphIoU entry on rows ``bx``: the self path (the tensor twice, as
    NMS calls it) and the general path (a copy), each against its plain
    version and timed; the self path's output must be exactly symmetric.
    Returns the self path's record and the checks that failed, which the
    caller raises after its other shapes' times are printed."""
    import torch

    from repro_torch.kernels.sphiou import ops as iou_ops
    from repro_torch.kernels.sphiou.ref import (sphiou_ref_batch,
                                                sphiou_ref_batch_bf16)

    f32 = dtype == torch.float32
    name = "sphiou_matrix_batch" + ("" if f32 else "_bf16")
    plain = sphiou_ref_batch if f32 else sphiou_ref_batch_bf16
    tol = 5e-6 if f32 else BF16_IOU_ATOL
    b, n, _ = bx.shape
    rec, failed = None, []
    for path, y in (("self", bx), ("cross", bx.clone())):
        got = iou_ops.sphiou_matrix_batch(bx, y, dtype=dtype)
        err = float((got - plain(bx, y)).abs().max())
        if err > tol:
            failed.append(f"{name} {b}x{n} {path} path: max |err| {err}")
        sym = bool(torch.equal(got, got.transpose(1, 2)))
        if path == "self" and not sym:
            failed.append(f"{name} {b}x{n}: the self path is not symmetric")
        ms = time_ms(lambda: iou_ops.sphiou_matrix_batch(bx, y, dtype=dtype))
        plain_ms = time_ms(lambda: plain(bx, y), reps=5)
        # per pair, counted from the source, a transcendental as one
        # operation: one sincos (2), two atan2, two asin, four sin and ~50
        # arithmetic; the self path computes each unordered pair once
        pairs = b * n * (n + 1) // 2 if path == "self" else b * n * n
        b_ms, b_by = bound_ms(b * n * 16 * (1 if path == "self" else 2)
                              + b * n * n * 4, pairs * 60)
        print(f"kernel {name} B={b} N={n} {path} path: max|err| {err:.3g} "
              f"(tol {tol:.3g}), symmetric {sym}, ms {ms:.4f}, plain_ms "
              f"{plain_ms:.4f}, library_ms null, bound_ms {b_ms:.5f} "
              f"({b_by})")
        if path == "self":
            rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=None,
                       shape=f"B={b} N={n}, self path")
    return rec, failed


def check_nms(records: dict) -> None:
    import numpy as np
    import torch

    from repro_torch.kernels.nms import ops as nms_ops
    from repro_torch.kernels.nms.ref import greedy_suppress_rows_ref
    from repro_torch.kernels.sphiou import ops as iou_ops

    dev = torch.device("cuda")
    failed = []
    # the recorded shapes, then a tick's rows (four streams padded to 128)
    # on the float32 IoU and on the bf16 option's
    for b, n, iou_dtype in ((8, 128, torch.float32), (32, 512, torch.float32),
                            (4, 128, torch.float32), (4, 128, torch.bfloat16)):
        boxes, scores, mask = nms_inputs(b, n, b + n)
        bx = torch.tensor(boxes, dtype=torch.float32, device=dev)
        sc = torch.tensor(scores, dtype=torch.float32, device=dev)
        mk = torch.tensor(mask, device=dev)
        iou = iou_ops.sphiou_matrix_batch(bx, bx, dtype=iou_dtype)
        what = f"B={b} N={n}" + (" (bf16 IoU)" if iou_dtype != torch.float32
                                 else "")
        if iou_dtype == torch.float32:  # the bf16 entry: check_sphiou_bf16
            rec, bad = check_sphiou_paths(bx, torch.float32)
            failed += bad
        keep = nms_ops.greedy_suppress_rows(iou, sc, mk, 0.6)
        keep_ref = greedy_suppress_rows_ref(iou, sc, mk, 0.6)
        check(bool(torch.equal(keep, keep_ref)),
              f"greedy_suppress_rows {what}: keep masks differ")
        g_ms = time_ms(lambda: nms_ops.greedy_suppress_rows(iou, sc, mk, 0.6),
                       reps=100)
        g_plain = time_ms(
            lambda: greedy_suppress_rows_ref(iou, sc, mk, 0.6), reps=5)
        kept = int(keep.sum())
        # this run's data: the kept boxes' IoU rows, plus scores/mask/keep
        gb_ms, gb_by = bound_ms(kept * n * 4 + b * n * 6, kept * n * 3)
        print(f"kernel greedy_suppress_rows {what}: keep masks equal ({kept} "
              f"kept of {int(mask.sum())}), ms {g_ms:.4f}, plain_ms "
              f"{g_plain:.4f}, library_ms null, bound_ms {gb_ms:.6f} "
              f"({gb_by})")
        if (b, n) == (32, 512):
            records["sphiou_matrix_batch"] = rec
            records["greedy_suppress_rows"] = dict(
                max_abs_err=0.0, ms=g_ms, plain_ms=g_plain, bound_ms=gb_ms,
                bound_by=gb_by, library_ms=None, shape=f"B={b} N={n}")
    check(not failed, "; ".join(failed))
    bad = iou_ops.trig_check(dev)
    print(f"sphiou trig premises (sinf odd, cosf even, sincosf equal to "
          f"both, bit for bit): {bad} finite float32 x >= 0 fail")
    check(bad == 0, f"sphiou trig premises fail at {bad} arguments")

    # a tick's rows with NaN scores (argmax ranks NaN above every number,
    # so the reference keeps a NaN-scored box first), +inf, and -0.0
    # beside 0.0 (equal: the lower index first)
    b, n = 4, 128
    boxes, scores, mask = nms_inputs(b, n, 5)
    scores[:, ::9] = np.nan
    scores[:, 4::11] = np.inf
    scores[:, 2::13] = 0.0
    scores[:, 3::13] = -0.0
    bx = torch.tensor(boxes, dtype=torch.float32, device=dev)
    sc = torch.tensor(scores, dtype=torch.float32, device=dev)
    mk = torch.tensor(mask, device=dev)
    iou = iou_ops.sphiou_matrix_batch(bx, bx)
    keep = nms_ops.greedy_suppress_rows(iou, sc, mk, 0.6)
    keep_ref = greedy_suppress_rows_ref(iou, sc, mk, 0.6)
    nan = torch.isnan(sc) & mk
    print(f"kernel greedy_suppress_rows B={b} N={n} with NaN, +inf and "
          f"signed-zero scores: kernel keeps {int(keep.sum())} "
          f"({int((keep & nan).sum())} of {int(nan.sum())} NaN-scored), "
          f"plain version {int(keep_ref.sum())} "
          f"({int((keep_ref & nan).sum())})")
    check(bool(torch.equal(keep, keep_ref)),
          f"greedy_suppress_rows B={b} N={n} with NaN scores: keep masks "
          f"differ")


def bench_box_sets():
    """The reference bench's box sets for the bf16 flip gate
    (``benchmarks/kernels_bench.py``): 10 trials of 8 rows x 24 boxes."""
    import numpy as np

    for trial in range(10):
        rng = np.random.default_rng(trial)
        boxes = np.stack([rng.uniform(-3, 3, (8, 24)),
                          rng.uniform(-1.2, 1.2, (8, 24)),
                          rng.uniform(0.3, 1.2, (8, 24)),
                          rng.uniform(0.3, 1.2, (8, 24))], -1
                         ).astype(np.float32)
        yield boxes, rng.uniform(0.1, 1, (8, 24)).astype(np.float32)


def near_threshold_rows(boxes, thr: float = 0.6):
    """(B,) True where a row holds a pair with float64 IoU within
    ``BF16_NEAR_MARGIN`` of the threshold (self-pairs aside)."""
    import numpy as np

    from repro_torch.core.sphere import sph_iou_matrix_np

    iou = np.stack([sph_iou_matrix_np(r.astype(np.float64),
                                      r.astype(np.float64)) for r in boxes])
    near = np.abs(iou - thr) <= BF16_NEAR_MARGIN
    np.einsum("bii->bi", near)[:] = False
    return near.any(axis=(1, 2))


def check_sphiou_bf16(records: dict) -> None:
    import torch

    from repro_torch.core.sphere import sph_nms_batch
    from repro_torch.kernels.sphiou import ops as iou_ops
    from repro_torch.kernels.sphiou.ref import (sphiou_ref_batch,
                                                sphiou_ref_batch_bf16)

    dev = torch.device("cuda")
    # row 3's inputs, then a tick's rows (four streams padded to 128)
    failed = []
    for b, n in ((32, 512), (4, 128)):
        boxes, _, _ = nms_inputs(b, n, b + n)
        bx = torch.tensor(boxes, dtype=torch.float32, device=dev)
        rec, bad = check_sphiou_paths(bx, torch.bfloat16)
        failed += bad
        if (b, n) != (32, 512):
            continue
        records["sphiou_matrix_batch_bf16"] = rec
        got = iou_ops.sphiou_matrix_batch(bx, bx, dtype=torch.bfloat16)
        exact = sphiou_ref_batch(bx, bx)
        d_kernel = float((got - exact).abs().max())
        d_plain = float((sphiou_ref_batch_bf16(bx, bx) - exact).abs().max())
        print(f"kernel sphiou_matrix_batch_bf16 B={b} N={n}: from the "
              f"float32 IoU: kernel {d_kernel:.3g}, plain {d_plain:.3g}")
    flips = total = far_flips = 0
    for boxes, scores in bench_box_sets():
        k32 = sph_nms_batch(boxes, scores, backend="cuda")
        k16 = sph_nms_batch(boxes, scores, backend="cuda",
                            iou_dtype=torch.bfloat16)
        diff = k32 != k16
        flips += int(diff.sum())
        total += diff.size
        far_flips += int((diff.any(axis=1) & ~near_threshold_rows(boxes)).sum())
    rate = flips / total
    print(f"kernel sphiou_matrix_batch_bf16 keep masks against float32 on the "
          f"reference bench's box sets: {flips} flips of {total} ({rate:.4f}, "
          f"bound {BF16_FLIP_BOUND}), {far_flips} on rows with no pair within "
          f"{BF16_NEAR_MARGIN} of the threshold (bound 0)")
    check(rate <= BF16_FLIP_BOUND and far_flips == 0,
          f"bf16 SphIoU flip gate: rate {rate}, far-row flips {far_flips}")
    records["sphiou_matrix_batch_bf16"]["keep_flip_rate"] = rate
    check(not failed, "; ".join(failed))


FLASH_CASES = [  # the reference's (tests/test_kernels.py)
    dict(b=2, sq=64, skv=64, hq=4, hkv=4, d=32, causal=True, window=None),
    dict(b=1, sq=128, skv=128, hq=8, hkv=2, d=64, causal=True, window=None),
    dict(b=1, sq=96, skv=96, hq=2, hkv=2, d=32, causal=True, window=32),
    dict(b=2, sq=1, skv=200, hq=4, hkv=1, d=32, causal=True, window=None),
    dict(b=1, sq=64, skv=64, hq=2, hkv=2, d=32, causal=False, window=None),
    dict(b=1, sq=80, skv=160, hq=2, hkv=2, d=16, causal=True, window=64),
]


def sdpa_call(q, k, v, window: int | None = None):
    """One PyTorch call computing causal GQA attention on (B, S, H, D)
    tensors: the library yardstick, timed only.  With a window, a boolean
    ``attn_mask`` of the causal band (SDPA takes no window of its own), on
    the fused backends only: the math backend would materialise the
    scores."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    if window is None:
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    i = torch.arange(q.shape[1], device=q.device)
    band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)

    def call():
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION,
                          SDPBackend.CUDNN_ATTENTION]):
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band,
                                                  enable_gqa=True)
    return call


def flash_pairs(s: int, window: int | None = None) -> int:
    """The (query, key) pairs of causal attention over ``s`` tokens that a
    ``window`` (None: none) leaves in: query q sees min(q + 1, window)."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def flash_bound(b: int, s: int, hq: int, hkv: int, d: int,
                float32: bool = False, window: int | None = None
                ) -> tuple[float, str]:
    """Causal attention's least time: 4*D operations a (query, key) pair
    in the window at the bf16 tensor-core rate, against q, k, v and the
    output moved once in bf16; for float32, 4-byte elements and the
    float32 rate outside the tensor cores (TF32 would round the inputs)."""
    pairs = b * hq * flash_pairs(s, window)
    elem = 4 if float32 else 2
    n_bytes = elem * d * b * s * (2 * hq + 2 * hkv)
    return bound_ms(n_bytes, 4 * d * pairs,
                    PEAK_F32_FLOPS if float32 else PEAK_BF16_TC_FLOPS)


def attn_excess(got, ref) -> float:
    """How far ``got`` lies outside one bf16 ulp of ``ref``:
    max(|got - ref| - ATTN_BF16_RTOL |ref|), held to ATTN_BF16_ATOL."""
    g, r = got.float(), ref.float()
    return float(((g - r).abs() - ATTN_BF16_RTOL * r.abs()).max())


def attention_rows(q, k, v, *, drop: int | None = None, causal: bool = True,
                   window: int | None = None, q_offset: int = 0,
                   rows: int = 2048):
    """GQA attention in float32, as the plain version computes it, by
    blocks of ``rows`` queries, so the scores of a long sequence fit.
    With ``drop``, the control: blind to keys drop..drop+ATTN_DROPPED_TILE-1,
    as a kernel that skipped that K/V tile would be.  Output in q's
    dtype."""
    import torch

    b, s, hq, d = q.shape
    rep = hq // k.shape[2]
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    kpos = torch.arange(k.shape[1], device=q.device)
    seen = torch.ones_like(kpos, dtype=torch.bool) if drop is None else \
        (kpos < drop) | (kpos >= drop + ATTN_DROPPED_TILE)
    out = torch.empty_like(q)
    for r0 in range(0, s, rows):
        qb = q[:, r0:r0 + rows].float()
        qpos = q_offset + r0 + torch.arange(qb.shape[1], device=q.device)
        mask = seen[None, :].expand(qb.shape[1], -1)
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window is not None:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        sc = torch.einsum("bqhd,bkhd->bhqk", qb, kf) * d ** -0.5
        p = torch.softmax(sc.masked_fill(~mask, -1e30), dim=-1) * mask
        del sc
        out[:, r0:r0 + rows] = torch.einsum("bhqk,bkhd->bqhd", p, vf).to(
            q.dtype)
        del p
    return out


def check_attn_bf16(got, ref, control, what: str) -> str:
    """Hold a bf16 flash output to ATTN_BF16_ATOL past one bf16 ulp of
    the plain version, and check the control fails that limit.  Returns
    the readings, for the printed line."""
    ex, ex_ctl = attn_excess(got, ref), attn_excess(control, ref)
    check(ex <= ATTN_BF16_ATOL,
          f"{what}: |err| exceeds 2^-7 |ref| by {ex}, limit {ATTN_BF16_ATOL}")
    check(ex_ctl > ATTN_BF16_ATOL,
          f"{what}: the control with a K/V tile dropped passes the limit "
          f"({ex_ctl} <= {ATTN_BF16_ATOL})")
    return (f"|err| - 2^-7 |ref| at most {ex:.3g} (limit {ATTN_BF16_ATOL}; "
            f"the control with {ATTN_DROPPED_TILE} keys dropped {ex_ctl:.3g}, "
            f"fails)")


def check_flash(records: dict) -> None:
    import torch

    from repro_torch.kernels.attention import ops
    from repro_torch.kernels.attention.ref import flash_attention_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)

    def qkv(b, sq, skv, hq, hkv, d, dtype):
        return (torch.randn((b, sq, hq, d), generator=gen, device=dev
                            ).to(dtype),
                torch.randn((b, skv, hkv, d), generator=gen, device=dev
                            ).to(dtype),
                torch.randn((b, skv, hkv, d), generator=gen, device=dev
                            ).to(dtype))

    # the reference's six cases: the SIMT kernel in float32 and bf16 at
    # their own head sizes, the tensor-core kernel in bf16 at D=64 and
    # D=128; float32 at the reference's tolerance, bf16 at its 3e-2 and at
    # ATTN_BF16_ATOL past one bf16 ulp; each case with its control
    for kernel, dtype, d in (("simt", torch.float32, None),
                             ("simt", torch.bfloat16, None),
                             ("wgmma", torch.bfloat16, 64),
                             ("wgmma", torch.bfloat16, 128)):
        worst = worst_ex = 0.0
        for c in FLASH_CASES:
            q, k, v = qkv(c["b"], c["sq"], c["skv"], c["hq"], c["hkv"],
                          d or c["d"], dtype)
            kw = dict(causal=c["causal"], window=c["window"],
                      q_offset=c["skv"] - c["sq"] if c["causal"] else 0)
            got = ops.launch(kernel, q, k, v, **kw)
            ref = flash_attention_ref(q, k, v, **kw)
            ctl = attention_rows(q, k, v, drop=c["skv"] // 2, **kw)
            err = float((got.float() - ref.float()).abs().max())
            worst = max(worst, err)
            what = f"{ops.KERNELS[kernel].name} {dtype} case {c} at D={d}"
            if dtype == torch.float32:
                check(bool(torch.allclose(got, ref, atol=2e-5, rtol=1e-4)),
                      f"{what}: max |err| {err}")
                check(not torch.allclose(ctl, ref, atol=2e-5, rtol=1e-4),
                      f"{what}: the control passes")
            else:
                check(err <= 3e-2, f"{what}: max |err| {err}")
                check_attn_bf16(got, ref, ctl, what)
                worst_ex = max(worst_ex, attn_excess(got, ref))
        tol = ("atol 2e-5 + rtol 1e-4" if dtype == torch.float32 else
               f"atol 3e-2; |err| - 2^-7 |ref| at most {worst_ex:.3g}, limit "
               f"{ATTN_BF16_ATOL}")
        print(f"kernel {ops.KERNELS[kernel].name} {str(dtype)[6:]}: the "
              f"reference's six cases at "
              f"{'their head sizes' if d is None else f'D={d}'}, max|err| "
              f"{worst:.3g} ({tol}); each case's control fails")

    # the main path's shape: smollm-135m's 4 x 2048 prefill, one layer, in
    # float32 at the reference's tolerance (the SIMT kernel), then in bf16
    # through both kernels against one bf16 ulp of the plain version, with
    # the control beside it
    b, s, hq, hkv, d = 4, 2048, 9, 3, 64
    q, k, v = qkv(b, s, s, hq, hkv, d, torch.float32)
    got = ops.flash_attention(q, k, v, causal=True)
    ref = flash_attention_ref(q, k, v, causal=True)
    err32 = float((got - ref).abs().max())
    check(bool(torch.allclose(got, ref, atol=2e-5, rtol=1e-4)),
          f"flash_attention smollm shape float32: max |err| {err32}")
    ctl = attention_rows(q, k, v, drop=s // 2)
    ctl_err = float((ctl - ref).abs().max())
    check(not torch.allclose(ctl, ref, atol=2e-5, rtol=1e-4),
          "flash_attention smollm shape float32: the control passes")
    print(f"kernel flash_attention B={b} S={s} Hq={hq} Hkv={hkv} D={d} "
          f"float32 causal: max|err| {err32:.3g} (atol 2e-5 + rtol 1e-4; "
          f"the control with {ATTN_DROPPED_TILE} keys dropped {ctl_err:.3g}, "
          f"fails)")
    # the float32 policy's LM prefill (phase 7, 1 x 2048), the shape the
    # SIMT kernel serves on a path: checked, then the kernel, SDPA in
    # float32 (TF32 off, as the port's policy sets it) and the plain
    # version timed in turn
    q1, k1, v1 = (x[:1].contiguous() for x in (q, k, v))
    got = ops.flash_attention(q1, k1, v1, causal=True)
    ref = flash_attention_ref(q1, k1, v1, causal=True)
    err1 = float((got - ref).abs().max())
    check(bool(torch.allclose(got, ref, atol=2e-5, rtol=1e-4)),
          f"flash_attention 1x{s} float32: max |err| {err1}")
    ms = time_ms(lambda: ops.flash_attention(q1, k1, v1, causal=True))
    lib = sdpa_call(q1, k1, v1)
    lib_ms = time_ms(lib)
    plain_ms = time_ms(lambda: flash_attention_ref(q1, k1, v1, causal=True),
                       reps=5)
    b_ms, b_by = flash_bound(1, s, hq, hkv, d, float32=True)
    shape = f"B=1 S={s} Hq={hq} Hkv={hkv} D={d} float32 causal"
    lib_err = float((got - lib().transpose(1, 2)).abs().max())
    print(f"kernel flash_attention {shape}: max|err| {err1:.3g} (atol 2e-5 + "
          f"rtol 1e-4; against SDPA {lib_err:.3g}), ms {ms:.4f}, plain_ms "
          f"{plain_ms:.4f}, library_ms {lib_ms:.4f} (SDPA float32, TF32 off), "
          f"bound_ms {b_ms:.5f} ({b_by})")
    records["flash_attention"] = dict(
        max_abs_err=err1, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, shape=shape)
    del q1, k1, v1

    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    ref = flash_attention_ref(q, k, v, causal=True)
    ctl = attention_rows(q, k, v, drop=s // 2)
    lib = sdpa_call(q, k, v)
    lib_out = lib().transpose(1, 2).float()
    shape = f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} bf16 causal"
    for kernel in ("wgmma", "simt"):
        name = ops.KERNELS[kernel].name
        got = ops.launch(kernel, q, k, v, causal=True)
        err = float((got.float() - ref.float()).abs().max())
        check(err <= 3e-2, f"{name} smollm shape: max |err| {err}")
        readings = check_attn_bf16(got, ref, ctl, f"{name} smollm shape bf16")
        lib_err = float((got.float() - lib_out).abs().max())
        print(f"kernel {name} {shape}: max|err| {err:.3g} (tol 3e-2), "
              f"{readings}; against SDPA {lib_err:.3g}")
        if kernel == "wgmma":  # the SIMT kernel's record: float32, above
            records[name] = dict(max_abs_err=err, shape=shape)
    # times in turn in one call: tensor-core, SIMT, SDPA, plain, and the
    # tensor-core kernel again (its spread)
    times = {}
    for kernel in ("wgmma", "simt"):
        times[kernel] = time_ms(lambda: ops.launch(kernel, q, k, v,
                                                   causal=True))
    lib_ms = time_ms(lib)
    plain_ms = time_ms(lambda: flash_attention_ref(q, k, v, causal=True),
                       reps=5)
    again = time_ms(lambda: ops.launch("wgmma", q, k, v, causal=True))
    b_ms, b_by = flash_bound(b, s, hq, hkv, d)
    records["flash_attention_wgmma"].update(
        ms=times["wgmma"], plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms)
    print_flash_times(shape, times, lib_ms, b_ms, b_by, plain_ms, again)

    # the 32k prefill's shape (one layer, B=1).  The plain version would
    # materialise ~39 GB of scores, so here the tensor-core kernel is held
    # to the SIMT kernel (both sum in float32 and round once) with the
    # control beside it, and in the LM phase to the chunked plain version
    s = 32768
    q, k, v = qkv(1, s, s, hq, hkv, d, torch.bfloat16)
    lib = sdpa_call(q, k, v)
    got = ops.launch("wgmma", q, k, v, causal=True)
    simt = ops.launch("simt", q, k, v, causal=True)
    lib_err = float((got.float() - lib().transpose(1, 2).float()).abs().max())
    readings = check_attn_bf16(got, simt,
                               attention_rows(q, k, v, drop=s // 2),
                               f"flash_attention_wgmma S={s} against SIMT")
    del simt
    print(f"kernel flash_attention_wgmma B=1 S={s} Hq={hq} Hkv={hkv} D={d} "
          f"bf16 causal, against the SIMT kernel: {readings}; against SDPA "
          f"max|err| {lib_err:.3g}")
    times = {kernel: time_ms(lambda: ops.launch(kernel, q, k, v,
                                                causal=True),
                             reps=3, warmup=1)
             for kernel in ("wgmma", "simt")}
    lib_ms = time_ms(lib, reps=3, warmup=1)
    again = time_ms(lambda: ops.launch("wgmma", q, k, v, causal=True),
                    reps=3, warmup=1)
    b_ms, b_by = flash_bound(1, s, hq, hkv, d)
    print_flash_times(f"B=1 S={s} Hq={hq} Hkv={hkv} D={d} bf16 causal",
                      times, lib_ms, b_ms, b_by, None, again)
    del q, k, v, lib, got
    for layout in FLASH_D128_LAYOUTS:
        check_flash_layout(qkv, *layout)


# the tensor-core kernel at D=128 on the MoE path's layouts (phase 8):
# mixtral-8x22b's prefill (2 x 8192 tokens, a group of 6, a 4096-token
# window: the window's edge and the skip of tiles behind it) and
# granite-34b's MQA (48 query heads on one KV head)
FLASH_D128_LAYOUTS = [
    ("mixtral-8x22b", 2, 8192, 48, 8, 128, 4096),
    ("granite-34b", 1, 4096, 48, 1, 128, None),
]


def check_flash_layout(qkv, name: str, b: int, s: int, hq: int, hkv: int,
                       d: int, window: int | None) -> None:
    """The tensor-core kernel at one layout, bf16: held to the plain
    version (by blocks of query rows: at B=2 and S=8192 its scores would
    take 25.8 GB) with the control, which drops a tile inside the window
    of the last rows; then the kernel, SDPA and the plain version at B=1
    timed in turn, and the kernel again."""
    import torch

    from repro_torch.kernels.attention import ops
    from repro_torch.kernels.attention.ref import flash_attention_ref

    q, k, v = qkv(b, s, s, hq, hkv, d, torch.bfloat16)
    kw = dict(causal=True, window=window)
    got = ops.launch("wgmma", q, k, v, **kw)
    ref = attention_rows(q, k, v, **kw)
    err = float((got.float() - ref.float()).abs().max())
    readings = check_attn_bf16(
        got, ref, attention_rows(q, k, v, drop=s - (window or s) // 2, **kw),
        f"flash_attention_wgmma at {name}'s layout")
    del ref
    lib = sdpa_call(q, k, v, window)
    lib_err = float((got.float() - lib().transpose(1, 2).float()).abs().max())
    win = f"window {window}" if window else "no window"
    shape = f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} bf16 causal, {win}"
    print(f"kernel flash_attention_wgmma {shape} ({name}): max|err| "
          f"{err:.3g}, {readings}; against SDPA {lib_err:.3g}")
    ms = time_ms(lambda: ops.launch("wgmma", q, k, v, **kw), reps=10)
    lib_ms = time_ms(lib, reps=10)
    q1, k1, v1 = q[:1], k[:1], v[:1]
    plain_ms = time_ms(lambda: flash_attention_ref(q1, k1, v1, **kw),
                       reps=2, warmup=1)
    again = time_ms(lambda: ops.launch("wgmma", q, k, v, **kw), reps=10)
    b_ms, b_by = flash_bound(b, s, hq, hkv, d, window=window)
    print(f"flash times {shape} ({name}): tensor-core kernel {ms:.4f} ms "
          f"(again {again:.4f}), SDPA {lib_ms:.4f} "
          f"({'a boolean band mask' if window else 'is_causal'}), plain "
          f"{plain_ms:.4f} at B=1, bound {b_ms:.5f} ({b_by}; "
          f"{b * hq * flash_pairs(s, window) / 1e9:.3f} G pairs); "
          f"tensor-core / SDPA {ms / lib_ms:.2f}x, tensor-core / bound "
          f"{ms / b_ms:.1f}x")


def print_flash_times(shape: str, times: dict, lib_ms: float, b_ms: float,
                      b_by: str, plain_ms: float | None, again: float
                      ) -> None:
    ms, simt_ms = times["wgmma"], times["simt"]
    plain = "" if plain_ms is None else f", plain {plain_ms:.4f}"
    print(f"flash times {shape}: tensor-core kernel {ms:.4f} ms (again "
          f"{again:.4f}), SIMT kernel {simt_ms:.4f}, SDPA {lib_ms:.4f}"
          f"{plain}, bound {b_ms:.5f} ({b_by}); SIMT / tensor-core "
          f"{simt_ms / ms:.2f}x, tensor-core / SDPA {ms / lib_ms:.2f}x, "
          f"tensor-core / bound {ms / b_ms:.1f}x")


# --------------------------------------------------------------------------
# phases 4-5: the loop
# --------------------------------------------------------------------------


def make_loops(backend, videos, n_categories: int, n_variants: int,
               explore_costs):
    from repro_torch.core.omnisense import OmniSenseLoop
    from repro_torch.serving import profiles
    from repro_torch.serving.network import NetworkModel
    from repro_torch.serving.scheduler import OmniSenseLatencyModel

    variants = profiles.make_ladder(n_categories=n_categories)[:n_variants]
    lat = OmniSenseLatencyModel(profiles.paper_profile(), NetworkModel())
    loops = []
    for video in videos:
        loop = OmniSenseLoop(variants, lat, backend, budget_s=2.0,
                             n_categories=n_categories,
                             explore_costs=explore_costs)
        # bootstrap the history with frame 0's objects (a full-ERP pass)
        loop.seed_history(video.visible_objects(0))
        loops.append(loop)
    return variants, loops


def check_small_input() -> None:
    """The per-request path on the card against the same path on the
    CPU (the plain versions), on a small input."""
    import dataclasses

    import torch

    from repro_torch.data.synthetic import make_video, render_erp
    from repro_torch.models import detector as det_mod
    from repro_torch.serving.scheduler import TorchDetectorBackend

    cfgs = [dataclasses.replace(det_mod.PAPER_LADDER[i], input_size=64,
                                n_classes=16) for i in (0, 1)]
    params = [det_mod.init_params(torch.Generator().manual_seed(i), c)
              for i, c in enumerate(cfgs)]
    gpu = TorchDetectorBackend(cfgs, params, conf=0.01, max_det=4)
    cpu = TorchDetectorBackend(cfgs, params, conf=0.01, max_det=4,
                               device="cpu")
    video = make_video(n_frames=4, n_objects=20, seed=7)
    _, (g_loop,) = make_loops(gpu, [video], 16, 2, [0.1, 0.2])
    _, (c_loop,) = make_loops(cpu, [video], 16, 2, [0.1, 0.2])
    frame = render_erp(video, 1, height=192, width=384)
    g_pend, c_pend = g_loop.begin_frame(frame), c_loop.begin_frame(frame)
    check([(r.region.center, r.variant.name) for r in g_pend.requests]
          == [(r.region.center, r.variant.name) for r in c_pend.requests]
          and g_pend.requests, "small input: plans differ or are empty")
    worst = dict(pi=0.0, heads=0.0, scores=0.0)
    with torch.inference_mode():
        for req in g_pend.requests:
            cfg = cfgs[req.variant.index - 1]
            s = cfg.input_size
            g_pi = gpu._project(frame, req.region, s)
            c_pi = cpu._project(frame, req.region, s)
            worst["pi"] = max(worst["pi"], float((g_pi.cpu() - c_pi).abs().max()))
            check(bool(torch.allclose(g_pi.cpu(), c_pi, atol=5e-5)),
                  "small input: PIs differ")
            p_idx = req.variant.index - 1
            g_heads = det_mod.apply(gpu.params[p_idx], c_pi[None].cuda(), cfg)
            c_heads = det_mod.apply(cpu.params[p_idx], c_pi[None], cfg)
            for g, c in zip(g_heads, c_heads):
                worst["heads"] = max(worst["heads"],
                                     float((g.cpu() - c).abs().max()))
                check(bool(torch.allclose(g.cpu(), c, atol=1e-3, rtol=1e-3)),
                      "small input: detector heads differ")
            g_sc = sorted(d.score for d in gpu.infer_sroi(frame, req.region,
                                                          req.variant))
            c_sc = sorted(d.score for d in cpu.infer_sroi(frame, req.region,
                                                          req.variant))
            check(len(g_sc) == len(c_sc), "small input: detection counts")
            if g_sc:
                worst["scores"] = max(worst["scores"], max(
                    abs(a - b) for a, b in zip(g_sc, c_sc)))
    check(worst["scores"] <= 1e-3, "small input: detection scores differ")
    print(f"small input (192x384, 64 px PIs, {len(g_pend.requests)} "
          f"requests): card vs CPU max|err| PI {worst['pi']:.3g} (tol 5e-5), "
          f"heads {worst['heads']:.3g} (tol 1e-3 + 1e-3 rel), sorted scores "
          f"{worst['scores']:.3g} (tol 1e-3)")


def tick_server(loops, backends, **kw):
    """A ``PodServer`` that records what the tick lines print, through
    overrides that call the server's own methods: the drain's and the
    ingestion's wall ms (``phase``, which the caller zeroes each tick),
    and ``_suppress_tick``'s inputs (``tick``): the raw row lengths, the
    padding decision, and the padded rows as the server builds them, with
    the float32 keep mask it applied, for the bf16 SphIoU flip check."""
    import numpy as np

    from repro_torch.core.sphere import nms_auto_backend, pad_detection_rows
    from repro_torch.serving.server import PodServer

    class TickServer(PodServer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.phase = dict(drain=0.0, ingest=0.0)
            self.tick = None

        def _execute(self, ops, timeline, close):
            t = time.perf_counter()
            super()._execute(ops, timeline, close)
            self.phase["drain"] += (time.perf_counter() - t) * 1e3

        def _ingest(self):
            t = time.perf_counter()
            super()._ingest()
            self.phase["ingest"] += (time.perf_counter() - t) * 1e3

        def _suppress_tick(self, plans):
            raw = [len(res.detections) for _, res in plans]
            live = [res for _, res in plans if res.detections]
            rows = [list(res.detections) for res in live]
            pad = self.buckets.pad_nms_rows
            nms = nms_auto_backend(len(plans),
                                   pad(max(map(len, rows), default=0)))
            boxes, scores, mask = (
                pad_detection_rows(rows, pad_n=pad, total_rows=len(plans))
                if nms == "cuda" else pad_detection_rows(rows))
            wall = super()._suppress_tick(plans)
            keep = np.zeros(mask.shape, bool)
            for r, (res, row) in enumerate(zip(live, rows)):
                kept = {id(d) for d in res.detections}
                keep[r, :len(row)] = [id(d) in kept for d in row]
            self.tick = dict(raw=raw, backend=nms, boxes=boxes, scores=scores,
                             mask=mask, keep=keep)
            return wall

    return TickServer(loops, backends, **kw)


def check_detections(results) -> int:
    import numpy as np

    n = 0
    for res in results:
        for d in res.detections:
            check(np.shape(d.box) == (4,) and bool(np.isfinite(d.box).all())
                  and math.isfinite(d.score), "a detection is not finite")
            n += 1
    return n


def run_main_path(profile: bool = False) -> tuple[dict, list]:
    """Phase 5; returns the launches and the ladder's parameters (the
    mixed pod of phase 6 serves the same detectors)."""
    import numpy as np
    import torch

    from repro_torch.core.sphere import sph_nms_batch
    from repro_torch.data.synthetic import make_video, render_erp
    from repro_torch.kernels import _build
    from repro_torch.models import detector as det_mod
    from repro_torch.serving.batching import ShapeBuckets
    from repro_torch.serving.scheduler import TorchDetectorBackend

    t0 = time.perf_counter()
    cfgs = list(det_mod.PAPER_LADDER)
    params = [det_mod.init_params(torch.Generator().manual_seed(100 + i), c,
                                  device="cuda") for i, c in enumerate(cfgs)]
    backend = TorchDetectorBackend(
        cfgs, params, conf=0.01, max_det=16,
        buckets=ShapeBuckets.for_max_batch(
            MAX_BATCH, tuple(sorted({c.input_size for c in cfgs}))))
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"main path: PAPER_LADDER {[c.input_size for c in cfgs]} px, "
          f"{n_params / 1e6:.1f}M parameters, 80 classes, init "
          f"{time.perf_counter() - t0:.1f}s")
    h, w = 1920, 3840
    counts = {}

    # -- per-request path: one stream, two frames --------------------------
    video = make_video(n_frames=8, n_objects=20, seed=11)
    _, (loop,) = make_loops(backend, [video], 80, 5, None)
    frames = [render_erp(video, f, height=h, width=w) for f in (1, 2)]
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    for f, frame in zip((1, 2), frames):
        t = time.perf_counter()
        res = loop.process_frame(frame)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        n = check_detections([res])
        print(f"per-request frame {f}: {len(res.srois)} SRoIs, plan "
              f"{res.plan.models if res.plan else None}, {n} detections "
              f"after NMS, wall ms {ms:.1f}")
    # every rung of the ladder, at its published input size, on one SRoI
    # of the last frame (the allocator need not have chosen every rung)
    check(bool(res.srois), "the last per-request frame had no SRoI")
    region = res.srois[0]
    for variant in loop.variants:
        t = time.perf_counter()
        dets = backend.infer_sroi(frames[-1], region, variant)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        check(all(np.shape(d.box) == (4,) and bool(np.isfinite(d.box).all())
                  and math.isfinite(d.score) for d in dets),
              f"a {variant.name} detection is not finite")
        print(f"per-request {variant.name} "
              f"({cfgs[variant.index - 1].input_size} px): {len(dets)} "
              f"detections, wall ms {ms:.1f}")
    counts["per_request"] = _build.launch_counts()
    print(f"per-request launches: {counts['per_request']}")

    # -- the pod tick: four streams, three frames, through PodServer.step ----
    videos = [make_video(n_frames=8, n_objects=20, seed=s)
              for s in (21, 22, 23, 24)]
    _, loops = make_loops(backend, videos, 80, 5, None)
    ticks = {f: [render_erp(v, f, height=h, width=w) for v in videos]
             for f in (1, 2, 3)}
    server = tick_server(loops, [backend] * len(loops), max_batch=MAX_BATCH,
                         buckets=backend.buckets,
                         frame_source=lambda s, f: ticks[f][s])
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    total_dets = 0
    for f in (1, 2, 3):
        # the last tick runs under the profiler when asked (--profile)
        prof = (torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
            if profile and f == 3 else contextlib.nullcontext())
        uploads, hits = backend.frame_uploads, backend.crop_cache_hits
        server.phase = dict(drain=0.0, ingest=0.0)
        n_timelines = len(server.timelines)
        with prof:
            t = time.perf_counter()
            server.step(f)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        rec = server.tick
        check(not rec["keep"][~rec["mask"]].any(), "NMS kept a padded entry")
        # the bf16 SphIoU option on the tick's own padded rows, outside the
        # tick's timing: its keep flips against the float32 suppression
        keep16 = sph_nms_batch(rec["boxes"], rec["scores"], rec["mask"],
                               backend="cuda", iou_dtype=torch.bfloat16)
        check(not keep16[~rec["mask"]].any(), "bf16 NMS kept a padded entry")
        flips16 = int((keep16 != rec["keep"]).sum())
        results = [loop._history[-1] for loop in loops]
        n = check_detections([types.SimpleNamespace(detections=r)
                              for r in results])
        total_dets += n
        per_variant: dict = {}
        for tl in server.timelines[n_timelines:]:
            for ev in tl.events:
                per_variant[ev.variant] = per_variant.get(ev.variant, 0) + ev.b
        drain, ingest = server.phase["drain"], server.phase["ingest"]
        print(f"tick {f}: requests per variant {per_variant}, detections "
              f"{rec['raw']} -> {[len(r) for r in results]}, wall ms "
              f"{wall:.1f} (emission {wall - drain - ingest:.1f}, drain "
              f"{drain:.1f}, ingest {ingest:.1f}); frame uploads "
              f"{backend.frame_uploads - uploads}, crop-cache hits "
              f"{backend.crop_cache_hits - hits}; NMS {rec['backend']} on "
              f"rows {rec['boxes'].shape[0]}x{rec['boxes'].shape[1]}; bf16 "
              f"SphIoU option: {flips16} keep flips of {int(rec['mask'].sum())}"
              f" boxes")
        check(backend.frame_uploads - uploads == len(videos),
              f"tick {f} uploaded {backend.frame_uploads - uploads} frames, "
              f"not one a stream ({len(videos)})")
        check(not backend._staged, "a staged frame outlived its tick")
        if profile and f == 3:
            print_profile(prof, wall)
    counts["batched"] = _build.launch_counts()
    print(f"pod tick launches: {counts['batched']}; crop cache "
          f"{backend.crop_cache_hits} hits / {backend.crop_cache_misses} "
          f"misses; {backend.trace_count} (variant, batch) shapes; "
          f"{server.stats.frames} frames, {server.stats.dispatches} "
          f"dispatches, incremental NMS {server._nms_inc.hits} row hits / "
          f"{server._nms_inc.misses} misses")
    check(total_dets > 0, "the pod ticks produced no detections")
    launches = {k: counts["per_request"].get(k, 0) + counts["batched"].get(k, 0)
                for k in KERNELS if k not in LM_KERNELS}
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the main path")
    return launches, params


# --------------------------------------------------------------------------
# phase 6: the mixed detection + action pod, then replay and fleet
# --------------------------------------------------------------------------


def count_launches_of(obj, method: str, into: dict) -> None:
    """Wrap ``obj.method`` so that the kernel launches made inside it are
    added to ``into`` (the launches of one backend, apart from the
    others that share the global counts)."""
    from repro_torch.kernels import _build

    inner = getattr(obj, method)

    def counted(*args, **kwargs):
        before = _build.launch_counts()
        try:
            return inner(*args, **kwargs)
        finally:
            for k, n in _build.launch_counts().items():
                into[k] = into.get(k, 0) + n - before.get(k, 0)

    setattr(obj, method, counted)


def check_action_rungs(act_cfgs, act_params, buckets, frame, regions) -> None:
    """Every ``ACTION_LADDER`` rung at its published shape, a batch of 8,
    through ``infer_srois_batched`` twice on the card: with the gnomonic
    sampling kernel and with the plain projection.  The logits of the
    two agree within ``ACTION_LOGIT_ATOL``, their categories are equal,
    and each kernel crop is held to the float64 map as
    ``check_project_srois`` holds the batched projection."""
    import numpy as np
    import torch

    from repro_torch.kernels.gnomonic.ref import project_sroi_f64
    from repro_torch.models import action as act_mod
    from repro_torch.serving.tasks import TorchActionBackend, action_ladder

    kern = TorchActionBackend(act_cfgs, act_params, buckets=buckets)
    plain = TorchActionBackend(act_cfgs, act_params, buckets=buckets,
                               use_kernel=False)
    items = [(frame, r) for r in regions]
    # the frame staged once, as a tick stages it (unstaged, every crop
    # would upload its 88.5 MB frame anew, as the reference's backend does)
    kern.stage_frames([frame])
    plain.stage_frames([frame])
    device_frame = torch.from_numpy(frame).cuda()
    for variant, cfg in zip(action_ladder(), act_cfgs):
        idx = variant.index - 1
        # a full window: clip_len frames of the same regions
        t = time.perf_counter()
        for f in range(cfg.clip_len):
            kern.set_frame(f)
            got = kern.infer_srois_batched(items, variant)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3 / cfg.clip_len
        for f in range(cfg.clip_len):
            plain.set_frame(f)
            want = plain.infer_srois_batched(items, variant)
        check(len(got) == 8 and all(len(d) == 1 for d in got),
              f"{variant.name}: not one prediction an item")
        keys = [(idx, round(r.center[0], 1), round(r.center[1], 1))
                for r in regions]
        k_clips = torch.stack([torch.stack(kern._clips[k]) for k in keys])
        p_clips = torch.stack([torch.stack(plain._clips[k]) for k in keys])
        check(tuple(k_clips.shape) == (8, cfg.clip_len, cfg.input_size,
                                       cfg.input_size, 3),
              f"{variant.name}: batch shape {tuple(k_clips.shape)}")
        with torch.inference_mode():
            k_logits = act_mod.apply(kern.params[idx], k_clips, cfg)
            p_logits = act_mod.apply(plain.params[idx], p_clips, cfg)
        check(bool(torch.isfinite(k_logits).all()),
              f"{variant.name}: logits not finite")
        err = float((k_logits - p_logits).abs().max())
        crop_err = float((k_clips - p_clips).abs().max())
        err_k = err_p = 0.0
        for r, kc, pc in zip(regions, k_clips[:, -1], p_clips[:, -1]):
            exact = project_sroi_f64(device_frame, r.center[0], r.center[1],
                                     r.fov, cfg.input_size)
            err_k = max(err_k, float((kc.double() - exact).abs().max()))
            err_p = max(err_p, float((pc.double() - exact).abs().max()))
        check([d[0].category for d in got] == [d[0].category for d in want],
              f"{variant.name}: categories differ with the plain projection")
        check(err <= ACTION_LOGIT_ATOL,
              f"{variant.name}: logits {err} from the plain projection's")
        check(err_k <= 2 * err_p + 5e-5,
              f"{variant.name}: crops {err_k} from the float64 map, the "
              f"plain projection {err_p}")
        print(f"action rung {variant.name}: batch 8 x {cfg.clip_len} x "
              f"{cfg.input_size}^2 x 3, wall ms {ms:.2f} a batch (8 crops "
              f"and the forward); kernel "
              f"vs plain projection: crops max|err| {crop_err:.3g}, logits "
              f"max|err| {err:.3g} (tol {ACTION_LOGIT_ATOL}), categories "
              f"equal; against the float64 map: kernel {err_k:.3g}, plain "
              f"{err_p:.3g} (tol 2 x plain + 5e-5)")
    check(kern.frame_uploads == plain.frame_uploads == 1,
          "the rungs' batches uploaded their frame more than once")
    kern.release_frames()
    plain.release_frames()


def run_mixed_path(det_params, profile: bool = False) -> dict:
    """The mixed pod: 2 detection streams on the full ``PAPER_LADDER``
    and 2 action streams on the four ``ACTION_LADDER`` rungs, 3 ticks
    through ``PodServer.step``; then every action rung at batch 8.
    Returns the launches of the ticks."""
    import torch

    from repro_torch.core.sroi import SRoI
    from repro_torch.data.synthetic import make_video, render_erp
    from repro_torch.kernels import _build
    from repro_torch.models import action as act_mod
    from repro_torch.models import detector as det_mod
    from repro_torch.serving.scheduler import TorchDetectorBackend
    from repro_torch.serving.tasks import (TorchActionBackend,
                                           build_task_streams,
                                           default_action_configs,
                                           shape_buckets_for,
                                           stream_tasks_for,
                                           task_for_variant)

    t0 = time.perf_counter()
    tasks = stream_tasks_for("mixed", 4)
    videos = [make_video(n_frames=8, n_objects=20, seed=s)
              for s in (31, 32, 33, 34)]
    _, loops, _, _ = build_task_streams(tasks, videos, [2.0] * len(tasks))
    buckets = shape_buckets_for(tasks, MAX_BATCH)
    det = TorchDetectorBackend(list(det_mod.PAPER_LADDER), det_params,
                               conf=0.01, max_det=16, buckets=buckets)
    act_cfgs = default_action_configs()
    act_params = [act_mod.init_params(torch.Generator().manual_seed(200 + i),
                                      c, device="cuda")
                  for i, c in enumerate(act_cfgs)]
    act = TorchActionBackend(act_cfgs, act_params, buckets=buckets)
    act_launches: dict = {}
    count_launches_of(act, "infer_srois_batched", act_launches)
    backends = [det if t == "detection" else act for t in tasks]
    # the registry's loops, served by the real backends
    for loop, backend, video in zip(loops, backends, videos):
        loop.backend = backend
        loop.seed_history(video.visible_objects(0))
    h, w = 1920, 3840
    ticks = {f: [render_erp(v, f, height=h, width=w) for v in videos]
             for f in (1, 2, 3)}
    server = tick_server(loops, backends, max_batch=MAX_BATCH,
                         buckets=buckets,
                         frame_source=lambda s, f: ticks[f][s])
    print(f"mixed pod: streams {tasks}; detection PAPER_LADDER "
          f"{[c.input_size for c in det.cfgs]} px, action "
          f"{[(c.name, c.clip_len, c.input_size) for c in act_cfgs]} "
          f"(d_model {act_cfgs[0].d_model}, {act_cfgs[0].n_layers} layer, "
          f"{act_cfgs[0].n_heads} heads), set-up "
          f"{time.perf_counter() - t0:.1f}s")
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    n_actions = 0
    for f in (1, 2, 3):
        prof = (torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
            if profile and f == 3 else contextlib.nullcontext())
        uploads = (det.frame_uploads, act.frame_uploads)
        act_gs = act_launches.get("gnomonic_sample", 0)
        server.phase = dict(drain=0.0, ingest=0.0)
        n_timelines = len(server.timelines)
        with prof:
            t = time.perf_counter()
            server.step(f)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        rec = server.tick
        check(not rec["keep"][~rec["mask"]].any(), "NMS kept a padded entry")
        results = [loop._history[-1] for loop in loops]
        check_detections([types.SimpleNamespace(detections=r)
                          for r in results])
        per_variant: dict = {}
        for tl in server.timelines[n_timelines:]:
            for ev in tl.events:
                key = f"{task_for_variant(ev.variant)}/{ev.variant}"
                per_variant[key] = per_variant.get(key, 0) + ev.b
        preds = [(d.category, round(d.score, 3)) for s, r in
                 enumerate(results) if tasks[s] != "detection" for d in r]
        n_actions += len(preds)
        up = (det.frame_uploads - uploads[0], act.frame_uploads - uploads[1])
        drain, ingest = server.phase["drain"], server.phase["ingest"]
        print(f"mixed tick {f}: wall ms {wall:.1f} (emission "
              f"{wall - drain - ingest:.1f}, drain {drain:.1f}, ingest "
              f"{ingest:.1f}); requests per (task, variant) {per_variant}; "
              f"action predictions (class, score) {preds}; detections "
              f"{rec['raw']} -> {[len(r) for r in results]}; frame uploads "
              f"{sum(up)} (detection {up[0]}, action {up[1]}); action "
              f"gnomonic_sample launches "
              f"{act_launches.get('gnomonic_sample', 0) - act_gs}; NMS "
              f"{rec['backend']} on rows {rec['boxes'].shape[0]}x"
              f"{rec['boxes'].shape[1]}")
        check(up == (2, 2), f"mixed tick {f} uploaded {up} frames, not one "
              f"a stream")
        check(not det._staged and not act._staged,
              "a staged frame outlived its tick")
        if profile and f == 3:
            print_profile(prof, wall, what="mixed tick 3")
    launches = _build.launch_counts()
    print(f"mixed pod launches: {launches}; of them the action path's "
          f"{act_launches}; {server.stats.frames_by_task} frames by task, "
          f"{server.stats.dispatches} dispatches")
    check(n_actions > 0, "the action streams predicted nothing")
    check(act_launches.get("gnomonic_sample", 0) > 0,
          "the action path did not launch gnomonic_sample")
    check(launches.get("project_srois_batched", 0) > 0,
          "the detection streams did not launch project_srois_batched")
    # every rung at its published shape, batch 8, on an action stream's
    # tick-3 frame (the allocator need not have chosen every rung)
    regions = [SRoI(center=(-2.9 + 0.75 * k, 0.35 * math.sin(k)),
                    fov=(1.1, 0.9)) for k in range(8)]
    check_action_rungs(act_cfgs, act_params, buckets, ticks[3][1], regions)
    return launches


def run_replay_lane() -> None:
    """The replay-determinism lane and the fleet, on the oracle backends
    (host only): three corpora recorded with ``repro_torch.launch.replay
    record`` and re-driven with ``check``, each of which must be
    bit-identical, then the serve launcher's mixed-task 2-pod fleet."""
    import io
    import shutil

    from repro_torch.launch import replay as replay_cli
    from repro_torch.launch import serve

    out_dir = ROOT / "build" / "chip_smoke_replay"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    corpora = {
        "closed": ["--streams", "8", "--policy", "async", "--pod-allocate"],
        "mixed": ["--streams", "8", "--open-loop", "--tasks", "mixed",
                  "--slo", "2.0", "--admission", "slo"],
        "fleet": ["--streams", "8", "--open-loop", "--pods", "2",
                  "--routing", "affinity"],
    }
    for name, args in corpora.items():
        path = str(out_dir / f"{name}.jsonl")
        t = time.perf_counter()
        for argv in (["record", "--out", path] + args, ["check", path]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = replay_cli.main(argv)
            lines = buf.getvalue().splitlines()
            for line in lines:
                print(f"replay {name} ({argv[0]}): {line}")
            check(rc == 0, f"replay {argv[0]} of the {name} corpus exited "
                  f"{rc}")
        check(len(lines) == 1 and "bit-identical" in lines[0],
              f"the {name} corpus did not replay bit-identically")
        print(f"replay {name}: {(time.perf_counter() - t) * 1e3:.0f} ms "
              f"wall (record and check)")
    shutil.rmtree(out_dir)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--open-loop", "--pods", "2", "--tasks", "mixed"])
    lines = buf.getvalue().splitlines()
    check(bool(lines) and lines[0].startswith("fleet [least-loaded routing, "
                                              "2 pods]"),
          f"serve launcher fleet: {lines[:1]}")
    for line in lines:
        print(f"serve launcher (oracle, --open-loop --pods 2 --tasks mixed):"
              f" {line}")


# --------------------------------------------------------------------------
# phase 7: the LM serving path
# --------------------------------------------------------------------------


def run_lm_path(profile: bool = False) -> dict:
    import dataclasses
    import hashlib

    import torch

    from repro_torch.configs import smollm_135m
    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as T
    from repro_torch.models import layers as L
    from repro_torch.training.steps import lm_decode_step, lm_prefill_step

    t0 = time.perf_counter()
    cfg = dataclasses.replace(smollm_135m.full_config(),
                              attention_impl="flash")
    dev = torch.device("cuda")
    params = T.init_params(torch.Generator(device=dev).manual_seed(12), cfg,
                           device=dev)
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"LM path: {cfg.name}, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{n_params / 1e6:.1f}M bf16 parameters (random, seeded), "
          f"attention_impl=flash, init {time.perf_counter() - t0:.1f}s")
    b, s, n_dec = 4, 2048, 32
    s_long = LM_SHAPES["prefill_32k"].seq_len
    tok_gen = torch.Generator(device=dev).manual_seed(13)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=tok_gen,
                           device=dev)
    long_tokens = torch.randint(0, cfg.vocab_size, (1, s_long),
                                generator=tok_gen, device=dev)
    prefill = lm_prefill_step(cfg, s + n_dec)
    decode = lm_decode_step(cfg)
    prefill(params, {"tokens": tokens[:, :256]})  # warm-up: handles, library
    torch.cuda.synchronize()

    _build.reset_launch_counts()
    t = time.perf_counter()
    out = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    logits = out["logits"].clone()
    finite = torch.isfinite(logits).all()
    token = logits.argmax(-1)
    generated = []
    t = time.perf_counter()
    for _ in range(n_dec):
        generated.append(token)
        out = decode(params, {"token": token, "cache_k": out["k"],
                              "cache_v": out["v"], "cache_len": out["length"]})
        finite &= torch.isfinite(out["logits"]).all()
        token = out["logits"].argmax(-1)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t) * 1e3 / n_dec
    check(int(out["length"]) == s + n_dec, "decode: cache length")
    t = time.perf_counter()
    long_out = lm_prefill_step(cfg, s_long)(params, {"tokens": long_tokens})
    torch.cuda.synchronize()
    long_ms = (time.perf_counter() - t) * 1e3
    finite &= torch.isfinite(long_out["logits"]).all()
    launches = _build.launch_counts()
    check(bool(finite), "the LM path gave non-finite logits")
    digest = hashlib.sha256(torch.stack(generated, 1).cpu().numpy()
                            .astype("int64").tobytes()).hexdigest()[:16]
    print(f"LM prefill B={b} S={s}: {prefill_ms:.1f} ms for the step, "
          f"prefill ms per request {prefill_ms / b:.1f}")
    print(f"LM decode B={b}, {n_dec} greedy steps after the {s}-token "
          f"prompt: decode ms per token {decode_ms:.2f}")
    print(f"LM generated tokens (B={b} x {n_dec}) sha256 {digest}; first "
          f"row {torch.stack(generated, 1)[0, :8].tolist()}")
    print(f"LM prefill B=1 S={s_long} (prefill_32k's length; its batch of "
          f"32 cut to 1 for the smoke's time): prefill ms per request "
          f"{long_ms:.1f}")
    print(f"LM launches: {launches} over 2 prefill calls of {cfg.n_layers} "
          f"layers ({cfg.n_layers} a call)")
    check(launches.get("flash_attention_wgmma", 0) == 2 * cfg.n_layers,
          f"flash_attention_wgmma launched "
          f"{launches.get('flash_attention_wgmma', 0)} times on the LM path, "
          f"not {2 * cfg.n_layers}")
    check(launches.get("flash_attention", 0) == 0,
          f"the SIMT flash_attention launched "
          f"{launches.get('flash_attention', 0)} times on the bf16 LM path")

    # comparisons, after the counts are read: the same step under the
    # chunked plain version, and layer 0's attention at 32k
    chunked = dataclasses.replace(cfg, attention_impl="chunked")
    ref = lm_prefill_step(chunked, s + n_dec)(params, {"tokens": tokens})
    err = float((logits - ref["logits"]).abs().max())
    agree = float((logits.argmax(-1) == ref["logits"].argmax(-1)).float()
                  .mean())
    print(f"LM prefill B={b} S={s} logits against attention_impl=chunked: "
          f"max|err| {err:.3g} (tol {LM_LOGIT_ATOL}), next-token agreement "
          f"{agree:.2f}")
    check(err <= LM_LOGIT_ATOL, f"LM logits against chunked: {err}")
    check_each_layer(params, cfg, tokens, "LM")
    with torch.no_grad():
        lp = T._layer_params(params, 0)
        x = L.embedding(params["embed"], long_tokens, cfg.policy)
        q, k, v = T._qkv(lp, x, cfg, torch.arange(s_long, device=dev))
        a_flash = T.attention(q, k, v, cfg, causal=True)
        a_ref = T.attention(q, k, v, chunked, causal=True)
        err0 = float((a_flash.float() - a_ref.float()).abs().max())
        readings = check_attn_bf16(
            a_flash, a_ref, attention_rows(q, k, v, drop=s_long // 2),
            f"LM prefill S={s_long} layer 0 attention")
    print(f"LM prefill S={s_long} layer-0 attention against the chunked "
          f"plain version: max|err| {err0:.3g}, {readings}")
    if profile:
        profile_lm(prefill, decode, params, tokens)
    del params, long_out, out, ref
    launches.update(run_lm_float32(cfg, tokens[:1]))
    return {k: launches.get(k, 0) for k in LM_KERNELS}


def check_each_layer(params, cfg, tokens, what: str, rows: int = 2048,
                     at_layer0=None):
    """Each layer's attention (``attention_impl="flash"``) on the chunked
    step's own activations against the chunked plain version, within one
    bf16 ulp and ATTN_BF16_ATOL, with the control at layer 0: a K/V tile
    dropped inside the window of the last rows (``rows`` query rows a
    block).  ``at_layer0(lp, x, attn_out, cfg)``, if given, also runs at
    layer 0; its result is returned."""
    import dataclasses

    import torch

    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    b, s = tokens.shape
    chunked = dataclasses.replace(cfg, attention_impl="chunked")
    kw = dict(causal=True, window=cfg.window)
    worst, worst_at, extra = -1.0, 0, None
    with torch.no_grad():
        x = L.embedding(params["embed"], tokens, cfg.policy)
        positions = torch.arange(s, device=tokens.device)
        for i in range(cfg.n_layers):
            lp = T._layer_params(params, i)
            q, k, v = T._qkv(lp, x, cfg, positions)
            a_ref = T.attention(q, k, v, chunked, **kw)
            a_flash = T.attention(q, k, v, cfg, **kw)
            if i == 0:
                drop = s - (cfg.window or s) // 2
                readings = check_attn_bf16(
                    a_flash, a_ref,
                    attention_rows(q, k, v, drop=drop, rows=rows, **kw),
                    f"{what} prefill B={b} S={s} layer 0 attention")
                if at_layer0 is not None:
                    extra = at_layer0(lp, x, a_flash, cfg)
            ex = attn_excess(a_flash, a_ref)
            if ex > worst:
                worst, worst_at = ex, i
            x, _ = T._finish_block(lp, x, a_ref, chunked)
    print(f"{what} prefill B={b} S={s} attention of each of {cfg.n_layers} "
          f"layers against the chunked plain version: |err| - 2^-7 |ref| at "
          f"most {worst:.3g}, at layer {worst_at} (limit {ATTN_BF16_ATOL}); "
          f"layer 0: {readings}")
    check(worst <= ATTN_BF16_ATOL,
          f"{what} prefill attention of layer {worst_at} against chunked: "
          f"|err| exceeds 2^-7 |ref| by {worst}")
    return extra


def run_lm_float32(cfg, tokens) -> dict:
    """The same model under the float32 policy (the reference's float32
    path, whose attention the SIMT kernel serves): one prefill, counted on
    its own, held to the chunked plain version's logits."""
    import dataclasses

    import torch

    from repro_torch.kernels import _build
    from repro_torch.models import transformer as T
    from repro_torch.training.steps import lm_prefill_step

    cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32,
                                compute_dtype=torch.float32)
    params = T.init_params(torch.Generator(device="cuda").manual_seed(12),
                           cfg32, device="cuda")
    b, s = tokens.shape
    prefill = lm_prefill_step(cfg32, s)
    prefill(params, {"tokens": tokens[:, :256]})  # warm-up
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t = time.perf_counter()
    logits = prefill(params, {"tokens": tokens})["logits"]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    launches = _build.launch_counts()
    chunked = dataclasses.replace(cfg32, attention_impl="chunked")
    ref = lm_prefill_step(chunked, s)(params, {"tokens": tokens})["logits"]
    check(bool(torch.isfinite(logits).all()),
          "the float32 LM prefill gave non-finite logits")
    err = float((logits - ref).abs().max())
    print(f"LM float32 policy prefill B={b} S={s}: {ms:.1f} ms; logits "
          f"against attention_impl=chunked max|err| {err:.3g} (tol "
          f"{LM_F32_LOGIT_ATOL}); launches {launches}")
    check(err <= LM_F32_LOGIT_ATOL,
          f"float32 LM logits against chunked: {err}")
    check(launches == {"flash_attention": cfg.n_layers},
          f"the float32 LM prefill launched {launches}, not "
          f"{cfg.n_layers} of the SIMT flash_attention")
    return launches


# --------------------------------------------------------------------------
# phase 8: the MoE LM serving path
# --------------------------------------------------------------------------

# phase 8's runs: (config module, layers kept of the published depth,
# batch, prompt tokens, greedy decode steps)
MOE_RUNS = (("mixtral_8x22b", 8, 2, 8192, 32),
            ("qwen3_moe_235b_a22b", 2, 1, 4096, 0))
# layer 0's MoE block against the per-token float32 formulation over the
# prompt's first MOE_CHECK_TOKENS tokens.  The formulation rounds the
# SwiGLU's hidden to bf16 where the reference's function does
# (``hidden.astype(cdt)``) and keeps the rest in float32; the block also
# rounds each pick's expert output, its gate and the gated product, and
# each of the k - 1 additions, by at most MOE_U relatively each (bf16's
# unit roundoff).  Hence |got - ref| <= MOE_U ((k + 2) sum_j |c_j| +
# rms(ref)) per element, c_j the picks' float32 contributions (the rms
# term covers the float32 sums' order); a control with one kept pick
# zeroed must fail it
MOE_U = 2.0 ** -8
MOE_CHECK_TOKENS = 1024


def check_moe_block(lp, x, attn_out, cfg) -> str:
    """Layer 0's MoE block on the card (``moe_block``: the dispatch, the
    grouped products, the combine) against a per-token float32
    formulation on the card, from the same bf16 input and weights: for
    each kept (token, expert) pick of the block's routing, the gate times
    that expert's SwiGLU of the token; a dropped pick gives 0.  Returns
    the readings, for the printed line."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    b, s, d = x.shape
    moe = lp["moe"]
    xa = x + L.dense({"w": lp["attn"]["wo"]},
                     attn_out.reshape(b, s, cfg.n_heads * cfg.d_head),
                     cfg.policy)
    h2 = L.rmsnorm(lp["ln2"], xa, cfg.norm_eps).reshape(b * s, d)
    routes = []
    got = T.moe_block(moe, h2, cfg, routes)[0][:MOE_CHECK_TOKENS].float()
    n = got.shape[0]
    ids, keep = routes[0].expert_ids[:n], routes[0].keep[:n]
    probs = torch.softmax(L.dense({"w": moe["router"]}, h2[:n],
                                  cfg.policy).float(), dim=-1)
    gates = probs.gather(1, ids)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    h = h2[:n].float()

    def swiglu(e, tok):
        wg, wu, wd = (moe[w][e].float() for w in ("w_gate", "w_up", "w_down"))
        hid = (F.silu(h[tok] @ wg) * (h[tok] @ wu)).to(cfg.compute_dtype)
        return hid.float() @ wd

    ref = torch.zeros((n, d), device=x.device)
    mag = torch.zeros((n, d), device=x.device)  # sum_j |c_j|
    for e in range(cfg.n_experts):
        tok, j = ((ids == e) & keep).nonzero(as_tuple=True)
        if len(tok):
            c = gates[tok, j, None] * swiglu(e, tok)
            ref.index_add_(0, tok, c)
            mag.index_add_(0, tok, c.abs())
    bound = MOE_U * ((cfg.moe_top_k + 2) * mag + ref.pow(2).mean().sqrt())

    def excess(want):
        return float(((got - want).abs() / bound).max())

    ex = excess(ref)
    # the control: the kept pick with the largest gate zeroed
    tok, j = divmod(int(torch.where(keep, gates, -1.0).argmax()), ids.shape[1])
    ctl = ref.clone()
    ctl[tok] -= gates[tok, j] * swiglu(int(ids[tok, j]), [tok])[0]
    ex_ctl = excess(ctl)
    what = f"{cfg.name} layer-0 MoE block over {n} tokens"
    check(ex <= 1.0, f"{what}: |err| exceeds its bound {ex} times")
    check(ex_ctl > 1.0, f"{what}: the control with a kept pick zeroed "
          f"passes ({ex_ctl} <= 1)")
    return (f"max |err| / (2^-8 ((k + 2) sum_j |c_j| + rms(ref))) {ex:.3g} "
            f"(limit 1; the control with the pick of token {tok}, gate "
            f"{float(gates[tok, j]):.3f}, zeroed {ex_ctl:.3g}, fails); "
            f"{int(keep.sum())} kept picks, {int((~keep).sum())} dropped")


def routes_by_layer(routes: list, n_layers: int) -> list[list]:
    """The :class:`Routing` records of successive calls, by layer."""
    return [routes[i::n_layers] for i in range(n_layers)]


def serve_moe(cfg, b: int, s: int, n_dec: int, full_layers: int,
              profile: bool) -> dict:
    """One MoE model through ``lm_prefill_step`` (and ``n_dec`` greedy
    ``lm_decode_step``s), launches counted from 0 before and read after;
    then the comparisons; returns the launches."""
    import dataclasses
    import hashlib

    import torch

    from repro_torch.kernels import _build
    from repro_torch.models import transformer as T
    from repro_torch.training.steps import lm_decode_step, lm_prefill_step

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = T.init_params(torch.Generator(device=dev).manual_seed(21), cfg,
                           device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    gbytes = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    print(f"MoE path: {cfg.name}, {cfg.n_layers} of its {full_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
          f"heads of {cfg.d_head}, {cfg.n_experts} experts top-"
          f"{cfg.moe_top_k}, d_ff_expert {cfg.d_ff_expert}, window "
          f"{cfg.window}, vocab {cfg.vocab_size}: {n_params / 1e9:.2f}B bf16 "
          f"parameters ({gbytes:.1f} GB; random, seeded), "
          f"attention_impl=flash, init {time.perf_counter() - t0:.1f}s")
    tok_gen = torch.Generator(device=dev).manual_seed(22)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=tok_gen,
                           device=dev)
    routes_p, routes_d = [], []
    prefill = lm_prefill_step(cfg, s + n_dec, routes_p)
    decode = lm_decode_step(cfg, routes_d)
    prefill(params, {"tokens": tokens[:, :256]})  # warm-up: handles, library
    torch.cuda.synchronize()
    routes_p.clear()
    torch.cuda.reset_peak_memory_stats()

    _build.reset_launch_counts()
    t = time.perf_counter()
    out = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    logits = out["logits"].clone()
    finite = torch.isfinite(logits).all()
    token = logits.argmax(-1)
    generated = []
    t = time.perf_counter()
    for _ in range(n_dec):
        generated.append(token)
        out = decode(params, {"token": token, "cache_k": out["k"],
                              "cache_v": out["v"], "cache_len": out["length"]})
        finite &= torch.isfinite(out["logits"]).all()
        token = out["logits"].argmax(-1)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t) * 1e3 / max(n_dec, 1)
    launches = _build.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(bool(finite), f"the {cfg.name} MoE path gave non-finite logits")
    check(int(out["length"]) == s + n_dec, f"{cfg.name}: cache length")
    print(f"MoE {cfg.name} prefill B={b} S={s}: {prefill_ms:.1f} ms for the "
          f"step, prefill ms per request {prefill_ms / b:.1f}; peak device "
          f"memory {peak_gb:.1f} GB")
    drops = [int(sum((~r.keep).sum() for r in rs))
             for rs in routes_by_layer(routes_p, cfg.n_layers)]
    print(f"MoE {cfg.name} prefill tokens dropped per layer (of {b * s} x "
          f"{cfg.moe_top_k} picks, capacity {T.moe_capacity(cfg, b * s)} an "
          f"expert): {drops}")
    if n_dec:
        gen = torch.stack(generated, 1)
        digest = hashlib.sha256(gen.cpu().numpy().astype("int64").tobytes()
                                ).hexdigest()[:16]
        drops = [int(sum((~r.keep).sum() for r in rs))
                 for rs in routes_by_layer(routes_d, cfg.n_layers)]
        print(f"MoE {cfg.name} decode B={b}, {n_dec} greedy steps after the "
              f"{s}-token prompt (positions {s}..{s + n_dec - 1}, ring slots "
              f"pos % {out['k'].shape[2]}): decode ms per token "
              f"{decode_ms:.2f}")
        print(f"MoE {cfg.name} generated tokens (B={b} x {n_dec}) sha256 "
              f"{digest}; first row {gen[0, :8].tolist()}")
        print(f"MoE {cfg.name} decode tokens dropped per layer over {n_dec} "
              f"steps (of {b} x {cfg.moe_top_k} picks a step, capacity "
              f"{T.moe_capacity(cfg, b)} an expert): {drops}")
    print(f"MoE {cfg.name} launches: {launches} over one prefill call of "
          f"{cfg.n_layers} layers (decode attends with plain einsums)")

    # comparisons, after the counts are read: the same step under the
    # chunked plain version, with its routing
    chunked = dataclasses.replace(cfg, attention_impl="chunked")
    routes_c = []
    ref = lm_prefill_step(chunked, s + n_dec, routes_c)(params,
                                                        {"tokens": tokens})
    err = float((logits - ref["logits"]).abs().max())
    agree = float((logits.argmax(-1) == ref["logits"].argmax(-1)).float()
                  .mean())
    moved = [int(((a.expert_ids != c.expert_ids) | (a.keep != c.keep))
                 .any(dim=1).sum()) for a, c in zip(routes_p, routes_c)]
    line = (f"MoE {cfg.name} prefill logits against attention_impl=chunked: "
            f"max|err| {err:.3g}, next-token agreement {agree:.2f}")
    if any(moved):
        print(f"{line}; not held to {LM_LOGIT_ATOL}: tokens whose experts or "
              f"drops differ, by layer: {moved}")
    else:
        print(f"{line} (tol {LM_LOGIT_ATOL}; every layer's experts and drops "
              f"agree)")
        check(err <= LM_LOGIT_ATOL, f"{cfg.name} logits against chunked: "
              f"{err}")
    del ref, routes_c
    moe_readings = check_each_layer(params, cfg, tokens, f"MoE {cfg.name}",
                                    rows=512, at_layer0=check_moe_block)
    print(f"MoE {cfg.name} layer-0 MoE block against the per-token float32 "
          f"formulation: {moe_readings}")
    if profile and n_dec:
        profile_lm(prefill, decode, params, tokens)
    return launches


def run_moe_path(profile: bool = False) -> dict:
    """Phase 8: the MoE models at published widths, depth cut to fit one
    card (``MOE_RUNS``), bf16 weights from a seeded generator,
    ``attention_impl="flash"`` (the tensor-core kernel at D=128).

    Cuts (``reduced``): mixtral-8x22b 56 -> 8 layers (a layer is 5.01 GB
    in bf16, 4.83 GB of it experts: 56 layers would take 281 GB), and
    ``prefill_32k``'s 32 x 32768 prompts -> 2 x 8192 (the grouped
    buffers grow with the tokens: 40960 grouped rows at capacity 5120 an
    expert; still two windows of 4096, so the window's mask and the
    kernel's skip of the tiles behind it both act), then 32 greedy decode
    steps at B=2; qwen3-moe-235b-a22b 94 -> 2 layers (12.4 GB with the
    embeddings), one 1 x 4096 prefill (capacity 320, 40960 grouped
    rows).  Launch counts are set to 0 before each model's path and read
    after it: the tensor-core kernel once a layer of each prefill, the
    SIMT kernel never."""
    import dataclasses
    import importlib

    import torch

    torch.cuda.empty_cache()  # phase 7's parameters are freed
    launches: dict = {}
    for module, n_layers, b, s, n_dec in MOE_RUNS:
        full = importlib.import_module(f"repro_torch.configs.{module}"
                                       ).full_config()
        cfg = dataclasses.replace(full, n_layers=n_layers,
                                  attention_impl="flash")
        got = serve_moe(cfg, b, s, n_dec, full.n_layers, profile)
        torch.cuda.empty_cache()  # its parameters are freed
        check(got.get("flash_attention_wgmma", 0) == n_layers,
              f"flash_attention_wgmma launched "
              f"{got.get('flash_attention_wgmma', 0)} times on {cfg.name}'s "
              f"path, not {n_layers}")
        check(got.get("flash_attention", 0) == 0,
              f"the SIMT flash_attention launched "
              f"{got.get('flash_attention', 0)} times on {cfg.name}'s path")
        for name, n in got.items():
            launches[name] = launches.get(name, 0) + n
    return {k: launches.get(k, 0) for k in LM_KERNELS}


# --------------------------------------------------------------------------
# phase 9: training
# --------------------------------------------------------------------------

# smollm-135m's train step: train_4k's sequence, its global batch of 256
# cut to TRAIN_BATCH (one card, and neither package accumulates
# gradients), TRAIN_STEPS steps, an async checkpoint after TRAIN_SAVE_AT
TRAIN_BATCH, TRAIN_STEPS, TRAIN_SAVE_AT = 8, 6, 3
# step 1's per-token NLL (the terms whose mean is its loss) under the bf16
# policy against the float32 policy on the same (widened) weights: mean
# |difference|.  bf16 rounds ~10 activations a layer at 2^-9 relative;
# over 30 layers the final hidden state drifts by a few percent, which
# moves a logit (std ~0.6 at these random weights) and so a token's NLL
# by a few hundredths.  The control (targets shifted by one token)
# changes each token's picked logit, by ~0.6 on average
TRAIN_NLL_ATOL = 0.1
# the detector's train step: the ladder's top rung, float32, TF32 off
DET_TRAIN_BATCH, DET_TRAIN_STEPS, DET_TRAIN_MAX_GB = 8, 3, 60.0


def bits(t):
    """``t``'s bits as an integer tensor (bit-for-bit comparisons)."""
    import torch

    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.view(ints[t.element_size()])


def token_nll(params, batch, cfg):
    """Each token's NLL (``lm_loss``'s CE terms, no aux), no grad."""
    import torch

    from repro_torch.models import transformer as T

    with torch.no_grad():
        hidden, _ = T.forward(params, batch["tokens"], cfg)
        w32 = params["unembed"]["w"].to(cfg.compute_dtype).float()
        out = []
        for lo in range(0, hidden.shape[1], cfg.ce_chunk):
            logits = hidden[:, lo:lo + cfg.ce_chunk].float() @ w32
            t = batch["targets"][:, lo:lo + cfg.ce_chunk].long()
            out.append(torch.logsumexp(logits, -1)
                       - logits.gather(-1, t[..., None])[..., 0])
    return torch.cat(out, 1)


def check_grads(grads, groups: dict, what: str) -> None:
    """Every leaf of ``grads`` finite; each named group's non-zero."""
    import torch

    from repro_torch import pytree

    bad = [i for i, g in enumerate(pytree.leaves(grads))
           if not bool(torch.isfinite(g).all())]
    check(not bad, f"{what}: non-finite gradient leaves {bad}")
    zero = [k for k, g in groups.items() if not bool((g != 0).any())]
    print(f"{what} gradients: {len(pytree.leaves(grads))} leaves finite; "
          f"{len(groups) - len(zero)} of {len(groups)} groups non-zero"
          + (f" (zero: {zero})" if zero else ""))
    check(not zero, f"{what}: zero gradients in {zero}")


def timed_steps(step, state, batches, what: str, unit: str, per_step: int
                ) -> tuple:
    """Runs ``step`` over ``batches``; prints each step's ms (host clock,
    ended by ``torch.cuda.synchronize()``), ``unit``/s, loss and grad
    norm.  Returns (state, losses)."""
    import torch

    losses, norms = [], []
    for batch in batches:
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        print(f"{what} step {int(m['step'])}: {ms:.1f} ms, "
              f"{per_step / ms * 1e3:.0f} {unit}/s, loss {losses[-1]:.6f}, "
              f"grad norm {norms[-1]:.6f}")
    check(all(math.isfinite(x) for x in losses + norms),
          f"{what}: non-finite loss or grad norm {losses} {norms}")
    return state, losses


def run_train_path(profile: bool = False) -> tuple[dict, dict]:
    """Phase 9; returns the launches of the LM train path and of the
    detector's."""
    import torch

    from repro_torch.kernels import _build

    torch.cuda.empty_cache()
    _build.reset_launch_counts()
    run_lm_train(profile)
    lm = _build.launch_counts()
    torch.cuda.empty_cache()
    _build.reset_launch_counts()
    run_detector_train(profile)
    det = _build.launch_counts()
    print(f"train launches: LM {lm}, detector {det}")
    check(not lm and not det, "a training path launched a kernel, which "
          "has no backward")
    return lm, det


def run_lm_train(profile: bool) -> None:
    """smollm-135m at published widths (bf16, ``chunked`` attention,
    remat, ``ce_chunk`` 512) trains ``TRAIN_STEPS`` steps of ``adamw(lr=
    1e-3, warmup_steps=10)`` on ``lm_batches`` through ``Prefetcher``;
    ``save_async`` after step ``TRAIN_SAVE_AT``, restored into a fresh
    ``make_state`` template, which runs the later steps again."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch import pytree
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.configs import smollm_135m
    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.data.pipeline import Prefetcher, lm_batches
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import steps as steps_mod

    cfg = smollm_135m.full_config()
    dev = torch.device("cuda")
    b, s = TRAIN_BATCH, LM_SHAPES["train_4k"].seq_len
    opt = opt_mod.adamw(lr=1e-3, warmup_steps=10)
    params = T.init_params(torch.Generator(device=dev).manual_seed(20), cfg,
                           device=dev)
    print(f"train path: {cfg.name}, {cfg.n_layers} layers, bf16, "
          f"attention_impl={cfg.attention_impl}, remat={cfg.remat}, "
          f"ce_chunk {cfg.ce_chunk}; batch {b} x {s} (train_4k's global "
          f"batch {LM_SHAPES['train_4k'].global_batch} cut to {b}: one "
          f"card, no gradient accumulation), adamw lr 1e-3 warmup 10")
    batches = [pytree.tree_map(lambda v: torch.as_tensor(v, device=dev), x)
               for x in Prefetcher(lm_batches(cfg.vocab_size, b, s, seed=0,
                                              n_batches=TRAIN_STEPS))]

    # (a) the gradient of every parameter group, at the initial weights
    loss0, grads = steps_mod.value_and_grad(
        lambda p: T.lm_loss(p, batches[0], cfg), params)
    lyr = grads["layers"]
    groups = {"embed": grads["embed"]["emb"], "ln_f": grads["ln_f"]["scale"],
              "unembed": grads["unembed"]["w"]}
    for i in (0, cfg.n_layers - 1):
        for part, keys in (("attn", ("wq", "wk", "wv", "wo")),
                           ("mlp", ("w_gate", "w_up", "w_down")),
                           ("ln1", ("scale",)), ("ln2", ("scale",))):
            for k in keys:
                groups[f"layer{i}.{part}.{k}"] = lyr[part][k][i]
    check_grads(grads, groups, "smollm-135m")
    del grads, lyr, groups

    state = steps_mod.make_state(params, opt)
    step = steps_mod.lm_train_step(cfg, opt)
    mgr = CheckpointManager(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, losses = timed_steps(
        step, state, batches[:TRAIN_SAVE_AT], "smollm-135m train",
        "tokens", b * s)
    saved = state
    mgr.save_async(TRAIN_SAVE_AT, saved)
    state, more = timed_steps(
        step, state, batches[TRAIN_SAVE_AT:], "smollm-135m train", "tokens",
        b * s)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"smollm-135m train: peak memory {peak:.2f} GB; step 1 loss "
          f"{losses[0]:.6f} (the gradient check's {float(loss0):.6f})")
    losses += more

    # (b) step 1's per-token NLL against the float32 policy's, and the
    # control with the targets shifted by one token
    cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32,
                                compute_dtype=torch.float32)
    nll = token_nll(params, batches[0], cfg)
    nll32 = token_nll(pytree.tree_map(lambda t: t.float(), params),
                      batches[0], cfg32)
    shifted = dict(batches[0], targets=batches[0]["targets"].roll(1, 1))
    nll_ctl = token_nll(params, shifted, cfg)
    err = float((nll - nll32).abs().mean())
    ctl = float((nll_ctl - nll32).abs().mean())
    print(f"smollm-135m step 1 loss {losses[0]:.6f}: bf16 per-token NLL "
          f"(mean {float(nll.mean()):.6f}) against the float32 policy's "
          f"(mean {float(nll32.mean()):.6f}): mean |diff| {err:.4g}, max "
          f"{float((nll - nll32).abs().max()):.4g} (limit {TRAIN_NLL_ATOL}); "
          f"the control with the targets shifted by one token {ctl:.4g}")
    check(err <= TRAIN_NLL_ATOL,
          f"smollm-135m step 1 NLL against float32: {err}")
    check(ctl > TRAIN_NLL_ATOL,
          f"the shifted-target control passed the NLL check: {ctl}")
    del nll, nll32, nll_ctl

    # (c) the restored state equals the saved one bit for bit
    mgr.wait()
    template = steps_mod.make_state(
        T.init_params(torch.Generator(device=dev).manual_seed(21), cfg,
                      device=dev), opt)
    restored = mgr.restore(TRAIN_SAVE_AT, template)
    got, want = pytree.leaves(restored), pytree.leaves(saved)
    same = sum(g.dtype == w.dtype and bool(torch.equal(bits(g), bits(w)))
               for g, w in zip(got, want))
    print(f"smollm-135m checkpoint at step {TRAIN_SAVE_AT}: "
          f"{mgr.manifest(TRAIN_SAVE_AT)['n_leaves']} leaves, {same} of "
          f"{len(want)} restored bit for bit; optimizer step "
          f"{int(restored['opt']['step'])}")
    check(same == len(want) == len(got),
          "the restored state differs from the saved one")

    # (d) the later steps again from the restored state
    _, resumed = timed_steps(
        step, restored, batches[TRAIN_SAVE_AT:], "smollm-135m resumed",
        "tokens", b * s)
    equal = resumed == losses[TRAIN_SAVE_AT:]
    print(f"smollm-135m resumed losses {resumed} against the uninterrupted "
          f"run's {losses[TRAIN_SAVE_AT:]}: "
          f"{'bit-equal' if equal else 'not bit-equal'}")
    if profile:
        profile_train_step(step, state, batches[-1], "smollm-135m")
    del state, saved, restored, template, params


def run_detector_train(profile: bool) -> None:
    """The detector's train step at the ladder's top rung (yolo-p6-1280:
    width and depth 1.0, P6 head), float32 with TF32 off, ``adamw``,
    ``DET_TRAIN_STEPS`` steps on ``detector_batches`` of the synthetic
    video at 1920x3840.  The batch is cut from ``DET_TRAIN_BATCH`` to
    half if peak memory passes ``DET_TRAIN_MAX_GB``."""
    import torch

    from repro_torch import pytree
    from repro_torch.data.pipeline import Prefetcher, detector_batches
    from repro_torch.data.synthetic import make_video
    from repro_torch.models import detector as det_mod
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import steps as steps_mod

    cfg = det_mod.PAPER_LADDER[-1]
    dev = torch.device("cuda")
    params = det_mod.init_params(torch.Generator(device=dev).manual_seed(30),
                                 cfg, device=dev)
    video = make_video(n_frames=8, n_objects=20, seed=11)
    opt = opt_mod.adamw(lr=1e-3)
    step = steps_mod.detector_train_step(cfg, opt)
    for b in (DET_TRAIN_BATCH, DET_TRAIN_BATCH // 2):
        t = time.perf_counter()
        batches = [pytree.tree_map(lambda v: torch.as_tensor(v, device=dev),
                                   x)
                   for x in Prefetcher(detector_batches(
                       video, cfg, b, height=1920, width=3840, seed=0,
                       n_batches=DET_TRAIN_STEPS))]
        print(f"detector train path: {cfg.name} ({cfg.input_size} px, width "
              f"{cfg.width_mult}, depth {cfg.depth_mult}, strides "
              f"{cfg.strides}), float32, TF32 off, adamw lr 1e-3, batch {b}; "
              f"{DET_TRAIN_STEPS} batches rendered in "
              f"{time.perf_counter() - t:.1f}s")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss0, grads = steps_mod.value_and_grad(
            lambda p: det_mod.detection_loss(p, batches[0], cfg), params)
        peak = torch.cuda.max_memory_allocated() / 1e9
        if peak <= DET_TRAIN_MAX_GB:
            break
        print(f"detector train: peak memory {peak:.2f} GB at batch {b} "
              f"passes {DET_TRAIN_MAX_GB} GB: batch cut to {b // 2}")
        del grads, batches
        torch.cuda.empty_cache()
    convs = {}

    def walk(t, path):
        if isinstance(t, dict):
            if "w" in t and t["w"].dim() == 4:
                convs[path] = t["w"]
            for k, v in t.items():
                walk(v, f"{path}.{k}" if path else k)
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, f"{path}[{i}]")
    walk(grads, "")
    check_grads(grads, convs, cfg.name)
    del grads
    state = steps_mod.make_state(params, opt)
    state, losses = timed_steps(step, state, batches, f"{cfg.name} train",
                                "images", b)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"{cfg.name} train: batch {b}, peak memory {peak:.2f} GB; step 1 "
          f"loss {losses[0]:.6f} (the gradient check's {float(loss0):.6f})")
    if profile:
        profile_train_step(step, state, batches[-1], cfg.name)


def profile_train_step(step, state, batch, what: str) -> None:
    """One train step under the profiler: the card's busy share and its
    top kernels."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    print_profile(prof, wall, f"one {what} train step", top=12)


def profile_lm(prefill, decode, params, tokens, n_dec: int = 4) -> None:
    """One prefill step and ``n_dec`` decode steps under the profiler:
    the card's busy share of each, and their top kernels."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        out = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    print_profile(prof, wall, f"one LM prefill step (B={tokens.shape[0]}, "
                  f"S={tokens.shape[1]})", top=8)
    token = out["logits"].argmax(-1)
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        for _ in range(n_dec):
            out = decode(params, {"token": token, "cache_k": out["k"],
                                  "cache_v": out["v"],
                                  "cache_len": out["length"]})
            token = out["logits"].argmax(-1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    print_profile(prof, wall, f"{n_dec} LM decode steps (B="
                  f"{tokens.shape[0]})", top=8)


def print_profile(prof, wall_ms: float, what: str = "tick 3",
                  top: int = 12) -> None:
    """Device busy time of one profiled window, against its wall time,
    and the kernels that took most of it."""
    from torch.autograd import DeviceType

    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(r[0] for r in rows)
    n_kernels = sum(r[1] for r in rows)
    print(f"profile of {what}: device busy {busy:.1f} ms of {wall_ms:.1f} ms "
          f"wall ({100 * busy / wall_ms:.1f}%), {n_kernels} device ops")
    h2d = [r for r in rows if r[2].startswith("Memcpy HtoD")]
    print(f"  host-to-device copies {sum(r[0] for r in h2d):.3f} ms in "
          f"{sum(r[1] for r in h2d)} copies "
          f"({', '.join(f'{r[2]} {r[1]}x' for r in h2d) or 'none'})")
    for ms, n, name in sorted(rows, reverse=True)[:top]:
        print(f"  {ms:9.3f} ms  {n:5d}x  {name[:90]}")
    port = [r for r in rows if any(k in r[2] for k in PORT_KERNEL_FUNCTIONS)]
    for ms, n, name in sorted(port, reverse=True):
        print(f"  port kernel {ms:9.4f} ms  {n:5d}x  {name[:90]}")


def run_serve_launcher() -> None:
    """The port's serve launcher (``repro_torch.launch.serve``) on its
    oracle pod: the async policy with pod-level allocation over virtual
    replica groups.  No kernel runs there; its summary lines print."""
    import io

    from repro_torch.launch import serve

    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        serve.main(["--streams", "8", "--frames", "8", "--policy", "async",
                    "--pod-allocate", "--devices", "8"])
    lines = out.getvalue().splitlines()
    check(bool(lines) and lines[0].startswith("served 64 frames"),
          f"serve launcher: {lines[:1]}")
    for line in lines:
        print(f"serve launcher (oracle, --policy async --pod-allocate): "
              f"{line}")
    print(f"serve launcher: {(time.perf_counter() - t) * 1e3:.1f} ms wall")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from repro_torch.device import set_fp32_policy
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable: {e}", file=sys.stderr)
        return 1
    set_fp32_policy()
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, TF32 off "
          f"(cudnn {torch.backends.cudnn.allow_tf32}, matmul "
          f"{torch.backends.cuda.matmul.allow_tf32})")
    t0 = time.perf_counter()
    print(f"build: {_build.build_all():.1f}s for {_build.kernel_names()}")
    print_ptxas(_build.ptxas_report("attention"), "flash_wgmma_kernel")
    print_ptxas(_build.ptxas_report("nms"), "greedy_")
    print_ptxas(_build.ptxas_report("gnomonic"), "project_srois_kernel")
    print_ptxas(_build.ptxas_report("sphiou"),
                ("sphiou_self_kernel", "sphiou_cross_kernel"))

    records: dict = {}
    flash_only = "--flash-only" in sys.argv[1:]
    frame_only = "--frame-kernels-only" in sys.argv[1:]
    if not flash_only:
        check_gnomonic(records)
        check_project_srois(records)
        check_sphiou_bf16(records)
        check_nms(records)
    if not frame_only:
        check_flash(records)
    if flash_only or frame_only:
        print(f"total {time.perf_counter() - t0:.1f}s "
              f"(--{'flash' if flash_only else 'frame-kernels'}-only: no "
              f"result)")
        return 0
    check_small_input()
    profile = "--profile" in sys.argv[1:]
    # each path's launches, counted from 0 just before it and read after
    by_path = {}
    by_path["frame_loop"], det_params = run_main_path(profile=profile)
    run_serve_launcher()
    by_path["mixed_pod"] = run_mixed_path(det_params, profile=profile)
    del det_params
    run_replay_lane()
    by_path["lm"] = run_lm_path(profile=profile)
    by_path["lm_moe"] = run_moe_path(profile=profile)
    by_path["lm_train"], by_path["detector_train"] = run_train_path(
        profile=profile)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        rec = records[name]
        paths = {p: c.get(name, 0) for p, c in by_path.items()}
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(paths.values()), max_abs_err=rec["max_abs_err"],
            ms=rec["ms"], plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"],
            shape=rec["shape"], launches_by_path=paths))
    print(f"total {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
