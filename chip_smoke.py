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
   kernel's path shape, timed beside SDPA in float32) and at 32k (the
   tensor-core kernel against the
   SIMT one), each with a control that drops one K/V tile and must fail;
   then the tensor-core kernel, the SIMT kernel, SDPA and the plain
   version are timed in turn.  The bf16 SphIoU option is also checked
   against the float32 kernel's keep masks (the reference's flip gate);
4. a small input through the per-request path on the card and on the
   CPU: the same SRoIs and plans, PIs, detector heads and detection
   scores within tolerance;
5. the main path at full width: the five-rung ``PAPER_LADDER``
   (416-1280 px inputs, published widths, 80 classes, random weights
   from a seeded generator) on synthetic 1920x3840 ERP video.  One
   stream runs ``OmniSenseLoop.process_frame`` for 2 frames (the
   per-request path: gnomonic sampling kernel), and one of its SRoIs goes
   through ``infer_sroi`` at every rung; then 4 streams run 3
   batched ticks (``begin_frame``, ``launch_srois_batched`` per variant
   with the fused projection and crop cache, ``finish_frame(defer_nms=
   True)``, one ``sph_nms_batch(backend="cuda")`` over the padded tick,
   ``finalize_detections``), and each tick's rows once more through the
   bf16 SphIoU option (``iou_dtype=torch.bfloat16``), its keep flips
   against float32 reported.  Launch counts are set to 0 just before each
   of the two paths and read just after; every kernel must have run;
6. the LM serving path at full width: smollm-135m (``full_config()``,
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
   chunked plain version's logits.

``--flash-only`` stops after the flash kernels' checks and times (phase 3
for attention alone), for comparing versions of the kernels; it prints no
result line.

``--frame-kernels-only`` stops after the frame loop's kernels (phase 3 for
the gnomonic sampler, the batched projection, SphIoU and the greedy
suppression), for the same use; it prints no result line either.

``--profile`` also profiles the last batched tick, one LM prefill step
and four decode steps: the card's busy share of each, its top kernels and
the frame loop's kernels among them.

The last lines are the kernels' JSON record, the ``nvidia-smi`` line and
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
# the kernels the LM serving path runs (bf16 on the tensor-core kernel,
# the float32 policy on the SIMT one); the frame loop runs the others
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
    cases = [("416", (0.3, 0.2), 60, 416), ("640", (math.pi, -0.4), 75, 640),
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


def sdpa_call(q, k, v):
    """One PyTorch call computing causal GQA attention on (B, S, H, D)
    tensors: the library yardstick, timed only."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)


def flash_bound(b: int, s: int, hq: int, hkv: int, d: int,
                float32: bool = False) -> tuple[float, str]:
    """Causal attention's least time: 4*D operations a (query, key) pair
    at the bf16 tensor-core rate, against q, k, v and the output moved
    once in bf16; for float32, 4-byte elements and the float32 rate
    outside the tensor cores (TF32 would round the inputs)."""
    pairs = b * hq * s * (s + 1) // 2
    elem = 4 if float32 else 2
    n_bytes = elem * d * b * s * (2 * hq + 2 * hkv)
    return bound_ms(n_bytes, 4 * d * pairs,
                    PEAK_F32_FLOPS if float32 else PEAK_BF16_TC_FLOPS)


def attn_excess(got, ref) -> float:
    """How far ``got`` lies outside one bf16 ulp of ``ref``:
    max(|got - ref| - ATTN_BF16_RTOL |ref|), held to ATTN_BF16_ATOL."""
    g, r = got.float(), ref.float()
    return float(((g - r).abs() - ATTN_BF16_RTOL * r.abs()).max())


def attention_dropping_tile(q, k, v, lo: int, *, causal: bool = True,
                            window: int | None = None, q_offset: int = 0,
                            rows: int = 2048):
    """The control: GQA attention in float32, as the plain version
    computes it, but blind to keys lo..lo+ATTN_DROPPED_TILE-1, as a kernel
    that skipped that K/V tile would be; by blocks of ``rows`` queries, so
    the scores of a 32k sequence fit.  Output in q's dtype."""
    import torch

    b, s, hq, d = q.shape
    rep = hq // k.shape[2]
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    kpos = torch.arange(k.shape[1], device=q.device)
    seen = (kpos < lo) | (kpos >= lo + ATTN_DROPPED_TILE)
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
        out[:, r0:r0 + rows] = torch.einsum("bhqk,bkhd->bqhd", p, vf).to(
            q.dtype)
        del sc, p
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
            ctl = attention_dropping_tile(q, k, v, c["skv"] // 2, **kw)
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
    ctl = attention_dropping_tile(q, k, v, s // 2)
    ctl_err = float((ctl - ref).abs().max())
    check(not torch.allclose(ctl, ref, atol=2e-5, rtol=1e-4),
          "flash_attention smollm shape float32: the control passes")
    print(f"kernel flash_attention B={b} S={s} Hq={hq} Hkv={hkv} D={d} "
          f"float32 causal: max|err| {err32:.3g} (atol 2e-5 + rtol 1e-4; "
          f"the control with {ATTN_DROPPED_TILE} keys dropped {ctl_err:.3g}, "
          f"fails)")
    # the float32 policy's LM prefill (phase 6, 1 x 2048), the shape the
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
    ctl = attention_dropping_tile(q, k, v, s // 2)
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
                               attention_dropping_tile(q, k, v, s // 2),
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


def check_detections(results) -> int:
    import numpy as np

    n = 0
    for res in results:
        for d in res.detections:
            check(np.shape(d.box) == (4,) and bool(np.isfinite(d.box).all())
                  and math.isfinite(d.score), "a detection is not finite")
            n += 1
    return n


def run_main_path(profile: bool = False) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.sphere import pad_detection_rows, sph_nms_batch
    from repro_torch.data.synthetic import make_video, render_erp
    from repro_torch.kernels import _build
    from repro_torch.models import detector as det_mod
    from repro_torch.serving.scheduler import TorchDetectorBackend

    t0 = time.perf_counter()
    cfgs = list(det_mod.PAPER_LADDER)
    params = [det_mod.init_params(torch.Generator().manual_seed(100 + i), c,
                                  device="cuda") for i, c in enumerate(cfgs)]
    backend = TorchDetectorBackend(cfgs, params, conf=0.01, max_det=16)
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

    # -- batched tick: four streams, three frames ---------------------------
    videos = [make_video(n_frames=8, n_objects=20, seed=s)
              for s in (21, 22, 23, 24)]
    variants, loops = make_loops(backend, videos, 80, 5, None)
    ticks = [[render_erp(v, f, height=h, width=w) for v in videos]
             for f in (1, 2, 3)]
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    total_dets = 0
    for f, frames in zip((1, 2, 3), ticks):
        # the last tick runs under the profiler when asked (--profile)
        prof = (torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
            if profile and f == 3 else contextlib.nullcontext())
        with prof:
            t = [time.perf_counter()]
            pendings = [lp.begin_frame(fr) for lp, fr in zip(loops, frames)]
            t.append(time.perf_counter())
            # launch every variant's chunks, then resolve them all, so the
            # host work of one overlaps the device work of the next
            launched = []
            for v in variants:
                slots = [(s, req) for s, p in enumerate(pendings)
                         for req in p.requests if req.variant.name == v.name]
                if slots:
                    launched.append((v.name, slots, backend.launch_srois_batched(
                        [(req.frame, req.region) for _, req in slots], v)))
            t.append(time.perf_counter())
            dets = [[None] * len(p.requests) for p in pendings]
            for _, slots, resolve in launched:
                for (s, req), d in zip(slots, resolve()):
                    dets[s][req.slot] = d
            t.append(time.perf_counter())
            results = [lp.finish_frame(p, d, defer_nms=True)
                       for lp, p, d in zip(loops, pendings, dets)]
            raw = [len(r.detections) for r in results]
            boxes, scores, mask = pad_detection_rows(
                [r.detections for r in results], backend.buckets.pad_nms_rows)
            keep = sph_nms_batch(boxes, scores, mask, backend="cuda")
            check(not keep[~mask].any(), "NMS kept a padded entry")
            for lp, r, row in zip(loops, results, keep):
                lp.finalize_detections(r, row[:len(r.detections)]
                                       if r.detections else None)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
        # the bf16 SphIoU option on the same padded rows, outside the
        # tick's timing: its keep flips against the float32 suppression
        keep16 = sph_nms_batch(boxes, scores, mask, backend="cuda",
                               iou_dtype=torch.bfloat16)
        check(not keep16[~mask].any(), "bf16 NMS kept a padded entry")
        flips16 = int((keep16 != keep).sum())
        n = check_detections(results)
        total_dets += n
        ph = [(b - a) * 1e3 for a, b in zip(t, t[1:])]
        print(f"tick {f}: requests per variant "
              f"{ {name: len(sl) for name, sl, _ in launched} }, NMS rows "
              f"{boxes.shape[0]}x{boxes.shape[1]}, detections {raw} -> "
              f"{[len(r.detections) for r in results]}, wall ms "
              f"{sum(ph):.1f} (begin_frame {ph[0]:.1f}, launch {ph[1]:.1f}, "
              f"resolve {ph[2]:.1f}, finish + NMS {ph[3]:.1f}); bf16 SphIoU "
              f"option: {flips16} keep flips of {int(mask.sum())} boxes")
        if profile and f == 3:
            print_profile(prof, sum(ph))
    counts["batched"] = _build.launch_counts()
    print(f"batched launches: {counts['batched']}; crop cache "
          f"{backend.crop_cache_hits} hits / {backend.crop_cache_misses} "
          f"misses; {backend.trace_count} (variant, batch) shapes")
    check(total_dets > 0, "the batched ticks produced no detections")
    launches = {k: counts["per_request"].get(k, 0) + counts["batched"].get(k, 0)
                for k in KERNELS if k not in LM_KERNELS}
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the main path")
    return launches


# --------------------------------------------------------------------------
# phase 6: the LM serving path
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
    # each layer's attention on the model's own activations, the chunked
    # step's, against the chunked plain version, and the control at layer 0
    worst, worst_at = -1.0, 0
    with torch.no_grad():
        x = L.embedding(params["embed"], tokens, cfg.policy)
        positions = torch.arange(s, device=dev)
        for i in range(cfg.n_layers):
            lp = T._layer_params(params, i)
            q, k, v = T._qkv(lp, x, cfg, positions)
            a_ref = T.attention(q, k, v, chunked, causal=True)
            a_flash = T.attention(q, k, v, cfg, causal=True)
            if i == 0:
                readings = check_attn_bf16(
                    a_flash, a_ref, attention_dropping_tile(q, k, v, s // 2),
                    f"LM prefill B={b} S={s} layer 0 attention")
            ex = attn_excess(a_flash, a_ref)
            if ex > worst:
                worst, worst_at = ex, i
            x = T._finish_block(lp, x, a_ref, cfg)
    print(f"LM prefill B={b} S={s} attention of each of {cfg.n_layers} "
          f"layers against the chunked plain version: |err| - 2^-7 |ref| at "
          f"most {worst:.3g}, at layer {worst_at} (limit {ATTN_BF16_ATOL}); "
          f"layer 0: {readings}")
    check(worst <= ATTN_BF16_ATOL,
          f"LM prefill attention of layer {worst_at} against chunked: "
          f"|err| exceeds 2^-7 |ref| by {worst}")
    with torch.no_grad():
        lp = T._layer_params(params, 0)
        x = L.embedding(params["embed"], long_tokens, cfg.policy)
        q, k, v = T._qkv(lp, x, cfg, torch.arange(s_long, device=dev))
        a_flash = T.attention(q, k, v, cfg, causal=True)
        a_ref = T.attention(q, k, v, chunked, causal=True)
        err0 = float((a_flash.float() - a_ref.float()).abs().max())
        readings = check_attn_bf16(
            a_flash, a_ref, attention_dropping_tile(q, k, v, s_long // 2),
            f"LM prefill S={s_long} layer 0 attention")
    print(f"LM prefill S={s_long} layer-0 attention against the chunked "
          f"plain version: max|err| {err0:.3g}, {readings}")
    if profile:
        profile_lm(prefill, decode, params, tokens)
    del params, long_out, out, ref
    launches.update(run_lm_float32(cfg, tokens[:1]))
    return {k: launches.get(k, 0) for k in LM_KERNELS}


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
    for ms, n, name in sorted(rows, reverse=True)[:top]:
        print(f"  {ms:9.3f} ms  {n:5d}x  {name[:90]}")
    port = [r for r in rows if any(k in r[2] for k in PORT_KERNEL_FUNCTIONS)]
    for ms, n, name in sorted(port, reverse=True):
        print(f"  port kernel {ms:9.4f} ms  {n:5d}x  {name[:90]}")


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
    launches = run_main_path(profile=profile)
    launches.update(run_lm_path(profile=profile))

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        rec = records[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=rec["max_abs_err"],
            ms=rec["ms"], plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"],
            shape=rec["shape"]))
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
