#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU, end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from the sources in the checkout (one ``nvcc``
   per source, all started together);
3. each kernel against its plain PyTorch version on the card, at the
   main path's shapes: max |err| against the stated tolerance, the
   kernel's, the plain version's and (where one PyTorch call computes
   the same function) that call's time in ms, and the least time the
   card could take (``bound_ms``);
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
   ``finalize_detections``).  Launch counts are set to 0 just before each
   of the two paths and read just after; every kernel must have run.

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

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s and
# float32 FLOP/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12

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
}


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


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / PEAK_F32_FLOPS * 1e3
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
        print(f"kernel gnomonic_sample {label}: {s}x{s} PI from {h}x{w}x{c} "
              f"f32, max|err| {err:.3g} (tol 3e-6 + 1e-5 rel), "
              f"ms {ms:.4f}, plain_ms {plain_ms:.4f}, library_ms "
              f"{lib_ms:.4f} (F.grid_sample), bound_ms {b_ms:.5f} ({b_by})")
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
    for b, s in ((8, 640), (8, 1280), (4, 416)):
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
        print(f"kernel project_srois_batched B={b} S={s}: max|kernel - "
              f"plain| {err:.3g}; against the float64 map: kernel "
              f"{err_k:.3g}, plain {err_p:.3g} (tol 2 x plain + 5e-5)")
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


def check_nms(records: dict) -> None:
    import torch

    from repro_torch.kernels.nms import ops as nms_ops
    from repro_torch.kernels.nms.ref import greedy_suppress_rows_ref
    from repro_torch.kernels.sphiou import ops as iou_ops
    from repro_torch.kernels.sphiou.ref import sphiou_ref_batch

    dev = torch.device("cuda")
    for b, n in ((8, 128), (32, 512)):
        boxes, scores, mask = nms_inputs(b, n, b + n)
        bx = torch.tensor(boxes, dtype=torch.float32, device=dev)
        sc = torch.tensor(scores, dtype=torch.float32, device=dev)
        mk = torch.tensor(mask, device=dev)
        iou = iou_ops.sphiou_matrix_batch(bx, bx)
        ref = sphiou_ref_batch(bx, bx)
        err = float((iou - ref).abs().max())
        check(err <= 5e-6, f"sphiou_matrix_batch {b}x{n}: max |err| {err}")
        ms = time_ms(lambda: iou_ops.sphiou_matrix_batch(bx, bx))
        plain_ms = time_ms(lambda: sphiou_ref_batch(bx, bx), reps=5)
        # per pair, counted from the source: two directions of sincos x3,
        # atan2, asin, sin x2 and ~25 arithmetic, plus areas and the ratio
        b_ms, b_by = bound_ms(2 * b * n * 16 + b * n * n * 4, b * n * n * 80)
        print(f"kernel sphiou_matrix_batch B={b} N={n}: max|err| {err:.3g} "
              f"(tol 5e-6), ms {ms:.4f}, plain_ms {plain_ms:.4f}, "
              f"library_ms null, bound_ms {b_ms:.5f} ({b_by})")
        keep = nms_ops.greedy_suppress_rows(iou, sc, mk, 0.6)
        keep_ref = greedy_suppress_rows_ref(iou, sc, mk, 0.6)
        check(bool(torch.equal(keep, keep_ref)),
              f"greedy_suppress_rows {b}x{n}: keep masks differ")
        g_ms = time_ms(lambda: nms_ops.greedy_suppress_rows(iou, sc, mk, 0.6))
        g_plain = time_ms(
            lambda: greedy_suppress_rows_ref(iou, sc, mk, 0.6), reps=5)
        kept = int(keep.sum())
        # this run's data: the kept boxes' IoU rows, plus scores/mask/keep
        gb_ms, gb_by = bound_ms(kept * n * 4 + b * n * 6, kept * n * 3)
        print(f"kernel greedy_suppress_rows B={b} N={n}: keep masks equal "
              f"({kept} kept of {int(mask.sum())}), ms {g_ms:.4f}, plain_ms "
              f"{g_plain:.4f}, library_ms null, bound_ms {gb_ms:.6f} "
              f"({gb_by})")
        if (b, n) == (32, 512):
            records["sphiou_matrix_batch"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, shape=f"B={b} N={n}")
            records["greedy_suppress_rows"] = dict(
                max_abs_err=0.0, ms=g_ms, plain_ms=g_plain, bound_ms=gb_ms,
                bound_by=gb_by, library_ms=None, shape=f"B={b} N={n}")


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
        n = check_detections(results)
        total_dets += n
        ph = [(b - a) * 1e3 for a, b in zip(t, t[1:])]
        print(f"tick {f}: requests per variant "
              f"{ {name: len(sl) for name, sl, _ in launched} }, NMS rows "
              f"{boxes.shape[0]}x{boxes.shape[1]}, detections {raw} -> "
              f"{[len(r.detections) for r in results]}, wall ms "
              f"{sum(ph):.1f} (begin_frame {ph[0]:.1f}, launch {ph[1]:.1f}, "
              f"resolve {ph[2]:.1f}, finish + NMS {ph[3]:.1f})")
        if profile and f == 3:
            print_profile(prof, sum(ph))
    counts["batched"] = _build.launch_counts()
    print(f"batched launches: {counts['batched']}; crop cache "
          f"{backend.crop_cache_hits} hits / {backend.crop_cache_misses} "
          f"misses; {backend.trace_count} (variant, batch) shapes")
    check(total_dets > 0, "the batched ticks produced no detections")
    launches = {k: counts["per_request"].get(k, 0) + counts["batched"].get(k, 0)
                for k in KERNELS}
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the main path")
    return launches


def print_profile(prof, wall_ms: float) -> None:
    """Device busy time of one profiled tick, against its wall time, and
    the kernels that took most of it."""
    from torch.autograd import DeviceType

    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(r[0] for r in rows)
    print(f"profile of tick 3: device busy {busy:.1f} ms of {wall_ms:.1f} ms "
          f"wall ({100 * busy / wall_ms:.1f}%)")
    for ms, n, name in sorted(rows, reverse=True)[:12]:
        print(f"  {ms:9.3f} ms  {n:5d}x  {name[:90]}")


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

    records: dict = {}
    check_gnomonic(records)
    check_project_srois(records)
    check_nms(records)
    check_small_input()
    launches = run_main_path(profile="--profile" in sys.argv[1:])

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
