"""The benchmark's frozen copies and plain reference against the port, on
the CPU at small sizes: the FLOP count against ``FlopCounterMode``, the
camera clock, the synthetic video and its frames, the plan of a frame,
the detector's forward and decode, the crop of an SRoI at the FoV clamp,
the lift of PI boxes to SphBBs and the greedy suppression."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from omnibench import flops, weights
from omnibench.check_detect import served
from omnibench.reference import clock, detector as ref_det, geometry
from omnibench.reference import plan as ref_plan, scene
from omnibench.tests.tiny import tiny_config
from repro_torch.core import sphere
from repro_torch.core.omnisense import OmniSenseLoop
from repro_torch.core.sroi import Detection
from repro_torch.data import synthetic
from repro_torch.models import detector as det_mod
from repro_torch.serving import profiles, traffic
from repro_torch.serving.network import NetworkModel
from repro_torch.serving.scheduler import OmniSenseLatencyModel, OracleBackend


def rungs(n_classes=16):
    return [ref_det.Rung(c.name, c.input_size, c.width_mult, c.depth_mult,
                         c.p6, n_classes) for c in det_mod.PAPER_LADDER]


@pytest.mark.parametrize("size", [64, 128])
def test_flop_count_equals_the_profilers_count(size):
    rs = rungs()
    trees = weights.ladder_weights(rs, 0, "cpu")
    for r, tree, cfg in zip(rs, trees, det_mod.PAPER_LADDER):
        cfg = dataclasses.replace(cfg, input_size=size, n_classes=16)
        with FlopCounterMode(display=False) as fc:
            det_mod.apply(tree, torch.zeros(2, size, size, 3), cfg)
        assert fc.get_total_flops() == 2 * flops.conv_flops_per_image(r, size)


def test_stream_clock_is_the_ports():
    for s in range(3):
        a = clock.StreamClock(s, 1.7, 0.2, seed=2 ** 31 + 11)
        b = traffic.StreamClock(s, 1.7, 0.2, seed=2 ** 31 + 11)
        assert [a.next_arrival() for _ in range(50)] == \
            [b.next_arrival() for _ in range(50)]


def test_video_and_frames_are_the_ports():
    a = scene.make_video(seed=2 ** 32 + 3)
    b = synthetic.make_video(seed=2 ** 32 + 3)
    for f in (0, 1, 4):
        assert [(d.box.tolist(), d.category) for d in a.visible_objects(f)] \
            == [(d.box.tolist(), d.category) for d in b.visible_objects(f)]
        assert np.array_equal(scene.render_erp(a, f, 96, 192),
                              synthetic.render_erp(b, f, 96, 192))


def test_plan_is_the_loops():
    video = synthetic.make_video(seed=9, n_objects=60)
    variants = profiles.make_ladder()
    lat = OmniSenseLatencyModel(profiles.paper_profile(), NetworkModel())
    backend = OracleBackend(video)
    loop = OmniSenseLoop(variants, lat, backend, budget_s=8.0)
    loop.seed_history(video.visible_objects(0))
    ref = ref_plan.StreamPlanner(ref_plan.make_ladder(), 8.0, 80,
                                 scene.make_video(seed=9, n_objects=60)
                                 .visible_objects(0))
    for f in range(1, 8):
        backend.set_frame(f)
        pend = loop.begin_frame(None)
        fp = ref.plan()
        assert [(s.center, s.fov, s.special) for s in fp.srois] == \
            [(s.center, s.fov, s.special) for s in pend.srois]
        assert fp.plan.models == pend.plan.models
        assert fp.plan.t_done == pend.plan.t_done
        res = loop.finish_frame(pend, [backend.infer_sroi(None, q.region,
                                                          q.variant)
                                       for q in pend.requests])
        assert ref.discovers(fp) == res.discovered
        ref.commit([Detection(d.box.copy(), d.category, d.score)
                    for d in res.detections])


def test_detector_and_decode_are_the_ports():
    cfg = tiny_config()
    rs = [ref_det.Rung(r["name"], r["input_size"], r["width_mult"],
                       r["depth_mult"], r["p6"], cfg["n_classes"])
          for r in cfg["ladder"]]
    trees = weights.ladder_weights(rs, 3, "cpu")
    x = torch.rand(1, 128, 128, 3, generator=torch.Generator().manual_seed(0))
    for r, tree in zip(rs, trees):
        dc = det_mod.DetectorConfig(r.name, 128, r.width_mult, r.depth_mult,
                                    cfg["n_classes"], r.p6)
        outs = det_mod.apply(tree, x, dc)
        for a, b in zip(outs, ref_det.forward(tree, x)):
            assert torch.equal(a, b)
        boxes, scores, classes = det_mod.decode(outs, dc, 0.01, max_det=4)
        c = ref_det.decode_cells(outs, r.strides)
        c["sphbb"] = c["boxes"]
        got = served(c, 0.01, 4)
        assert [d.score for d in got] == scores[0][scores[0] > 0].tolist()
        assert [d.category for d in got] == classes[0][:len(got)].tolist()
        assert np.allclose(np.stack([d.box for d in got]),
                           boxes[0][:len(got)].numpy())


def test_sphbb_lift_and_greedy_suppression():
    rng = np.random.default_rng(4)
    rect = torch.tensor(rng.uniform(0, 96, (40, 2)), dtype=torch.float32)
    rect = torch.cat([rect, rect + torch.rand(40, 2) * 30], 1)
    for ct, cp, fov in ((0.3, 0.2, (1.0, 0.8)), (-3.0, 1.2, (0.6, 1.1))):
        a = sphere.pi_box_to_sphbb(rect, ct, cp, fov, (96, 96)).double()
        b = geometry.pi_boxes_to_sphbb(rect, ct, cp, fov, 96)
        d = (a - b).abs()
        d[:, 0] = torch.minimum(d[:, 0], 2 * math.pi - d[:, 0])
        assert float(d.max()) < 1e-5
    boxes = np.concatenate([rng.uniform(-1, 1, (60, 2)),
                            rng.uniform(0.05, 0.6, (60, 2))], 1)
    scores = rng.uniform(0, 1, 60)
    keep, margin = geometry.greedy_keep(boxes, scores, 0.3)
    want = sphere.sph_nms_batch(boxes[None], scores[None], iou_threshold=0.3,
                                backend="host")[0]
    assert np.array_equal(keep, want) and margin > 0


@pytest.mark.parametrize("fov", [(1.0472, math.pi), (math.pi, 0.9),
                                 (5.2, math.pi)])
def test_crop_at_the_clamp_is_the_ports(fov):
    """A special SRoI's FoV clamps at pi: its crop, mapped from the
    geometry rounded to float32 as the projection takes it, is the
    port's plain projection of the same SRoI."""
    from repro_torch.kernels.gnomonic import ops as gno_ops

    frame = torch.from_numpy(scene.render_erp(scene.make_video(seed=9), 1,
                                              height=96, width=192))
    for ct, cp in ((0.4, -0.3), (-2.9, 0.0), (1.7, 1.2)):
        got = gno_ops.project_srois_batched(frame[None], [0], [[ct, cp]],
                                            [fov], (48, 48))[0]
        c, f = np.float32([ct, cp]).tolist(), np.float32(fov).tolist()
        want = geometry.crop(frame, c[0], c[1], (f[0], f[1]), 48)
        assert float((got.double() - want).abs().max()) < 1e-4
