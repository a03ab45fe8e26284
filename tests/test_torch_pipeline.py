"""The port's OmniSense loop against the reference's, end to end.

* Oracle loop (``examples/quickstart.py``): NumPy throughout, so every
  frame's SRoIs, plan and detections, and the Sph-mAP, are identical.
* Real pixels: ``TorchDetectorBackend`` (on the CPU, the plain versions
  of its kernels) against ``JaxDetectorBackend`` with the same converted
  weights, on 192x384 frames, through the per-request path and the
  batched tick (``launch_srois_batched``, deferred NMS over the tick).
  The two loops run in lockstep: both plan each frame (their SRoIs and
  plans are identical), both backends serve the same requests, and both
  loops then ingest the port's detections, so their histories stay
  equal.  A free-running pair would drift: a 1e-5 rad shift of an SRoI
  moves its PI by a thousandth of a pixel, which the random-weight
  detector amplifies.  Per request, detection counts and categories are
  equal; scores agree within 1e-4 and SphBBs within 1e-4 plus 1e-3 of
  their size: the detectors sum their convolutions in another order, so
  their heads agree to about 1e-4 (``test_torch_detector.py``), and a
  box's extent is ``exp(head) * stride`` pixels, which scales that error
  with the box.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest

from repro.core import omnisense as j_omni
from repro.core import sphere as j_sphere
from repro.data import synthetic as j_syn
from repro.models import detector as j_det
from repro.serving import evaluation as j_eval
from repro.serving import network as j_net
from repro.serving import profiles as j_prof
from repro.serving import scheduler as j_sched
from repro_torch.core import omnisense as t_omni
from repro_torch.core import sphere as t_sphere
from repro_torch.data import synthetic as t_syn
from repro_torch.models import detector as t_det
from repro_torch.serving import evaluation as t_eval
from repro_torch.serving import network as t_net
from repro_torch.serving import profiles as t_prof
from repro_torch.serving import scheduler as t_sched

J = dict(omni=j_omni, syn=j_syn, eval=j_eval, net=j_net, prof=j_prof,
         sched=j_sched, sphere=j_sphere)
T = dict(omni=t_omni, syn=t_syn, eval=t_eval, net=t_net, prof=t_prof,
         sched=t_sched, sphere=t_sphere)


def _oracle_run(m, n_frames=13):
    video = m["syn"].make_video(n_frames=n_frames + 4, n_objects=50, seed=3)
    variants = m["prof"].make_ladder()
    lat = m["sched"].OmniSenseLatencyModel(m["prof"].paper_profile(),
                                           m["net"].NetworkModel())
    backend = m["sched"].OracleBackend(video)
    costs = [lat._pre(v) + lat._inf(v) for v in variants]
    loop = m["omni"].OmniSenseLoop(variants, lat, backend, budget_s=2.0,
                                   explore_costs=costs)
    frames, preds, gts = [], [], []
    for f in range(n_frames):
        backend.set_frame(f)
        res = loop.process_frame(None)
        frames.append(res)
        preds.extend((f, d) for d in res.detections)
        gts.extend((f, d) for d in video.visible_objects(f))
    return frames, m["eval"].sph_map(preds, gts)


def test_oracle_loop_matches_reference():
    t_frames, t_map = _oracle_run(T)
    j_frames, j_map = _oracle_run(J)
    assert t_map == j_map
    assert any(r.discovered for r in t_frames)
    for t, j in zip(t_frames, j_frames):
        assert [(s.center, s.fov) for s in t.srois] == \
            [(s.center, s.fov) for s in j.srois]
        assert (t.plan.models if t.plan else None) == \
            (j.plan.models if j.plan else None)
        assert t.planned_latency == j.planned_latency
        assert t.discovered == j.discovered
        assert len(t.detections) == len(j.detections)
        for a, b in zip(t.detections, j.detections):
            assert (a.category, a.score) == (b.category, b.score)
            np.testing.assert_array_equal(a.box, b.box)


# -- real pixels ---------------------------------------------------------------


def _cfgs(det_mod):
    # the first two rungs at one small shape (so the reference compiles
    # each program once), 16 classes as in examples/real_detector_pipeline
    return [dataclasses.replace(det_mod.PAPER_LADDER[i], input_size=64,
                                n_classes=16, width_mult=0.25,
                                depth_mult=0.34) for i in (0, 1)]


def make_weights():
    """The reference's random weights and the port's conversion of them."""
    jparams = [j_det.init_params(jax.random.PRNGKey(i), c)
               for i, c in enumerate(_cfgs(j_det))]
    tparams = [t_det.from_jax_params(jax.tree_util.tree_map(np.asarray, p))
               for p in jparams]
    return jparams, tparams


@pytest.fixture(scope="module")
def weights():
    return make_weights()


def _videos():
    return [t_syn.make_video(n_frames=8, n_objects=20, seed=s) for s in (7, 8)]


def _loops(m, backend, videos):
    variants = m["prof"].make_ladder(n_categories=16)[:2]
    lat = m["sched"].OmniSenseLatencyModel(m["prof"].paper_profile(),
                                           m["net"].NetworkModel())
    loops = []
    for video in videos:
        loop = m["omni"].OmniSenseLoop(variants, lat, backend, budget_s=2.0,
                                       n_categories=16,
                                       explore_costs=[0.1, 0.2])
        # bootstrap the history with frame 0's objects (a full-ERP pass)
        loop.seed_history([m["syn"].Detection(box=d.box, category=d.category,
                                              score=d.score)
                           for d in video.visible_objects(0)])
        loops.append(loop)
    return variants, loops


def _backends(weights, **kw):
    jparams, tparams = weights
    jb = j_sched.JaxDetectorBackend(_cfgs(j_det), jparams, conf=0.01,
                                    max_det=4, **kw)
    tb = t_sched.TorchDetectorBackend(_cfgs(t_det), tparams, conf=0.01,
                                      max_det=4, device="cpu", **kw)
    return jb, tb


def _same_plan(t, j):
    assert [(r.center, r.fov) for r in t.srois] == \
        [(r.center, r.fov) for r in j.srois]
    assert (t.plan.models if t.plan else None) == \
        (j.plan.models if j.plan else None)
    assert [(r.region.center, r.variant.name, r.slot) for r in t.requests] \
        == [(r.region.center, r.variant.name, r.slot) for r in j.requests]


def _close_dets(t_dets, j_dets):
    assert [d.category for d in t_dets] == [d.category for d in j_dets]
    if t_dets:
        np.testing.assert_allclose(np.stack([d.box for d in t_dets]),
                                   np.stack([d.box for d in j_dets]),
                                   atol=1e-4, rtol=1e-3)
        np.testing.assert_allclose([d.score for d in t_dets],
                                   [d.score for d in j_dets], atol=1e-4)


def _as_ref(dets):
    return [j_syn.Detection(box=d.box, category=d.category, score=d.score)
            for d in dets]


def serve_per_request(t_loop, j_loop, tb, jb, frame) -> int:
    """One frame through the per-request path of both loops in lockstep;
    returns the port's detection count after NMS."""
    t_pend, j_pend = t_loop.begin_frame(frame), j_loop.begin_frame(frame)
    _same_plan(t_pend, j_pend)
    t_dets = [tb.infer_sroi(frame, r.region, r.variant)
              for r in t_pend.requests]
    for t, r in zip(t_dets, t_pend.requests):
        _close_dets(t, jb.infer_sroi(frame, r.region, r.variant))
    t_res = t_loop.finish_frame(t_pend, t_dets)
    j_res = j_loop.finish_frame(j_pend, [_as_ref(d) for d in t_dets])
    assert [d.score for d in t_res.detections] == \
        [d.score for d in j_res.detections]
    return len(t_res.detections)


def test_real_pixels_per_request_matches_reference(weights):
    jb, tb = _backends(weights)
    videos = _videos()[:1]
    _, (t_loop,) = _loops(T, tb, videos)
    _, (j_loop,) = _loops(J, jb, videos)
    n_dets = 0
    for f in range(3):
        frame = t_syn.render_erp(videos[0], f, height=192, width=384)
        n_dets += serve_per_request(t_loop, j_loop, tb, jb, frame)
    assert n_dets > 0


def test_infer_erp_matches_reference(weights):
    """The ERP baseline: the whole frame resized to the model's input."""
    jb, tb = _backends(weights)
    video = _videos()[0]
    frame = t_syn.render_erp(video, 1, height=192, width=384)
    for t_var, j_var in zip(t_prof.make_ladder(n_categories=16)[:2],
                            j_prof.make_ladder(n_categories=16)[:2]):
        t_dets = tb.infer_erp(frame, t_var)
        _close_dets(t_dets, jb.infer_erp(frame, j_var))
        assert all(np.isfinite(d.box).all() for d in t_dets)


def _tick(t_loops, j_loops, t_vars, tb, jb, frames):
    """One batched tick in lockstep: emission per stream, one launch per
    variant on each backend, deferred NMS over the padded tick."""
    t_pend = [lp.begin_frame(fr) for lp, fr in zip(t_loops, frames)]
    j_pend = [lp.begin_frame(fr) for lp, fr in zip(j_loops, frames)]
    for t, j in zip(t_pend, j_pend):
        _same_plan(t, j)
    dets = [[None] * len(p.requests) for p in t_pend]
    for v in t_vars:
        slots = [(s, req) for s, p in enumerate(t_pend)
                 for req in p.requests if req.variant.name == v.name]
        if not slots:
            continue
        items = [(req.frame, req.region) for _, req in slots]
        resolve = tb.launch_srois_batched(items, v)
        j_out = jb.launch_srois_batched(items, j_prof.make_ladder(
            n_categories=16)[v.index - 1])()
        for (s, req), t, j in zip(slots, resolve(), j_out):
            _close_dets(t, j)
            dets[s][req.slot] = t
    t_res = [lp.finish_frame(p, d, defer_nms=True)
             for lp, p, d in zip(t_loops, t_pend, dets)]
    j_res = [lp.finish_frame(p, [_as_ref(x) for x in d], defer_nms=True)
             for lp, p, d in zip(j_loops, j_pend, dets)]
    boxes, scores, mask = t_sphere.pad_detection_rows(
        [r.detections for r in t_res])
    keep = t_sphere.sph_nms_batch(boxes, scores, mask, backend="torch",
                                  device="cpu")
    np.testing.assert_array_equal(
        keep, j_sphere.sph_nms_batch(boxes, scores, mask, backend="jit"))
    for r, (t, j) in enumerate(zip(t_res, j_res)):
        k = keep[r, :len(t.detections)] if t.detections else None
        t_loops[r].finalize_detections(t, k)
        j_loops[r].finalize_detections(j, k)
    return t_res


def test_real_pixels_batched_tick_matches_reference(weights):
    jb, tb = _backends(weights)
    videos = _videos()
    t_vars, t_loops = _loops(T, tb, videos)
    _, j_loops = _loops(J, jb, videos)
    n_dets = 0
    for f in range(3):
        frames = [t_syn.render_erp(v, f, height=192, width=384)
                  for v in videos]
        n_dets += sum(len(r.detections)
                      for r in _tick(t_loops, j_loops, t_vars, tb, jb, frames))
    assert n_dets > 0
    assert tb.trace_count == len(tb._shapes) > 0
    assert tb.crop_cache_misses > 0
