"""Twins of ``tests/test_placement.py::TestShardedJaxBackend``, which
skip on a one-device host; these run on the CPU.

The group's devices are 8 distinct ``torch.device("cpu", i)``
identities, so ``VariantPlacement`` partitions them into multi-device
replica groups and ``TorchDetectorBackend`` runs the replica forward:
one parameter copy a (variant, device), the padded batch split into equal
row slices in device order, each launched before any is read.  The
detector is the first two ``PAPER_LADDER`` rungs at 64 px with the
converted weights of ``test_torch_pipeline.py`` (width 0.25, 16 classes:
the reference test's rungs, cut in width for the CPU).  Detections are
held to the reference's unsharded ``JaxDetectorBackend`` (``use_kernel=
False``) within the reference's tolerances (boxes rtol/atol 1e-4, scores
rtol 1e-4, atol 1e-5), and the placed ``PodServer`` to the unplaced one,
detection for detection.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from repro.core import omnisense as j_omni
from repro.core import sroi as j_sroi
from repro.models import detector as j_det
from repro.serving import batching as j_batch
from repro.serving import network as j_net
from repro.serving import profiles as j_prof
from repro.serving import scheduler as j_sched
from repro.serving import server as j_server
from repro_torch.core import omnisense as t_omni
from repro_torch.core import sroi as t_sroi
from repro_torch.models import detector as t_det
from repro_torch.serving import batching as t_batch
from repro_torch.serving import network as t_net
from repro_torch.serving import placement as t_place
from repro_torch.serving import profiles as t_prof
from repro_torch.serving import scheduler as t_sched
from repro_torch.serving import server as t_server
from test_torch_pipeline import _cfgs, make_weights

J = dict(omni=j_omni, sroi=j_sroi, batch=j_batch, net=j_net, prof=j_prof,
         sched=j_sched, server=j_server, det=j_det)
T = dict(omni=t_omni, sroi=t_sroi, batch=t_batch, net=t_net, prof=t_prof,
         sched=t_sched, server=t_server, det=t_det)
DEVICES = [torch.device("cpu", i) for i in range(8)]


@pytest.fixture(scope="module")
def weights():
    return make_weights()


def _backend(m, weights):
    jparams, tparams = weights
    buckets = m["batch"].ShapeBuckets((1, 2, 4, 8), resolutions=(64,))
    if m is J:
        return j_sched.JaxDetectorBackend(_cfgs(j_det), jparams, conf=0.01,
                                          use_kernel=False, max_det=4,
                                          buckets=buckets)
    return t_sched.TorchDetectorBackend(_cfgs(t_det), tparams, conf=0.01,
                                        max_det=4, buckets=buckets,
                                        device="cpu")


@pytest.fixture(scope="module")
def sharded_setup(weights):
    variants = t_prof.make_ladder(n_categories=16, seed=0)[:2]
    placement = t_place.VariantPlacement(variants, devices=DEVICES)
    return _backend(T, weights), variants, placement


def _regions(rng, n):
    fov = (math.radians(60), math.radians(60))
    return [t_sroi.SRoI(center=(float(rng.uniform(-2.5, 2.5)),
                                float(rng.uniform(-0.9, 0.9))), fov=fov)
            for _ in range(n)]


def _close(got, want, score_atol=1e-5):
    assert len(got) == len(want)
    assert [d.category for d in got] == [d.category for d in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.box, b.box, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(a.score, b.score, rtol=1e-4,
                                   atol=score_atol)


def _reference_dets(weights, items, variant_index):
    """The reference's unsharded batched forward of the same crops."""
    backend = _backend(J, weights)
    v = j_prof.make_ladder(n_categories=16, seed=0)[variant_index]
    return backend.infer_srois_batched(
        [(f, j_sroi.SRoI(center=r.center, fov=r.fov)) for f, r in items], v)


def test_sharded_forward_matches_unsharded(sharded_setup, weights):
    backend, variants, placement = sharded_setup
    rng = np.random.default_rng(0)
    frame = rng.random((64, 128, 3)).astype(np.float32)
    items = [(frame, r) for r in _regions(rng, 7)]
    for i, v in enumerate(variants):
        group = placement.group_for(v.name)
        assert group.n_devices > 1  # the point of the lane
        plain = backend.infer_srois_batched(items, v)
        sharded = backend.infer_srois_batched(items, v, group=group)
        ref = _reference_dets(weights, items, i)
        assert len(plain) == len(sharded) == len(ref)
        assert sum(len(d) for d in plain) > 0
        for dets_a, dets_b, dets_r in zip(plain, sharded, ref):
            _close(dets_b, dets_a)
            _close(dets_b, dets_r)


def test_each_device_runs_an_equal_slice(sharded_setup, monkeypatch):
    """The padded batch rounds up to the group's width and each device
    runs one slice of it on its own parameter copy, in device order."""
    backend, variants, placement = sharded_setup
    v = variants[0]
    group = placement.group_for(v.name)
    seen = []
    apply = t_det.apply
    monkeypatch.setattr(t_det, "apply", lambda p, imgs, cfg: (
        seen.append((id(p), imgs.shape[0])), apply(p, imgs, cfg))[1])
    rng = np.random.default_rng(3)
    frame = rng.random((64, 128, 3)).astype(np.float32)
    backend.infer_srois_batched([(frame, r) for r in _regions(rng, 3)], v,
                                group=group)
    g = group.n_devices
    b_pad = group.shard_batch(backend.buckets.pad_batch(3))
    idx = v.index - 1
    assert [n for _, n in seen] == [b_pad // g] * g
    assert [pid for pid, _ in seen] == [
        id(backend._replicas[(idx, d)]) for d in group.devices]


def test_launch_overlaps_groups_then_resolves(sharded_setup):
    """The pod drain's two-phase form: every group's forward is
    launched before any result is resolved; results match the
    blocking entry point."""
    backend, variants, placement = sharded_setup
    rng = np.random.default_rng(1)
    frame = rng.random((64, 128, 3)).astype(np.float32)
    items = [(frame, r) for r in _regions(rng, 5)]
    resolvers = [(v, backend.launch_srois_batched(
        items, v, placement.group_for(v.name))) for v in variants]
    for v, resolve in resolvers:
        got = resolve()
        want = backend.infer_srois_batched(items, v)
        assert [len(d) for d in got] == [len(d) for d in want]
        for a, b in zip(got, want):
            _close(a, b)


def test_sharded_retraces_bounded_by_buckets(sharded_setup):
    backend, variants, placement = sharded_setup
    rng = np.random.default_rng(2)
    frame = rng.random((64, 128, 3)).astype(np.float32)
    v = variants[0]
    group = placement.group_for(v.name)
    start = backend.trace_count
    for count in (1, 2, 3, 5, 1, 4, 2):  # mixed-size "ticks"
        backend.infer_srois_batched(
            [(frame, r) for r in _regions(rng, count)], v, group=group)
    n_buckets = len(backend.buckets.batch_sizes)
    assert backend.trace_count - start <= n_buckets
    # sharded shapes key on (variant, padded batch, group devices) and
    # the padded batch always divides over its group
    assert any(len(key) == 3 for key in backend._shapes)
    for key in backend._shapes:
        assert len(key) in (2, 3)
        if len(key) == 3:
            assert key[1] % len(key[2]) == 0


def _build_pod(m, weights, placement, frames, seeds, n_streams):
    backend = _backend(m, weights)
    variants = m["prof"].make_ladder(n_categories=16, seed=0)[:2]
    lat = m["sched"].OmniSenseLatencyModel(m["prof"].paper_profile(),
                                           m["net"].NetworkModel())
    loops = []
    for s in range(n_streams):
        loop = m["omni"].OmniSenseLoop(variants, lat, backend, budget_s=4.0,
                                       n_categories=16, explore_every=0)
        loop.seed_history([m["sroi"].Detection(box=box.copy(), category=c,
                                               score=0.9)
                           for box, c in seeds[s]])
        loops.append(loop)
    if placement is not None:
        placement = placement(variants)
    return loops, m["server"].PodServer(
        loops, [backend] * n_streams, max_batch=8,
        frame_source=lambda s, f: frames[(s, f)], placement=placement)


def test_placed_pod_on_real_detector_matches_single_device(weights):
    """End-to-end: a placed PodServer on the real detector path (frames,
    replica groups of 8 CPU device identities) matches the unplaced pod
    detection for detection, and the reference's unplaced pod."""
    rng = np.random.default_rng(5)
    n_streams, n_frames = 4, 2
    frames = {(s, f): rng.random((64, 128, 3)).astype(np.float32)
              for s in range(n_streams) for f in range(n_frames)}
    seeds = [[(np.array([rng.uniform(-2, 2), rng.uniform(-0.8, 0.8),
                         0.5, 0.5]), int(rng.integers(16)))
              for _ in range(2)] for _ in range(n_streams)]
    loops_a, single = _build_pod(T, weights, None, frames, seeds, n_streams)
    loops_b, placed = _build_pod(
        T, weights, lambda vs: t_place.VariantPlacement(vs, devices=DEVICES),
        frames, seeds, n_streams)
    loops_r, ref = _build_pod(J, weights, None, frames, seeds, n_streams)
    assert all(g.n_devices > 1 for g in placed.placement.groups)
    saw = 0
    for f in range(n_frames):
        single.step(f)
        placed.step(f)
        ref.step(f)
        for la, lb, lr in zip(loops_a, loops_b, loops_r):
            da, db = la._history[-1], lb._history[-1]
            _close(db, da, score_atol=1e-4)
            _close(db, lr._history[-1], score_atol=1e-4)
            saw += len(da)
    assert saw > 0
    # tick accounting is device-aware (max over groups can only be <= the
    # dispatch sum)
    assert placed.stats.sum_tick_inf_s <= placed.stats.sum_batched_inf_s
    assert placed.stats.group_busy_s
