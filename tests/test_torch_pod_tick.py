"""The port's ``PodServer`` tick on the real detector, and the tick's
frame staging (``TorchDetectorBackend.stage_frames``).

* The pod tick of ``tests/test_serving_batch.py``'s
  ``test_pod_tick_on_real_detector_matches_inline`` (3 streams, 2
  frames of 64x128 noise, 64 px inputs), with the converted weights of
  ``test_torch_pipeline.py``: the port's ``PodServer`` over
  ``TorchDetectorBackend`` (on the CPU, the kernels' plain versions)
  against the reference's ``PodServer`` over
  ``JaxDetectorBackend(use_kernel=False)``, and against the port's own
  per-stream inline loop.  Equal counts and categories; boxes within
  atol/rtol 1e-4 (the detectors sum their convolutions in another
  order, ``test_torch_detector.py``).
* Staging: a tick whose frames were staged gives the same detections,
  bit for bit, as one whose chunks upload their frames; each distinct
  frame uploads once a tick; a buffer refilled in place between ticks
  is served from its new pixels; no device frame outlives its tick.
"""

from __future__ import annotations

import gc
import weakref

import numpy as np
import pytest

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
from repro_torch.serving import profiles as t_prof
from repro_torch.serving import scheduler as t_sched
from repro_torch.serving import server as t_server
from test_torch_pipeline import _cfgs, make_weights

J = dict(omni=j_omni, sroi=j_sroi, batch=j_batch, net=j_net, prof=j_prof,
         sched=j_sched, server=j_server)
T = dict(omni=t_omni, sroi=t_sroi, batch=t_batch, net=t_net, prof=t_prof,
         sched=t_sched, server=t_server)
N_STREAMS, N_FRAMES = 3, 2


@pytest.fixture(scope="module")
def weights():
    return make_weights()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(5)
    frames = {(s, f): rng.random((64, 128, 3)).astype(np.float32)
              for s in range(N_STREAMS) for f in range(N_FRAMES)}
    seeds = [[(np.array([rng.uniform(-2, 2), rng.uniform(-0.8, 0.8),
                         0.5, 0.5]), int(rng.integers(16)))
              for _ in range(2)] for _ in range(N_STREAMS)]
    return frames, seeds


def _backend(m, weights, **kw):
    jparams, tparams = weights
    buckets = m["batch"].ShapeBuckets((1, 2, 4, 8), resolutions=(64,))
    if m is J:
        return j_sched.JaxDetectorBackend(_cfgs(j_det), jparams, conf=0.01,
                                          use_kernel=False, max_det=4,
                                          buckets=buckets, **kw)
    return t_sched.TorchDetectorBackend(_cfgs(t_det), tparams, conf=0.01,
                                        max_det=4, buckets=buckets,
                                        device="cpu", **kw)


def _loops(m, backend, seeds):
    variants = m["prof"].make_ladder(n_categories=16, seed=0)[:2]
    lat = m["sched"].OmniSenseLatencyModel(m["prof"].paper_profile(),
                                           m["net"].NetworkModel())
    loops = []
    for s in range(N_STREAMS):
        loop = m["omni"].OmniSenseLoop(variants, lat, backend, budget_s=4.0,
                                       n_categories=16, explore_every=0)
        loop.seed_history([m["sroi"].Detection(box=box.copy(), category=c,
                                               score=0.9)
                           for box, c in seeds[s]])
        loops.append(loop)
    return loops


def _pod(m, backend, seeds, frame_source):
    loops = _loops(m, backend, seeds)
    return m["server"].PodServer(loops, [backend] * N_STREAMS, max_batch=8,
                                 frame_source=frame_source)


def _close(got, want):
    assert len(got) == len(want)
    assert [d.category for d in got] == [d.category for d in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.box, b.box, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(a.score, b.score, rtol=1e-4, atol=1e-4)


def _exact(got, want):
    assert [(d.category, d.score) for d in got] == \
        [(d.category, d.score) for d in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.box, b.box)


def test_pod_tick_matches_reference_and_inline(weights, inputs):
    frames, seeds = inputs
    source = lambda s, f: frames[(s, f)]  # noqa: E731
    t_pod = _pod(T, _backend(T, weights), seeds, source)
    j_pod = _pod(J, _backend(J, weights), seeds, source)
    inline = _loops(T, _backend(T, weights), seeds)
    saw = 0
    for f in range(N_FRAMES):
        expect = [loop.process_frame(frames[(s, f)]).detections
                  for s, loop in enumerate(inline)]
        t_pod.step(f)
        j_pod.step(f)
        for s in range(N_STREAMS):
            got = t_pod.loops[s]._history[-1]
            _close(got, j_pod.loops[s]._history[-1])
            _close(got, expect[s])
            saw += len(got)
    assert saw > 0  # the detector must actually emit detections
    assert t_pod.stats.frames == j_pod.stats.frames == N_STREAMS * N_FRAMES
    assert t_pod.stats.dispatches == j_pod.stats.dispatches
    assert t_pod.stats.batch_sizes == j_pod.stats.batch_sizes


class _Unstaged:
    """A backend without the staging hooks: every chunk uploads its
    frames, as before staging (``PodServer`` calls a hook only where
    the backend has one)."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        if name in ("stage_frames", "release_frames"):
            raise AttributeError(name)
        return getattr(self._inner, name)


def _histories(pod):
    return [list(loop._history[-1]) for loop in pod.loops]


def test_staged_tick_equals_unstaged(weights, inputs):
    frames, seeds = inputs
    source = lambda s, f: frames[(s, f)]  # noqa: E731
    staged_b = _backend(T, weights)
    plain_b = _backend(T, weights)
    staged = _pod(T, staged_b, seeds, source)
    plain = _pod(T, _Unstaged(plain_b), seeds, source)
    for f in range(N_FRAMES):
        staged.step(f)
        plain.step(f)
        for got, want in zip(_histories(staged), _histories(plain)):
            _exact(got, want)
        # each stream's frame went up once this tick
        assert staged_b.frame_uploads == N_STREAMS * (f + 1)
        assert not staged_b._staged
    # unstaged, each variant chunk uploads its distinct frames again
    assert plain_b.frame_uploads >= staged_b.frame_uploads
    assert staged_b.crop_cache_misses == plain_b.crop_cache_misses > 0


def test_refilled_buffer_is_served_from_its_new_pixels(weights, inputs):
    frames, seeds = inputs
    bufs = [np.zeros((64, 128, 3), np.float32) for _ in range(N_STREAMS)]

    def refilled(s, f):
        bufs[s][...] = frames[(s, f)]
        return bufs[s]

    pod = _pod(T, _backend(T, weights), seeds, refilled)
    fresh = _pod(T, _backend(T, weights), seeds,
                 lambda s, f: frames[(s, f)].copy())
    for f in range(N_FRAMES):
        pod.step(f)
        fresh.step(f)
        for got, want in zip(_histories(pod), _histories(fresh)):
            _exact(got, want)


def test_no_device_frame_outlives_its_tick(weights, inputs):
    frames, seeds = inputs
    backend = _backend(T, weights)
    stacks = []
    stage = backend.stage_frames

    def watch(fs):
        stage(fs)
        stacks.extend(weakref.ref(ent[1]) for ent in backend._staged.values())

    backend.stage_frames = watch
    pod = _pod(T, backend, seeds, lambda s, f: frames[(s, f)])
    pod.step(0)
    assert stacks and not backend._staged
    gc.collect()
    assert all(ref() is None for ref in stacks)


def test_stage_frames_uploads_each_distinct_frame_once(weights):
    import torch

    backend = _backend(T, weights)
    rng = np.random.default_rng(0)
    a, b = (rng.random((8, 16, 3)).astype(np.float32) for _ in range(2))
    c = rng.random((4, 8, 3))  # another shape, float64
    backend.stage_frames([a, b, a, None, c])
    assert backend.frame_uploads == 3
    stack, idx = backend._chunk_frames([b, a, b])
    assert stack.shape == (2, 8, 16, 3) and idx == [1, 0, 1]
    assert torch.equal(stack[1], torch.from_numpy(b))
    assert backend.frame_uploads == 3  # read from the stage
    # a frame equal to a staged one but not it is uploaded with its chunk
    stack, idx = backend._chunk_frames([a.copy(), a])
    assert stack.shape == (2, 8, 16, 3) and idx == [0, 1]
    assert backend.frame_uploads == 5
    # a frame of another shape is staged in a stack of its own
    stack, idx = backend._chunk_frames([c])
    assert stack.dtype == torch.float32 and idx == [0]
    assert torch.equal(stack[0], torch.from_numpy(c.astype(np.float32)))
    assert backend.frame_uploads == 5
    backend.release_frames()
    assert not backend._staged
    backend._chunk_frames([a])
    assert backend.frame_uploads == 6
