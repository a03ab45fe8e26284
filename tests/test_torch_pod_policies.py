"""The port's real-backend ``PodServer`` under its ``deadline`` and
``async`` policies, and an open-loop ``FleetServer`` of real-backend
pods, against the reference's.

The inputs and set-up are ``test_torch_pod_tick.py``'s: the smoke
detectors at 64 px with the converted weights of
``test_torch_pipeline.py``, 64x128 noise frames, the port's
``TorchDetectorBackend`` on the CPU (the kernels' plain versions)
against the reference's ``JaxDetectorBackend(use_kernel=False)``.

* ``deadline`` (3 ticks) and ``async`` (4 ticks, then ``flush``; both
  sides carry requests): each frame's detections within 1e-4 of the
  reference's, equal schedules (dispatches, batch sizes, carried
  requests), and nothing left queued, staged or in flight after
  ``flush``.
* A fleet of 2 pods (affinity routing, SLO admission at 2.0 s, the serve
  launcher's arrivals, 0.5 fps, jitter 0.2, seed 0, over the horizon of
  4 frames a stream): each frame's detections within 1e-4, equal routes
  and admissions.
* The port alone: a carried request's crop, projected a tick after its
  frame's own tick (when that frame is no longer staged), equals a fresh
  projection from its own frame; the next frame of its stream gives
  another crop.
"""

from __future__ import annotations

import numpy as np
import pytest

from repro.serving import fleet as j_fleet
from repro.serving import runtime as j_rt
from repro.serving import traffic as j_traffic
from repro_torch.serving import fleet as t_fleet
from repro_torch.serving import runtime as t_rt
from repro_torch.serving import traffic as t_traffic
from test_torch_pod_tick import (J, N_STREAMS, T, _backend, _close, _loops,
                                 make_weights)

J = dict(J, rt=j_rt, fleet=j_fleet, traffic=j_traffic)
T = dict(T, rt=t_rt, fleet=t_fleet, traffic=t_traffic)
N_FRAMES = 5  # the pods' 4 ticks and the control's next frame


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads for the module's tests, restored after: under
    pytest-xdist several test processes share the machine's cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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


def _record_frames(loops) -> list[list]:
    """Each stream's finished frames' detections, in finishing order
    (``finalize_detections`` is called once a frame)."""
    out = [[] for _ in loops]
    for s, loop in enumerate(loops):
        inner = loop.finalize_detections

        def finalize(res, keep, inner=inner, rec=out[s]):
            inner(res, keep)
            rec.append(list(res.detections))

        loop.finalize_detections = finalize
    return out


def _pod(m, weights, seeds, frames, policy):
    backend = _backend(m, weights)
    loops = _loops(m, backend, seeds)
    done = _record_frames(loops)
    pod = m["server"].PodServer(
        loops, [backend] * N_STREAMS, max_batch=8, policy=policy,
        frame_source=lambda s, f: frames[(s, f)])
    return pod, backend, done


def _same_frames(t_done, j_done) -> int:
    n = 0
    assert [len(r) for r in t_done] == [len(r) for r in j_done]
    for t_rows, j_rows in zip(t_done, j_done):
        for got, want in zip(t_rows, j_rows):
            _close(got, want)
            n += len(got)
    return n


def _same_schedule(t_stats, j_stats):
    assert t_stats.frames == j_stats.frames
    assert t_stats.dispatches == j_stats.dispatches
    assert t_stats.batch_sizes == j_stats.batch_sizes
    assert t_stats.carried_requests == j_stats.carried_requests


@pytest.mark.parametrize("policy,ticks", [("deadline", 3), ("async", 4)])
def test_policy_pod_matches_reference(weights, inputs, policy, ticks):
    frames, seeds = inputs
    t_pod, t_backend, t_done = _pod(T, weights, seeds, frames, policy)
    j_pod, _, j_done = _pod(J, weights, seeds, frames, policy)
    for f in range(ticks):
        t_pod.step(f)
        j_pod.step(f)
    t_pod.flush()
    j_pod.flush()
    assert t_pod.stats.frames == N_STREAMS * ticks
    _same_schedule(t_pod.stats, j_pod.stats)
    if policy == "async":
        assert t_pod.stats.carried_requests > 0
    assert _same_frames(t_done, j_done) > 0
    assert not len(t_pod.queues) and not t_pod._inflight
    assert not t_backend._staged


def test_open_loop_fleet_matches_reference(weights, inputs):
    _, seeds = inputs
    # the arrivals' jitter may give a stream more frames than the horizon
    # holds at 0.5 fps: each is drawn when first asked for, from its seed
    frames: dict = {}

    def source(s, f):
        if (s, f) not in frames:
            frames[(s, f)] = np.random.default_rng((5, s, f)).random(
                (64, 128, 3)).astype(np.float32)
        return frames[(s, f)]

    runs = []
    for m in (T, J):
        backend = _backend(m, weights)
        loops = _loops(m, backend, seeds)
        done = _record_frames(loops)

        def make_pod(pid, m=m, loops=loops, backend=backend):
            return m["server"].PodServer(
                loops, [backend] * N_STREAMS, max_batch=8,
                policy=m["rt"].make_policy("sync", admission="slo"),
                frame_source=source)

        fleet = m["fleet"].FleetServer(make_pod, 2, routing="affinity")
        traffic = m["traffic"].ArrivalProcess(
            N_STREAMS, fps=0.5, jitter=0.2, seed=0, horizon_s=4 / 0.5)
        stats = fleet.run_open_loop(traffic, slo_s=2.0)
        runs.append((stats, done, fleet))
    (t_stats, t_done, t_fleet_), (j_stats, j_done, j_fleet_) = runs
    assert dict(t_fleet_.assignment) == dict(j_fleet_.assignment)
    assert (t_stats.routes, t_stats.migrations) == (j_stats.routes,
                                                    j_stats.migrations)
    assert len(t_stats.pod_stats) == len(j_stats.pod_stats) == 2
    for t_s, j_s in zip(t_stats.pod_stats, j_stats.pod_stats):
        assert (t_s.arrivals, t_s.admitted, t_s.degraded, t_s.rejected,
                t_s.missed) == (j_s.arrivals, j_s.admitted, j_s.degraded,
                                j_s.rejected, j_s.missed)
        _same_schedule(t_s, j_s)
    assert sum(s.frames for s in t_stats.pod_stats) > 0
    assert _same_frames(t_done, j_done) > 0


def test_carried_crop_is_cut_from_its_own_frame(weights, inputs):
    import torch

    from repro_torch.kernels.gnomonic.ops import project_srois_batched

    frames, seeds = inputs
    where = {id(img): key for key, img in frames.items()}
    pod, backend, _ = _pod(T, weights, seeds, frames, "async")
    crops = []  # (frame, geometry, size, crop) of each projected crop
    project = backend._project_chunk

    def recording(chunk, size):
        pis, geoms = project(chunk, size)
        crops.extend((f, g, size, pi) for (f, _), g, pi in
                     zip(chunk, geoms, pis))
        return pis, geoms

    backend._project_chunk = recording
    carried = []  # the crops of requests drained a tick after emission
    execute = pod._execute

    def watching(ops, timeline, close):
        aged = [it.request for name in pod.queues.counts()
                for it in pod.queues.peek(name) if it.age > 0]
        n = len(crops)
        execute(ops, timeline, close)
        for req in aged:
            carried.extend(c for c in crops[n:] if c[0] is req.frame)

    pod._execute = watching
    for f in range(4):
        pod.step(f)
    pod.flush()
    assert carried and pod.stats.carried_requests > 0
    for frame, (ct, cp, fov), size, pi in carried:
        s, f = where[id(frame)]
        assert frame is frames[(s, f)] and f < 4

        def fresh(img):
            return project_srois_batched(torch.from_numpy(img)[None], [0],
                                         [(ct, cp)], [fov], (size, size))[0]

        torch.testing.assert_close(pi, fresh(frame), rtol=0, atol=1e-6)
        assert float((pi - fresh(frames[(s, f + 1)])).abs().max()) > 0.1
