"""``TorchDetectorBackend``'s other serving paths against the reference's
``JaxDetectorBackend``, with the same converted weights on 192x384
frames (the helpers and tolerances of ``test_torch_pipeline.py``):

* frames that are not kept alive between calls, or one buffer refilled
  in place every frame, where consecutive frames agree on a sparse grid
  of pixels: each request is served from the pixels it was given, as the
  reference's (which uploads the frame on every call) is;
* the staged tick (``fused=False``: one projection per crop);
* the crop cache: regions that drift by less than the pixel pitch reuse
  the anchor's PI and geometry, exactly as the reference's cache does.
"""

from __future__ import annotations

import numpy as np
import pytest

from repro.serving import profiles as j_prof
from repro_torch.core import sroi as t_sroi
from repro_torch.data import synthetic as t_syn
from repro_torch.serving import profiles as t_prof
from test_torch_pipeline import (J, T, _backends, _close_dets, _loops, _tick,
                                 _videos, make_weights, serve_per_request)


@pytest.fixture(scope="module")
def weights():
    return make_weights()


def _render(video, f, grid):
    """Frame ``f`` at 192x384 with every 8th row and column taken from
    ``grid`` (when given): frames that agree on a sparse grid of pixels,
    so a content check that samples a few pixels cannot tell them apart.
    Returns the frame and its grid."""
    img = t_syn.render_erp(video, f, height=192, width=384)
    if grid is not None:
        img[::8, ::8] = grid
    return img, img[::8, ::8].copy()


@pytest.mark.parametrize("frames", ["dropped", "refilled"])
def test_per_request_serves_each_frame_from_its_own_pixels(weights, frames):
    jb, tb = _backends(weights)
    video = _videos()[0]
    _, (t_loop,) = _loops(T, tb, [video])
    _, (j_loop,) = _loops(J, jb, [video])
    # float64, so that the backend's float32 copy of the buffer is a copy
    # on the CPU too, as it is on a card
    buf = np.zeros((192, 384, 3), np.float64)
    grid = None
    n_dets = 0
    for f in (1, 2):
        if frames == "dropped":
            # nothing holds the frame once the call returns, so the next
            # frame's array may take its place in memory
            img, grid = _render(video, f, grid)
            n_dets += serve_per_request(t_loop, j_loop, tb, jb, img)
            del img
        else:
            buf[...], grid = _render(video, f, grid)
            n_dets += serve_per_request(t_loop, j_loop, tb, jb, buf)
    assert n_dets > 0


def test_staged_tick_matches_reference(weights):
    jb, tb = _backends(weights, fused=False)
    videos = _videos()
    t_vars, t_loops = _loops(T, tb, videos)
    _, j_loops = _loops(J, jb, videos)
    n_dets = 0
    for f in range(2):
        frames = [t_syn.render_erp(v, f, height=192, width=384)
                  for v in videos]
        n_dets += sum(len(r.detections)
                      for r in _tick(t_loops, j_loops, t_vars, tb, jb, frames))
    assert n_dets > 0
    assert tb.crop_cache_hits == tb.crop_cache_misses == 0


def test_crop_cache_hits_match_reference(weights):
    jb, tb = _backends(weights)
    video = _videos()[0]
    frame = t_syn.render_erp(video, 2, height=192, width=384)
    t_var = t_prof.make_ladder(n_categories=16)[1]
    j_var = j_prof.make_ladder(n_categories=16)[1]
    size = tb.buckets.bucket_resolution(tb.cfgs[t_var.index - 1].input_size)
    fov = (1.2, 0.9)
    px, py = fov[0] / size, fov[1] / size  # radians per PI pixel
    anchors = [t_sroi.SRoI(center=(float(d.box[0]), float(d.box[1])), fov=fov)
               for d in video.visible_objects(2)[:4]]
    # less than a pixel from each anchor, on the same side of the pitch
    # grid (so the same cache key); one a pitch away from its anchor
    drifted = [t_sroi.SRoI(center=((round(r.center[0] / px) + 0.3) * px,
                                   (round(r.center[1] / py) - 0.3) * py),
                           fov=fov) for r in anchors]
    far = t_sroi.SRoI(center=(anchors[0].center[0] + 1.5 * px,
                              anchors[0].center[1]), fov=fov)
    for a, d in zip(anchors, drifted):
        assert tb._crop_key(frame, d, size) == tb._crop_key(frame, a, size)

    first = [(frame, r) for r in anchors]
    t0 = tb.infer_srois_batched(first, t_var)
    for t, j in zip(t0, jb.infer_srois_batched(first, j_var)):
        _close_dets(t, j)
    # the drifted regions hit; the far region and a copy of the frame
    # (the same pixels in another array) miss
    second = [(frame, r) for r in drifted] + [(frame, far),
                                              (frame.copy(), anchors[0])]
    t1 = tb.infer_srois_batched(second, t_var)
    for t, j in zip(t1, jb.infer_srois_batched(second, j_var)):
        _close_dets(t, j)
    assert tb.crop_cache_hits == jb.crop_cache_hits == len(anchors)
    assert tb.crop_cache_misses == jb.crop_cache_misses == len(anchors) + 2
    # a hit is the anchor's PI lifted through the anchor's geometry
    assert sum(len(d) for d in t0) > 0
    for hit, anchor in zip(t1, t0):
        assert [d.category for d in hit] == [d.category for d in anchor]
        for a, b in zip(hit, anchor):
            np.testing.assert_array_equal(a.box, b.box)
            assert a.score == b.score
