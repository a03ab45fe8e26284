"""``repro_torch.tracing``: the pod tick's span tree and counters on the
real detector (the CPU, the kernels' plain versions, a tiny ladder),
the recorder's arithmetic on a fake clock, its bound on kept ticks, the
launch counts it keeps for ``kernels/_build.py``, and its stamps laid
over a ``torch.profiler`` trace of the CPU."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.core import omnisense, sroi
from repro_torch.kernels import _build
from repro_torch.models import detector as det_mod
from repro_torch.serving import batching, network, profiles, scheduler
from repro_torch.serving.server import PodServer

N_STREAMS, N_TICKS = 3, 2
FRAME = (64, 128, 3)

# the tree of a pod tick: each span's parent
PARENT = {"tick": None, "stage": "tick", "stage.host_copy": "stage",
          "stage.pinned_wait": "stage", "emit": "tick",
          "emit.predict": "emit", "emit.allocate": "emit", "drain": "tick",
          "drain.launch": "drain", "drain.wait": "drain",
          "drain.lift": "drain", "ingest": "tick",
          "ingest.discovery": "ingest", "ingest.nms": "ingest"}


@pytest.fixture(autouse=True)
def fresh_recorder():
    tracing.reset()
    yield
    tracing.reset()


def _pod():
    cfgs = [dataclasses.replace(det_mod.PAPER_LADDER[i], input_size=64,
                                n_classes=16, width_mult=0.25,
                                depth_mult=0.34) for i in (0, 1)]
    params = [det_mod.init_params(torch.Generator().manual_seed(i), c)
              for i, c in enumerate(cfgs)]
    buckets = batching.ShapeBuckets((1, 2, 4, 8), resolutions=(64,))
    backend = scheduler.TorchDetectorBackend(cfgs, params, conf=0.01,
                                             max_det=4, buckets=buckets,
                                             device="cpu")
    variants = profiles.make_ladder(n_categories=16, seed=0)[:2]
    lat = scheduler.OmniSenseLatencyModel(profiles.paper_profile(),
                                          network.NetworkModel())
    rng = np.random.default_rng(5)
    loops = []
    for _ in range(N_STREAMS):
        # every 2nd frame explores: the second tick runs a discovery pass
        # a stream
        loop = omnisense.OmniSenseLoop(variants, lat, backend, budget_s=4.0,
                                       n_categories=16, explore_every=2)
        loop.seed_history([sroi.Detection(
            box=np.array([rng.uniform(-2, 2), rng.uniform(-0.8, 0.8), 0.5,
                          0.5]), category=int(rng.integers(16)), score=0.9)
            for _ in range(2)])
        loops.append(loop)
    frames = {(s, f): rng.random(FRAME).astype(np.float32)
              for s in range(N_STREAMS) for f in range(N_TICKS)}
    server = PodServer(loops, [backend] * N_STREAMS, max_batch=8,
                       buckets=buckets,
                       frame_source=lambda s, f: frames[(s, f)])
    return server, backend


def test_pod_tick_span_tree_and_counters():
    server, backend = _pod()
    erp_calls = []
    infer_erp = backend.infer_erp

    def counted_erp(*args):
        erp_calls.append(args)
        return infer_erp(*args)

    backend.infer_erp = counted_erp
    for f in range(N_TICKS):
        n_erp = len(erp_calls)
        server.step(f)
        spans = tracing.tick_spans(f)
        names = [s.name for s in spans]
        assert names[0] == "tick" and names.count("tick") == 1
        for s in spans:
            assert s.end_ns is not None and s.start_ns <= s.end_ns
            want = PARENT[s.name]
            if want is None:
                assert s.parent is None
                continue
            up = spans[s.parent]
            assert up.name == want
            assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns
        for name in ("stage", "emit", "drain", "ingest", "ingest.nms"):
            assert names.count(name) == 1
        assert sorted(s.key for s in spans if s.name == "emit.predict") == \
            list(range(N_STREAMS))
        # one chunk a dispatch: its launch, wait and lift joined by key
        n_chunks = len(server.timelines[-1].events)
        assert n_chunks > 0
        for part in ("drain.launch", "drain.wait", "drain.lift"):
            assert sorted(s.key for s in spans if s.name == part) == \
                list(range(n_chunks))
        n_disc = len(erp_calls) - n_erp
        assert names.count("ingest.discovery") == n_disc
        assert n_disc == (N_STREAMS if f == 1 else 0)
        totals = tracing.tick_totals(f)
        assert all(self_s >= 0 for _, self_s, _ in totals.values())
        assert totals["drain.launch"][2] == n_chunks
        assert totals["tick"][0] >= totals["drain"][0] + totals["emit"][0]
        counters = tracing.tick_counters(f)
        assert counters["h2d_bytes"] == N_STREAMS * int(np.prod(FRAME)) * 4
        assert counters["forwards"] == n_chunks + n_disc
        # three copies back a chunk and a discovery pass; the CPU's NMS
        # takes the host path
        assert counters["host_syncs"] == 3 * (n_chunks + n_disc)
        assert counters["d2h_bytes"] > 0
    assert tracing.ticks() == list(range(N_TICKS))


def test_fake_clock_totals_and_mapping(monkeypatch):
    now = [1000]
    monkeypatch.setattr(tracing, "_now", lambda: now[0])
    monkeypatch.setattr(tracing.time, "time_ns", lambda: 5_000_000)

    def tick_ns(n):
        now[0] += n

    tracing.begin_tick(7)
    with tracing.span("a"):
        tick_ns(10)
        with tracing.span("b", key=1):
            tick_ns(30)
        with tracing.span("b", key=2):
            tick_ns(20)
            tracing.count("c", 3)
        tick_ns(5)
    tracing.end_tick()
    with tracing.span("outside"):
        tick_ns(1)
    tracing.count("c")
    assert tracing.tick_totals(7) == {"a": pytest.approx((65e-9, 15e-9, 1)),
                                      "b": pytest.approx((50e-9, 50e-9, 2))}
    # anchored at perf 1000 and wall 5e6: every stamp shifts by 4999000
    assert tracing.tick_spans(7) == [
        tracing.Span("a", 5_000_000, 5_000_065, None, None),
        tracing.Span("b", 5_000_010, 5_000_040, 0, 1),
        tracing.Span("b", 5_000_040, 5_000_060, 0, 2)]
    assert tracing.tick_counters(7) == {"c": 3}
    assert tracing.totals()["c"] == 4
    assert tracing.tick_spans(8) == [] and tracing.tick_totals(8) == {}


def test_kept_ticks_are_bounded():
    for t in range(tracing.MAX_TICKS + 44):
        tracing.begin_tick(t)
        with tracing.span("tick"):
            tracing.count("n")
    assert tracing.ticks() == list(range(44, tracing.MAX_TICKS + 44))
    assert tracing.tick_spans(43) == []
    assert tracing.totals()["n"] == tracing.MAX_TICKS + 44
    # a tick opened again replaces its record
    tracing.begin_tick(50)
    assert tracing.tick_spans(50) == [] and tracing.ticks()[-1] == 50
    assert len(tracing.ticks()) == tracing.MAX_TICKS


def test_launch_counts_are_the_tracer_counters():
    tracing.count("host_syncs")
    _build.reset_launch_counts()
    assert _build.launch_counts() == {}
    tracing.begin_tick(0)
    _build.count("gnomonic_sample")
    _build.count("gnomonic_sample")
    _build.count("greedy_suppress_rows")
    tracing.end_tick()
    assert _build.launch_counts() == {"gnomonic_sample": 2,
                                      "greedy_suppress_rows": 1}
    assert tracing.tick_counters(0) == {"launch.gnomonic_sample": 2,
                                        "launch.greedy_suppress_rows": 1}
    _build.reset_launch_counts()
    assert _build.launch_counts() == {}
    assert tracing.totals() == {"host_syncs": 1}


def test_to_host_counts_a_sync_and_its_bytes():
    tracing.begin_tick(0)
    out = tracing.to_host(torch.arange(6, dtype=torch.float32))
    np.testing.assert_array_equal(out, np.arange(6, dtype=np.float32))
    assert tracing.tick_counters(0) == {"host_syncs": 1, "d2h_bytes": 24}


def test_device_counts_wait_for_the_flush():
    """``count_later`` adds nothing until ``flush_counts``, which counts
    every name's scalars in the tick it runs in, with one sync."""
    tracing.begin_tick(0)
    for n in (3, 4):
        tracing.count_later("a", torch.tensor(n))
    tracing.count_later("b", torch.tensor(7))
    tracing.end_tick()
    assert "a" not in tracing.totals()
    tracing.begin_tick(1)
    tracing.flush_counts()
    tracing.flush_counts()  # nothing left: no second sync
    assert tracing.tick_counters(1) == {"a": 7, "b": 7, "host_syncs": 1,
                                        "d2h_bytes": 16}
    assert tracing.tick_counters(0) == {}


def test_spans_land_on_the_profiler_clock():
    # the profiler's range opens after the outer span and before the inner
    # one, and closes after the inner and before the outer: the 2 ms
    # bounds the two clocks' mapping, whatever time the range's own entry
    # and exit take (a first call, or a loaded machine, makes that long)
    x = torch.randn(256, 256)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tracing.begin_tick(0)
        with tracing.span("outer"):
            with torch.profiler.record_function("probe"):
                with tracing.span("probe"):
                    for _ in range(20):
                        x = torch.tanh(x @ x)
                    time.sleep(0.005)
        tracing.end_tick()
    origin = prof.profiler.kineto_results.trace_start_ns()
    [ev] = [e for e in prof.events() if e.name == "probe"]
    outer, sp = tracing.tick_spans(0)
    start = origin + 1000 * ev.time_range.start
    end = origin + 1000 * ev.time_range.end
    assert outer.start_ns - 2e6 < start < sp.start_ns + 2e6
    assert sp.end_ns - 2e6 < end < outer.end_ns + 2e6
    assert sp.end_ns - sp.start_ns >= 5e6
