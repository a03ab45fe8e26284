"""The reader of the fused norm-activation share
(``omnibench/metrics/norm_act_fused_share.py`` over
``repro_torch.tracing``'s ``launch.groupnorm_mish`` and
``norm_act.calls``): 100 where every call launched the kernel, 0 where
the detector ran its plain path (the CPU), and nothing on a program that
counts neither, or has no tracer."""

from __future__ import annotations

import sys
from types import SimpleNamespace as NS

import pytest
import torch

from omnibench import harness
from omnibench.tests.test_omnibench_harness import REPO

NAME = "norm_act_fused_share"


@pytest.fixture
def recorder():
    from repro_torch import tracing

    tracing.reset()
    yield tracing
    tracing.reset()


def test_the_reader_reads_the_share_of_fused_calls(recorder):
    read = harness.Bench(REPO).reader(NAME)
    run = NS(timed_ticks=lambda: [NS(index=3, frames=2),
                                  NS(index=4, frames=2)])
    for tick in (3, 4):
        recorder.begin_tick(tick)
        recorder.count("norm_act.calls", 64)
        recorder.count("launch.groupnorm_mish", 64)
        recorder.end_tick()
    assert read(run) == pytest.approx(100.0)


def test_the_reader_reads_0_on_the_plain_path(recorder):
    from repro_torch.models import detector as det_mod

    read = harness.Bench(REPO).reader(NAME)
    cfg = det_mod.DetectorConfig("t", 32, width_mult=0.25, depth_mult=0.34,
                                 n_classes=2)
    params = det_mod.init_params(torch.Generator().manual_seed(0), cfg)
    recorder.begin_tick(5)
    det_mod.apply(params, torch.rand(1, 32, 32, 3), cfg)
    recorder.end_tick()
    assert recorder.tick_counters(5)["norm_act.calls"] > 0
    assert read(NS(timed_ticks=lambda: [NS(index=5, frames=1)])) == 0.0


def test_the_reader_reports_nothing_without_the_counts(recorder, monkeypatch):
    import repro_torch

    read = harness.Bench(REPO).reader(NAME)
    run = NS(timed_ticks=lambda: [NS(index=3, frames=2)])
    recorder.begin_tick(3)
    recorder.count("host_syncs")  # a program that counts, but not these
    recorder.end_tick()
    assert read(run) is None
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert read(run) is None
