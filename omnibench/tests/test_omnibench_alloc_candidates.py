"""The reader of the knapsack DP's candidate count
(``omnibench/metrics/alloc_candidates_per_frame.py`` over
``repro_torch.tracing``'s ``alloc.candidates``): a tiny CPU cell reports
it, it reads the count a served frame, and it reports nothing on a
program that does not count, or has no tracer."""

from __future__ import annotations

import sys
from types import SimpleNamespace as NS

import pytest

from omnibench import harness
from omnibench.tests import tiny
from omnibench.tests.test_omnibench_harness import REPO, run_tiny

NAME = "alloc_candidates_per_frame"


@pytest.fixture
def recorder():
    from repro_torch import tracing

    tracing.reset()
    yield tracing
    tracing.reset()


def test_a_tiny_cell_reports_the_candidates(tmp_path):
    traffic = tiny.tiny_traffic(warm_ticks=2, trace_from=1)
    res = run_tiny(tmp_path, traffic=traffic, traced=True)["result"]
    assert res["correct"] is True
    m = res["metrics"][NAME]
    assert m["unit"] == "candidates"
    # at least the first column's feasible models of every planned frame
    assert m["value"] >= 1


def test_the_reader_reads_the_count_a_frame(recorder):
    read = harness.Bench(REPO).reader(NAME)
    run = NS(timed_ticks=lambda: [NS(index=3, frames=2),
                                  NS(index=4, frames=2)])
    for tick, n in ((3, 90), (4, 30)):
        recorder.begin_tick(tick)
        recorder.count("alloc.candidates", n)
        recorder.end_tick()
    assert read(run) == pytest.approx(30.0)


def test_the_reader_reports_nothing_without_the_count(recorder, monkeypatch):
    import repro_torch

    read = harness.Bench(REPO).reader(NAME)
    run = NS(timed_ticks=lambda: [NS(index=3, frames=2)])
    recorder.begin_tick(3)
    recorder.count("host_syncs")  # a program that counts, but not this
    recorder.end_tick()
    assert read(run) is None
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert read(run) is None
