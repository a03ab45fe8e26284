"""The readers of the program's own spans and counters
(``omnibench/program_spans.py`` over ``repro_torch.tracing``): a tiny
CPU cell reports all seven, each inside the wrapper span that holds its
spans, and on a program without the tracer each reports nothing."""

from __future__ import annotations

import sys
from types import SimpleNamespace as NS

import pytest

from omnibench import harness
from omnibench.tests import tiny
from omnibench.tests.test_omnibench_harness import REPO, run_tiny

READERS = ("drain_launch_ms_per_tick", "drain_wait_ms_per_tick",
           "drain_lift_ms_per_tick", "allocate_ms_per_frame",
           "discovery_ms_per_tick", "host_syncs_per_tick", "h2d_mb_per_tick")


def test_a_tiny_cell_reports_the_program_spans(tmp_path):
    # five warm ticks: the first window tick, untraced, serves each
    # stream's 6th frame, a discovery frame; the second is traced
    traffic = tiny.tiny_traffic(warm_ticks=5, trace_from=1)
    res = run_tiny(tmp_path, traffic=traffic, traced=True)["result"]
    assert res["correct"] is True
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(READERS) <= set(m)
    h, w = tiny.tiny_config()["erp"]
    assert m["h2d_mb_per_tick"] == pytest.approx(
        traffic["streams"] * h * w * 3 * 4 / 1e6, rel=1e-12)
    assert m["discovery_ms_per_tick"] > 0
    # per chunk: three copies back; per discovery pass: three more
    assert m["host_syncs_per_tick"] >= 3 * (1 + traffic["streams"])
    # the program's spans lie inside the benchmark's wrappers
    assert (m["drain_launch_ms_per_tick"] + m["drain_wait_ms_per_tick"]
            + m["drain_lift_ms_per_tick"]) <= m["drain_ms_per_tick"]
    assert 0 < m["allocate_ms_per_frame"] <= m["plan_ms_per_frame"]


@pytest.mark.parametrize("name", READERS)
def test_a_reader_reports_nothing_without_the_tracer(name, monkeypatch):
    import repro_torch
    from repro_torch import tracing

    read = harness.Bench(REPO).reader(name)
    run = NS(timed_ticks=lambda: [NS(index=3, frames=2)])
    tracing.begin_tick(3)
    tracing.end_tick()
    assert read(run) == 0.0  # a kept tick with nothing in it
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert read(run) is None
