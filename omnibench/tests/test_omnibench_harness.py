"""The benchmark's harness on the CPU, at a tiny size: every name in
``BENCHMARK.json`` resolves to its file, a cell added as a new traffic
file runs with no other edit, a dry run loads no module of JAX or of the
JAX package (compared by whole top-level names).

The runs go in a subprocess of their own: the test process may hold JAX
from other test files, and the harness patches the port's modules for
the length of a run.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

from omnibench import harness
from omnibench.tests import tiny

REPO = Path(__file__).resolve().parents[2]

RUN = """
import json, sys
sys.path[:0] = [{repo!r}, {src!r}]
from omnibench import harness
from omnibench.tests import faults
fault = getattr(faults, {fault!r}) if {fault!r} else None
result, rows = harness.run_cell({root!r}, {cell!r}, {seed}, 1e9, {traced},
                                device="cpu", max_ticks=2, fault=fault,
                                log=lambda s: None)
loaded = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps(dict(result=result, loaded=loaded)))
"""


def run_tiny(tmp_path, cell="tiny-new", traffic=None, fault="", seed=5,
             traced=False, config=None) -> dict:
    root = tiny.make_root(tmp_path, {cell: traffic or tiny.tiny_traffic()},
                          config=config)
    code = RUN.format(repo=str(REPO), src=str(REPO / "src"), fault=fault,
                      root=str(root), cell=cell, seed=seed, traced=traced)
    # two threads: the test runners already keep every core busy
    env = dict(os.environ, OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_every_name_resolves():
    bench = harness.Bench(REPO)
    spec = bench.spec
    for c in spec["configs"]:
        cfg = bench.config(c["name"])
        assert (REPO / "omnibench" / "pods" / f"{cfg['pod']}.py").exists()
    metrics = {m["name"] for m in spec["end_to_end"] + spec["per_layer"]}
    for w in spec["workloads"]:
        assert bench.traffic(w["traffic"])["loop"] in ("closed", "camera")
        assert bench.metrics(w["name"], False)
        assert bench.metrics(w["name"], True)
    for name in metrics:
        assert callable(bench.reader(name))
    for m in spec["per_layer"]:
        for w in m.get("workloads", []):
            assert m["moves"] in {e["name"] for e in bench.metrics(w, False)}


def test_forbidden_names_are_whole_top_level_names():
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "repro")
    sys.modules.setdefault("repro_torch_lookalike_probe", sys)
    try:
        assert "repro" not in {n for n in harness.forbidden_modules()
                               if n.startswith("repro_")}
    finally:
        sys.modules.pop("repro_torch_lookalike_probe", None)


def test_a_new_traffic_file_runs_and_loads_no_jax(tmp_path):
    out = run_tiny(tmp_path)
    res = out["result"]
    assert res["correct"] is True
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}
    assert res["attempted"] == 4 and res["failed"] == 0
    assert list(res)[-1] == "compared"
    assert not set(out["loaded"]) & {"jax", "jaxlib", "flax", "repro"}
    assert "repro_torch" in out["loaded"]


def test_a_new_camera_cell_runs_traced(tmp_path):
    out = run_tiny(tmp_path, cell="tiny-cam",
                   traffic=tiny.tiny_traffic("camera", fps=50.0),
                   traced=True)
    res = out["result"]
    assert res["correct"] is True
    assert "busy_s" in res["device"] and "window_s" in res["device"]
    assert "breakdown" in res
    assert {"plan_ms_per_frame", "requests_per_frame", "gflop_per_frame",
            "detections_per_frame"} <= set(res["metrics"])



def test_work_readers_count_every_window_tick():
    from types import SimpleNamespace as NS

    bench = harness.Bench(REPO)
    counts = {3: dict(requests=5, served=6), 4: dict(requests=3, served=2)}
    run = NS(window=NS(ticks=[NS(index=i, frames=2) for i in (3, 4)]),
             flops={3: 4e9, 4: 2e9}, pod=NS(tick_counts=counts.get))
    assert bench.reader("requests_per_frame")(run) == 2.0
    assert bench.reader("detections_per_frame")(run) == 2.0
    assert bench.reader("gflop_per_frame")(run) == 1.5
