"""The region-description cell's harness on the CPU, at a tiny size: a
``describe`` pod (the tiny Kimi-VL of ``repro_torch.configs.kimi_vl_a3b``
on crops of 16-40 px of a 96x192 ERP) run through ``harness.run_cell``
reads ``correct: true`` and reports its per-layer metrics traced, and
each fault planted under its timed path (``faults_describe``) reads
``correct: false``; the weights maker's layout is the port's.

The runs go in a subprocess of their own, as the detection cell's tests
do (``test_omnibench_harness.py``)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parents[1]
REPO = HERE.parent

RUN = """
import json, sys
sys.path[:0] = [{repo!r}, {src!r}]
from omnibench import harness
from omnibench.tests import faults_describe
fault = getattr(faults_describe, {fault!r}) if {fault!r} else None
result, rows = harness.run_cell({root!r}, "tiny-describe", {seed}, 1e9,
                                {traced}, device="cpu", max_ticks=2,
                                fault=fault, log=lambda s: None)
loaded = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps(dict(result=result, loaded=loaded)))
"""


def tiny_config() -> dict:
    from repro_torch.configs import kimi_vl_a3b

    cfg = json.loads((HERE / "configs" / "kimi-vl-a3b-describe.json")
                     .read_text())
    cfg.update(kimi_vl_a3b.tiny_dict())
    cfg["name"] = "tiny-describe"
    for r, s in zip(cfg["ladder"], (16, 24, 32, 40)):
        r["input_size"] = s
    cfg["prompt"] = {"pre": 4, "post": 2}
    cfg["answer_tokens"] = 3
    cfg["erp"] = [96, 192]
    return cfg


def make_root(tmp: Path) -> Path:
    root = Path(tmp) / "checkout"
    shutil.copytree(HERE, root / "omnibench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (root / "omnibench" / "configs" / "tiny-describe.json").write_text(
        json.dumps(tiny_config()))
    traffic = json.loads((HERE / "workloads" / "describe-closed.json")
                         .read_text())
    traffic.update(streams=2, pool_frames=2, warm_ticks=1, check_ticks=2,
                   check_within=2, trace_from=0, trace_ticks=1)
    (root / "omnibench" / "workloads" / "tiny-describe.json").write_text(
        json.dumps(traffic))
    bench["configs"] = [dict(name="tiny-describe",
                             file="omnibench/configs/tiny-describe.json")]
    bench["workloads"] = [dict(name="tiny-describe", config="tiny-describe",
                               traffic="tiny-describe", chips=1,
                               why="tiny")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = (["tiny-describe"]
                              if "describe-kimivl-closed" in m["workloads"]
                              else [])
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_tiny(tmp_path, fault="", traced=False, seed=4) -> dict:
    root = make_root(tmp_path)
    code = RUN.format(repo=str(REPO), src=str(REPO / "src"), fault=fault,
                      root=str(root), seed=seed, traced=traced)
    env = dict(os.environ, OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_tiny_describe_cell_is_correct_and_traced(tmp_path):
    out = run_tiny(tmp_path, traced=True)
    res = out["result"]
    assert res["correct"] is True, res["compared"]
    assert res["failed"] == 0 and res["attempted"] == 4
    assert {"vision_ms_per_tick", "vlm_prefill_ms_per_tick",
            "vlm_decode_ms_per_tick", "image_tokens_per_frame",
            "expert_load_ratio", "describe_tick_mfu"} <= set(res["metrics"])
    assert res["metrics"]["expert_load_ratio"]["value"] >= 1.0
    assert not set(out["loaded"]) & {"jax", "jaxlib", "flax", "repro"}
    assert list(res)[-1] == "compared"


@pytest.mark.parametrize("fault,broken", [("logit_raised", "logit_gap"),
                                          ("cache_skipped", "logit_gap"),
                                          ("bias_ignored", "route_gap")])
def test_a_planted_fault_reads_incorrect(tmp_path, fault, broken):
    res = run_tiny(tmp_path, fault=fault)["result"]
    assert res["correct"] is False
    got = res["compared"][broken]
    assert got["value"] > got["limit"]


def test_the_weights_are_in_the_ports_layout():
    from omnibench import vlm_weights
    from repro_torch.configs import kimi_vl_a3b
    from repro_torch.models import kimi_vl

    cfg = kimi_vl_a3b.tiny_config()
    bench = [(p, tuple(s), k, sc) for p, s, k, sc in
             vlm_weights.param_spec(kimi_vl_a3b.tiny_dict())]
    port = [(p, tuple(s), k, sc) for p, s, k, sc in kimi_vl.param_spec(cfg)]
    assert bench == port
    a = vlm_weights.make(kimi_vl_a3b.tiny_dict(), 3, "cpu")
    b = vlm_weights.make(kimi_vl_a3b.tiny_dict(), 3, "cpu")
    assert torch.equal(a["lm"]["layers"][2]["moe"]["gate_up"],
                       b["lm"]["layers"][2]["moe"]["gate_up"])
    assert a["lm"]["embed"].dtype == torch.bfloat16
