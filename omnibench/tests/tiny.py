"""A tiny copy of the benchmark for the CPU tests: the harness's files
copied under a temporary root, with one small configuration of the
ladder (crops of 64-128 px at a quarter of the widths, a
96x192 ERP, 16 classes) and small traffic
mixes, registered in that root's own ``BENCHMARK.json``."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SIZES = (64, 64, 96, 96, 128)


def tiny_config() -> dict:
    cfg = json.loads((HERE / "configs" / "omnisense-detect.json").read_text())
    cfg["name"] = "tiny-detect"
    for r, s in zip(cfg["ladder"], SIZES):
        r.update(input_size=s, width_mult=0.25, depth_mult=0.34)
    cfg["n_classes"] = 16
    cfg["erp"] = [96, 192]
    return cfg


def small_config() -> dict:
    """The ladder at its published widths and classes, on crops of
    128-256 px from a 480x960 ERP (the card's test size)."""
    cfg = json.loads((HERE / "configs" / "omnisense-detect.json").read_text())
    cfg["name"] = "tiny-detect"
    for r, s in zip(cfg["ladder"], (128, 128, 192, 192, 256)):
        r["input_size"] = s
    cfg["erp"] = [480, 960]
    return cfg


def tiny_traffic(loop: str = "closed", **kw) -> dict:
    t = dict(loop=loop, streams=2, task="detection", budget_s=8.0,
             scene_key=250814237,
             objects=60, video_frames=120, pool_frames=2, warm_ticks=1,
             check_ticks=2, check_within=2, trace_from=0, trace_ticks=1)
    if loop == "camera":
        t.update(fps=4.0, jitter=0.2)
    t.update(kw)
    return t


def make_root(tmp: Path, cells: dict, config: dict | None = None) -> Path:
    """``cells``: name -> traffic dict; every cell on the tiny config (or
    on ``config``)."""
    root = Path(tmp) / "checkout"
    shutil.copytree(HERE, root / "omnibench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    (root / "omnibench" / "configs" / "tiny-detect.json").write_text(
        json.dumps(config or tiny_config()))
    bench["configs"] = [dict(bench["configs"][0], name="tiny-detect",
                             file="omnibench/configs/tiny-detect.json")]
    bench["workloads"] = []
    for name, traffic in cells.items():
        (root / "omnibench" / "workloads" / f"{name}.json").write_text(
            json.dumps(traffic))
        bench["workloads"].append(dict(name=name, config="tiny-detect",
                                       traffic=name, chips=1, why="tiny"))
    names = list(cells)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = names
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
