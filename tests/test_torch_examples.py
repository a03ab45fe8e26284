"""The port's example twins (``examples_torch/``) against the reference's
examples (``examples/``): run in this process on the same arguments,
they must print the same lines.

* ``quickstart.py``: every per-frame line (SRoIs, plan, detections,
  planned latency, discovery) and both Sph-mAP lines.
* ``serve_pod.py`` under the three policies and the open loop (a cut
  pod: 4 streams, 6 frames): every line but the control-plane
  overhead, which is a wall-clock time.
* ``real_detector_pipeline.py --device cpu`` runs to its end.
"""

from __future__ import annotations

import runpy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(path: Path, argv: list[str], capsys, monkeypatch) -> list[str]:
    monkeypatch.setattr(sys, "argv", [str(path)] + argv)
    capsys.readouterr()
    runpy.run_path(str(path), run_name="__main__")
    return capsys.readouterr().out.splitlines()


def test_quickstart_twin_prints_the_reference_lines(capsys, monkeypatch):
    ref = _run(ROOT / "examples/quickstart.py", [], capsys, monkeypatch)
    got = _run(ROOT / "examples_torch/quickstart.py", [], capsys,
               monkeypatch)
    assert got == ref
    assert sum(line.startswith("frame ") for line in got) == 24
    assert any(line.startswith("OmniSense: Sph-mAP=") for line in got)
    assert any(line.startswith("CubeMap-3: Sph-mAP=") for line in got)


@pytest.mark.parametrize("args", [
    ["--policy", "sync"], ["--policy", "deadline"], ["--policy", "async"],
    ["--open-loop", "--fps", "0.5", "--jitter", "0.2", "--slo", "2.0",
     "--admission", "slo"]],
    ids=["sync", "deadline", "async", "open-loop"])
def test_serve_pod_twin_prints_the_reference_lines(args, capsys,
                                                   monkeypatch):
    argv = ["--streams", "4", "--frames", "6", "--devices", "6"] + args

    def lines(path):
        return [line for line in _run(path, argv, capsys, monkeypatch)
                if "control-plane overhead" not in line]

    ref = lines(ROOT / "examples/serve_pod.py")
    got = lines(ROOT / "examples_torch/serve_pod.py")
    assert got == ref
    assert got[-1] == "pod serving loop OK"


def test_real_detector_pipeline_twin_runs_on_the_cpu(capsys, monkeypatch):
    out = _run(ROOT / "examples_torch/real_detector_pipeline.py",
               ["--device", "cpu"], capsys, monkeypatch)
    assert sum(line.startswith("frame ") for line in out) == 3
    assert out[-1].startswith("full real-tensor pipeline OK on cpu")
