"""The control on the card: the reference put in the program's place one
step below the configuration's precision (the crop in bfloat16, the
detector's convolutions in TF32) must come out not correct, where the program on the same
frames comes out correct.  Marked ``cuda``; skips where no CUDA device is
present.  At the cell's own size the control runs through
``omnibench/control.py`` (see PERF.md); here at a size a test run holds:

    PYTHONPATH=src python -m pytest -q -m cuda omnibench/tests
"""

from __future__ import annotations

import pytest
import torch

from omnibench import harness
from omnibench.check_detect import control_reference
from omnibench.tests import tiny


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [11, 2 ** 31 + 5, 2 ** 32 + 77])
def test_control_is_not_correct(tmp_path, cuda, seed):
    traffic = tiny.tiny_traffic(streams=4, check_ticks=3, check_within=3)
    root = tiny.make_root(tmp_path, {"small": traffic},
                          config=tiny.small_config())
    result, rows = harness.run_cell(root, "small", seed, 1e9, False,
                                    device=cuda, max_ticks=3,
                                    controls={"control": control_reference},
                                    log=lambda s: None)
    assert result["correct"] is True, rows
    limits = {k: lim for k, _, lim in rows}
    ctrl = result["controls"]["control"]
    assert any(ctrl[k] > limits[k] for k in limits), ctrl
