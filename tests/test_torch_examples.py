"""The port's example twins (``examples_torch/``) against the reference's
examples (``examples/``): run in this process on the same arguments,
they must print the same lines.

* ``quickstart.py``: every per-frame line (SRoIs, plan, detections,
  planned latency, discovery) and both Sph-mAP lines.
* ``serve_pod.py`` under the three policies and the open loop (a cut
  pod: 4 streams, 6 frames): every line but the control-plane
  overhead, which is a wall-clock time.
* ``real_detector_pipeline.py --device cpu`` runs to its end.
* ``train_restart.py --device cpu`` prints the reference's lines (its
  numbers are its own weights'), keeps the optimizer's step counter
  across the restart and keeps improving the loss; its first steps'
  losses equal the reference's ``lm_train_step`` on the same weights and
  batches within rtol 1e-5 (``tests/test_torch_training.py``'s train-step
  tolerance).
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


def test_train_restart_twin_matches_the_reference_steps(capsys):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.configs import base as jbase
    from repro.data.pipeline import lm_batches
    from repro.training import optimizer as JO
    from repro.training import steps as JS
    from repro_torch import pytree
    from repro_torch.models import transformer as TT

    mod = runpy.run_path(str(ROOT / "examples_torch/train_restart.py"))
    capsys.readouterr()
    res = mod["main"](["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("phase 1: step 50, loss ")
    assert out[0].endswith("checkpoints at [20, 40]")
    assert out[1] == ("restart: restored step 40 (optimizer step counter = "
                      "40)")
    assert out[2].startswith("phase 2: step 40 -> 90, loss ")
    assert out[-1] == "checkpoint/restart training substrate OK"
    assert res["restored"] == res["opt_step"] == 40
    assert res["more"][-1] < res["losses"][0]

    # the reference's train step from the example's initial weights
    cfg = jbase.get_arch("smollm_135m").smoke
    params = TT.init_params(torch.Generator().manual_seed(mod["SEED"]),
                            TT.from_jax_config(cfg), device="cpu")
    jp = pytree.tree_map(lambda t: jnp.asarray(t.numpy()), params)
    opt = JO.adamw(lr=3e-3, warmup_steps=10)
    step = jax.jit(JS.lm_train_step(cfg, opt))
    state = JS.make_state(jp, opt)
    for i, batch in zip(range(3), lm_batches(cfg.vocab_size, batch=8,
                                             seq=32, n_batches=200)):
        state, m = step(state, jax.tree.map(jnp.asarray, batch))
        np.testing.assert_allclose(res["losses"][i], float(m["loss"]),
                                   rtol=1e-5)

