"""Guards of the port's boundaries.

* ``repro_torch`` (and ``chip_smoke.py``'s imports) import neither JAX
  nor the JAX package: every module imports in a process where both are
  blocked.
* No hidden CPU fallback: an entry point given no device raises when no
  CUDA device is present.
* The port's ``PodServer`` batches through real variant queues, not a
  ``collections.Counter`` simulation (the twin of
  ``tests/test_repo_hygiene.py``'s gate on the reference).
"""

from __future__ import annotations

import inspect
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core.sroi import SRoI

ROOT = Path(__file__).resolve().parents[1]


def _modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_every_module_imports_without_jax_or_reference():
    mods = _modules()
    assert "repro_torch.serving.scheduler" in mods
    assert "repro_torch.kernels.gnomonic.ops" in mods
    assert "repro_torch.kernels.attention.ops" in mods
    assert "repro_torch.models.transformer" in mods
    for m in ("serving.server", "serving.runtime", "serving.telemetry",
              "serving.pod_allocation", "serving.placement",
              "serving.traffic", "serving.batching", "serving.baselines",
              "launch.serve", "launch.replay", "serving.tasks",
              "serving.fleet", "serving.replay", "distributed.elastic",
              "models.vision", "models.action", "pytree",
              "training.optimizer", "training.compression",
              "training.steps", "checkpoint.checkpoint", "data.pipeline",
              "configs.base", "launch.train"):
        assert f"repro_torch.{m}" in mods
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_device_means_cuda_or_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.kernels.gnomonic.ops import gnomonic_sample
    from repro_torch.models import detector as det_mod
    from repro_torch.serving.scheduler import TorchDetectorBackend

    cfg = det_mod.DetectorConfig("t", 32, width_mult=0.25, n_classes=2)
    params = det_mod.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchDetectorBackend([cfg], [params])
    erp = np.zeros((8, 16, 3), np.float32)
    uv = np.zeros((4, 4), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        gnomonic_sample(erp, uv, uv)
    # asked for explicitly, the CPU runs the plain versions
    from repro_torch.models import action as act_mod
    from repro_torch.serving.tasks import TorchActionBackend

    acfg = act_mod.ActionConfig("a", 16, 2, patch=8, d_model=8, d_ff=16)
    aparams = act_mod.init_params(torch.Generator().manual_seed(0), acfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchActionBackend([acfg], [aparams])
    assert TorchActionBackend([acfg], [aparams],
                              device="cpu").device.type == "cpu"
    backend = TorchDetectorBackend([cfg], [params], device="cpu")
    assert backend.device.type == "cpu"
    assert gnomonic_sample(erp, uv, uv, device="cpu").shape == (4, 4, 3)
    region = SRoI(center=(0.0, 0.0), fov=(1.0, 1.0))
    assert backend._project(erp, region, 8).shape == (8, 8, 3)


def test_pod_server_has_no_counter_simulation():
    from repro_torch.serving import server as server_mod

    src = inspect.getsource(server_mod)
    assert "Counter" not in src, (
        "PodServer must batch variants through real per-variant queues "
        "(repro_torch.serving.batching), not a collections.Counter "
        "simulation")
    assert "VariantQueues" in src


def test_placement_without_devices_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.serving import profiles
    from repro_torch.serving.placement import VariantPlacement

    variants = profiles.make_ladder()[:2]
    with pytest.raises(RuntimeError, match="CUDA"):
        VariantPlacement(variants)
    # named device slots need no card
    assert VariantPlacement.virtual(variants, 2).n_devices == 2
    assert VariantPlacement(variants, devices=[torch.device("cpu")]
                            ).n_devices == 1
