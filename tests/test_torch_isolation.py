"""Guards of the port's boundaries.

* ``repro_torch`` (and ``chip_smoke.py``'s imports) import neither JAX
  nor the JAX package: every module imports in a process where both are
  blocked.
* No hidden CPU fallback: an entry point given no device raises when no
  CUDA device is present.
"""

from __future__ import annotations

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
    backend = TorchDetectorBackend([cfg], [params], device="cpu")
    assert backend.device.type == "cpu"
    assert gnomonic_sample(erp, uv, uv, device="cpu").shape == (4, 4, 3)
    region = SRoI(center=(0.0, 0.0), fov=(1.0, 1.0))
    assert backend._project(erp, region, 8).shape == (8, 8, 3)
