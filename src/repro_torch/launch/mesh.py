"""Production mesh descriptions (port of ``repro.launch.mesh``).

PyTorch has no placeholder devices, so a production mesh here is a
description, :class:`MeshSpec`: its shape and axis names, with no
devices.  The cost analysis (``launch/cells.py``, ``launch/dryrun.py``)
reads it to adapt the sharding specs and to divide a cell's arguments
per device.  The shapes are the reference's, so the two tables compare:

  * single pod:  (data=16, model=16)          — 256 devices
  * multi-pod:   (pod=2, data=16, model=16)   — 512 devices

The ``pod`` axis is the outermost (slowest) axis, so inter-pod
collectives are confined to the pure-DP gradient reduction.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    # the devices, in the mesh's row-major order; None for a description
    devices: tuple[torch.device, ...] | None = None

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshSpec(shape, axes)


def make_host_mesh(device: str | torch.device | None = None) -> MeshSpec:
    """1x1 mesh on the local device (the card unless the caller names
    another)."""
    return MeshSpec((1, 1), ("data", "model"), (resolve_device(device),))


# The roofline's constants: NVIDIA H100 SXM5 80GB, NVIDIA's data sheet,
# dense rates without sparsity, at the 700 W power limit.  Peaks, not
# measurements; a card set to a lower limit runs slower under load.
PEAK_FLOPS_BF16 = 989e12  # per GPU, bf16 tensor cores
HBM_BW = 3.35e12  # bytes/s per GPU (HBM3)
NVLINK_BW = 900e9  # bytes/s per GPU (NVLink 4, all links)
