"""Config registry and workload shapes (port of ``repro.configs.base``).

Each ``repro_torch/configs/<arch_id>.py`` module exports:
  * ``FAMILY``       — "lm" | "diffusion" | "vision"
  * ``full_config()``  — the published configuration
  * ``smoke_config()`` — a reduced same-family config for CPU tests
  * ``SHAPES``       — the arch's input-shape set
  * ``SKIP``         — dict shape_name -> reason, for cells that are
    skipped (e.g. long_500k on pure full-attention LMs)

``get_arch(arch_id)`` returns an ``ArchSpec`` bundling these.  The port
has the four LM archs; a vision or diffusion id raises
``NotImplementedError`` until the slice that ports its family.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any

ARCH_IDS = (
    "granite_34b",
    "smollm_135m",
    "mixtral_8x22b",
    "qwen3_moe_235b_a22b",
    "flux_dev",
    "unet_sdxl",
    "convnext_b",
    "resnet_152",
    "resnet_50",
    "vit_b16",
)

# canonical hyphenated ids (CLI spelling) -> module names
ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}

# the families not ported yet, and the slice that ports each
# (ROADMAP, queue 1, slice F)
_UNPORTED = {
    "flux_dev": "diffusion", "unet_sdxl": "diffusion",
    "convnext_b": "vision", "resnet_152": "vision", "resnet_50": "vision",
    "vit_b16": "vision",
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode | generate | serve
    # LM fields
    seq_len: int = 0
    global_batch: int = 0
    # vision / diffusion fields
    img_res: int = 0
    batch: int = 0
    steps: int = 0


LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", seq_len=4096, global_batch=256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", seq_len=32768,
                             global_batch=32),
    "decode_32k": ShapeSpec("decode_32k", "decode", seq_len=32768,
                            global_batch=128),
    "long_500k": ShapeSpec("long_500k", "decode", seq_len=524288,
                           global_batch=1),
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str
    config: Any
    smoke: Any
    shapes: dict[str, ShapeSpec]
    skip: dict[str, str]


def get_arch(arch_id: str) -> ArchSpec:
    mod_name = ALIASES.get(arch_id, arch_id)
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ALIASES)}")
    if mod_name in _UNPORTED:
        family = _UNPORTED[mod_name]
        raise NotImplementedError(
            f"{mod_name} is a {family} arch: the port has it with its "
            f"{family} slice (ROADMAP, queue 1, slice F), not yet")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return ArchSpec(
        arch_id=mod_name,
        family=mod.FAMILY,
        config=mod.full_config(),
        smoke=mod.smoke_config(),
        shapes=mod.SHAPES,
        skip=getattr(mod, "SKIP", {}),
    )


def list_archs() -> list[str]:
    return list(ARCH_IDS)


FULL_ATTENTION_SKIP = {
    "long_500k": "SKIP(full-attention): 524k-token decode needs "
                 "sub-quadratic attention; this arch has no sliding window "
                 "(see DESIGN.md section 4)."
}
