"""Config registry and workload shapes (port of ``repro.configs.base``).

Each ``repro_torch/configs/<arch_id>.py`` module exports:
  * ``FAMILY``       — "lm" | "diffusion" | "vision"
  * ``full_config()``  — the published configuration
  * ``smoke_config()`` — a reduced same-family config for CPU tests
  * ``SHAPES``       — the arch's input-shape set
  * ``SKIP``         — dict shape_name -> reason, for cells that are
    skipped (e.g. long_500k on pure full-attention LMs)

``get_arch(arch_id)`` returns an ``ArchSpec`` bundling these; the port
has every arch of the reference's registry.
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

DIFFUSION_SHAPES = {
    "train_256": ShapeSpec("train_256", "train", img_res=256, batch=256,
                           steps=1000),
    "gen_1024": ShapeSpec("gen_1024", "generate", img_res=1024, batch=4,
                          steps=50),
    "gen_fast": ShapeSpec("gen_fast", "generate", img_res=512, batch=16,
                          steps=4),
    "train_1024": ShapeSpec("train_1024", "train", img_res=1024, batch=32,
                            steps=1000),
}

VISION_SHAPES = {
    "cls_224": ShapeSpec("cls_224", "train", img_res=224, batch=256),
    "cls_384": ShapeSpec("cls_384", "train", img_res=384, batch=64),
    "serve_b1": ShapeSpec("serve_b1", "serve", img_res=224, batch=1),
    "serve_b128": ShapeSpec("serve_b128", "serve", img_res=224, batch=128),
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
