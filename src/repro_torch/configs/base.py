"""Workload shapes (port of ``repro.configs.base``).

Each ``repro_torch/configs/<arch_id>.py`` module exports
``full_config()`` (the published configuration) and ``smoke_config()``
(a reduced same-family config for CPU tests).  The reference's arch
registry (``get_arch``, ``ArchSpec``) and its skip tables come with the
port's first benchmark, which reads them.
"""

from __future__ import annotations

import dataclasses


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
