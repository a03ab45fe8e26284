"""Dry run: count every (architecture x input shape) cell of the port on
fake tensors and extract the roofline terms (port of
``repro.launch.dryrun``).

The reference lowers and compiles each cell on 512 placeholder host
devices and analyses the optimised HLO.  PyTorch has neither, so each
cell's step runs once here on fake tensors (``FakeTensorMode``: shapes
and dtypes, no memory) under the dispatch-level counter of
:mod:`repro_torch.launch.hloanalysis`, at its published size, and the
production mesh (:func:`~repro_torch.launch.mesh.make_production_mesh`)
divides its arguments per device under the cell's adapted specs.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-34b \\
        --shape train_4k --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu \\
        --out build/dryrun_torch

The fake tensors live on the card unless ``--device`` names another
device (without a card, ``--device cpu``).  Per cell it records the
counting wall time, the counted FLOPs and bytes of the whole program
(global: the port's step is one program, not one device's partition),
the per-device argument bytes, and ``null`` with a ``why`` for what the
count cannot know: the sharded temporaries and outputs (there is no
SPMD partitioner) and the collectives (the step runs on one device).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.device import resolve_device
from repro_torch.launch import cells as cells_mod
from repro_torch.launch import hloanalysis
from repro_torch.launch import mesh as mesh_mod

WHY = {
    "memory.output_size_in_bytes":
        "no SPMD partitioner: the outputs' per-device layout is not known",
    "memory.temp_size_in_bytes":
        "no SPMD partitioner: the sharded temporaries are not known (the "
        "count runs the whole step on one fake device)",
    "collective_bytes":
        "the cell's step runs whole on one device and dispatches no "
        "collective; the per-rank functions of the multi-device path "
        "count theirs (moe_block_a2a's all-to-alls, counted on a fake "
        "process group), but no cell runs per rank yet",
}


def count_cell(cell: cells_mod.Cell,
               device: str | torch.device = "cpu") -> dict:
    """:func:`hloanalysis.analyze` of ``cell.step`` on fake tensors on
    ``device`` (nothing is allocated)."""
    fake = FakeTensorMode()
    args = cells_mod.materialize(cell, fake, device)
    with fake:
        return hloanalysis.analyze(cell.step, *args)


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             device: str | torch.device = "cpu") -> dict:
    mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod)
    cell = cells_mod.build_cell(arch_id, shape_name)
    t0 = time.time()
    analysis = count_cell(cell, device)
    t_count = time.time() - t0
    return {
        "arch": arch_id,
        "shape": shape_name,
        "kind": cell.kind,
        "mesh": list(mesh.shape),
        "mesh_axes": list(mesh.axis_names),
        "devices": mesh.size,
        "count_device": str(device),
        "count_s": round(t_count, 2),
        "memory": {
            "argument_size_in_bytes": cell.argument_bytes_per_device(mesh),
            "output_size_in_bytes": None,
            "temp_size_in_bytes": None,
        },
        # global quantities: the whole program's
        "hlo_flops": analysis["flops"],
        "hlo_bytes": analysis["hbm_bytes"],
        "collective_bytes": None,
        "collectives_per_device": None,
        "n_ops": analysis["n_ops"],
        "why": dict(WHY),
        "model_flops": cell.model_flops,
        "comment": cell.comment,
    }


def roofline_terms(record: dict, chips: int | None = None) -> dict:
    """The reference's roofline (seconds) on the H100's peaks; the
    collective term is left out while its bytes are unknown."""
    chips = chips or record["devices"]
    terms = {
        "compute_s": record["hlo_flops"] / (chips * mesh_mod.PEAK_FLOPS_BF16),
        "memory_s": record["hlo_bytes"] / (chips * mesh_mod.HBM_BW),
    }
    if record["collective_bytes"] is not None:
        terms["collective_s"] = record["collective_bytes"] / (
            chips * mesh_mod.NVLINK_BW)
    dominant = max(terms, key=terms.get)
    useful = record["model_flops"] / max(record["hlo_flops"], 1.0)
    bound = max(terms.values())
    return {**terms, "dominant": dominant, "useful_flops_ratio": useful,
            "roofline_fraction": (record["model_flops"] /
                                  (chips * mesh_mod.PEAK_FLOPS_BF16)) / bound
            if bound > 0 else 0.0}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--device", default=None,
                    help="device of the fake tensors (default: the card)")
    ap.add_argument("--out", default="build/dryrun_torch")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.all:
        todo = list(cells_mod.iter_cells())
    else:
        todo = [(args.arch, args.shape, None)]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = 0
    for multi_pod in meshes:
        tag = "multipod" if multi_pod else "singlepod"
        for arch_id, shape_name, skip in todo:
            name = f"{arch_id}__{shape_name}__{tag}"
            path = out_dir / f"{name}.json"
            if skip is not None:
                path.write_text(json.dumps(
                    {"arch": arch_id, "shape": shape_name, "skipped": skip},
                    indent=2))
                print(f"[SKIP] {name}: {skip}")
                continue
            if path.exists():
                print(f"[CACHED] {name}")
                continue
            try:
                rec = run_cell(arch_id, shape_name, multi_pod, device)
                rec["roofline"] = roofline_terms(rec)
                path.write_text(json.dumps(rec, indent=2))
                r = rec["roofline"]
                print(f"[OK] {name}: count={rec['count_s']}s "
                      f"flops={rec['hlo_flops']:.3e} "
                      f"bytes={rec['hlo_bytes']:.3e}B "
                      f"args={rec['memory']['argument_size_in_bytes']:.3e}B"
                      f"/device dominant={r['dominant']} "
                      f"frac={r['roofline_fraction']:.3f}", flush=True)
            except Exception as e:  # noqa: BLE001 — report and continue
                failures += 1
                print(f"[FAIL] {name}: {e}")
                (out_dir / f"{name}.err").write_text(traceback.format_exc())
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
