"""The plan of launch-layer cells that ``chip_smoke.py`` runs on the card
(phase 12's ``CELL_RUNS`` and phase 18's ``CELL_PLAN``), on the CPU.

* Together the two cover each of the reference table's 37 counted cells
  exactly once, and ``CELL_SKIPS`` names its 3 skipped ``long_500k``
  cells.
* Each cut names only fields that exist (the shape's batch or sequence,
  a field of the arch's published config) and cuts: no value above the
  published one.
* At smoke configs, a cut LM, flux and UNet cell built by
  ``_phase12_cell`` through the launch layer's own constructors counts the
  same FLOPs on fake and on real tensors, and its control
  (``control_cut``: one layer or double block fewer, one batch element
  fewer, or more at a batch of 1) counts other FLOPs.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import base as tbase
from repro_torch.launch import cells as tcells
from repro_torch.launch import dryrun
from repro_torch.launch.hloanalysis import analyze

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

PLAN = [(a, s, cut, held) for a, s, cut, held in chip_smoke.CELL_PLAN]
RUNS = [(a, s) for a, s, _, _ in chip_smoke.CELL_RUNS]


@pytest.fixture(autouse=True)
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_plan_covers_every_counted_cell_once():
    counted = [(a, s) for a, s, skip in tcells.iter_cells() if skip is None]
    skipped = {(a, s) for a, s, skip in tcells.iter_cells()
               if skip is not None}
    planned = RUNS + [(a, s) for a, s, _, _ in PLAN]
    assert len(counted) == 37 and len(PLAN) == 33
    assert sorted(planned) == sorted(counted)
    assert len(set(planned)) == len(planned)
    assert set(chip_smoke.CELL_SKIPS) == skipped
    assert len(chip_smoke.CELL_SKIPS) == 3
    assert {s for _, s in chip_smoke.CELL_SKIPS} == {"long_500k"}


def _fields(arch) -> set:
    return {f.name for f in dataclasses.fields(arch.config)}


@pytest.mark.parametrize("entry", PLAN, ids=[f"{a}/{s}" for a, s, _, _
                                             in PLAN])
def test_cuts_name_fields_that_exist(entry):
    """Every cut and held field is the shape's batch (or an LM's
    sequence) or a field of the published config, at a value no larger
    than the published one (element by element for a tuple of depths or
    levels, of which a held cut may keep the first ones only)."""
    arch_id, shape_name, cut, held = entry
    arch = tbase.get_arch(arch_id)
    allowed = _fields(arch) | {"batch"} | (
        {"seq_len"} if arch.family == "lm" else set())
    for k, v in {**cut, **(held or {})}.items():
        assert k in allowed, k
        pub = chip_smoke.published(arch_id, shape_name, k)
        if isinstance(pub, tuple):
            assert 0 < len(v) <= len(pub) and all(
                0 <= a <= b for a, b in zip(v, pub))
            assert len(v) == len(pub) or k not in cut
        else:
            assert 0 < v < pub
    for k in cut.keys() & (held or {}).keys():
        assert held[k] <= cut[k]


@pytest.mark.parametrize("entry", PLAN, ids=[f"{a}/{s}" for a, s, _, _
                                             in PLAN])
def test_plan_cells_build(entry):
    """The run's cell, the held one and the control's build through the
    launch layer's constructors (on fake tensors: nothing is allocated), the
    run's at its cut (its batch, its layers) and of its shape's kind."""
    arch_id, shape_name, cut, held = entry
    cell = chip_smoke._phase12_cell(arch_id, shape_name, **cut)
    assert cell.kind == tbase.get_arch(arch_id).shapes[shape_name].kind
    held_cut = {**cut, **(held or {})}
    for c in (chip_smoke._phase12_cell(arch_id, shape_name, **held_cut),
              chip_smoke._phase12_cell(arch_id, shape_name,
                                       **chip_smoke.control_cut(
                                           arch_id, shape_name, held_cut))):
        assert c.kind == cell.kind
    batch = cell.abstract_args[1]
    first = next(v for k, v in sorted(batch.items()) if k in (
        "tokens", "token", "images", "latents"))
    assert first.shape[0] == cut.get(
        "batch", chip_smoke.published(arch_id, shape_name, "batch"))
    params = cell.abstract_args[0]
    params = params["params"] if cell.kind == "train" else params
    if "n_layers" in cut:
        assert params["layers"]["ln1"]["scale"].shape[0] == cut["n_layers"]


def test_control_at_batch_one_takes_two():
    assert chip_smoke.control_cut("vit_b16", "serve_b1", {}) == {"batch": 2}
    assert chip_smoke.control_cut("resnet_50", "cls_384", {}) == {
        "batch": 63}
    assert chip_smoke.control_cut("granite_34b", "prefill_32k", {
        "n_layers": 1, "batch": 1}) == {"n_layers": 0, "batch": 1}


def test_unknown_field_is_refused():
    with pytest.raises(TypeError):
        chip_smoke._phase12_cell("vit_b16", "cls_224", n_blocks=3)


def _smoke_arch(arch_id):
    """``arch_id`` at its smoke config, its shapes cut to a few tokens or
    pixels."""
    arch = _REAL_GET_ARCH(arch_id)
    small = {"lm": dict(seq_len=32, global_batch=2),
             "vision": dict(img_res=32, batch=2),
             "diffusion": dict(img_res=64, batch=2)}[arch.family]
    shapes = {k: dataclasses.replace(v, **small)
              for k, v in arch.shapes.items()}
    return dataclasses.replace(arch, config=arch.smoke, shapes=shapes)


_REAL_GET_ARCH = tbase.get_arch


def _fake_and_real(cell):
    fake = dryrun.count_cell(cell, "cpu")
    first, data = tcells.materialize(cell, device="cpu", seed=7)
    real = analyze(cell.step, first, data)
    return fake, real


@pytest.mark.parametrize("arch_id,shape_name,cut", [
    ("mixtral_8x22b", "train_4k", {"n_layers": 1}),
    ("granite_34b", "decode_32k", {"n_layers": 1, "batch": 1}),
    ("flux_dev", "train_1024", {"n_double_blocks": 1, "n_single_blocks": 1}),
    ("unet_sdxl", "gen_1024", {"transformer_depth": (1, 1, 1),
                               "n_res_blocks": 1})],
    ids=["lm_train", "lm_decode", "flux_train", "unet_gen"])
def test_cut_cell_counts_alike_and_control_differs(arch_id, shape_name, cut,
                                                   monkeypatch):
    """The cut cell is the cut config's (its parameters have the cut's
    depth), counts the same FLOPs (and FLOPs by dtype) on fake and real
    tensors, and its control counts other FLOPs."""
    monkeypatch.setattr(tbase, "get_arch", _smoke_arch)
    cell = chip_smoke._phase12_cell(arch_id, shape_name, **cut)
    fake, real = _fake_and_real(cell)
    assert fake["flops"] == real["flops"] > 0
    assert fake["flops_by_dtype"] == real["flops_by_dtype"]
    ctl_cut = chip_smoke.control_cut(arch_id, shape_name, cut)
    assert ctl_cut != cut
    ctl = dryrun.count_cell(chip_smoke._phase12_cell(arch_id, shape_name,
                                                     **ctl_cut), "cpu")
    assert ctl["flops"] != fake["flops"]
    params = cell.abstract_args[0]
    params = params["params"] if cell.kind == "train" else params
    if "n_layers" in cut:
        assert params["layers"]["ln1"]["scale"].shape[0] == cut["n_layers"]
    if "batch" in cut:
        assert cell.abstract_args[1]["token"].shape[0] == cut["batch"]
