"""The launch layer's sharding rules, meshes and cells
(``repro_torch.distributed.sharding``, ``repro_torch.launch.mesh``,
``repro_torch.launch.cells``) against the reference's.

The reference's side needs the production meshes, 256 and 512 devices,
which JAX builds only on placeholder host devices requested before its
first import.  It runs once, in one subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=512`` (as its dry
run does; ~15 s on a CPU, JAX's import included, ~8 s of it the
``"seconds"`` it writes), and writes what the tests compare as JSON:
each arch's spec tree of its full-size parameters (``jax.eval_shape``),
and for each of the 37 built cells its abstract arguments, its
``model_flops`` and its ``in_shardings`` on both meshes, with each
leaf's per-device shard shape.  The port's side builds its parameters on
fake tensors.  Everything compares exactly.

The port's conv kernels are OIHW (stacked ``(L, O, I, kh, kw)``), the
reference's HWIO (``(L, kh, kw, I, O)``): for those leaves the port's
shape and adapted spec must be the reference's, permuted the same way.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from repro.configs import base as jbase
from repro.models import diffusion as JDiff
from repro.models import vision as JV
from repro_torch import pytree
from repro_torch.configs import base as tbase
from repro_torch.distributed import sharding as tshd
from repro_torch.launch import cells as tcells
from repro_torch.launch import mesh as tmesh
from repro_torch.models import diffusion as TDiff
from repro_torch.models import vision as TV

ROOT = Path(__file__).resolve().parents[1]

BUILT = [(a, s) for a, s, skip in tcells.iter_cells() if skip is None]

_REF_DUMP = r'''
import os, json, sys, time
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
t0 = time.time()
import jax, numpy as np
from repro.configs import base as cfgbase
from repro.distributed import sharding as shd
from repro.launch import cells
from repro.launch import mesh as mesh_mod
from repro.models import diffusion as D, transformer as T, vision as V


def key(k):
    return k.key if hasattr(k, "key") else k.idx


def enc_spec(spec):
    return [list(a) if isinstance(a, tuple) else a for a in spec]


def params_abs(arch):
    cfg = arch.config
    key0 = jax.random.PRNGKey(0)
    if arch.family == "lm":
        return (jax.eval_shape(lambda: T.init_params(key0, cfg)),
                shd.lm_param_rules(n_experts=cfg.n_experts if cfg.moe else 0))
    if arch.family == "vision":
        init = {V.ViTConfig: V.vit_init, V.ConvNeXtConfig: V.convnext_init,
                V.ResNetConfig: V.resnet_init}[type(cfg)]
        return (jax.eval_shape(lambda: init(key0, cfg)),
                shd.vision_param_rules())
    init = D.mmdit_init if isinstance(cfg, D.MMDiTConfig) else D.unet_init
    return (jax.eval_shape(lambda: init(key0, cfg)),
            shd.diffusion_param_rules())


out = {"specs": {}, "cells": {}}
for arch_id in cfgbase.list_archs():
    arch = cfgbase.get_arch(arch_id)
    tree, rules = params_abs(arch)
    specs = shd.spec_tree(tree, rules)
    out["specs"][arch_id] = [
        [[key(k) for k in p], enc_spec(s)]
        for p, s in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]]
meshes = {"single": mesh_mod.make_production_mesh(multi_pod=False),
          "multi": mesh_mod.make_production_mesh(multi_pod=True)}
for arch_id, shape, skip in cells.iter_cells():
    if skip is not None:
        continue
    c = cells.build_cell(arch_id, shape)
    leaves = jax.tree_util.tree_flatten_with_path(c.abstract_args)[0]
    rec = {"args": [[[key(k) for k in p], list(a.shape), str(np.dtype(a.dtype))]
                    for p, a in leaves],
           "model_flops": c.model_flops, "kind": c.kind}
    for name, m in meshes.items():
        shardings = jax.tree.leaves(c.in_shardings(m))
        rec[name] = [[enc_spec(ns.spec), list(ns.shard_shape(a.shape))]
                     for ns, (_, a) in zip(shardings, leaves)]
    out["cells"][f"{arch_id}/{shape}"] = rec
out["seconds"] = time.time() - t0
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def ref():
    """The reference's side, from one subprocess on 512 host devices."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", _REF_DUMP], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout)


@pytest.fixture(scope="module")
def built():
    return {c: tcells.build_cell(*c) for c in BUILT}


def _spec(s) -> list:
    """A spec as the JSON lists the reference's side writes."""
    return [list(a) if isinstance(a, tuple) else a for a in s]


def _dtype(a) -> str:
    return "int32" if isinstance(a, int) else str(a.dtype).split(".")[-1]


def _conv_perm(nd: int) -> list[int]:
    """The reference's HWIO dims in the port's OIHW order."""
    lead = list(range(nd - 4))
    return lead + [nd - 1, nd - 2, nd - 4, nd - 3]


def _port_layout(ref_spec: list, ref_shape: list, port_shape: list) -> list:
    """The reference's spec moved to the port's layout: as it is where
    the shapes agree, permuted like an HWIO -> OIHW kernel where not."""
    if list(port_shape) == list(ref_shape):
        return ref_spec
    perm = _conv_perm(len(ref_shape))
    assert [ref_shape[i] for i in perm] == list(port_shape)
    parts = ref_spec + [None] * (len(ref_shape) - len(ref_spec))
    out = [parts[i] for i in perm]
    while out and out[-1] is None:
        out.pop()
    return out


# -- the pytree's paths --------------------------------------------------------


@pytest.mark.parametrize("arch", ["convnext_b", "unet_sdxl"])
def test_pytree_paths_match_jax(arch):
    """``flatten_with_path`` on the smoke trees (with their ``None``
    subtrees) gives ``jax.tree_util.tree_flatten_with_path``'s paths and
    leaves, in its order; ``tree_map_with_path`` keeps the structure."""
    jcfg = jbase.get_arch(arch).smoke
    init = JV.convnext_init if arch == "convnext_b" else JDiff.unet_init
    jtree = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), jax.eval_shape(
        lambda: init(jax.random.PRNGKey(0), jcfg)))
    assert any(v is None for v in jax.tree.leaves(
        jtree, is_leaf=lambda x: x is None))
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tflat, treedef = pytree.flatten_with_path(jtree)
    assert [tuple(k.key if hasattr(k, "key") else k.idx for k in p)
            for p, _ in jflat] == [p for p, _ in tflat]
    assert all(a is b for (_, a), (_, b) in zip(jflat, tflat))
    assert str(treedef) == str(jax.tree.structure(jtree))
    mapped = pytree.tree_map_with_path(lambda p, x: "/".join(map(str, p)),
                                       jtree)
    assert jax.tree.structure(mapped) == jax.tree.structure(jtree)
    assert pytree.leaves(mapped) == ["/".join(map(str, p)) for p, _ in tflat]
    # the port's own tree (OIHW kernels) has the same paths
    mod = TV if arch == "convnext_b" else TDiff
    ttree = mod.from_jax_params(jtree, device="cpu")
    assert [p for p, _ in pytree.flatten_with_path(ttree)[0]] == \
        [p for p, _ in tflat]


# -- sharding rules ------------------------------------------------------------


def _port_param_specs(arch_id: str):
    arch = tbase.get_arch(arch_id)
    cfg = arch.config
    if arch.family == "lm":
        from repro_torch.models import transformer as TT

        init, rules = TT.init_params, tshd.lm_param_rules(
            n_experts=cfg.n_experts if cfg.moe else 0)
    elif arch.family == "vision":
        init, rules = TV.init_params, tshd.vision_param_rules()
    else:
        init, rules = TDiff.init_params, tshd.diffusion_param_rules()
    with FakeTensorMode():
        params = init(torch.Generator(), cfg, "cpu")
        assert all(isinstance(x, FakeTensor) for x in pytree.leaves(params))
    return tshd.spec_tree(params, rules)


@pytest.mark.parametrize("arch_id", tbase.ARCH_IDS)
def test_spec_tree_matches_reference(ref, arch_id):
    """Every arch's full-size parameter paths map to the reference's
    specs, leaf by leaf in order (the rules are the reference's)."""
    got = [[list(p), _spec(s)] for p, s in pytree.flatten_with_path(
        _port_param_specs(arch_id))[0]]
    assert got == ref["specs"][arch_id]


def test_partition_spec_stand_in():
    from jax.sharding import PartitionSpec as JP

    p = tshd.P(None, ("pod", "data"), "model")
    assert tuple(p) == tuple(JP(None, ("pod", "data"), "model"))
    assert p == (None, ("pod", "data"), "model")
    assert list(p) == [None, ("pod", "data"), "model"] and len(p) == 3
    assert p[1] == ("pod", "data") and p != tshd.P(None, "data", "model")
    assert hash(p) == hash(tshd.P(None, ("pod", "data"), "model"))
    # a leaf of the port's trees, not a node
    assert pytree.leaves({"a": p, "b": [tshd.P()]}) == [p, tshd.P()]
    # adapted to a mesh: absent axes dropped, trailing Nones trimmed
    tshd.set_mesh_axis_sizes(tmesh.make_production_mesh())
    assert tshd.adapt_spec(tshd.P(tshd.BATCH, None)) == tshd.P("data")
    assert tshd.adapt_spec(tshd.P(None, "pod")) == tshd.P()
    assert tshd._axis_size(("data", "model")) == 256
    tshd.set_mesh_axis_sizes(tmesh.make_production_mesh(multi_pod=True))
    assert tshd.adapt_tree({"x": tshd.P(tshd.BATCH)}) == \
        {"x": tshd.P(("pod", "data"))}
    assert tshd._axis_size(tshd.BATCH) == 32


def test_one_device_activation_helpers_are_the_identity():
    x = torch.arange(6.0).reshape(2, 3)
    assert tshd.constrain(x, tshd.BATCH, "model") is x
    with tshd.no_activation_constraints():
        assert tshd.constrain(x, None) is x
    assert tshd.current_mesh() is None
    assert tshd.mesh_axis_size("model") == 1
    m = tmesh.make_host_mesh("cpu")
    named = tshd.tree_shardings(m, {"w": tshd.P(None, "model")})
    assert named["w"] == tshd.named(m, tshd.P(None, "model"))
    assert tshd.opt_state_specs({"w": tshd.P("data")})["step"] == tshd.P()


# -- meshes ----------------------------------------------------------------------


def test_meshes():
    single = tmesh.make_production_mesh()
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert (single.shape, single.axis_names, single.size) == (
        (16, 16), ("data", "model"), 256)
    assert (multi.shape, multi.axis_names, multi.size) == (
        (2, 16, 16), ("pod", "data", "model"), 512)
    assert single.devices is None and multi.devices is None
    host = tmesh.make_host_mesh("cpu")
    assert host.shape == (1, 1) and host.devices == (torch.device("cpu"),)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.make_host_mesh()
    # the H100 SXM's data-sheet peaks
    assert (tmesh.PEAK_FLOPS_BF16, tmesh.HBM_BW, tmesh.NVLINK_BW) == (
        989e12, 3.35e12, 900e9)


# -- cells -------------------------------------------------------------------------


def test_registry_covers_all_cells():
    cells = list(tcells.iter_cells())
    assert len(cells) == 40  # 10 archs x 4 shapes
    skipped = [c for c in cells if c[2] is not None]
    # exactly the three pure-full-attention LMs skip long_500k
    assert sorted(c[0] for c in skipped) == [
        "granite_34b", "qwen3_moe_235b_a22b", "smollm_135m"]
    assert all(c[1] == "long_500k" for c in skipped)
    with pytest.raises(ValueError, match="long_500k"):
        tcells.build_cell("smollm_135m", "long_500k")


@pytest.mark.parametrize("cell", BUILT, ids=lambda c: f"{c[0]}/{c[1]}")
def test_input_specs_and_model_flops_match_reference(ref, built, cell):
    """The abstract arguments' paths, shapes and dtypes (a host int for
    a () int32 scalar; conv kernels in the port's layout) and the
    analytic ``model_flops`` equal the reference's."""
    c, r = built[cell], ref["cells"]["/".join(cell)]
    flat = pytree.flatten_with_path(c.abstract_args, tcells._is_spec)[0]
    assert c.kind == r["kind"]
    assert len(flat) == len(r["args"])
    for (path, a), (rpath, rshape, rdtype) in zip(flat, r["args"]):
        assert list(path) == rpath
        shape = list(a.shape) if tcells._is_spec(a) else []
        if shape != rshape:
            assert shape == [rshape[i] for i in _conv_perm(len(rshape))], \
                path
        assert _dtype(a) == rdtype, path
    assert c.model_flops == r["model_flops"]
    assert tcells.input_specs(*cell) == c.abstract_args


@pytest.mark.parametrize("cell", BUILT, ids=lambda c: f"{c[0]}/{c[1]}")
def test_in_shardings_match_reference(ref, built, cell):
    """The specs adapted to both production meshes equal the
    reference's ``in_shardings(mesh).spec`` leaf by leaf (moved to the
    port's conv layout), and the per-device argument bytes equal the sum
    of the reference's shard shapes."""
    c, r = built[cell], ref["cells"]["/".join(cell)]
    flat, treedef = pytree.flatten(c.abstract_args, tcells._is_spec)
    for name, multi in (("single", False), ("multi", True)):
        m = tmesh.make_production_mesh(multi_pod=multi)
        specs = treedef.flatten_up_to(c.in_shardings(m))
        want_bytes = 0
        for a, spec, (rspec, rshard), (_, rshape, rdtype) in zip(
                flat, specs, r[name], r["args"]):
            shape = list(a.shape) if tcells._is_spec(a) else []
            assert _spec(spec) == _port_layout(rspec, rshape, shape)
            want_bytes += int(np.prod(rshard)) * np.dtype(rdtype).itemsize
        assert c.argument_bytes_per_device(m) == want_bytes


def test_materialize_fake_and_real():
    """Fake tensors of the specs' shapes and dtypes with no storage, and
    real seeded ones that a smoke cell's step runs on."""
    arch = tbase.get_arch("smollm_135m")
    arch = dataclasses.replace(arch, config=arch.smoke)
    shape = tbase.ShapeSpec("t", "train", seq_len=32, global_batch=2)
    c = tcells._lm_cell(arch, shape)
    fake = FakeTensorMode()
    args = tcells.materialize(c, fake, "cpu")
    flat = pytree.flatten(args)[0]
    specs = pytree.flatten(c.abstract_args, tcells._is_spec)[0]
    for x, s in zip(flat, specs):
        if tcells._is_spec(s):
            assert isinstance(x, FakeTensor)
            assert (tuple(x.shape), x.dtype) == (s.shape, s.dtype)
        else:
            assert x == s == 0
    state, batch = tcells.materialize(c, device="cpu", seed=3)
    state2, batch2 = tcells.materialize(c, device="cpu", seed=3)
    assert torch.equal(batch["tokens"], batch2["tokens"])
    assert int(batch["tokens"].max()) < arch.config.vocab_size
    assert all(not bool(t.any()) for t in pytree.leaves(state["opt"]["mu"]))
    new_state, metrics = c.step(state, batch)
    assert bool(torch.isfinite(metrics["loss"])) and metrics["step"] == 1
    assert new_state["step"] == 1
