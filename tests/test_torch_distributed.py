"""The port's multi-device path on the CPU: ``torch.distributed`` over
gloo, one subprocess a rank (the reference holds its own path on 8 forced
host devices in a subprocess, ``tests/test_distributed_integration.py``).

The fixture :func:`job` runs 8 gloo ranks of the port (``WORKER``, one
subprocess a rank, a ``file://`` store under ``tmp_path``, one thread a
rank) beside one JAX subprocess of the reference on 8 forced host
devices (``REF_SCRIPT``), both on the same inputs (the reference's
``init_params`` and a seeded numpy draw, converted for the port by
``from_jax_params``):

* ``moe_block_a2a`` on a (2, 4) ``("data", "model")`` mesh against the
  reference's ``moe_block_a2a`` under ``shard_map`` on the same mesh, at
  ``capacity_factor`` 16 (no drops) and 1 (drops): the output and the
  aux within 1e-5, every gradient leaf of ``sum(out**2)`` within 1e-4
  (the reference's own limits); the port's also against its
  ``moe_block`` on each rank's 8-token slice (their concatenation, and
  the mean of their aux).  The control, ``moe_block`` on the whole
  batch at cf 1, misses.  A transformer forward with ``moe_a2a`` takes
  the all-to-all block on the mesh and equals the forward without one
  (cf 16).
* ``compressed_psum_step`` (bf16 and top-k) in the reference's
  data-parallel quadratic: 8 ranks, targets 0..7, SGD, 80 steps; within
  0.05 of the mean target, and the whole trajectory of ``w`` equal to
  the reference script's.
* the elastic round trip: a (4, 2) mesh saves a sharded tensor
  gathered, ``remesh_plan`` on 4 healthy devices, ``remesh`` over ranks
  0-3 (ranks 4-7 sit out: no coordinate), each rank's block restored bit
  for bit, the manifest's signature.

In this process: a world-1 gloo mesh leaves the MoE, transformer and
train-step results bit for bit as they are with no mesh; the active mesh
and the cost analysis's axis sizes stay apart; and the all-to-all's wire
bytes of the per-rank block on a fake process group of 8 ranks.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import mixtral_8x22b as tmixtral
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as TS
from repro_torch.launch.mesh import MeshSpec
from repro_torch.models import transformer as TT
from repro_torch.training import optimizer as topt
from repro_torch.training import steps as tsteps

REPO = pathlib.Path(__file__).resolve().parent.parent
WORLD = 8
TIMEOUT = 300
# the reference test's MoE block (tests/test_distributed_integration.py)
MOE_KW = dict(name="m", n_layers=1, d_model=32, n_heads=4, n_kv_heads=4,
              d_head=8, d_ff=0, vocab_size=11, moe=True, n_experts=8,
              moe_top_k=2, d_ff_expert=16, sequence_parallel=True,
              moe_a2a=True)
CFS = (16.0, 1.0)
MODES = ("bf16", "topk")
KEYS = ("router", "w_gate", "w_up", "w_down")

REF_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.distributed.sharding import shard_map
    from repro.models import transformer as T
    from repro.training import compression as comp
    from repro.training import optimizer as opt_mod

    d = sys.argv[1]
    kw = json.loads(sys.argv[2])
    inp = np.load(f"{d}/inputs.npz")
    p = {k: jnp.asarray(inp[k]) for k in ("router", "w_gate", "w_up",
                                           "w_down")}
    x = jnp.asarray(inp["x"])
    out = {}
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    for cf in (16.0, 1.0):
        cfg = T.TransformerConfig(capacity_factor=cf, **kw)
        with mesh:
            xs = jax.device_put(x, NamedSharding(mesh, P(("data", "model"),
                                                         None)))
            o, aux = jax.jit(lambda p, x: T.moe_block_a2a(p, x, cfg))(p, xs)
            g = jax.jit(jax.grad(lambda p, x: jnp.sum(
                T.moe_block_a2a(p, x, cfg)[0] ** 2)))(p, xs)
        out[f"out_{cf}"] = np.asarray(o)
        out[f"aux_{cf}"] = np.asarray(aux)
        for k in g:
            out[f"grad_{cf}_{k}"] = np.asarray(g[k])

    # the data-parallel quadratic of test_compressed_psum_shard_map_converges
    mesh = jax.make_mesh((8,), ("data",))
    opt = opt_mod.sgd(lr=0.1, momentum=0.0)
    targets = jnp.arange(8.0)
    for mode in ("bf16", "topk"):
        params = {"w": jnp.zeros(())}
        state = opt.init(params)
        cstate = comp.CompressionState.zeros_like({"w": jnp.zeros(())})

        @jax.jit
        def step(params, state, cstate, targets):
            def inner(p, tgt, cres):
                grads = {"w": 2 * (p["w"] - tgt[0])}
                mean, new_c = comp.compressed_psum_step(
                    grads, comp.CompressionState({"w": cres}), "data",
                    mode=mode)
                return mean["w"], new_c.residual["w"]

            mean_g, new_res = shard_map(
                inner, mesh=mesh, in_specs=(P(), P("data"), P()),
                out_specs=(P(), P()), check_vma=False,
            )(params, targets, cstate.residual["w"])
            new_params, new_state = opt.update({"w": mean_g}, params, state)
            return new_params, new_state, comp.CompressionState(
                {"w": new_res})

        traj = []
        for _ in range(80):
            params, state, cstate = step(params, state, cstate, targets)
            traj.append(np.asarray(params["w"]))
        out[f"w_{mode}"] = np.stack(traj)
    np.savez(f"{d}/ref.npz", **out)
""")

WORKER = textwrap.dedent("""
    import sys
    import torch
    torch.set_num_threads(1)
    import dataclasses, json
    import numpy as np
    import torch.distributed as dist
    from repro_torch.checkpoint.checkpoint import (CheckpointManager,
                                                   restore_local,
                                                   save_gathered)
    from repro_torch.configs import mixtral_8x22b as mx
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import elastic
    from repro_torch.distributed.sharding import P, use_mesh
    from repro_torch.models import transformer as T
    from repro_torch.training import compression as comp
    from repro_torch.training import optimizer as opt_mod

    rank, d = int(sys.argv[1]), sys.argv[2]
    kw = json.loads(sys.argv[3])
    res = {}
    mesh = C.init_mesh((2, 4), ("data", "model"), "cpu", rank=rank,
                       store=f"{d}/store")
    flat = ("data", "model")
    inp = np.load(f"{d}/inputs.npz")
    p_full = T.from_jax_params({k: inp[k] for k in
                                ("router", "w_gate", "w_up", "w_down")},
                               "cpu")
    x = torch.from_numpy(inp["x"])
    for cf in (16.0, 1.0):
        cfg = T.TransformerConfig(capacity_factor=cf, **kw)
        p = {k: v.clone().requires_grad_()
             for k, v in T.moe_local_experts(p_full, mesh).items()}
        xl = C.local_shard(x, mesh, P(flat, None))
        with use_mesh(mesh):
            out, aux = T.moe_block_a2a(p, xl, cfg)
        (out ** 2).sum().backward()
        res[f"out_{cf}"] = C.gather(out, mesh, P(flat, None))
        res[f"aux_{cf}"] = aux.detach()
        # the objective is the sum of the ranks' losses: the replicated
        # router's gradient sums over every rank, an expert slice's over
        # the data ranks that hold it
        res[f"grad_{cf}_router"] = C.psum(p["router"].grad, flat, mesh)
        for k in ("w_gate", "w_up", "w_down"):
            res[f"grad_{cf}_{k}"] = C.gather(
                C.psum(p[k].grad, "data", mesh), mesh, T.MOE_EXPERT_SPEC)

    # a forward with moe_a2a on the mesh against the forward with none
    cfg = dataclasses.replace(mx.smoke_config(), capacity_factor=16.0,
                              moe_a2a=True, sequence_parallel=True)
    params = T.init_params(torch.Generator().manual_seed(3), cfg, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 32),
                           generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        plain, plain_aux = T.forward(params, tokens, cfg)
        calls = []
        blk = T.moe_block_a2a
        T.moe_block_a2a = lambda *a, **k: calls.append(1) or blk(*a, **k)
        with use_mesh(mesh):
            meshed, meshed_aux = T.forward(params, tokens, cfg)
        T.moe_block_a2a = blk
    res["fwd_err"] = torch.tensor(float((meshed - plain).abs().max()))
    res["fwd_aux"] = torch.stack([plain_aux, meshed_aux])
    res["fwd_a2a_calls"] = torch.tensor(len(calls))

    # compressed_psum_step in the reference's data-parallel quadratic
    mesh8 = C.init_mesh((8,), ("data",), "cpu")
    opt = opt_mod.sgd(lr=0.1, momentum=0.0)
    for mode in ("bf16", "topk"):
        params = {"w": torch.zeros(())}
        state = opt.init(params)
        cstate = comp.CompressionState.zeros_like(params)
        traj = []
        for _ in range(80):
            grads = {"w": 2 * (params["w"] - float(rank))}
            mean, cstate = comp.compressed_psum_step(grads, cstate, "data",
                                                     mode, mesh8)
            params, state = opt.update(mean, params, state)
            traj.append(params["w"])
        res[f"w_{mode}"] = torch.stack(traj)

    # elastic: save on (4, 2), lose 4 devices, restore on the plan's mesh
    mesh42 = C.init_mesh((4, 2), ("data", "model"), "cpu")
    spec = P("data", "model")
    w = torch.arange(32.0).reshape(8, 4)
    mgr = CheckpointManager(f"{d}/ckpt")
    save_gathered(mgr, 1, {"w": C.local_shard(w, mesh42, spec)}, mesh42,
                  {"w": spec})
    plan = elastic.remesh_plan((4, 2), ("data", "model"), healthy_devices=4)
    new = elastic.remesh(plan, "cpu")
    coord = new.get_coordinate()
    el = {"coord": None if coord is None else list(coord),
          "plan": {k: list(v) if isinstance(v, tuple) else v
                   for k, v in plan.items()},
          "manifest": mgr.manifest(1)["mesh"]}
    if coord is not None:
        got = restore_local(mgr, 1, {"w": torch.zeros(8, 4)}, new,
                            {"w": spec})["w"]
        want = C.local_shard(w, new, spec)
        el["block"] = got.tolist()
        el["bit_equal"] = bool(torch.equal(got, want))
        el["gathered_equal"] = bool(torch.equal(C.gather(got, new, spec), w))
    with open(f"{d}/elastic_{rank}.json", "w") as f:
        json.dump(el, f)
    C.barrier(mesh)
    if rank == 0:
        np.savez(f"{d}/port.npz", **{k: v.detach().numpy()
                                     for k, v in res.items()})
    dist.destroy_process_group()
""")


def _env() -> dict:
    env = dict(os.environ)
    env.update(PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    return env


def _wait(procs: list, what: str) -> None:
    for i, proc in enumerate(procs):
        try:
            _, err = proc.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise
        assert proc.returncode == 0, f"{what} {i}: {err[-3000:]}"


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """Writes the inputs, runs the reference's subprocess and the port's 8
    ranks side by side, and returns their results."""
    import jax
    from repro.models import transformer as jT

    d = tmp_path_factory.mktemp("dist")
    cfg = jT.TransformerConfig(**MOE_KW)
    p = jax.tree.map(lambda a: np.asarray(a[0]),
                     jT.init_params(jax.random.PRNGKey(0), cfg)
                     ["layers"]["moe"])
    x = np.random.default_rng(1).standard_normal((64, 32)).astype(np.float32)
    np.savez(d / "inputs.npz", x=x, **p)
    kw = json.dumps(MOE_KW)
    pipe = dict(stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
                env=_env(), cwd=REPO)
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(d), kw],
                           **pipe)
    ranks = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(d),
                               kw], **pipe) for r in range(WORLD)]
    _wait(ranks, "port rank")
    _wait([ref], "reference")
    return (dict(np.load(d / "ref.npz")), dict(np.load(d / "port.npz")),
            [json.loads((d / f"elastic_{r}.json").read_text())
             for r in range(WORLD)], {k: p[k] for k in KEYS}, x)


def _cfg(cf: float) -> TT.TransformerConfig:
    return TT.TransformerConfig(capacity_factor=cf, **MOE_KW)


def _max(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


@pytest.mark.parametrize("cf", CFS)
def test_moe_a2a_forward_matches_reference(job, cf):
    ref, port, *_ = job
    assert port[f"out_{cf}"].shape == (64, 32)
    assert _max(port[f"out_{cf}"], ref[f"out_{cf}"]) < 1e-5
    assert _max(port[f"aux_{cf}"], ref[f"aux_{cf}"]) < 1e-5


@pytest.mark.parametrize("cf", CFS)
def test_moe_a2a_gradients_match_reference(job, cf):
    ref, port, *_ = job
    for k in KEYS:
        assert port[f"grad_{cf}_{k}"].shape == ref[f"grad_{cf}_{k}"].shape
        assert np.abs(ref[f"grad_{cf}_{k}"]).max() > 0, k
        assert _max(port[f"grad_{cf}_{k}"], ref[f"grad_{cf}_{k}"]) < 1e-4, k


def _per_slice(p, x, cf):
    """The port's moe_block on each rank's 8-token slice: (their outputs
    concatenated, the mean of their aux)."""
    tp = TT.from_jax_params(p, "cpu")
    outs = [TT.moe_block(tp, torch.from_numpy(x[i * 8:(i + 1) * 8]),
                         _cfg(cf)) for i in range(WORLD)]
    return (torch.cat([o for o, _ in outs]).numpy(),
            float(torch.stack([a for _, a in outs]).mean()))


@pytest.mark.parametrize("cf", CFS)
def test_moe_a2a_is_moe_block_on_each_rank_slice(job, cf):
    _, port, _, p, x = job
    out, aux = _per_slice(p, x, cf)
    assert _max(port[f"out_{cf}"], out) < 1e-5
    assert abs(float(port[f"aux_{cf}"]) - aux) < 1e-5


def test_whole_batch_moe_block_control_misses_with_drops(job):
    """At cf 1 the ranks drop picks by their own 8 tokens' capacity: the
    whole-batch block (one capacity for 64 tokens) is not the a2a block,
    while at cf 16 (no drops) it is."""
    ref, _, _, p, x = job
    tp = TT.from_jax_params(p, "cpu")
    for cf, missed in ((1.0, True), (16.0, False)):
        out, _ = TT.moe_block(tp, torch.from_numpy(x), _cfg(cf))
        assert (_max(out.numpy(), ref[f"out_{cf}"]) > 1e-2) == missed, cf


def test_forward_takes_the_a2a_block_on_the_mesh(job):
    """The hidden states equal the forward with no mesh (no drops at cf
    16); the aux does not: the all-to-all block balances each rank's own
    tokens and averages the ranks' aux, as the reference's does."""
    _, port, *_ = job
    assert int(port["fwd_a2a_calls"]) == 2  # one a layer, on rank 0
    assert float(port["fwd_err"]) < 1e-5
    assert np.isfinite(port["fwd_aux"]).all()


@pytest.mark.parametrize("mode", MODES)
def test_compressed_psum_converges(job, mode):
    _, port, *_ = job
    assert abs(float(port[f"w_{mode}"][-1]) - 3.5) < 0.05


@pytest.mark.parametrize("mode", MODES)
def test_compressed_psum_matches_reference(job, mode):
    """The whole trajectory of ``w``.  In bf16 bit for bit: each rank's
    payload has 8 significant bits, so the 8 ranks' float32 sum is exact
    in any order.  Top-k at ratio 0.1 of a scalar keeps the whole float32
    gradient, whose 8-term sum rounds by its order (gloo's ring against
    XLA's reduction): within 1e-6, a few float32 ulps at |w| <= 3.5."""
    ref, port, *_ = job
    if mode == "bf16":
        np.testing.assert_array_equal(port[f"w_{mode}"], ref[f"w_{mode}"])
    else:
        np.testing.assert_allclose(port[f"w_{mode}"], ref[f"w_{mode}"],
                                   rtol=0, atol=1e-6)


def test_elastic_checkpoint_remesh_roundtrip(job):
    from repro.distributed.elastic import remesh_plan

    *_, elastic, _, _ = job
    plan = remesh_plan((4, 2), ("data", "model"), healthy_devices=4)
    assert plan["devices_used"] == 4
    want = np.arange(32.0).reshape(8, 4)
    for r, el in enumerate(elastic):
        assert el["plan"] == {k: list(v) if isinstance(v, tuple) else v
                              for k, v in plan.items()}
        assert el["manifest"] == {"shape": [4, 2], "axes": ["data", "model"]}
        if r >= 4:
            assert el["coord"] is None and "block" not in el
            continue
        assert el["coord"] == [r // 2, r % 2]
        assert el["bit_equal"] and el["gathered_equal"]
        i, j = el["coord"]
        np.testing.assert_array_equal(el["block"],
                                      want[4 * i:4 * i + 4, 2 * j:2 * j + 2])


# -- one rank, in this process ------------------------------------------------


def _mixtral(**kw):
    return dataclasses.replace(tmixtral.smoke_config(), capacity_factor=1.0,
                               moe_a2a=True, sequence_parallel=True, **kw)


def _bits(tree) -> list:
    from repro_torch import pytree

    return [t.detach().clone() for t in pytree.leaves(tree)]


def _same(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _runs() -> dict:
    """The MoE block, a prefill and a train step of the mixtral smoke
    config with the mesh switches on (float32, cf 1: drops)."""
    cfg = _mixtral()
    params = TT.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen)
    x = torch.randn(48, cfg.d_model, generator=gen)
    moe = TT.moe_block(TT._layer_params(params, 0)["moe"], x, cfg)
    logits, cache = TT.prefill(params, tokens, cfg, 32)
    opt = topt.adamw(lr=1e-3)
    state = tsteps.make_state(params, opt)
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}
    state, metrics = tsteps.lm_train_step(cfg, opt)(state, batch)
    return {"moe": _bits(moe), "prefill": _bits([logits, cache.k, cache.v]),
            "train": _bits([state, metrics])}


class TestOneRankMesh:
    @pytest.fixture(scope="class")
    def mesh(self, tmp_path_factory):
        store = tmp_path_factory.mktemp("w1") / "store"
        mesh = C.init_mesh((1, 1), ("data", "model"), "cpu", rank=0,
                           store=str(store))
        yield mesh
        import torch.distributed as dist

        dist.destroy_process_group()

    @pytest.fixture(scope="class")
    def runs(self, mesh):
        plain = _runs()
        with TS.use_mesh(mesh):
            meshed = _runs()
        return plain, meshed

    @pytest.mark.parametrize("what", ["moe", "prefill", "train"])
    def test_world1_mesh_gives_the_same_bits(self, runs, what):
        plain, meshed = runs
        assert _same(plain[what], meshed[what])

    def test_world1_a2a_block_is_moe_block(self, mesh):
        """At one model rank the exchange moves nothing: the a2a block's
        output, aux and gradients are moe_block's, bit for bit."""
        cfg = _mixtral()
        p = TT._layer_params(TT.init_params(
            torch.Generator().manual_seed(0), cfg, "cpu"), 0)["moe"]
        x = torch.randn(48, cfg.d_model,
                        generator=torch.Generator().manual_seed(2))
        res = []
        for blk in (TT.moe_block, TT.moe_block_a2a):
            pg = {k: v.clone().requires_grad_() for k, v in p.items()}
            with TS.use_mesh(mesh):
                out, aux = blk(pg, x, cfg)
            (out ** 2).sum().backward()
            res.append([out.detach(), aux.detach()]
                       + [pg[k].grad for k in KEYS])
        assert _same(*res)

    def test_active_mesh_is_read_and_kept_apart(self, mesh):
        assert TS.current_mesh() is None and TS.mesh_axis_size("model") == 1
        TS.set_mesh_axis_sizes(MeshSpec((16, 16), ("data", "model")))
        try:
            with TS.use_mesh(mesh):
                assert TS.current_mesh() is mesh
                assert TS.mesh_axis_size("model") == 1
                assert TS.mesh_axis_size("data") == 1
                assert TS.mesh_axis_size("pod") == 1
                # the cost analysis's record is not the active mesh's
                assert TS._axis_size("model") == 16
                assert TS.adapt_spec(TS.P(("pod", "data"), "model")) \
                    == TS.P("data", "model")
                TS.set_mesh_axis_sizes(MeshSpec((4,), ("model",)))
                assert TS.current_mesh() is mesh
                assert TS.mesh_axis_size("model") == 1
            assert TS.current_mesh() is None
            assert TS._axis_size("model") == 4
        finally:
            TS._MESH_SIZES = {}

    def test_shard_map_blocks_and_refuses_grad(self, mesh):
        x = torch.arange(12.0).reshape(4, 3)
        f = TS.shard_map(lambda a, b: (a * 2, b.sum()), mesh=mesh,
                         in_specs=(TS.P(("data", "model"), None), TS.P()),
                         out_specs=(TS.P(("data", "model"), None), TS.P()))
        a, b = f(x, x)
        assert torch.equal(a, x * 2) and torch.equal(b, x.sum())
        with pytest.raises(RuntimeError, match="differentiable"):
            f(x.clone().requires_grad_(), x)
        assert C.local_shard(x, mesh, TS.P("data", "model")) is not None
        with pytest.raises(ValueError, match="order"):
            C.local_shard(x, mesh, TS.P(("model", "data")))

    @pytest.mark.parametrize("mode", MODES)
    def test_world1_compressed_psum_is_the_compressor(self, mesh, mode):
        from repro_torch.training import compression as comp

        g = {"a": torch.randn(5, 7, generator=torch.Generator()
                              .manual_seed(3)), "b": torch.randn(11)}
        st = comp.CompressionState.zeros_like(g)
        mean, new = comp.compressed_psum_step(g, st, "data", mode, mesh)
        if mode == "bf16":
            payload, want_st = comp.bf16_compress(g, st)
            want = comp.bf16_decompress(payload)
        else:
            payload, want_st = comp.topk_compress(g, st)
            want = comp.topk_decompress(payload, g)
        assert _same(_bits(mean), _bits(want))
        assert _same(_bits(new.residual), _bits(want_st.residual))

    def test_world1_other_modes_are_topk(self, mesh):
        """The reference's ``compressed_psum_step`` takes every mode but
        ``"bf16"`` as top-k (its ``else`` branch,
        ``src/repro/training/compression.py``); so does the port."""
        from repro_torch.training import compression as comp

        g = {"a": torch.randn(5, 7, generator=torch.Generator()
                              .manual_seed(3)), "b": torch.randn(11)}
        st = comp.CompressionState.zeros_like(g)
        none = comp.compressed_psum_step(g, st, "data", "none", mesh)
        topk = comp.compressed_psum_step(g, st, "data", "topk", mesh)
        assert _same(_bits(none[0]), _bits(topk[0]))
        assert _same(_bits(none[1].residual), _bits(topk[1].residual))


def test_a2a_wire_bytes_on_a_fake_process_group():
    """``hloanalysis.analyze`` of one rank's ``moe_block_a2a`` on the
    (2, 4) mesh of a fake 8-rank process group, on fake tensors: two
    all-to-alls of E * capacity * D elements each (the reference
    docstring's tokens * k * D / model ranks a link, with no drops), and
    the aux's mean over the two axes."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.hloanalysis import analyze

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=WORLD)
    try:
        mesh = C.init_mesh((2, 4), ("data", "model"), "cpu")
        cfg = _cfg(16.0)
        e, d, tl = cfg.n_experts, cfg.d_model, 64 // WORLD
        cap = TT.moe_capacity(cfg, tl)
        with FakeTensorMode():
            p = {"router": torch.empty(d, e),
                 "w_gate": torch.empty(e // 4, d, cfg.d_ff_expert),
                 "w_up": torch.empty(e // 4, d, cfg.d_ff_expert),
                 "w_down": torch.empty(e // 4, cfg.d_ff_expert, d)}
            x = torch.empty(tl, d)
            with TS.use_mesh(mesh):
                a = analyze(TT.moe_block_a2a, p, x, cfg)
    finally:
        dist.destroy_process_group()
    assert cap * e == tl * cfg.moe_top_k * 16  # cf 16: no drops
    assert a["collectives"]["all-to-all"] == {
        "bytes": float(2 * e * cap * d * 4), "count": 2.0}
    assert a["collectives"]["all-reduce"] == {"bytes": 8.0, "count": 2.0}
