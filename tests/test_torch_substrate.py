"""The port's training substrate against the reference's: the twin of
``tests/test_substrate.py``'s optimizer, compression, checkpoint and
pipeline tests, compression bit for bit, the data pipeline's arrays,
checkpoints that interchange between the packages, the tree order both
walk, the arch registry and the train launcher.

Inputs come from fixed numpy seeds.  Compression, the pipeline and the
checkpoints are held to the reference exactly (bit for bit); the
twins keep ``test_substrate.py``'s own tolerances.
"""

from __future__ import annotations

import dataclasses
import io
import json
import math
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import CheckpointManager as JManager
from repro.configs import base as jbase
from repro.data import pipeline as jpipe
from repro.data.synthetic import make_video as jmake_video
from repro.models import detector as JD
from repro.models import transformer as JT
from repro.models import vision as JV
from repro.training import compression as jcomp
from repro.training import optimizer as JO
from repro.training import steps as JS
from repro_torch import pytree
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import base as tbase
from repro_torch.data import pipeline as tpipe
from repro_torch.data.pipeline import Prefetcher, lm_batches
from repro_torch.data.synthetic import make_video
from repro_torch.launch import train as tlaunch
from repro_torch.models import diffusion as TDiff
from repro_torch.models import transformer as TT
from repro_torch.models import vision as TV
from repro_torch.training import compression as comp
from repro_torch.training import optimizer as opt_mod
from repro_torch.training import steps as TS


def _t(x):
    return torch.tensor(x, dtype=torch.float32)


# --------------------------------------------------------------------------
# the twins of tests/test_substrate.py
# --------------------------------------------------------------------------


class TestOptimizer:
    def test_adamw_converges_on_quadratic(self):
        opt = opt_mod.adamw(lr=0.1)
        params = {"w": _t([3.0, -2.0])}
        state = opt.init(params)
        target = _t([1.0, 1.0])
        for _ in range(200):
            grads = {"w": 2 * (params["w"] - target)}
            params, state = opt.update(grads, params, state)
        np.testing.assert_allclose(params["w"].numpy(), [1.0, 1.0],
                                   atol=1e-2)

    def test_sgd_momentum(self):
        opt = opt_mod.sgd(lr=0.05, momentum=0.9)
        params = {"w": _t(4.0)}
        state = opt.init(params)
        for _ in range(300):
            params, state = opt.update({"w": 2 * params["w"]}, params, state)
        assert abs(float(params["w"])) < 1e-2

    def test_clip_by_global_norm(self):
        grads = {"a": torch.full((4,), 100.0)}
        clipped, norm = opt_mod.clip_by_global_norm(grads, 1.0)
        assert float(norm) == 200.0
        assert np.isclose(float(opt_mod.global_norm(clipped)), 1.0,
                          rtol=1e-5)


class TestCompression:
    def test_bf16_error_feedback_unbiased(self):
        grads = {"w": _t([1e-4, 1.0, 3.14159])}
        state = comp.CompressionState.zeros_like(grads)
        acc = torch.zeros(3)
        for _ in range(50):
            payload, state = comp.bf16_compress(grads, state)
            acc = acc + comp.bf16_decompress(payload)["w"]
        np.testing.assert_allclose(acc.numpy() / 50, grads["w"].numpy(),
                                   rtol=1e-2)

    def test_topk_roundtrip_and_ratio(self):
        rng = np.random.default_rng(0)
        grads = {"w": torch.from_numpy(rng.standard_normal(1000).astype(
            np.float32))}
        state = comp.CompressionState.zeros_like(grads)
        payload, state = comp.topk_compress(grads, state, ratio=0.1)
        dense = comp.topk_decompress(payload, grads)
        assert int((dense["w"] != 0).sum()) == 100
        assert comp.compression_ratio(payload, grads) < 0.25

    def test_topk_error_feedback_conservation(self):
        grads = {"w": _t([10.0, 0.1, -3.0, 0.02])}
        state = comp.CompressionState.zeros_like(grads)
        total = torch.zeros(4)
        n = 30
        for _ in range(n):
            payload, state = comp.topk_compress(grads, state, ratio=0.25)
            total = total + comp.topk_decompress(payload, grads)["w"]
        np.testing.assert_allclose((total + state.residual["w"]).numpy(),
                                   grads["w"].numpy() * n, rtol=1e-5)


class TestCheckpoint:
    def test_save_restore_roundtrip(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep_n=2)
        state = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
                 "step": torch.tensor(7, dtype=torch.int32)}
        mgr.save(7, state, {"shape": [1, 1], "axes": ["data", "model"]})
        assert mgr.latest_step() == 7
        restored = mgr.restore(7, state)
        assert torch.equal(restored["params"]["w"], state["params"]["w"])
        assert restored["step"].shape == () and int(restored["step"]) == 7
        assert mgr.manifest(7)["mesh"] == {"shape": [1, 1],
                                           "axes": ["data", "model"]}

    def test_retention_gc(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep_n=2)
        state = {"w": torch.zeros(3)}
        for s in (1, 2, 3, 4):
            mgr.save(s, state)
        assert mgr.steps() == [3, 4]

    def test_async_save(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        state = {"w": torch.ones((32, 32))}
        mgr.save_async(11, state)
        mgr.wait()
        assert mgr.latest_step() == 11

    def test_async_save_snapshots_before_it_returns(self, tmp_path):
        """A tensor changed in place after ``save_async`` returns does not
        reach the file."""
        mgr = CheckpointManager(tmp_path)
        state = {"w": torch.ones(1 << 16)}
        mgr.save_async(1, state)
        state["w"].mul_(3.0)
        mgr.wait()
        assert bool((mgr.restore(1, state)["w"] == 1.0).all())

    def test_crash_leaves_no_partial_commit(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        (tmp_path / "step_5.tmp").mkdir()
        (tmp_path / "step_5.tmp" / "garbage").write_text("x")
        assert mgr.latest_step() is None
        mgr.save(5, {"w": torch.zeros(2)})
        assert mgr.latest_step() == 5

    def test_structure_mismatch_rejected(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        mgr.save(1, {"w": torch.zeros(3)})
        with pytest.raises(ValueError):
            mgr.restore(1, {"w": torch.zeros(3), "extra": torch.zeros(1)})
        with pytest.raises(ValueError, match="shape"):
            mgr.restore(1, {"w": torch.zeros(4)})


class TestPipeline:
    def test_prefetcher_order_and_completion(self):
        assert list(Prefetcher(iter(range(10)), depth=3)) == list(range(10))

    def test_prefetcher_propagates_errors(self):
        def gen():
            yield 1
            raise RuntimeError("boom")
        it = Prefetcher(gen())
        assert next(it) == 1
        with pytest.raises(RuntimeError):
            list(it)

    def test_lm_batches_learnable(self):
        batches = list(lm_batches(vocab=17, batch=4, seq=8, n_batches=3))
        assert len(batches) == 3
        assert batches[0]["tokens"].shape == (4, 8)
        assert batches[0]["tokens"].dtype == np.int32


# --------------------------------------------------------------------------
# compression and the pipeline against the reference, bit for bit
# --------------------------------------------------------------------------


def _grads(seed=0):
    rng = np.random.default_rng(seed)
    g = {"a": rng.standard_normal((6, 5)).astype(np.float32),
         "b": [rng.standard_normal(7).astype(np.float32)]}
    g["a"][0, :4] = [0.5, -0.5, 0.5, -0.5]  # a tie of magnitudes at the cut
    g["a"][1:] *= 0.1
    return g


def _same_bits(got: torch.Tensor, ref) -> bool:
    """Same shape, dtype and bytes (bf16 against its 2-byte records)."""
    ref = np.asarray(ref)
    if got.dtype == torch.bfloat16:
        arr = got.view(torch.int16).numpy()
    else:
        arr = got.numpy()
        if arr.dtype != ref.dtype:
            return False
    return arr.shape == ref.shape and arr.tobytes() == ref.tobytes()


@pytest.mark.parametrize("ratio", [0.1, 0.25])
def test_compression_matches_reference_bit_for_bit(ratio):
    g = _grads()
    jg, tg = jax.tree.map(jnp.asarray, g), pytree.tree_map(torch.from_numpy,
                                                           g)
    js, ts = (jcomp.CompressionState.zeros_like(jg),
              comp.CompressionState.zeros_like(tg))
    jks, tks = js, ts
    for i in range(3):  # the residual carries into later steps
        jp, js = jcomp.bf16_compress(jg, js)
        tp, ts = comp.bf16_compress(tg, ts)
        jk, jks = jcomp.topk_compress(jg, jks, ratio=ratio)
        tk, tks = comp.topk_compress(tg, tks, ratio=ratio)
        for got, ref in zip(pytree.leaves(tp) + pytree.leaves(ts.residual)
                            + pytree.leaves(tk) + pytree.leaves(tks.residual),
                            jax.tree.leaves(jp) + jax.tree.leaves(js.residual)
                            + jax.tree.leaves(jk)
                            + jax.tree.leaves(jks.residual)):
            assert _same_bits(got, ref)
        assert comp.compression_ratio(tk, tg) == jcomp.compression_ratio(
            jk, jg)
        assert _same_bits(comp.topk_decompress(tk, tg)["a"],
                          jcomp.topk_decompress(jk, jg)["a"])
    # the tie: 0.5 at indices 0 and 2 against -0.5 at 1 and 3, the lower
    # index first (jax.lax.top_k's order)
    vals, idx = comp.topk_compress({"w": _t([0.5, -0.5, 0.5, -0.5, 0.1])},
                                   comp.CompressionState.zeros_like(
                                       {"w": torch.zeros(5)}), ratio=0.6)[0][
        "w"]
    assert idx.tolist() == [0, 1, 2] and idx.dtype == torch.int32


def test_pipeline_arrays_equal_reference():
    for got, ref in zip(lm_batches(97, 3, 16, seed=4, n_batches=2),
                        jpipe.lm_batches(97, 3, 16, seed=4, n_batches=2)):
        assert got.keys() == ref.keys()
        for k in got:
            assert got[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(got[k], ref[k])
    cfg = JD.DetectorConfig("d", 64, width_mult=0.25, n_classes=3, p6=True)
    for got, ref in ((tpipe.rasterize_targets(cfg, 3, seed=5),
                      jpipe.rasterize_targets(cfg, 3, seed=5)),
                     (next(tpipe.detector_batches(
                         make_video(n_frames=4, n_objects=5, seed=1), cfg, 2,
                         seed=2)),
                      next(jpipe.detector_batches(
                          jmake_video(n_frames=4, n_objects=5, seed=1), cfg,
                          2, seed=2)))):
        assert got.keys() == ref.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], ref[k])


# --------------------------------------------------------------------------
# checkpoints across the packages
# --------------------------------------------------------------------------


def _lm_states(opt_kw=dict(lr=1e-3, warmup_steps=2)):
    """One float32 smollm-smoke state after a train step in each package,
    from the same parameters and batch."""
    jcfg = jbase.get_arch("smollm_135m").smoke
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = TT.from_jax_config(jcfg)
    tp = TT.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    batch = next(jpipe.lm_batches(jcfg.vocab_size, 2, 16, seed=3))
    jopt, topt = JO.adamw(**opt_kw), opt_mod.adamw(**opt_kw)
    js, _ = JS.lm_train_step(jcfg, jopt)(JS.make_state(jp, jopt),
                                         jax.tree.map(jnp.asarray, batch))
    ts, _ = TS.lm_train_step(tcfg, topt)(
        TS.make_state(tp, topt),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    return js, ts, topt


def test_float32_lm_checkpoints_interchange_bit_for_bit(tmp_path):
    js, ts, topt = _lm_states()
    # the reference writes, the port restores
    JManager(tmp_path / "ref").save(1, js)
    got = CheckpointManager(tmp_path / "ref").restore(1, ts)
    leaves = pytree.leaves(got)
    assert len(leaves) == len(jax.tree.leaves(js)) == 38
    for g, r in zip(leaves, jax.tree.leaves(js)):
        assert _same_bits(g, np.asarray(r))
    # the port writes, the reference restores
    CheckpointManager(tmp_path / "port").save(1, ts)
    back = JManager(tmp_path / "port").restore(1, js)
    for r, t in zip(jax.tree.leaves(back), pytree.leaves(ts)):
        assert _same_bits(t, r)
    # the same manifest structure and leaf file keys
    jm = JManager(tmp_path / "ref").manifest(1)
    tm = CheckpointManager(tmp_path / "port").manifest(1)
    assert (tm["n_leaves"], tm["treedef"]) == (jm["n_leaves"], jm["treedef"])
    with np.load(tmp_path / "ref/step_1/leaves.npz") as a, \
            np.load(tmp_path / "port/step_1/leaves.npz") as b:
        assert sorted(a.files) == sorted(b.files)
    # a restored port state trains on
    state, m = TS.lm_train_step(TT.from_jax_config(
        jbase.get_arch("smollm_135m").smoke), topt)(got, {
            k: torch.from_numpy(v) for k, v in next(
                jpipe.lm_batches(128, 2, 16, seed=4)).items()})
    assert int(state["step"]) == 2 and math.isfinite(float(m["loss"]))


def test_bf16_checkpoint_restores_in_the_port_not_in_the_reference(tmp_path):
    """bf16 leaves are stored as raw 2-byte records: the port writes and
    reads them bit for bit, and reads the reference's; the reference
    cannot restore them (``np.asarray`` has no cast from ``|V2``)."""
    bits = np.arange(-20, 20, dtype=np.int16) * 517
    tstate = {"w": torch.from_numpy(bits).view(torch.bfloat16).reshape(5, 8),
              "step": torch.tensor(3, dtype=torch.int32)}
    CheckpointManager(tmp_path / "port").save(3, tstate)
    got = CheckpointManager(tmp_path / "port").restore(3, tstate)
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), tstate["w"].view(
        torch.int16))
    jstate = {"w": jnp.asarray(bits.view(ml_dtypes.bfloat16).reshape(5, 8)),
              "step": jnp.asarray(3, jnp.int32)}
    JManager(tmp_path / "ref").save(3, jstate)
    with np.load(tmp_path / "ref/step_3/leaves.npz") as ref_file, \
            np.load(tmp_path / "port/step_3/leaves.npz") as port_file:
        for f in ("leaf_0", "leaf_1"):
            assert ref_file[f].tobytes() == port_file[f].tobytes()
    from_ref = CheckpointManager(tmp_path / "ref").restore(3, tstate)
    assert torch.equal(from_ref["w"].view(torch.int16),
                       tstate["w"].view(torch.int16))
    for d in ("ref", "port"):
        with pytest.raises(ValueError, match="cast"):
            JManager(tmp_path / d).restore(3, jstate)


# --------------------------------------------------------------------------
# the tree order, the registry and the launcher
# --------------------------------------------------------------------------


def test_tree_order_and_structure_match_jax():
    tree = {"z": [1, {"b": 2, "a": (3, 4)}], "a": {"y": 5, "x": [6]},
            "m": (7,)}
    leaves, treedef = pytree.flatten(tree)
    jleaves, jdef = jax.tree.flatten(tree)
    assert leaves == jleaves
    assert str(treedef) == str(jdef)
    assert treedef.unflatten(leaves) == jdef.unflatten(jleaves)
    assert pytree.tree_map(lambda a: a + 1, tree) == jax.tree.map(
        lambda a: a + 1, tree)


def test_arch_registry_matches_reference():
    assert tbase.list_archs() == jbase.list_archs()
    assert tbase.ALIASES == jbase.ALIASES
    assert tbase.FULL_ATTENTION_SKIP == jbase.FULL_ATTENTION_SKIP
    for arch_id in ("granite-34b", "smollm-135m", "mixtral-8x22b",
                    "qwen3-moe-235b-a22b"):
        t, j = tbase.get_arch(arch_id), jbase.get_arch(arch_id)
        assert (t.arch_id, t.family, t.skip) == (j.arch_id, j.family, j.skip)
        assert t.config == TT.from_jax_config(j.config)
        assert t.smoke == TT.from_jax_config(j.smoke)
        assert {k: dataclasses.asdict(v) for k, v in t.shapes.items()} \
            == {k: dataclasses.asdict(v) for k, v in j.shapes.items()}
    for arch_id in ("vit-b16", "resnet_50"):
        t, j = tbase.get_arch(arch_id), jbase.get_arch(arch_id)
        assert (t.arch_id, t.family, t.skip) == (j.arch_id, j.family, j.skip)
        assert t.config == TV.from_jax_config(j.config)
        assert t.smoke == TV.from_jax_config(j.smoke)
    for arch_id in ("flux-dev", "unet_sdxl"):
        t, j = tbase.get_arch(arch_id), jbase.get_arch(arch_id)
        assert (t.arch_id, t.family, t.skip) == (j.arch_id, j.family, j.skip)
        assert t.config == TDiff.from_jax_config(j.config)
        assert t.smoke == TDiff.from_jax_config(j.smoke)
        assert {k: dataclasses.asdict(v) for k, v in t.shapes.items()} \
            == {k: dataclasses.asdict(v) for k, v in j.shapes.items()}
    with pytest.raises(KeyError):
        tbase.get_arch("no-such-arch")


def test_train_launcher_trains_and_restarts(tmp_path):
    argv = ["--arch", "smollm-135m", "--steps", "20", "--ckpt-every", "10",
            "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    out = io.StringIO()
    with redirect_stdout(out):
        tlaunch.main(argv)
    lines = out.getvalue().splitlines()
    assert [ln.split()[1] for ln in lines[:-1]] == ["1", "10", "20"]
    assert all(ln.startswith("step ") and " loss=" in ln and " gnorm=" in ln
               and ln.endswith("s/step)") for ln in lines[:-1])
    assert lines[-1] == "done"
    assert CheckpointManager(tmp_path).steps() == [10, 20]
    assert json.loads((tmp_path / "step_20/manifest.json").read_text())[
        "n_leaves"] == 38
    out = io.StringIO()
    with redirect_stdout(out):
        tlaunch.main(argv[:3] + ["30"] + argv[4:])
    lines = out.getvalue().splitlines()
    assert lines[0] == "restored checkpoint at step 20"
    assert lines[1].startswith("step   21 loss=")
    # the diffusion family trains, checkpoints and restarts the same way
    # (on two PyTorch threads, restored after: the smoke UNet's many small
    # ops crawl when six test processes each run a thread a core)
    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        for arch_id in ("flux-dev", "unet-sdxl"):
            d = tmp_path / arch_id
            argv = ["--arch", arch_id, "--steps", "2", "--ckpt-every", "1",
                    "--batch", "2", "--ckpt-dir", str(d), "--device", "cpu"]
            with redirect_stdout(io.StringIO()):
                tlaunch.main(argv)
            assert CheckpointManager(d).steps() == [1, 2]
            out = io.StringIO()
            with redirect_stdout(out):
                tlaunch.main(argv[:3] + ["3"] + argv[4:])
            lines = out.getvalue().splitlines()
            assert lines[0] == "restored checkpoint at step 2"
            assert lines[1].startswith("step    3 loss=")
            assert lines[-1] == "done"
    finally:
        torch.set_num_threads(n_threads)


def test_train_launcher_trains_and_restarts_resnet(tmp_path):
    """``--arch resnet-50`` trains its smoke config on the CPU (batch
    norm stats in the checkpoint) and restarts from the checkpoint."""
    argv = ["--arch", "resnet-50", "--steps", "4", "--ckpt-every", "2",
            "--batch", "2", "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    out = io.StringIO()
    with redirect_stdout(out):
        tlaunch.main(argv)
    lines = out.getvalue().splitlines()
    assert len(lines) == 2 and lines[0].startswith("step    1 loss=")
    assert " gnorm=" in lines[0] and lines[-1] == "done"
    assert CheckpointManager(tmp_path).steps() == [2, 4]
    jstate = jax.eval_shape(lambda: JS.make_state(JV.resnet_init(
        jax.random.PRNGKey(0), jbase.get_arch("resnet_50").smoke),
        JO.adamw()))
    assert json.loads((tmp_path / "step_4/manifest.json").read_text())[
        "n_leaves"] == len(jax.tree.leaves(jstate))
    out = io.StringIO()
    with redirect_stdout(out):
        tlaunch.main(argv[:3] + ["5"] + argv[4:])
    lines = out.getvalue().splitlines()
    assert lines[0] == "restored checkpoint at step 4"
    assert lines[1].startswith("step    5 loss=")
    assert lines[-1] == "done"
