"""``repro_torch.models.detector`` against ``repro.models.detector`` on a
reduced ladder, with the reference's own weights (``from_jax_params``).

f32 throughout; ``apply``'s heads agree within 1e-4 (the convolutions
run in XLA on one side and in PyTorch's CPU kernels on the other, so
sums are taken in another order), ``decode``'s boxes and scores within
1e-4 and its classes exactly.  ``detection_loss`` within rtol 1e-5 and
its gradients within atol 1e-4 and rtol 1e-3 (a convolution's weight
gradient sums over every pixel of the batch, ~10^4 terms, in each
backend's order); one ``detector_train_step``'s loss and grad norm within
rtol 1e-4, its parameters as ``tests/test_torch_training.py`` bounds two
AdamW runs (every one within 2 lr, 99.9% within 1e-3 lr: where a
gradient is near 0 a sum-order difference can turn its sign, and
AdamW's first step, ``g / (|g| + eps)``, then moves the two runs up to lr
apart; 0.5 lr read on the CPU for one parameter).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import detector as jdet
from repro.models import layers as jlayers
from repro.training import optimizer as jopt
from repro.training import steps as jsteps
from repro_torch import pytree
from repro_torch.data.pipeline import rasterize_targets
from repro_torch.models import detector as tdet
from repro_torch.models import layers as tlayers
from repro_torch.training import optimizer as topt
from repro_torch.training import steps as tsteps


def _cfgs(mod):
    small = dict(input_size=64, n_classes=16)
    return [dataclasses.replace(mod.PAPER_LADDER[0], **small),
            # P6 (four scales) at a quarter of its width
            dataclasses.replace(mod.PAPER_LADDER[4], width_mult=0.25,
                                depth_mult=0.34, **small)]


@pytest.fixture(scope="module")
def ladder():
    out = []
    for i, (jc, tc) in enumerate(zip(_cfgs(jdet), _cfgs(tdet))):
        jp = jdet.init_params(jax.random.PRNGKey(i), jc)
        tp = tdet.from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
        out.append((jc, jp, tc, tp))
    return out


# the reference's batched path runs these jitted, as here
_japply = jax.jit(jdet.apply, static_argnums=2)
_jdecode = jax.jit(jdet.decode, static_argnums=1,
                   static_argnames=("conf_threshold", "max_det"))


def _images(seed, b=2, s=64):
    return np.random.default_rng(seed).random((b, s, s, 3)).astype(np.float32)


def test_from_jax_params_layouts(ladder):
    jc, jp, tc, tp = ladder[0]
    assert tp["stem"]["conv"]["w"].shape == (16, 3, 3, 3)  # OIHW
    np.testing.assert_array_equal(
        tp["heads"][1]["out"]["w"].numpy(),
        np.asarray(jp["heads"][1]["out"]["w"]).transpose(3, 2, 0, 1))
    assert len(tp["stages"]) == len(jp["stages"])
    assert len(tp["stages"][0]["csp"]["bottlenecks"]) == jc.depth
    gen = torch.Generator().manual_seed(0)
    fresh = tdet.init_params(gen, tc)
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, fresh)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda t: 0, tp))
    assert fresh["stem"]["conv"]["w"].abs().max() <= (1 / 27) ** 0.5


@pytest.mark.parametrize("i", [0, 1])
def test_apply_and_decode_match_reference(ladder, i):
    jc, jp, tc, tp = ladder[i]
    imgs = _images(i)
    jouts = _japply(jp, jnp.asarray(imgs), jc)
    touts = tdet.apply(tp, torch.from_numpy(imgs), tc)
    assert len(touts) == len(jc.strides)
    for got, ref in zip(touts, jouts):
        assert got.shape == ref.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                                   rtol=1e-4)
    valid = np.array([True, False])
    jb, js, jk = _jdecode(jouts, jc, conf_threshold=0.01, max_det=16,
                          valid=jnp.asarray(valid))
    tb, ts, tk = tdet.decode([torch.from_numpy(np.asarray(o)) for o in jouts],
                             tc, conf_threshold=0.01, max_det=16,
                             valid=torch.from_numpy(valid))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-4)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert not ts.numpy()[1].any()  # the padded row emits nothing


def test_decode_breaks_ties_toward_lower_index():
    """Equal scores keep the lower index first, as ``lax.top_k``."""
    cfg = tdet.DetectorConfig("t", 32, n_classes=2)
    outs = [np.zeros((1, 32 // s, 32 // s, 7), np.float32)
            for s in cfg.strides]
    outs[0][0, 1, 2, 4] = 3.0  # one clearly better cell
    jb, js, jk = _jdecode([jnp.asarray(o) for o in outs],
                          dataclasses.replace(jdet.PAPER_LADDER[0],
                                              input_size=32, n_classes=2),
                          conf_threshold=0.0, max_det=8)
    tb, ts, tk = tdet.decode([torch.from_numpy(o) for o in outs], cfg,
                             conf_threshold=0.0, max_det=8)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


@pytest.mark.parametrize("size,stride", [(16, 2), (15, 2), (9, 1)])
def test_conv2d_same_padding_matches_reference(size, stride):
    rng = np.random.default_rng(size + stride)
    x = rng.standard_normal((1, size, size, 4)).astype(np.float32)
    w = rng.standard_normal((3, 3, 4, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    ref = jlayers.conv2d({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                         jnp.asarray(x), stride=stride)
    got = tlayers.conv2d(
        {"w": torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
         "b": torch.from_numpy(b)},
        torch.from_numpy(x).permute(0, 3, 1, 2), stride=stride)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), atol=1e-5)


def test_norm_activation_layers_match_reference():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 6, 6, 48)).astype(np.float32)
    p = {"scale": rng.standard_normal(48).astype(np.float32),
         "bias": rng.standard_normal(48).astype(np.float32)}
    assert tlayers.num_groups(48) == jlayers.num_groups(48) == 24
    ref = jlayers.groupnorm({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = tlayers.groupnorm({k: torch.from_numpy(v) for k, v in p.items()}, xt)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(tlayers.mish(xt).permute(0, 2, 3, 1).numpy(),
                               np.asarray(jlayers.mish(jnp.asarray(x))),
                               atol=1e-6)
    np.testing.assert_array_equal(
        tlayers.upsample_nearest(xt).permute(0, 2, 3, 1).numpy(),
        np.asarray(jlayers.upsample_nearest(jnp.asarray(x))))


def test_flops_per_image_matches_reference():
    for jc, tc in zip(jdet.PAPER_LADDER, tdet.PAPER_LADDER):
        assert tdet.flops_per_image(tc) == jdet.flops_per_image(jc)
        assert (tc.name, tc.input_size, tc.strides) == \
            (jc.name, jc.input_size, jc.strides)


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------


def _train_batch(cfg, b=2, seed=3):
    batch = {"images": np.random.default_rng(seed).random(
        (b, cfg.input_size, cfg.input_size, 3)).astype(np.float32)}
    batch.update(rasterize_targets(cfg, b))
    return batch


def _grads_oihw(tree):
    """A gradient tree of the reference's in the port's layout."""
    return tdet.from_jax_params(jax.tree_util.tree_map(np.asarray, tree))


def test_detection_loss_and_grads_match_reference(ladder):
    jc, jp, tc, tp = ladder[0]
    batch = _train_batch(jc)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jdet.detection_loss(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, jc)))(jp)
    tl, tg = tsteps.value_and_grad(lambda p: tdet.detection_loss(
        p, {k: torch.from_numpy(v) for k, v in batch.items()}, tc), tp)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for got, ref in zip(pytree.leaves(tg), pytree.leaves(_grads_oihw(jg))):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4,
                                   rtol=1e-3)


def test_detector_train_and_serve_steps_match_reference(ladder):
    jc, jp, tc, tp = ladder[0]
    batch = _train_batch(jc)
    lr = 1e-3
    jo, to = jopt.adamw(lr=lr), topt.adamw(lr=lr)
    js, jm = jax.jit(jsteps.detector_train_step(jc, jo))(
        jsteps.make_state(jp, jo),
        {k: jnp.asarray(v) for k, v in batch.items()})
    ts, tm = tsteps.detector_train_step(tc, to)(
        tsteps.make_state(tp, to),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4)
    assert int(tm["step"]) == int(ts["opt"]["step"]) == 1
    diff = np.concatenate([
        np.abs(g.numpy() - r.numpy()).ravel() for g, r in zip(
            pytree.leaves(ts["params"]),
            pytree.leaves(_grads_oihw(js["params"])))])
    assert diff.max() <= 2 * lr
    assert np.quantile(diff, 0.999) <= 1e-3 * lr
    images = batch["images"][:1]
    jout = jsteps.detector_serve_step(jc)(jp, {"images": jnp.asarray(images)})
    tout = tsteps.detector_serve_step(tc)(tp, {"images": torch.from_numpy(
        images)})
    assert set(tout) == set(jout) == {"boxes", "scores", "classes"}
    np.testing.assert_allclose(tout["scores"].numpy(),
                               np.asarray(jout["scores"]), atol=1e-4)
