"""The vision family (``repro_torch.models.vision``, the backbone detector
and the vision steps) against the reference's, with the reference's own
weights (``from_jax_params``), and the pytree's ``None`` subtrees against
``jax.tree``.

Inputs come from fixed numpy seeds, at the smoke configs.  Tolerances:

* float32 logits, feature maps and detector heads: atol 1e-4, rtol 1e-4
  (the convolutions run in XLA on one side and in PyTorch's CPU kernels
  on the other, so sums are taken in another order; 1.4e-5 read on the
  CPU for ResNet's train-mode logits).
* ResNet's train-mode feature maps: atol 5e-4, rtol 1e-4.  Train-mode
  batchnorm divides each channel by its batch's std, over 8 values at
  stride 32 (batch 2 of 2x2 maps), which grows float32 sum-order
  differences stage by stage: on the CPU the two packages sit 1.1e-4 and
  1.7e-4 from a float64 run of the same features there, 1.3e-4 apart.
* BatchNorm running stats: atol 1e-5 (float32 means and variances over
  the batch, ~10^3 terms, in another order).
* One ``vision_train_step``: loss, grad norm rtol 1e-4, accuracy exactly;
  the parameters as ``tests/test_torch_training.py`` bounds two AdamW
  runs (every one within 2 lr, 99.9% within 1e-3 lr: where a gradient is
  near 0 a sum-order difference can turn its sign, and AdamW's first
  step, ``g / (|g| + eps)``, then moves the two runs up to lr apart).
* ``batchnorm`` and ``max_pool`` alone: atol 1e-6 (one float32 pass);
  their controls (``F.batch_norm``'s running variance,
  ``F.max_pool2d(padding=1)``) must miss by far more.
* Checkpoints: bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.checkpoint.checkpoint import CheckpointManager as JManager
from repro.configs import base as jbase
from repro.models import detector as JD
from repro.models import layers as JL
from repro.models import vision as JV
from repro.training import optimizer as JO
from repro.training import steps as JS
from repro_torch import pytree
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import base as tbase
from repro_torch.models import detector as TD
from repro_torch.models import layers as TL
from repro_torch.models import vision as TV
from repro_torch.training import optimizer as TO
from repro_torch.training import steps as TS

TOL = dict(atol=1e-4, rtol=1e-4)
TRAIN_FEAT_TOL = dict(atol=5e-4, rtol=1e-4)
STATS_ATOL = 1e-5
VISION_ARCHS = ("vit_b16", "convnext_b", "resnet_50", "resnet_152")
_JINIT = {JV.ViTConfig: JV.vit_init, JV.ConvNeXtConfig: JV.convnext_init,
          JV.ResNetConfig: JV.resnet_init}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _images(seed, b=2, res=64, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, res, res, 3)) * scale + shift).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _jparams(jcfg, seed):
    """The reference's params, initialised once per (config, seed); the
    reference runs jitted here, as its launcher runs it."""
    return jax.jit(_JINIT[type(jcfg)], static_argnums=1)(
        jax.random.PRNGKey(seed), jcfg)


_japply = jax.jit(JS.vision_apply, static_argnums=(2, 3))


def _pair(jcfg, seed=0):
    """(reference params, port config, port params from them)."""
    jp = _jparams(jcfg, seed)
    return jp, TV.from_jax_config(jcfg), TV.from_jax_params(
        jax.tree.map(np.asarray, jp), device="cpu")


def _to_jax_layout(tree):
    """The port's tree as numpy arrays in the reference's layout (conv
    kernels OIHW -> HWIO, stacked ones too): the inverse of
    ``from_jax_params``."""
    def walk(t, parent):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(v, k) if k != "w" or parent not in TV.CONV_KEYS
                    else _hwio(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, parent) for v in t]
        return t.numpy()

    def _hwio(w):
        lead = w.dim() - 4
        return w.permute(*range(lead), lead + 2, lead + 3, lead + 1,
                         lead).contiguous().numpy()
    return walk(tree, None)


def _assert_trees_close(got, ref, **tol):
    """``got`` (the port's tree) against ``ref`` (the reference's) in
    the reference's layout, structure and leaf order included."""
    g_leaves, g_def = pytree.flatten(_to_jax_layout(got))
    r_leaves, r_def = jax.tree.flatten(ref)
    assert str(g_def) == str(r_def)
    for g, r in zip(g_leaves, r_leaves):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, np.asarray(r, np.float32), **tol)


def _bn_stats(tree):
    """The (path, mean or var leaf) pairs of a params tree."""
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                if k in ("mean", "var"):
                    out.append((f"{path}.{k}", v))
                else:
                    walk(v, f"{path}.{k}")
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, f"{path}[{i}]")
    walk(tree, "")
    return out


# --------------------------------------------------------------------------
# the pytree's None subtrees
# --------------------------------------------------------------------------

_NONE_TREES = [
    {"a": [None, {"w": 1}], "b": 2},
    None,
    [None],
    (None, 3),
    {"z": None, "a": (4, None, [5, None]), "m": {"q": None}},
    [[], {}, None, ()],
]


@pytest.mark.parametrize("tree", _NONE_TREES)
def test_pytree_none_subtrees_match_jax(tree):
    leaves, treedef = pytree.flatten(tree)
    jleaves, jdef = jax.tree.flatten(tree)
    assert leaves == jleaves
    assert str(treedef) == str(jdef)
    assert treedef.unflatten(leaves) == jdef.unflatten(jleaves)
    assert pytree.tree_map(lambda a: a * 10, tree) == jax.tree.map(
        lambda a: a * 10, tree)
    assert treedef.flatten_up_to(tree) == jdef.flatten_up_to(tree)


def test_pytree_flatten_up_to_matches_none_against_none():
    tree = {"a": [None, {"w": 1}], "b": 2}
    treedef = pytree.flatten(tree)[1]
    assert treedef.flatten_up_to({"a": [None, {"w": [7, 8]}], "b": 9}) == [
        [7, 8], 9]
    with pytest.raises(ValueError):
        treedef.flatten_up_to({"a": [0, {"w": 1}], "b": 2})


def test_convnext_smoke_tree_has_jax_leaves_and_order():
    jcfg = jbase.get_arch("convnext_b").smoke
    jp, _, tp = _pair(jcfg)
    assert jp["downsample"][0] is None and tp["downsample"][0] is None
    assert len(pytree.leaves(tp)) == len(jax.tree.leaves(jp)) == 56
    _assert_trees_close(tp, jp, atol=0, rtol=0)


def test_none_subtrees_through_optimizer_grad_and_checkpoint(tmp_path):
    """``tree_map``, AdamW's ``flatten_up_to`` walk, ``value_and_grad``
    and ``CheckpointManager`` on a ResNet with a stage of depth 1 (its
    ``rest`` is ``None``), restored bit for bit."""
    jcfg = JV.ResNetConfig("r", 32, (1, 2, 1, 1), 8, 5, remat=False)
    tcfg = TV.from_jax_config(jcfg)
    tp = TV.resnet_init(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert tp["stages"][0]["rest"] is None
    jshapes = jax.eval_shape(lambda key: JV.resnet_init(key, jcfg),
                             jax.random.PRNGKey(0))
    assert str(pytree.flatten(tp)[1]) == str(jax.tree.structure(jshapes))
    opt = TO.adamw(lr=1e-3)
    state = TS.make_state(tp, opt)
    assert state["opt"]["mu"]["stages"][2]["rest"] is None
    batch = {"images": torch.from_numpy(_images(3, res=32)),
             "labels": torch.tensor([1, 4], dtype=torch.int32)}
    state, _ = TS.vision_train_step(tcfg, opt)(state, batch)
    assert state["params"]["stages"][3]["rest"] is None
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, state)
    got = mgr.restore(1, TS.make_state(TV.resnet_init(
        torch.Generator().manual_seed(1), tcfg, "cpu"), opt))
    assert got["params"]["stages"][0]["rest"] is None
    for g, w in zip(pytree.leaves(got), pytree.leaves(state)):
        assert torch.equal(g, w)


# --------------------------------------------------------------------------
# batchnorm and max_pool (ROADMAP hazards (f) and (a))
# --------------------------------------------------------------------------


def _bn_params(c, seed):
    rng = np.random.default_rng(seed)
    return {"scale": rng.random(c).astype(np.float32) + 0.5,
            "bias": rng.standard_normal(c).astype(np.float32),
            "mean": rng.standard_normal(c).astype(np.float32),
            "var": rng.random(c).astype(np.float32) + 0.5}


@pytest.mark.parametrize("train", [False, True])
def test_batchnorm_matches_reference(train):
    x = _images(1, b=3, res=7, scale=2.0, shift=0.5)[..., :3]
    x = np.concatenate([x, x[..., :2] * 3], axis=-1)  # 5 channels
    p = _bn_params(5, 2)
    jy, jstats = JL.batchnorm(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                              train=train)
    tp = pytree.tree_map(torch.from_numpy, p)
    ty, tstats = TL.batchnorm(tp, torch.from_numpy(x).permute(0, 3, 1, 2),
                              train=train)
    np.testing.assert_allclose(_np(ty.permute(0, 2, 3, 1)), np.asarray(jy),
                               atol=1e-6, rtol=1e-6)
    for k in ("mean", "var"):
        np.testing.assert_allclose(_np(tstats[k]), np.asarray(jstats[k]),
                                   atol=STATS_ATOL)
    if not train:
        assert tstats is tp
        return
    assert all(t.dtype == torch.float32 for t in tstats.values())
    # the control: F.batch_norm's running variance is the unbiased one,
    # and it updates its buffers in place
    run_mean, run_var = tp["mean"].clone(), tp["var"].clone()
    F.batch_norm(torch.from_numpy(x).permute(0, 3, 1, 2), run_mean, run_var,
                 tp["scale"], tp["bias"], training=True, momentum=0.1,
                 eps=1e-5)
    assert np.abs(_np(run_var) - np.asarray(jstats["var"])).max() \
        > 100 * STATS_ATOL


def test_batchnorm_keeps_bf16_and_float32_stats():
    p = pytree.tree_map(torch.from_numpy, _bn_params(4, 3))
    p["scale"], p["bias"] = p["scale"].bfloat16(), p["bias"].bfloat16()
    x = torch.from_numpy(_images(4, b=2, res=5)[..., :2]).repeat(1, 1, 1, 2)
    y, stats = TL.batchnorm(p, x.permute(0, 3, 1, 2).bfloat16(), train=True)
    assert y.dtype == torch.bfloat16
    assert stats["mean"].dtype == stats["var"].dtype == torch.float32
    assert stats["scale"] is p["scale"]


@pytest.mark.parametrize("size", [7, 8, 15, 16])
@pytest.mark.parametrize("window,stride", [(3, 2), (2, 2), (3, 1)])
def test_max_pool_matches_reference_same_padding(size, window, stride):
    x = _images(size, b=2, res=size)
    jy = np.asarray(JL.max_pool(jnp.asarray(x), window, stride))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    ty = _np(TL.max_pool(tx, window, stride).permute(0, 2, 3, 1))
    assert ty.shape == jy.shape
    np.testing.assert_allclose(ty, jy, atol=1e-6)
    if (window, stride) == (3, 2):
        # the control: torch's symmetric padding shifts the windows (on an
        # even size) or changes nothing the test can see (on an odd one)
        ctl = _np(F.max_pool2d(tx, 3, 2, padding=1).permute(0, 2, 3, 1))
        if size % 2 == 0:
            assert ctl.shape == jy.shape
            assert np.abs(ctl - jy).max() > 0.1


# --------------------------------------------------------------------------
# the backbones at their smoke configs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch_id", VISION_ARCHS)
@pytest.mark.parametrize("train", [False, True])
def test_apply_matches_reference(arch_id, train):
    jcfg = jbase.get_arch(arch_id).smoke
    jp, tcfg, tp = _pair(jcfg)
    img = _images(7, res=jcfg.img_res, scale=3.0, shift=1.0)
    jlogits, jnew = _japply(jp, jnp.asarray(img), jcfg, train)
    tlogits, tnew = TS.vision_apply(tp, torch.from_numpy(img), tcfg, train)
    assert tlogits.dtype == torch.float32
    np.testing.assert_allclose(_np(tlogits), np.asarray(jlogits), **TOL)
    _assert_trees_close(tnew, jnew, atol=STATS_ATOL, rtol=0)
    moved = [k for (k, a), (_, b) in zip(_bn_stats(tnew), _bn_stats(tp))
             if not torch.equal(a, b)]
    if isinstance(tcfg, TV.ResNetConfig) and train:
        assert len(moved) == len(_bn_stats(tp)) > 0
    else:
        assert tnew is tp and not moved


@pytest.mark.parametrize("arch_id", ["resnet_50", "convnext_b"])
@pytest.mark.parametrize("train", [False, True])
def test_features_match_reference(arch_id, train):
    jcfg = jbase.get_arch(arch_id).smoke
    jp, tcfg, tp = _pair(jcfg)
    img = _images(8, res=jcfg.img_res)
    jfeat_fn, tfeat_fn = ((JV.resnet_features, TV.resnet_features)
                          if arch_id == "resnet_50" else
                          (JV.convnext_features, TV.convnext_features))
    jfeats, _ = jax.jit(jfeat_fn, static_argnums=(2, 3))(
        jp, jnp.asarray(img), jcfg, train)
    tfeats, _ = tfeat_fn(tp, torch.from_numpy(img), tcfg, train)
    assert [tuple(f.shape) for f in tfeats] == [f.shape for f in jfeats]
    assert [f.shape[1] for f in tfeats] == [16, 8, 4, 2]  # strides 4..32
    tol = TRAIN_FEAT_TOL if train and arch_id == "resnet_50" else TOL
    for t, j in zip(tfeats, jfeats):
        np.testing.assert_allclose(_np(t), np.asarray(j), **tol)


def test_remat_gives_the_same_gradients():
    """``remat`` recomputes each scanned block in the backward: the
    gradients and the refreshed stats equal the stored run's bit for
    bit, the stats are refreshed once."""
    for arch_id in ("resnet_50", "vit_b16"):
        jcfg = jbase.get_arch(arch_id).smoke
        _, tcfg, tp = _pair(jcfg)
        batch = {"images": torch.from_numpy(_images(9, res=jcfg.img_res)),
                 "labels": torch.tensor([3, 7])}
        out = []
        for remat in (False, True):
            cfg = dataclasses.replace(tcfg, remat=remat)
            (loss, (_, new_p)), grads = TS.value_and_grad(
                lambda p: _xent(p, batch, cfg), tp, has_aux=True)
            out.append((loss, new_p, grads))
        (l0, n0, g0), (l1, n1, g1) = out
        assert torch.equal(l0, l1)
        for a, b in zip(pytree.leaves((n0, g0)), pytree.leaves((n1, g1))):
            assert torch.equal(a, b)


def _xent(p, batch, cfg):
    logits, new_p = TS.vision_apply(p, batch["images"], cfg, train=True)
    return F.cross_entropy(logits, batch["labels"]), (logits, new_p)


# --------------------------------------------------------------------------
# one train step a family, against jax.value_and_grad of the reference's
# --------------------------------------------------------------------------


def _assert_adamw_close(got, ref, lr: float, steps: int) -> None:
    g = pytree.leaves(_to_jax_layout(got))
    diff = np.concatenate([np.abs(a - np.asarray(b, np.float32)).ravel()
                           for a, b in zip(g, jax.tree.leaves(ref))])
    assert diff.max() <= 2 * lr * steps
    assert np.quantile(diff, 0.999) <= 1e-3 * lr


@pytest.mark.parametrize("arch_id", ["vit_b16", "convnext_b", "resnet_50"])
def test_train_step_matches_reference(arch_id):
    jcfg = jbase.get_arch(arch_id).smoke
    jp, tcfg, tp = _pair(jcfg)
    rng = np.random.default_rng(10)
    batch = {"images": _images(11, b=4, res=jcfg.img_res),
             "labels": rng.integers(0, jcfg.n_classes, 4).astype(np.int32)}
    lr = 1e-3
    jstate, jm = jax.jit(JS.vision_train_step(jcfg, JO.adamw(lr=lr)))(
        JS.make_state(jp, JO.adamw(lr=lr)),
        jax.tree.map(jnp.asarray, batch))
    opt = TO.adamw(lr=lr)
    tstate, tm = TS.vision_train_step(tcfg, opt)(
        TS.make_state(tp, opt), pytree.tree_map(torch.from_numpy, batch))
    for k in ("loss", "grad_norm"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-4)
    assert float(tm["accuracy"]) == float(jm["accuracy"])
    assert int(tm["step"]) == int(jm["step"]) == 1
    _assert_adamw_close(tstate["params"], jstate["params"], lr, 1)
    # the refreshed batchnorm stats, merged after AdamW
    tstats, jstats = _bn_stats(tstate["params"]), _bn_stats(jstate["params"])
    assert [k for k, _ in tstats] == [k for k, _ in jstats]
    for (_, t), (_, j) in zip(tstats, jstats):
        np.testing.assert_allclose(_np(t), np.asarray(j), atol=STATS_ATOL)
    if isinstance(tcfg, TV.ResNetConfig):
        assert tstats and not torch.equal(
            tstate["params"]["bn_stem"]["mean"], tp["bn_stem"]["mean"])


# --------------------------------------------------------------------------
# the backbone detector
# --------------------------------------------------------------------------


def _backbone_cfgs(backbone):
    if backbone == "resnet":
        jbb = JV.ResNetConfig("bb", 64, (2, 2, 2, 2), 16, 10, remat=False)
    else:
        jbb = JV.ConvNeXtConfig("bb", 64, (2, 2, 2, 2), (16, 32, 64, 128), 10,
                                remat=False)
    kw = dict(input_size=64, n_classes=8, head_width=32)
    return (JD.BackboneDetectorConfig(f"{backbone}-det", jbb, **kw),
            TD.BackboneDetectorConfig(f"{backbone}-det",
                                      TV.from_jax_config(jbb), **kw))


@pytest.mark.parametrize("backbone", ["resnet", "convnext"])
def test_backbone_detector_matches_reference(backbone):
    jcfg, tcfg = _backbone_cfgs(backbone)
    jp = jax.jit(JD.backbone_detector_init, static_argnums=1)(
        jax.random.PRNGKey(4), jcfg)
    tp = TV.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    img = _images(12, res=64)
    jouts = jax.jit(JD.backbone_detector_apply, static_argnums=2)(
        jp, jnp.asarray(img), jcfg)
    touts = TD.backbone_detector_apply(tp, torch.from_numpy(img), tcfg)
    assert [tuple(o.shape) for o in touts] == [o.shape for o in jouts]
    for t, j in zip(touts, jouts):
        np.testing.assert_allclose(_np(t), np.asarray(j), **TOL)
    jb, js, jc = JD.decode(jouts, jcfg, conf_threshold=0.0, max_det=8)
    tb, ts, tc = TD.decode(touts, tcfg, conf_threshold=0.0, max_det=8)
    np.testing.assert_allclose(_np(tb), np.asarray(jb), **TOL)
    np.testing.assert_allclose(_np(ts), np.asarray(js), **TOL)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    fresh = TD.backbone_detector_init(torch.Generator().manual_seed(0), tcfg,
                                      "cpu")
    assert str(pytree.flatten(fresh)[1]) == str(pytree.flatten(tp)[1])
    assert [tuple(t.shape) for t in pytree.leaves(fresh)] == \
        [tuple(t.shape) for t in pytree.leaves(tp)]


# --------------------------------------------------------------------------
# checkpoints across the packages, the registry and the launcher
# --------------------------------------------------------------------------


def test_resnet_checkpoint_interchanges_with_reference(tmp_path):
    """A float32 ResNet train state (BN stats, moments) saved by either
    package is restored by the other bit for bit (the port's conv kernels
    written in the reference's HWIO layout)."""
    jcfg = jbase.get_arch("resnet_50").smoke
    jp, tcfg, tp = _pair(jcfg)
    batch = {"images": _images(13, b=2, res=jcfg.img_res),
             "labels": np.array([2, 5], np.int32)}
    jopt, topt = JO.adamw(lr=1e-3), TO.adamw(lr=1e-3)
    jstate, _ = jax.jit(JS.vision_train_step(jcfg, jopt))(
        JS.make_state(jp, jopt), jax.tree.map(jnp.asarray, batch))
    tstate, _ = TS.vision_train_step(tcfg, topt)(
        TS.make_state(tp, topt), pytree.tree_map(torch.from_numpy, batch))
    # the reference's file -> the port
    JManager(tmp_path / "ref").save(1, jstate)
    jtemplate = pytree.tree_map(torch.from_numpy,
                                jax.tree.map(np.array, jstate))
    got = CheckpointManager(tmp_path / "ref").restore(1, jtemplate)
    for g, w in zip(pytree.leaves(got), jax.tree.leaves(jstate)):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()
    # the port's file -> the reference
    tsaved = {"params": _to_jax_layout(tstate["params"]),
              "opt": {k: (_to_jax_layout(v) if k != "step" else v.numpy())
                      for k, v in tstate["opt"].items()},
              "step": tstate["step"].numpy()}
    CheckpointManager(tmp_path / "port").save(1, pytree.tree_map(
        torch.from_numpy, tsaved))
    back = JManager(tmp_path / "port").restore(1, jstate)
    assert str(jax.tree.structure(back)) == str(jax.tree.structure(jstate))
    for g, w in zip(jax.tree.leaves(back), pytree.leaves(tsaved)):
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes()
    assert CheckpointManager(tmp_path / "port").manifest(1)["n_leaves"] == \
        len(jax.tree.leaves(jstate))


def test_registry_resolves_the_vision_archs():
    for arch_id in VISION_ARCHS:
        t, j = tbase.get_arch(arch_id), jbase.get_arch(arch_id)
        assert (t.arch_id, t.family, t.skip) == (j.arch_id, j.family, j.skip)
        assert t.config == TV.from_jax_config(j.config)
        assert t.smoke == TV.from_jax_config(j.smoke)
        assert t.config.n_params == j.config.n_params
        assert t.config.param_dtype == torch.bfloat16
        assert t.smoke.param_dtype == torch.float32
        assert {k: dataclasses.asdict(v) for k, v in t.shapes.items()} \
            == {k: dataclasses.asdict(v) for k, v in j.shapes.items()}
    assert tbase.VISION_SHAPES.keys() == jbase.VISION_SHAPES.keys()
    from repro.configs import vit_b16 as jvit
    from repro_torch.configs import vit_b16 as tvit
    assert tvit.config_for_res(384) == TV.from_jax_config(
        jvit.config_for_res(384))


# --------------------------------------------------------------------------
# the twins of tests/test_models.py::TestVision, ::TestBackboneDetector
# and the vision cases of tests/test_arch_smoke.py
# --------------------------------------------------------------------------

_GEN = 0


def _gen():
    return torch.Generator().manual_seed(_GEN)


class TestVision:
    @pytest.mark.parametrize("family", ["vit", "convnext", "resnet"])
    def test_forward_shapes_and_finite(self, family):
        img = torch.from_numpy(_images(0, b=2, res=64))
        if family == "vit":
            cfg = TV.ViTConfig("t", 64, 16, 2, 32, 4, 64, 10, remat=False)
        elif family == "convnext":
            cfg = TV.ConvNeXtConfig("t", 64, (2, 2, 2, 2), (16, 32, 64, 128),
                                    10, remat=False)
        else:
            cfg = TV.ResNetConfig("t", 64, (2, 2, 2, 2), 16, 10, remat=False)
        p = TV.init_params(_gen(), cfg, "cpu")
        logits, _ = TS.vision_apply(p, img, cfg, train=False)
        assert logits.shape == (2, 10)
        assert bool(torch.isfinite(logits).all())

    def test_resnet_bn_stats_update_only_in_train(self):
        cfg = TV.ResNetConfig("t", 32, (2, 2, 2, 2), 16, 10, remat=False)
        p = TV.resnet_init(_gen(), cfg, "cpu")
        img = torch.from_numpy(_images(1, b=2, res=32, scale=3, shift=1))
        _, p_train = TV.resnet_apply(p, img, cfg, train=True)
        _, p_eval = TV.resnet_apply(p, img, cfg, train=False)
        assert not torch.allclose(p_train["bn_stem"]["mean"],
                                  p["bn_stem"]["mean"])
        assert torch.equal(p_eval["bn_stem"]["mean"], p["bn_stem"]["mean"])


class TestBackboneDetector:
    @pytest.mark.parametrize("backbone", ["resnet", "convnext"])
    def test_heads_and_decode(self, backbone):
        _, cfg = _backbone_cfgs(backbone)
        p = TD.backbone_detector_init(_gen(), cfg, "cpu")
        outs = TD.backbone_detector_apply(
            p, torch.from_numpy(_images(2, b=2, res=64)), cfg)
        assert [o.shape[1] for o in outs] == [8, 4, 2]
        boxes, scores, cls = TD.decode(outs, cfg, conf_threshold=0.0,
                                       max_det=8)
        assert boxes.shape == (2, 8, 4)
        assert bool(torch.isfinite(boxes).all())

    def test_classifier_path_unchanged(self):
        bb = TV.ResNetConfig("bb", 32, (2, 2, 2, 2), 16, 10, remat=False)
        p = TV.resnet_init(_gen(), bb, "cpu")
        img = torch.from_numpy(_images(3, b=2, res=32))
        logits, _ = TV.resnet_apply(p, img, bb, train=False)
        feats, _ = TV.resnet_features(p, img, bb, train=False)
        assert feats[-1].shape[-1] == 16 * 8 * 4
        assert logits.shape == (2, 10)


@pytest.mark.parametrize("arch_id", VISION_ARCHS)
def test_smoke_train_step(arch_id):
    arch = tbase.get_arch(arch_id)
    cfg = arch.smoke
    opt = TO.adamw(lr=1e-3)
    params = TV.init_params(_gen(), cfg, "cpu")
    rng = np.random.default_rng(0)
    batch = {"images": torch.from_numpy(_images(4, b=2, res=cfg.img_res)),
             "labels": torch.from_numpy(
                 rng.integers(0, cfg.n_classes, 2).astype(np.int32))}
    state, metrics = TS.vision_train_step(cfg, opt)(
        TS.make_state(params, opt), batch)
    assert np.isfinite(float(metrics["loss"]))
    assert 0.0 <= float(metrics["accuracy"]) <= 1.0
    assert all(bool(torch.isfinite(t).all())
               for t in pytree.leaves(state["params"]))
    served = TS.vision_serve_step(cfg)(state["params"], batch)
    assert served["logits"].shape == (2, cfg.n_classes)
