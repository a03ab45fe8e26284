"""The diffusion family (``repro_torch.models.diffusion``, the diffusion
steps, configs and launcher) against the reference's, with the
reference's own weights (``from_jax_params``).

Inputs come from fixed numpy seeds, at the smoke configs, in float32.
Every MMDiT comparison runs on parameters whose modulation
(``mod``, ``final_mod``) is drawn non-zero (``perturb_modulation``, the
same values in both packages): the reference initialises it at zero,
which makes every block the identity and its weights' gradients 0.
The training losses take the reference's own ``jax.random`` draws
(``diffusion_draws`` is replaced in the test): the port's generator
draws other bits.  Tolerances:

* ``_mha``: atol 1e-6 (one float32 pass).
* ``timestep_embedding`` and ``axial_2d_sincos``: XLA's float32 ``exp``
  and PyTorch's differ by one ulp on some frequencies (14 of the 128 at
  dim 256), and the argument ``pos * freq`` carries that ulp times
  ``pos``: atol 1e-6 + max(pos) * 2^-23 (1.2e-4 at the timesteps'
  1000, 7.5e-6 at a 64-wide axis, 1.1e-6 for flux's t in [0, 1)).  The
  controls (sines first; a w-major grid) must miss by more than 0.1.
* ``mmdit_apply``, ``unet_apply``, the sampler steps: atol 1e-4, rtol
  1e-4.  The zero-modulation control must miss by more than 1e-2.
* The losses: rtol 1e-5; their gradients leaf by leaf atol 1e-4 x the
  largest |gradient| of the tree, rtol 1e-4.
* One ``diffusion_train_step``: loss and grad norm rtol 1e-4, the
  parameters as ``tests/test_torch_training.py`` bounds two AdamW runs
  (every one within 2 lr, 99.9% within 1e-3 lr); a second step's loss
  and grad norm rtol 1e-4.
* Remat against no remat, checkpoints, ``from_jax_params``: bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
import io
import json
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import CheckpointManager as JManager
from repro.configs import base as jbase
from repro.launch import train as jlaunch
from repro.models import diffusion as JDiff
from repro.models import layers as JL
from repro.training import optimizer as JO
from repro.training import steps as JS
from repro_torch import pytree
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import base as tbase
from repro_torch.launch import train as tlaunch
from repro_torch.models import diffusion as TDiff
from repro_torch.models import layers as TL
from repro_torch.training import optimizer as TO
from repro_torch.training import steps as TS

TOL = dict(atol=1e-4, rtol=1e-4)
ULP = 2.0 ** -23


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _jparams(jcfg, seed):
    """The reference's params, initialised once per (config, seed)."""
    init = JDiff.mmdit_init if isinstance(jcfg, JDiff.MMDiTConfig) \
        else JDiff.unet_init
    return jax.jit(init, static_argnums=1)(jax.random.PRNGKey(seed), jcfg)


@functools.lru_cache(maxsize=None)
def _jtrain_step(jcfg, lr):
    """The reference's ``diffusion_train_step`` with ``adamw(lr)``,
    jitted once per (config, lr)."""
    return jax.jit(JS.diffusion_train_step(jcfg, JO.adamw(lr=lr)))


def _with_modulation(jp, tp):
    """The reference's tree ``jp`` with the modulation leaves of the
    port's ``tp`` (the same values in both packages)."""
    jp = jax.tree.map(lambda x: x, jp)  # a copy of the containers
    def numpy(tree):
        return pytree.tree_map(lambda t: t.numpy(), tree)
    for k in ("img", "txt"):
        jp["double"][k]["mod"] = numpy(tp["double"][k]["mod"])
    jp["single"]["mod"] = numpy(tp["single"]["mod"])
    jp["final_mod"] = numpy(tp["final_mod"])
    return jp


def _pair(arch_id, seed=0, perturb=True):
    """(reference config, reference params, port config, port params):
    the reference's weights, a flux tree's modulation drawn non-zero in
    both."""
    jcfg = jbase.get_arch(arch_id).smoke
    jp = _jparams(jcfg, seed)
    tcfg = TDiff.from_jax_config(jcfg)
    tp = TDiff.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    if perturb and isinstance(tcfg, TDiff.MMDiTConfig):
        tp = TDiff.perturb_modulation(tp, torch.Generator().manual_seed(
            100 + seed))
        jp = _with_modulation(jp, tp)
    return jcfg, jp, tcfg, tp


def _inputs(cfg, seed, b=2):
    """Seeded numpy inputs of the model's apply: latents, timesteps and
    the conditioning, in the reference's batch keys."""
    rng = np.random.default_rng(seed)
    r = cfg.latent_res
    out = {"latents": rng.standard_normal(
        (b, r, r, cfg.latent_ch)).astype(np.float32)}
    if isinstance(cfg, JDiff.MMDiTConfig):
        out["t"] = rng.random(b).astype(np.float32)
        out["ctx"] = rng.standard_normal(
            (b, cfg.n_ctx_tokens, cfg.d_ctx)).astype(np.float32)
        out["pooled"] = rng.standard_normal((b, cfg.d_pooled)).astype(
            np.float32)
        out["guidance"] = (rng.random(b) * 4).astype(np.float32)
    else:
        out["t"] = (rng.random(b) * 999).astype(np.float32)
        out["ctx"] = rng.standard_normal(
            (b, cfg.n_ctx_tokens, cfg.ctx_dim)).astype(np.float32)
        out["add_emb"] = rng.standard_normal((b, cfg.d_add)).astype(
            np.float32)
    return out


def _t(tree):
    return pytree.tree_map(torch.from_numpy, tree)


def _to_jax_layout(tree):
    """The port's tree as numpy arrays in the reference's layout (conv
    kernels OIHW -> HWIO): the inverse of ``from_jax_params``."""
    def walk(t, parent):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(v, k) if k != "w" or parent not in TDiff.CONV_KEYS
                    else v.permute(2, 3, 1, 0).contiguous().numpy()
                    for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, parent) for v in t]
        return t.detach().numpy()
    return walk(tree, None)


def _assert_grads_close(got, ref):
    g_leaves, g_def = pytree.flatten(_to_jax_layout(got))
    r_leaves, r_def = jax.tree.flatten(ref)
    assert str(g_def) == str(r_def)
    scale = max(float(np.abs(np.asarray(r)).max()) for r in r_leaves)
    for g, r in zip(g_leaves, r_leaves):
        np.testing.assert_allclose(g, np.asarray(r), atol=1e-4 * scale,
                                   rtol=1e-4)


def _jdraws(seed, step, shape):
    """The reference's draws of a train step: ``fold_in(PRNGKey(seed),
    step)`` split into a uniform ``t`` (B,) and a normal ``eps``."""
    rng = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    r1, r2 = jax.random.split(rng)
    return (np.array(jax.random.uniform(r1, (shape[0],))),
            np.array(jax.random.normal(r2, shape, jnp.float32)))


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    """Two intra-op threads for the module's tests, restored after: under
    pytest-xdist several test processes share the machine's cores, and
    PyTorch's default of one thread a core then oversubscribes them (the
    smoke UNet's many small ops ran ~20x slower beside two other
    processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def ref_draws(monkeypatch):
    """``diffusion_draws`` replaced by the reference's draws."""
    def draws(batch, step):
        u, eps = _jdraws(int(batch["seed"]), int(step),
                         tuple(batch["latents"].shape))
        return torch.from_numpy(u), torch.from_numpy(eps)
    monkeypatch.setattr(TDiff, "diffusion_draws", draws)


_japply = {
    "flux_dev": jax.jit(JDiff.mmdit_apply, static_argnums=6),
    "unet_sdxl": jax.jit(JDiff.unet_apply, static_argnums=5),
}


def _apply_both(arch_id, jcfg, jp, tcfg, tp, x):
    if arch_id == "flux_dev":
        args = ("latents", "t", "ctx", "pooled", "guidance")
        jout = _japply[arch_id](jp, *(jnp.asarray(x[k]) for k in args), jcfg)
        tout = TDiff.mmdit_apply(tp, *(torch.from_numpy(x[k]) for k in args),
                                 tcfg)
    else:
        args = ("latents", "t", "ctx", "add_emb")
        jout = _japply[arch_id](jp, *(jnp.asarray(x[k]) for k in args), jcfg)
        tout = TDiff.unet_apply(tp, *(torch.from_numpy(x[k]) for k in args),
                                tcfg)
    return np.asarray(jout), tout


# --------------------------------------------------------------------------
# the shared helpers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dim,scale", [(256, 1000.0), (256, 1.0),
                                       (32, 999.0)])
def test_timestep_embedding_matches_reference(dim, scale):
    t = (np.random.default_rng(dim).random(64) * scale).astype(np.float32)
    t[0] = 0.0
    ref = np.asarray(JL.timestep_embedding(jnp.asarray(t), dim))
    got = TL.timestep_embedding(torch.from_numpy(t), dim)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(_np(got), ref, rtol=0,
                               atol=1e-6 + float(t.max()) * ULP)
    # the control: sines first
    swapped = torch.cat([got[:, dim // 2:], got[:, :dim // 2]], dim=-1)
    assert np.abs(_np(swapped) - ref).max() > 0.1


@pytest.mark.parametrize("h,w,d", [(4, 4, 64), (3, 5, 12), (64, 64, 3072)])
def test_axial_2d_sincos_matches_reference(h, w, d):
    ref = np.asarray(JDiff.axial_2d_sincos(h, w, d))
    got = TDiff.axial_2d_sincos(h, w, d)
    assert tuple(got.shape) == ref.shape == (h * w, d)
    np.testing.assert_allclose(_np(got), ref, rtol=0,
                               atol=1e-6 + (max(h, w) - 1) * ULP)
    # the control: w-major rows
    if h != w:
        ctl = TDiff.axial_2d_sincos(w, h, d)
        assert np.abs(_np(ctl) - ref).max() > 0.1


@pytest.mark.parametrize("sq,skv,d,heads", [(24, 24, 64, 4), (40, 7, 32, 2)])
def test_mha_matches_reference(sq, skv, d, heads):
    rng = np.random.default_rng(sq + skv)
    q, k, v = (rng.standard_normal((2, s, d)).astype(np.float32)
               for s in (sq, skv, skv))
    ref = np.asarray(JDiff._mha(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), heads, JL.F32))
    got = TDiff._mha(*map(torch.from_numpy, (q, k, v)), heads, TL.F32)
    np.testing.assert_allclose(_np(got), ref, atol=1e-6, rtol=0)


# --------------------------------------------------------------------------
# the models at their smoke configs
# --------------------------------------------------------------------------


def check_apply_matches_reference(arch_id):
    jcfg, jp, tcfg, tp = _pair(arch_id)
    x = _inputs(jcfg, 1)
    ref, got = _apply_both(arch_id, jcfg, jp, tcfg, tp, x)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == ref.shape == x["latents"].shape
    np.testing.assert_allclose(_np(got), ref, **TOL)
    if arch_id == "flux_dev":
        # the control: the port's blocks under the zero modulation of a
        # fresh init miss the perturbed reference
        _, _, _, fresh = _pair(arch_id, perturb=False)
        _, ctl = _apply_both(arch_id, jcfg, jp, tcfg, fresh, x)
        assert np.abs(_np(ctl) - ref).max() > 1e-2


def test_perturbed_modulation_reaches_every_block():
    """With the modulation drawn non-zero every weight of the blocks has
    a non-zero gradient; with the zeros of AdaLN-Zero they are 0."""
    jcfg, _, tcfg, tp = _pair("flux_dev")
    _, _, _, fresh = _pair("flux_dev", perturb=False)
    x = _t(_inputs(jcfg, 2))

    def loss(p):
        v = TDiff.mmdit_apply(p, x["latents"], x["t"], x["ctx"],
                              x["pooled"], x["guidance"], tcfg)
        return (v ** 2).mean()

    for params, nonzero in ((tp, True), (fresh, False)):
        _, g = TS.value_and_grad(loss, params)
        blocks = pytree.leaves({k: v for k, v in g["double"]["img"].items()
                                if k != "mod"}) + [g["single"]["wqkv"],
                                                   g["single"]["wo2"]]
        assert all(bool((b != 0).any()) == nonzero for b in blocks)


def check_sampler_step_matches_reference(arch_id):
    jcfg, jp, tcfg, tp = _pair(arch_id)
    x = _inputs(jcfg, 3)
    if arch_id == "flux_dev":
        x["dt"] = np.full(2, 0.25, np.float32)
        batch = {k: x[k] for k in ("latents", "t", "dt", "ctx", "pooled",
                                   "guidance")}
    else:
        x["t_prev"] = np.maximum(x["t"] - 250, 0).astype(np.float32)
        batch = {k: x[k] for k in ("latents", "t", "t_prev", "ctx",
                                   "add_emb")}
    ref = jax.jit(JS.diffusion_denoise_step(jcfg))(
        jp, jax.tree.map(jnp.asarray, batch))["latents"]
    got = TS.diffusion_denoise_step(tcfg)(tp, _t(batch))["latents"]
    assert not got.requires_grad
    np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)
    # the direct calls agree with the step
    if arch_id == "flux_dev":
        direct = TDiff.flux_euler_step(tp, *(torch.from_numpy(batch[k]) for k
                                             in ("latents", "t", "dt", "ctx",
                                                 "pooled", "guidance")), tcfg)
    else:
        direct = TDiff.unet_ddim_step(tp, *(torch.from_numpy(batch[k]) for k
                                            in ("latents", "t", "t_prev",
                                                "ctx", "add_emb")), tcfg)
    assert torch.equal(direct.detach(), got)


def _loss_batch(jcfg, seed, b=2):
    x = _inputs(jcfg, seed, b)
    keys = ("latents", "ctx", "pooled") if isinstance(
        jcfg, JDiff.MMDiTConfig) else ("latents", "ctx", "add_emb")
    batch = {k: x[k] for k in keys}
    batch["seed"] = np.array(seed * 7 + 1, np.int32)
    return batch


def check_loss_and_gradients_match_reference(arch_id):
    jcfg, jp, tcfg, tp = _pair(arch_id)
    batch = _loss_batch(jcfg, 4)
    step = 3
    rng = jax.random.fold_in(jax.random.PRNGKey(int(batch["seed"])), step)
    jloss_fn = JDiff.flux_rf_loss if arch_id == "flux_dev" \
        else JDiff.unet_eps_loss
    tloss_fn = TDiff.flux_rf_loss if arch_id == "flux_dev" \
        else TDiff.unet_eps_loss
    jbatch = jax.tree.map(jnp.asarray, batch)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(p, jbatch, jcfg, rng)))(jp)
    tl, tg = TS.value_and_grad(
        lambda p: tloss_fn(p, _t(batch), tcfg, torch.tensor(step)), tp)
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    _assert_grads_close(tg, jg)


def train_states(arch_id):
    """(reference state, port state, batch) after one
    ``diffusion_train_step`` of ``adamw(lr=1e-3)`` from the reference's
    weights, the two steps' metrics held to each other on the way."""
    jcfg, jp, tcfg, tp = _pair(arch_id)
    batch = _loss_batch(jcfg, 5, b=3)
    jopt, topt = JO.adamw(lr=1e-3), TO.adamw(lr=1e-3)
    jstate, jm = _jtrain_step(jcfg, 1e-3)(JS.make_state(jp, jopt),
                                          jax.tree.map(jnp.asarray, batch))
    tstate, tm = TS.diffusion_train_step(tcfg, topt)(
        TS.make_state(tp, topt), _t(batch))
    for k in ("loss", "grad_norm"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-4)
    assert int(tm["step"]) == int(jm["step"]) == 1
    return jstate, tstate, batch


def check_train_step_matches_reference(arch_id):
    """One step against the reference's jitted step, then a second step's
    loss and grad norm (its draws fold in step 1)."""
    jstate, tstate, batch = train_states(arch_id)
    lr = 1e-3
    g = pytree.leaves(_to_jax_layout(tstate["params"]))
    diff = np.concatenate([np.abs(a - np.asarray(b)).ravel() for a, b in
                           zip(g, jax.tree.leaves(jstate["params"]))])
    assert diff.max() <= 2 * lr
    assert np.quantile(diff, 0.999) <= 1e-3 * lr
    jcfg = jbase.get_arch(arch_id).smoke
    _, jm = _jtrain_step(jcfg, lr)(jstate, jax.tree.map(jnp.asarray, batch))
    _, tm = TS.diffusion_train_step(TDiff.from_jax_config(jcfg), TO.adamw(
        lr=lr))(tstate, _t(batch))
    assert int(tm["step"]) == 2
    for k in ("loss", "grad_norm"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-4)


def check_remat_gives_the_same_gradients(arch_id):
    """``remat`` recomputes each block in the backward: the loss and the
    gradients equal the stored run's bit for bit."""
    jcfg, _, tcfg, tp = _pair(arch_id)
    batch = _t(_loss_batch(jcfg, 6))
    loss_fn = TDiff.flux_rf_loss if arch_id == "flux_dev" \
        else TDiff.unet_eps_loss
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        out.append(TS.value_and_grad(
            lambda p: loss_fn(p, batch, cfg, 0), tp))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(pytree.leaves(g0), pytree.leaves(g1)):
        assert torch.equal(a, b)


def test_diffusion_draws_repeat_and_differ_across_steps():
    batch = {"latents": torch.zeros((3, 4, 4, 2)), "seed": np.int32(11)}
    u0, e0 = TDiff.diffusion_draws(batch, 0)
    u0b, e0b = TDiff.diffusion_draws(batch, torch.tensor(0,
                                                          dtype=torch.int32))
    u1, e1 = TDiff.diffusion_draws(batch, 1)
    assert torch.equal(u0, u0b) and torch.equal(e0, e0b)
    assert not torch.equal(u0, u1) and not torch.equal(e0, e1)
    assert u0.shape == (3,) and e0.shape == (3, 4, 4, 2)
    assert bool(((u0 >= 0) & (u0 < 1)).all())
    u2, _ = TDiff.diffusion_draws({**batch, "seed": np.int32(12)}, 0)
    assert not torch.equal(u0, u2)


# --------------------------------------------------------------------------
# from_jax_params, init, checkpoints
# --------------------------------------------------------------------------


def check_from_jax_params_keeps_leaves_order_and_none(arch_id):
    jcfg = jbase.get_arch(arch_id).smoke
    jp = jax.tree.map(np.asarray, _jparams(jcfg, 0))
    tp = TDiff.from_jax_params(jp, device="cpu")
    t_leaves, t_def = pytree.flatten(tp)
    j_leaves, j_def = jax.tree.flatten(jp)
    assert str(t_def) == str(j_def)
    assert len(t_leaves) == {"flux_dev": 33, "unet_sdxl": 456}[arch_id]
    back, _ = pytree.flatten(_to_jax_layout(tp))
    for b, j in zip(back, j_leaves):
        assert b.dtype == j.dtype and b.tobytes() == j.tobytes()
    if arch_id == "unet_sdxl":
        assert tp["down"][0]["attn"] == [None, None]
        assert tp["up"][-1]["attn"] == [None, None, None]
        assert tp["down"][-1]["down"] is None and tp["up"][-1]["up"] is None
        w = tp["down"][0]["res"][0]["conv1"]["w"]
        jw = jp["down"][0]["res"][0]["conv1"]["w"]
        assert tuple(w.shape) == (jw.shape[3], jw.shape[2], jw.shape[0],
                                  jw.shape[1])
        assert torch.equal(w[5, 3], torch.from_numpy(jw[:, :, 3, 5]))
        assert torch.equal(tp["time1"]["w"], torch.from_numpy(jp["time1"]["w"]))
        assert tp["mid"]["attn"]["blocks"]["wq1"]["w"].dim() == 3
    else:
        assert torch.equal(tp["double"]["img"]["wqkv"],
                           torch.from_numpy(jp["double"]["img"]["wqkv"]))
    bf = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tb = TDiff.from_jax_params(bf, device="cpu")
    for a, b in zip(pytree.leaves(_to_jax_layout(
            pytree.tree_map(lambda t: t.view(torch.int16), tb))),
            jax.tree.leaves(bf)):
        assert a.tobytes() == np.asarray(b).tobytes()
    with pytest.raises(ValueError, match="conv kernel"):
        TDiff.from_jax_params({"conv_in": {"w": np.zeros((3, 4), np.float32)}},
                              device="cpu")


def check_init_matches_reference_structure(arch_id):
    jcfg = jbase.get_arch(arch_id).smoke
    tcfg = TDiff.from_jax_config(jcfg)
    tp = TDiff.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    jinit = JDiff.mmdit_init if arch_id == "flux_dev" else JDiff.unet_init
    jshapes = jax.eval_shape(lambda k: jinit(k, jcfg), jax.random.PRNGKey(0))
    assert str(pytree.flatten(tp)[1]) == str(jax.tree.structure(jshapes))
    for t, j in zip(pytree.leaves(_to_jax_layout(tp)),
                    jax.tree.leaves(jshapes)):
        assert t.shape == j.shape and t.dtype == j.dtype
    if arch_id == "flux_dev":
        assert not bool(tp["final_mod"]["w"].any())
        assert not bool(tp["double"]["txt"]["mod"]["w"].any())


# --------------------------------------------------------------------------
# the registry and the launcher
# --------------------------------------------------------------------------


def test_registry_resolves_the_diffusion_archs():
    for arch_id in ("flux-dev", "unet_sdxl"):
        t, j = tbase.get_arch(arch_id), jbase.get_arch(arch_id)
        assert (t.arch_id, t.family, t.skip) == (j.arch_id, j.family, j.skip)
        assert t.config == TDiff.from_jax_config(j.config)
        assert t.smoke == TDiff.from_jax_config(j.smoke)
        assert t.config.n_params == j.config.n_params
        assert t.config.param_dtype == torch.bfloat16
        assert t.smoke.param_dtype == torch.float32
        assert {k: dataclasses.asdict(v) for k, v in t.shapes.items()} \
            == {k: dataclasses.asdict(v) for k, v in j.shapes.items()}
    from repro.configs import flux_dev as jflux
    from repro.configs import unet_sdxl as junet
    from repro_torch.configs import flux_dev as tflux
    from repro_torch.configs import unet_sdxl as tunet
    assert tflux.VAE_FACTOR == jflux.VAE_FACTOR == 8
    assert tunet.VAE_FACTOR == junet.VAE_FACTOR == 8
    assert tbase.DIFFUSION_SHAPES.keys() == jbase.DIFFUSION_SHAPES.keys()
    assert [tbase.get_arch(a).arch_id for a in tbase.list_archs()] == \
        list(jbase.ARCH_IDS)


@pytest.mark.parametrize("arch_id", ["flux-dev", "unet-sdxl"])
def test_launcher_batches_equal_reference(arch_id):
    arch_t, arch_j = tbase.get_arch(arch_id), jbase.get_arch(arch_id)
    tgen = tlaunch.make_batch_gen(arch_t, arch_t.smoke, 3,
                                  np.random.default_rng(0))
    jgen = jlaunch.make_batch_gen(arch_j, arch_j.smoke, 3,
                                  np.random.default_rng(0))
    for _ in range(3):
        tb, jb = next(tgen), next(jgen)
        assert tb.keys() == jb.keys()
        for k in tb:
            assert np.asarray(tb[k]).dtype == np.asarray(jb[k]).dtype
            assert np.array_equal(tb[k], jb[k])


@pytest.mark.parametrize("arch_id,n_leaves", [("flux-dev", 3 * 33 + 2),
                                              ("unet-sdxl", 3 * 456 + 2)])
def test_train_launcher_trains_and_restarts_diffusion(tmp_path, arch_id,
                                                      n_leaves):
    argv = ["--arch", arch_id, "--steps", "2", "--ckpt-every", "2",
            "--batch", "2", "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    out = io.StringIO()
    with redirect_stdout(out):
        tlaunch.main(argv)
    lines = out.getvalue().splitlines()
    assert len(lines) == 2 and lines[0].startswith("step    1 loss=")
    assert " gnorm=" in lines[0] and lines[-1] == "done"
    assert CheckpointManager(tmp_path).steps() == [2]
    assert json.loads((tmp_path / "step_2/manifest.json").read_text())[
        "n_leaves"] == n_leaves
    out = io.StringIO()
    with redirect_stdout(out):
        tlaunch.main(argv[:3] + ["3"] + argv[4:])
    lines = out.getvalue().splitlines()
    assert lines[0] == "restored checkpoint at step 2"
    assert lines[1].startswith("step    3 loss=")
    assert lines[-1] == "done"


# --------------------------------------------------------------------------
# the twins of tests/test_models.py::TestDiffusion and of the diffusion
# cases of tests/test_arch_smoke.py
# --------------------------------------------------------------------------


def _gen():
    return torch.Generator().manual_seed(0)


def _randn(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


class TestDiffusion:
    def test_mmdit_velocity_shape(self):
        cfg = TDiff.MMDiTConfig("t", 8, 4, 2, 64, 4, 2, 3, 32, 8, 16,
                                remat=False)
        p = TDiff.mmdit_init(_gen(), cfg, "cpu")
        v = TDiff.mmdit_apply(p, _randn(0, 2, 8, 8, 4),
                              torch.tensor([0.2, 0.9]), _randn(1, 2, 8, 32),
                              _randn(2, 2, 16), torch.zeros(2), cfg)
        assert v.shape == (2, 8, 8, 4) and bool(torch.isfinite(v).all())

    def test_unet_eps_and_ddim(self):
        cfg = TDiff.UNetConfig("t", 16, 4, 32, (1, 2, 4), 2, (1, 1, 2),
                               24, 7, 20, 16, remat=False)
        p = TDiff.unet_init(_gen(), cfg, "cpu")
        lat = _randn(0, 2, 16, 16, 4)
        ctx = _randn(1, 2, 7, 24)
        add = _randn(2, 2, 20)
        loss = TDiff.unet_eps_loss(
            p, {"latents": lat, "ctx": ctx, "add_emb": add, "seed": 0}, cfg,
            0)
        assert np.isfinite(float(loss))
        x = TDiff.unet_ddim_step(p, lat, torch.tensor([500., 500.]),
                                 torch.tensor([480., 480.]), ctx, add, cfg)
        assert x.shape == lat.shape

    def test_rf_loss_decreases_with_perfect_model(self):
        # sanity: the rf loss of the zero-velocity model equals E|eps-x0|^2
        cfg = TDiff.MMDiTConfig("t", 8, 4, 2, 32, 4, 1, 1, 16, 4, 8,
                                remat=False)
        p = TDiff.mmdit_init(_gen(), cfg, "cpu")
        lat = torch.zeros((4, 8, 8, 4))
        loss = TDiff.flux_rf_loss(
            p, {"latents": lat, "ctx": torch.zeros((4, 4, 16)),
                "pooled": torch.zeros((4, 8)), "seed": 0}, cfg, 0)
        assert 0.5 < float(loss) < 2.0  # ~E|eps|^2 = 1 for x0 = 0


def check_smoke_train_step(arch_id):
    arch = tbase.get_arch(arch_id)
    cfg = arch.smoke
    opt = TO.adamw(lr=1e-3)
    params = TDiff.init_params(_gen(), cfg, "cpu")
    r = cfg.latent_res
    batch = {"latents": _randn(0, 2, r, r, cfg.latent_ch),
             "seed": torch.tensor(0, dtype=torch.int32)}
    if arch_id == "flux_dev":
        batch["ctx"] = _randn(1, 2, cfg.n_ctx_tokens, cfg.d_ctx)
        batch["pooled"] = _randn(2, 2, cfg.d_pooled)
    else:
        batch["ctx"] = _randn(1, 2, cfg.n_ctx_tokens, cfg.ctx_dim)
        batch["add_emb"] = _randn(2, 2, cfg.d_add)
    state, metrics = TS.diffusion_train_step(cfg, opt)(
        TS.make_state(params, opt), batch)
    assert np.isfinite(float(metrics["loss"]))
    assert all(bool(torch.isfinite(t).all())
               for t in pytree.leaves(state["params"]))


def test_full_configs_match_published_widths():
    f = tbase.get_arch("flux_dev").config
    assert (f.latent_res, f.n_double_blocks, f.n_single_blocks, f.d_model,
            f.n_heads) == (128, 19, 38, 3072, 24)
    u = tbase.get_arch("unet_sdxl").config
    assert (u.ch, tuple(u.ch_mult), u.n_res_blocks,
            tuple(u.transformer_depth), u.ctx_dim) == (
        320, (1, 2, 4), 2, (1, 2, 10), 2048)


# --------------------------------------------------------------------------
# the MMDiT's cases of the checks above (the UNet's are in
# tests/test_torch_diffusion_unet.py)
# --------------------------------------------------------------------------


def test_apply_matches_reference():
    check_apply_matches_reference("flux_dev")


def test_sampler_step_matches_reference():
    check_sampler_step_matches_reference("flux_dev")


def test_loss_and_gradients_match_reference(ref_draws):
    check_loss_and_gradients_match_reference("flux_dev")


def test_train_step_matches_reference(ref_draws):
    check_train_step_matches_reference("flux_dev")


def test_remat_gives_the_same_gradients():
    check_remat_gives_the_same_gradients("flux_dev")


def test_from_jax_params_keeps_leaves_order_and_none():
    check_from_jax_params_keeps_leaves_order_and_none("flux_dev")


def test_init_matches_reference_structure():
    check_init_matches_reference_structure("flux_dev")


def test_smoke_train_step():
    check_smoke_train_step("flux_dev")
