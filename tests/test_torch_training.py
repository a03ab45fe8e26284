"""The port's training path against the reference's: ``chunked_ce_loss``
and ``lm_loss`` (value and gradients, against ``jax.value_and_grad``),
the LM train steps, the optimizers on identical gradients, and
``flash_attention``'s refusal of autograd (the detector's loss and train
step: ``tests/test_torch_detector.py``).

Inputs come from fixed numpy seeds; the port takes the reference's
initialised parameters (``from_jax_params``).

Tolerances:

* float32 losses and gradients: the reference's float32 attention
  tolerance (``tests/test_kernels.py``), atol 2e-5 and rtol 1e-4: only
  the float32 sums' order differs (3.9e-7 at most on the CPU).
* bf16 ``chunked_ce_loss``: the logits are exact products of bf16 values
  summed in float32 on both sides, so the loss agrees within rtol 1e-5;
  a gradient is a float32 sum rounded once to bf16, and a sum-order
  difference can move it to the neighbouring bf16 value: rtol 2^-7.
* Train steps (float32, adamw at lr): loss and grad norm rtol 1e-5; the
  moments mu atol 1e-6 and nu atol 1e-7 (their
  values reach 0.02 and 0.002).  The parameters (:func:`_assert_adamw_close`):
  every one within 2 lr a step, and 99.9% of them within 1e-3 lr.  AdamW's
  update is ``mhat / (sqrt(vhat) + eps)``, whose first step is
  ``g / (|g| + eps)``: where a gradient is near 0, a float32 sum-order
  difference can turn its sign, and the two runs then step that parameter
  up to lr each way; elsewhere they step alike (99.9% within 3e-5 lr on
  the CPU).
* The optimizers on identical gradients: bit for bit, against the
  reference's update run op by op (under ``jax.jit`` XLA contracts a
  multiply-add into one FMA, one rounding fewer); the global norm rtol
  1e-6 (a sum in another order) and the clipped leaves rtol 2e-6.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mixtral_8x22b as jmixtral
from repro.configs import smollm_135m as jsmol
from repro.kernels.attention import ops as jattn
from repro.models import transformer as JT
from repro.training import optimizer as JO
from repro.training import steps as JS
from repro_torch import pytree
from repro_torch.kernels.attention import ops as tattn
from repro_torch.models import transformer as TT
from repro_torch.training import optimizer as TO
from repro_torch.training import steps as TS

F32_TOL = dict(atol=2e-5, rtol=1e-4)
S = 37  # not a multiple of the smoke configs' ce_chunk of 16


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _lm_pair(jcfg, seed=0):
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, TT.from_jax_config(jcfg), TT.from_jax_params(
        jax.tree.map(np.asarray, jp), device="cpu")


def _lm_batch(vocab, b=2, s=S, seed=1):
    """Tokens and targets with a few -1 (ignored) targets."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    tgts = rng.integers(0, vocab, (b, s)).astype(np.int32)
    tgts[0, :5] = -1
    tgts[1, -3:] = -1
    return {"tokens": toks, "targets": tgts}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _assert_adamw_close(got, ref, lr: float, steps: int) -> None:
    """Parameters after ``steps`` AdamW steps from the same start, as the
    module's docstring bounds them (``ref``'s leaves numpy, in ``got``'s
    layout)."""
    diff = np.concatenate([np.abs(_np(g) - _np(r)).ravel() for g, r in
                           zip(pytree.leaves(got), pytree.leaves(ref))])
    assert diff.max() <= 2 * lr * steps
    assert np.quantile(diff, 0.999) <= 1e-3 * lr


def _assert_trees_close(got, ref, **tol):
    g_leaves, g_def = pytree.flatten(got)
    r_leaves, r_def = jax.tree.flatten(ref)
    assert str(g_def) == str(r_def)
    for g, r in zip(g_leaves, r_leaves):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(_np(g), _np(r), **tol)


# --------------------------------------------------------------------------
# lm_loss and chunked_ce_loss
# --------------------------------------------------------------------------


def _lm_loss_pair(jcfg, batch):
    jp, tcfg, tp = _lm_pair(jcfg)
    jl, jg = jax.value_and_grad(
        lambda p: JT.lm_loss(p, _jax(batch), jcfg))(jp)
    tl, tg = TS.value_and_grad(
        lambda p: TT.lm_loss(p, _torch(batch), tcfg), tp)
    return (jl, jg), (tl, tg), tcfg, tp


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_lm_loss_and_grads_match_reference_dense(remat):
    jcfg = dataclasses.replace(jsmol.smoke_config(), remat=remat)
    batch = _lm_batch(jcfg.vocab_size)
    (jl, jg), (tl, tg), tcfg, _ = _lm_loss_pair(jcfg, batch)
    assert tcfg.remat == remat and S % tcfg.ce_chunk
    np.testing.assert_allclose(float(tl), float(jl), **F32_TOL)
    _assert_trees_close(tg, jg, **F32_TOL)


@pytest.mark.parametrize("capacity", [1.0, 8.0], ids=["drops", "no_drops"])
def test_lm_loss_and_grads_match_reference_moe(capacity):
    """mixtral's smoke config: the aux loss, its window, and capacity
    overflow dropping picks (factor 1.0) or none (8.0)."""
    jcfg = dataclasses.replace(jmixtral.smoke_config(),
                               capacity_factor=capacity)
    batch = _lm_batch(jcfg.vocab_size, s=24)
    (jl, jg), (tl, tg), tcfg, tp = _lm_loss_pair(jcfg, batch)
    routes = []
    with torch.no_grad():
        _, aux = TT.forward(tp, _torch(batch)["tokens"], tcfg, routes=routes)
    dropped = sum(int((~r.keep).sum()) for r in routes)
    assert (dropped > 0) == (capacity == 1.0)
    assert float(aux) > 0
    np.testing.assert_allclose(float(tl), float(jl), **F32_TOL)
    _assert_trees_close(tg, jg, **F32_TOL)


def test_remat_gives_the_gradients_of_no_remat():
    """The three remat sites recompute the same operations: the loss and
    every gradient are equal to the last bit."""
    cfg = dataclasses.replace(TT.from_jax_config(jsmol.smoke_config()),
                              attn_chunk=8, ce_chunk=8)
    params = TT.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    batch = _torch(_lm_batch(cfg.vocab_size))
    plain = TS.value_and_grad(lambda p: TT.lm_loss(p, batch, cfg), params)
    remat_cfg = dataclasses.replace(cfg, remat=True)
    remat = TS.value_and_grad(lambda p: TT.lm_loss(p, batch, remat_cfg),
                              params)
    assert torch.equal(plain[0], remat[0])
    for a, b in zip(pytree.leaves(plain[1]), pytree.leaves(remat[1])):
        assert torch.equal(a, b)


def test_remat_saves_no_chunk_scores():
    """Under remat autograd keeps no (Sq, chunk) score matrix of the
    attention chunks: the saved tensors of one layer's forward are its
    inputs, not S^2 scores."""
    cfg = dataclasses.replace(TT.from_jax_config(jsmol.smoke_config()),
                              n_layers=1, attn_chunk=8)
    params = TT.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    batch = _torch(_lm_batch(cfg.vocab_size, s=64))
    for remat, want_scores in ((False, True), (True, False)):
        shapes = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: shapes.append(tuple(t.shape)) or t, lambda t: t):
            TS.value_and_grad(
                lambda p: TT.lm_loss(p, batch, dataclasses.replace(
                    cfg, remat=remat)), params)
        scores = (2, cfg.n_heads, 64, 8)
        assert (scores in shapes) == want_scores


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_ce_loss_matches_reference(dtype):
    """The CE alone: ragged last chunk, -1 targets, bf16 operands (the
    reference's float32-output product)."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jcfg = dataclasses.replace(jsmol.smoke_config(), param_dtype=jdt,
                               compute_dtype=jdt)
    tcfg = TT.from_jax_config(jcfg)
    rng = np.random.default_rng(2)
    h = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    w = (rng.standard_normal((jcfg.d_model, jcfg.vocab_size)) * 0.1
         ).astype(np.float32)
    t = _lm_batch(jcfg.vocab_size)["targets"]
    jl, (jgh, jgw) = jax.value_and_grad(
        lambda h, w: JT.chunked_ce_loss(h, w, jnp.asarray(t), jcfg),
        argnums=(0, 1))(jnp.asarray(h).astype(jdt), jnp.asarray(w).astype(jdt))
    th = torch.from_numpy(h).to(tdt).requires_grad_()
    tw = torch.from_numpy(w).to(tdt).requires_grad_()
    tl = TT.chunked_ce_loss(th, tw, torch.from_numpy(t), tcfg)
    tgh, tgw = torch.autograd.grad(tl, [th, tw])
    assert tl.dtype == torch.float32 and tgh.dtype == tdt
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    tol = F32_TOL if dtype == "float32" else dict(atol=1e-6, rtol=2.0 ** -7)
    for got, ref in ((tgh, jgh), (tgw, jgw)):
        np.testing.assert_allclose(_np(got), _np(ref), **tol)


def test_chunked_ce_loss_counts_only_valid_targets():
    cfg = TT.from_jax_config(jsmol.smoke_config())
    h = torch.randn(1, 20, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    w = torch.randn(cfg.d_model, cfg.vocab_size, generator=torch.Generator()
                    .manual_seed(1)) * 0.1
    t = torch.arange(20)[None] % cfg.vocab_size
    masked = t.clone()
    masked[0, 10:] = -1
    logits = (h @ w)[0]
    want = (torch.logsumexp(logits[:10], -1)
            - logits[torch.arange(10), t[0, :10]]).mean()
    torch.testing.assert_close(TT.chunked_ce_loss(h, w, masked, cfg), want,
                               atol=1e-6, rtol=1e-6)
    none = torch.full_like(t, -1)
    assert float(TT.chunked_ce_loss(h, w, none, cfg)) == 0.0


# --------------------------------------------------------------------------
# train steps
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["smollm", "mixtral"])
def test_three_lm_train_steps_match_reference(name):
    jcfg = (jsmol if name == "smollm" else jmixtral).smoke_config()
    lr = 1e-3
    jopt = JO.adamw(lr=lr, warmup_steps=2, weight_decay=0.01)
    topt = TO.adamw(lr=lr, warmup_steps=2, weight_decay=0.01)
    jp, tcfg, tp = _lm_pair(jcfg)
    jstate, tstate = JS.make_state(jp, jopt), TS.make_state(tp, topt)
    jstep = jax.jit(JS.lm_train_step(jcfg, jopt))
    tstep = TS.lm_train_step(tcfg, topt)
    for i in range(3):
        batch = _lm_batch(jcfg.vocab_size, s=24, seed=10 + i)
        jstate, jm = jstep(jstate, _jax(batch))
        tstate, tm = tstep(tstate, _torch(batch))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
        assert int(tm["step"]) == int(jm["step"]) == i + 1
    assert not any(t.requires_grad for t in pytree.leaves(tstate))
    assert int(tstate["step"]) == int(tstate["opt"]["step"]) == 3
    assert tstate["step"].dtype == torch.int32
    assert str(pytree.flatten(tstate)[1]) == str(jax.tree.structure(jstate))
    _assert_adamw_close(tstate["params"], jax.tree.map(np.asarray,
                                                       jstate["params"]),
                        lr, 3)
    _assert_trees_close(tstate["opt"]["mu"], jstate["opt"]["mu"], atol=1e-6,
                        rtol=0)
    _assert_trees_close(tstate["opt"]["nu"], jstate["opt"]["nu"], atol=1e-7,
                        rtol=0)


def test_train_step_leaves_its_inputs_unchanged():
    cfg = TT.from_jax_config(jsmol.smoke_config())
    opt = TO.adamw(lr=1e-2)
    params = TT.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    state = TS.make_state(params, opt)
    before = [t.clone() for t in pytree.leaves(state)]
    new, _ = TS.lm_train_step(cfg, opt)(state,
                                        _torch(_lm_batch(cfg.vocab_size)))
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                  pytree.leaves(state)))
    assert not torch.equal(new["params"]["embed"]["emb"],
                           params["embed"]["emb"])


# --------------------------------------------------------------------------
# flash attention has no backward
# --------------------------------------------------------------------------


def test_flash_attention_refuses_autograd_as_the_reference_does():
    x = np.random.default_rng(0).standard_normal((1, 16, 2, 16)).astype(
        np.float32)
    with pytest.raises(AssertionError):
        jax.grad(lambda q: jattn.flash_attention(q, q, q).sum())(
            jnp.asarray(x))
    q = torch.from_numpy(x).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        tattn.flash_attention(q, q, q)
    # without grad, or with grad disabled, it runs
    with torch.no_grad():
        assert tattn.flash_attention(q, q, q).shape == q.shape
    assert tattn.flash_attention(q.detach(), q.detach(), q.detach()
                                 ).grad_fn is None
    # and a train step on the flash path raises, not trains without it
    cfg = dataclasses.replace(TT.from_jax_config(jsmol.smoke_config()),
                              attention_impl="flash")
    params = TT.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    opt = TO.adamw()
    with pytest.raises(RuntimeError, match="no backward"):
        TS.lm_train_step(cfg, opt)(TS.make_state(params, opt),
                                   _torch(_lm_batch(cfg.vocab_size)))


# --------------------------------------------------------------------------
# optimizers on identical gradients
# --------------------------------------------------------------------------


def _opt_trees(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"a": {"w": (4, 3), "b": (3,)}, "z": [(5,), (2, 2)]}
    return jax.tree.map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))


def _run_opts(jopt, topt, n=12):
    params = _opt_trees(0)
    jp = jax.tree.map(jnp.asarray, params)
    tp = pytree.tree_map(torch.from_numpy, params)
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(n):
        g = _opt_trees(100 + i)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), jp, js)
        with torch.no_grad():
            tp, ts = topt.update(pytree.tree_map(torch.from_numpy, g), tp, ts)
    return (jp, js), (tp, ts)


@pytest.mark.parametrize("kw", [dict(lr=0.1), dict(lr=0.1, warmup_steps=5),
                                dict(lr=0.05, weight_decay=0.1,
                                     warmup_steps=3)],
                         ids=["plain", "warmup", "decay"])
def test_adamw_matches_reference_on_identical_gradients(kw):
    (jp, js), (tp, ts) = _run_opts(JO.adamw(**kw), TO.adamw(**kw))
    _assert_trees_close(tp, jp, atol=0, rtol=0)
    _assert_trees_close(ts["mu"], js["mu"], atol=0, rtol=0)
    _assert_trees_close(ts["nu"], js["nu"], atol=0, rtol=0)
    assert int(ts["step"]) == int(js["step"]) == 12
    assert ts["step"].dtype == torch.int32


def test_sgd_matches_reference_on_identical_gradients():
    kw = dict(lr=0.05, momentum=0.9, weight_decay=0.01)
    (jp, js), (tp, ts) = _run_opts(JO.sgd(**kw), TO.sgd(**kw))
    _assert_trees_close(tp, jp, atol=0, rtol=0)
    _assert_trees_close(ts["vel"], js["vel"], atol=0, rtol=0)
    assert int(ts["step"]) == int(js["step"]) == 12


@pytest.mark.parametrize("max_norm", [1.0, 0.3, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _opt_trees(7)
    jc, jn = JO.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    tc, tn = TO.clip_by_global_norm(pytree.tree_map(torch.from_numpy, g),
                                    max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    _assert_trees_close(tc, jc, atol=0, rtol=2e-6)
    # a bf16 gradient is clipped in float32, as JAX promotes it
    bf = {"w": torch.ones(3, dtype=torch.bfloat16) * 3}
    clipped, _ = TO.clip_by_global_norm(bf, 1.0)
    assert clipped["w"].dtype == torch.float32
