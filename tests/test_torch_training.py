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
* AdamW with bf16 moments and SGD on bf16 parameters: bit for bit
  against the reference's eager update, over 12 steps.  Against
  ``jax.jit(update)`` the moments stay bit for bit, and each parameter
  within ``n 2^-7 (|p| + n lr)`` after n steps (:data:`BF16_JIT_ULPS`):
  XLA's fused update can round delta's float32 arithmetic otherwise (one
  rounding fewer, as above), an ulp that a bf16 rounding of the parameter (its dtype's, or the bf16
  state's ``p.astype(bfloat16)``) can carry into one bf16 ulp of it,
  2^-7 of its magnitude at most, once a step; a parameter's magnitude
  stays within ``|p| + n lr`` of its end value (each step moves it by
  about lr at most).  On the CPU the 12 steps read up to 1.15 such
  ulps, a tenth of the limit.
* The LM train steps with bf16 moments against the reference's jitted
  step: the loss and grad norm as above (rtol 1e-5); the parameters
  within 2 lr a step, and 99.9% of them within 1e-3 lr plus a bf16 ulp
  of the parameter a step (the bf16 state rounds each float32 parameter
  to bf16 before it steps, and a float32 difference can move that
  rounding to the neighbouring bf16 value); each moment within ``n
  (atol + 2^-7 |m|)`` after n steps, atol the float32 moments' (1e-6 for
  mu, 1e-7 for nu): a float32 gradient difference as for float32
  moments, plus one bf16 neighbour a step, the older differences shrunk
  by b1 or b2.  The reference's own eager step lies as far from its
  jitted one (on the CPU both read up to 2.8 of the n = 3 allowed).
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


@pytest.mark.parametrize("jit", [True, False], ids=["jit", "eager"])
def test_three_moe_train_steps_with_bf16_moments_match_reference(jit):
    """mixtral's smoke config with ``adamw(state_dtype=bfloat16)``, as the
    card trains mixtral-8x22b, against the reference's step (jitted, and
    op by op), within the module docstring's bf16-moment tolerances."""
    jcfg = jmixtral.smoke_config()
    lr, n = 1e-3, 3
    kw = dict(lr=lr, warmup_steps=2, weight_decay=0.01)
    jopt = JO.adamw(state_dtype=jnp.bfloat16, **kw)
    topt = TO.adamw(state_dtype=torch.bfloat16, **kw)
    jp, tcfg, tp = _lm_pair(jcfg)
    jstate, tstate = JS.make_state(jp, jopt), TS.make_state(tp, topt)
    jstep = JS.lm_train_step(jcfg, jopt)
    jstep = jax.jit(jstep) if jit else jstep
    tstep = TS.lm_train_step(tcfg, topt)
    for i in range(n):
        batch = _lm_batch(jcfg.vocab_size, s=24, seed=10 + i)
        jstate, jm = jstep(jstate, _jax(batch))
        tstate, tm = tstep(tstate, _torch(batch))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    assert int(tstate["step"]) == n
    diff = np.concatenate([
        np.abs(_np(g) - np.asarray(r)).ravel() / (
            1e-3 * lr + n * 2.0 ** -7 * np.abs(np.asarray(r)).ravel())
        for g, r in zip(pytree.leaves(tstate["params"]),
                        jax.tree.leaves(jstate["params"]))])
    assert np.quantile(diff, 0.999) <= 1.0
    for g, r in zip(pytree.leaves(tstate["params"]),
                    jax.tree.leaves(jstate["params"])):
        assert np.abs(_np(g) - np.asarray(r)).max() <= 2 * lr * n
    for k, atol in (("mu", 1e-6), ("nu", 1e-7)):
        for g, r in zip(pytree.leaves(tstate["opt"][k]),
                        jax.tree.leaves(jstate["opt"][k])):
            assert g.dtype == torch.bfloat16
            g, r = _np(g), np.asarray(r.astype(jnp.float32))
            bound = n * (atol + 2.0 ** -7 * np.maximum(np.abs(g), np.abs(r)))
            assert (np.abs(g - r) <= bound).all()


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


def _run_opts(jopt, topt, n=12, trees=_opt_trees, dtype="float32",
              jit=False):
    """n updates of both optimizers from the same parameters on the same
    gradients, both in ``dtype`` (numpy float32 trees rounded once, the
    same bf16 values on both sides)."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def both(tree):
        j = jax.tree.map(lambda x: jnp.asarray(x).astype(jdt), tree)
        return j, pytree.tree_map(
            lambda x: torch.from_numpy(np.array(x.astype(jnp.float32))
                                       ).to(tdt), j)

    jp, tp = both(trees(0))
    js, ts = jopt.init(jp), topt.init(tp)
    jupdate = jax.jit(jopt.update) if jit else jopt.update
    for i in range(n):
        jg, tg = both(trees(100 + i))
        jp, js = jupdate(jg, jp, js)
        with torch.no_grad():
            tp, ts = topt.update(tg, tp, ts)
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


def _wide_trees(seed=0):
    """A 64x128 matrix and a 128 vector: past ATen's 128-element switch
    to MKL's vector square root (not rounded to nearest) on the CPU."""
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.standard_normal((64, 128)).astype(np.float32),
                  "b": rng.standard_normal((128,)).astype(np.float32)}}


# each bf16 parameter against jax.jit(update): n 2^-7 (|p| + n lr) after
# n steps (the module's docstring)
BF16_JIT_ULPS = 2.0 ** -7
ADAMW_KW = [dict(lr=0.1), dict(lr=0.1, warmup_steps=5),
            dict(lr=0.05, weight_decay=0.1, warmup_steps=3)]
ADAMW_IDS = ["plain", "warmup", "decay"]
SGD_KW = [dict(lr=0.05, momentum=0.9, weight_decay=0.01),
          dict(lr=0.1, momentum=0.9)]


def _assert_bf16_jit_close(got, ref, lr: float, n: int) -> None:
    for g, r in zip(pytree.leaves(got), jax.tree.leaves(ref)):
        r = np.asarray(r.astype(jnp.float32))
        tol = n * BF16_JIT_ULPS * (np.abs(r) + n * lr)
        assert (np.abs(_np(g) - r) <= tol).all()


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("param_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kw", ADAMW_KW, ids=ADAMW_IDS)
def test_adamw_bf16_state_matches_reference(kw, param_dtype, jit):
    """bf16 moments over bf16 and float32 parameters: the weak Python
    constants and the float32 0-d arrays' promotion, as JAX types them."""
    (jp, js), (tp, ts) = _run_opts(
        JO.adamw(state_dtype=jnp.bfloat16, **kw),
        TO.adamw(state_dtype=torch.bfloat16, **kw), trees=_wide_trees,
        dtype=param_dtype, jit=jit)
    for k in ("mu", "nu"):
        assert all(t.dtype == torch.bfloat16 for t in pytree.leaves(ts[k]))
        _assert_trees_close(ts[k], js[k], atol=0, rtol=0)
    assert all(t.dtype == getattr(torch, param_dtype)
               for t in pytree.leaves(tp))
    if jit:
        _assert_bf16_jit_close(tp, jp, kw["lr"], 12)
    else:
        _assert_trees_close(tp, jp, atol=0, rtol=0)
    assert int(ts["step"]) == int(js["step"]) == 12


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("kw", SGD_KW, ids=["momentum_decay", "momentum"])
def test_sgd_bf16_params_match_reference(kw, jit):
    (jp, js), (tp, ts) = _run_opts(JO.sgd(**kw), TO.sgd(**kw),
                                   trees=_wide_trees, dtype="bfloat16",
                                   jit=jit)
    assert all(t.dtype == torch.bfloat16 for t in pytree.leaves(tp))
    _assert_trees_close(ts["vel"], js["vel"], atol=0, rtol=0)
    if jit:
        _assert_bf16_jit_close(tp, jp, kw["lr"], 12)
    else:
        _assert_trees_close(tp, jp, atol=0, rtol=0)


def _pre_repair_adamw(lr, b1=0.9, b2=0.95, eps=1e-8):
    """AdamW's update as the port computed it before it followed JAX's
    type rules: Python-float constants kept at float32 precision against
    a bf16 moment, and the bf16 moments' quotients by the float32 0-d
    bias corrections kept in bf16."""
    def init(params):
        return {"mu": pytree.tree_map(lambda p: torch.zeros_like(
                    p, dtype=torch.bfloat16), params),
                "nu": pytree.tree_map(lambda p: torch.zeros_like(
                    p, dtype=torch.bfloat16), params),
                "step": torch.zeros((), dtype=torch.int32)}

    def update(grads, params, state):
        step = state["step"] + 1
        stepf = step.to(torch.float32)
        lr_t = lr * torch.ones_like(stepf)
        bc1, bc2 = 1.0 - b1 ** stepf, 1.0 - b2 ** stepf

        def upd(g, p, mu, nu):
            g16 = g.to(torch.bfloat16)
            mu_n = b1 * mu + (1 - b1) * g16
            nu_n = b2 * nu + (1 - b2) * (g16 * g16)
            delta = (mu_n / bc1) / (torch.sqrt(nu_n / bc2) + eps)
            return (p.to(torch.bfloat16) - lr_t * delta).to(p.dtype), mu_n, \
                nu_n

        out = [upd(*a) for a in zip(pytree.leaves(grads),
                                    pytree.leaves(params),
                                    pytree.leaves(state["mu"]),
                                    pytree.leaves(state["nu"]))]
        treedef = pytree.flatten(params)[1]
        return (treedef.unflatten([o[0] for o in out]),
                {"mu": treedef.unflatten([o[1] for o in out]),
                 "nu": treedef.unflatten([o[2] for o in out]),
                 "step": step})

    return TO.Optimizer(init, update)


def _pre_repair_sgd(lr, momentum):
    def init(params):
        return {"vel": pytree.tree_map(torch.zeros_like, params),
                "step": torch.zeros((), dtype=torch.int32)}

    def update(grads, params, state):
        treedef = pytree.flatten(params)[1]
        out = [(p - lr * (momentum * v + g), momentum * v + g)
               for g, p, v in zip(pytree.leaves(grads), pytree.leaves(params),
                                  pytree.leaves(state["vel"]))]
        return (treedef.unflatten([o[0].to(torch.bfloat16) for o in out]),
                {"vel": treedef.unflatten([o[1] for o in out]),
                 "step": state["step"] + 1})

    return TO.Optimizer(init, update)


@pytest.mark.parametrize("opt", ["adamw", "sgd"])
def test_pre_repair_arithmetic_differs_from_reference(opt):
    """The control of the bf16 parity tests: the arithmetic without JAX's
    type rules, on the same trees, leaves the reference's eager update in
    at least one element of the parameters (and, for AdamW, the
    moments)."""
    if opt == "adamw":
        jopt = JO.adamw(lr=0.1, state_dtype=jnp.bfloat16)
        topt, keys = _pre_repair_adamw(lr=0.1), ("mu", "nu")
    else:
        jopt, topt, keys = JO.sgd(lr=0.1, momentum=0.9), \
            _pre_repair_sgd(lr=0.1, momentum=0.9), ("vel",)
    (jp, js), (tp, ts) = _run_opts(jopt, topt, trees=_wide_trees,
                                   dtype="bfloat16")

    def n_differ(got, ref):
        return sum(int((_np(g) != np.asarray(r.astype(jnp.float32))).sum())
                   for g, r in zip(pytree.leaves(got), jax.tree.leaves(ref)))

    assert n_differ(tp, jp) > 0
    if opt == "adamw":
        assert all(n_differ(ts[k], js[k]) > 0 for k in keys)


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


# --------------------------------------------------------------------------
# the train steps' update, one leaf at a time
# --------------------------------------------------------------------------

LEAF_OPTS = {
    "adamw_f32_moments": lambda: TO.adamw(lr=0.05, weight_decay=0.1,
                                          warmup_steps=3),
    "adamw_bf16_moments": lambda: TO.adamw(lr=0.05, weight_decay=0.1,
                                           warmup_steps=3,
                                           state_dtype=torch.bfloat16),
    "sgd": lambda: TO.sgd(lr=0.05, momentum=0.9, weight_decay=0.01),
}


def _leaf_trees(seed, dtype):
    """A leaf of each kind the slicer meets: a stack whose first
    dimension holds one row, a matrix whose 37 rows a slice does not
    divide, a vector and a scalar."""
    rng = np.random.default_rng(seed)
    shapes = {"stack": (1, 6, 5, 7), "w": (37, 5), "b": (300,), "s": ()}
    return {k: torch.from_numpy(np.asarray(3 * rng.standard_normal(s),
                                           np.float32)).to(dtype)
            for k, s in shapes.items()}


def _counting(opt):
    """``opt`` with its rule's ``upd`` calls counted (``calls[0]``)."""
    calls = [0]

    def rule(state):
        upd, slots, rest = opt.rule(state)

        def counted(*a):
            calls[0] += 1
            return upd(*a)
        return counted, slots, rest

    return TO.Optimizer(opt.init, opt.update, rule), calls


def _assert_bit_equal(got, want):
    g_leaves, g_def = pytree.flatten(got)
    w_leaves, w_def = pytree.flatten(want)
    assert str(g_def) == str(w_def)
    for g, w in zip(g_leaves, w_leaves):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("sliced", [False, True], ids=["whole", "sliced"])
@pytest.mark.parametrize("max_norm", [1.0, 1e4], ids=["clips", "no_clip"])
@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32_params", "bf16_params"])
@pytest.mark.parametrize("name", list(LEAF_OPTS))
def test_leaf_update_matches_clip_then_update(name, param_dtype, max_norm,
                                              sliced, monkeypatch):
    """``clip_and_update`` (the train steps' update) against the whole-tree
    composition it replaces, ``clip_by_global_norm`` then ``update``, over
    5 steps: the same norm, parameters and state, bit for bit; each
    gradient entry cleared; the inputs unchanged.  ``sliced`` updates
    every leaf of more than 8 elements in slices of at most 8 (upd called
    once a slice), against the whole leaves."""
    opt = LEAF_OPTS[name]()
    params = _leaf_trees(0, param_dtype)
    before = [t.clone() for t in pytree.leaves(params)]
    p_old, s_old = params, opt.init(params)
    old_norms = []
    for i in range(5):
        clipped, norm = TO.clip_by_global_norm(
            _leaf_trees(100 + i, param_dtype), max_norm)
        p_old, s_old = opt.update(clipped, p_old, s_old)
        old_norms.append(norm)
    if sliced:
        monkeypatch.setattr(TO, "SLICE_ELEMS", 8)
    counted, calls = _counting(opt)
    p_new, s_new = params, opt.init(params)
    for i in range(5):
        leaves, treedef = pytree.flatten(_leaf_trees(100 + i, param_dtype))
        p_new, s_new, norm = TO.clip_and_update(counted, leaves, treedef,
                                                p_new, s_new, max_norm)
        assert all(g is None for g in leaves)
        assert torch.equal(norm, old_norms[i])
    _assert_bit_equal(p_new, p_old)
    _assert_bit_equal(s_new, s_old)
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                  pytree.leaves(params)))
    # the (1, 6, 5, 7) stack in slices of one row of 7 at each of its 6
    # x 5 leading indices, the matrix in its 37 rows of 5 one at a time,
    # the vector of 300 in runs of 8
    per_step = (30 + 37 + 38 + 1) if sliced else 4
    assert calls[0] == 5 * per_step


@pytest.mark.parametrize("case", [
    ("adamw", "float32", "float32"), ("adamw", "bfloat16", "bfloat16"),
    ("adamw", "bfloat16", "float32"), ("sgd", None, "bfloat16"),
    ("sgd", None, "float32")],
    ids=["adamw_f32", "adamw_bf16_bf16_params", "adamw_bf16_f32_params",
         "sgd_bf16", "sgd_f32"])
def test_sliced_leaf_update_matches_reference_eager(case, monkeypatch):
    """``clip_and_update`` with every leaf in slices of 1000 elements (the
    64 x 128 matrix in 9 slices of 7 rows and one of 1) against the
    reference's eager ``clip_by_global_norm`` then ``update`` on the same
    gradients, 12 steps, bit for bit, as
    ``test_adamw_bf16_state_matches_reference`` holds the whole-tree
    update.  At a ``max_norm`` the gradients stay under, the clip scale is
    exactly 1 on both sides (their norms, float32 sums in another order,
    agree within rtol 1e-6: ``test_clip_by_global_norm_matches_reference``)."""
    opt, state_dtype, dtype = case
    kw = dict(lr=0.05, momentum=0.9, weight_decay=0.01)
    if opt == "adamw":
        kw = dict(lr=0.05, weight_decay=0.1, warmup_steps=3)
        jopt = JO.adamw(state_dtype=getattr(jnp, state_dtype), **kw)
        topt = TO.adamw(state_dtype=getattr(torch, state_dtype), **kw)
    else:
        jopt, topt = JO.sgd(**kw), TO.sgd(**kw)
    monkeypatch.setattr(TO, "SLICE_ELEMS", 1000)
    counted, calls = _counting(topt)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def both(tree):
        j = jax.tree.map(lambda x: jnp.asarray(x).astype(jdt), tree)
        return j, pytree.tree_map(
            lambda x: torch.from_numpy(np.array(x.astype(jnp.float32))
                                       ).to(tdt), j)

    jp, tp = both(_wide_trees(0))
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(12):
        jg, tg = both(_wide_trees(100 + i))
        jg, _ = JO.clip_by_global_norm(jg, 1e4)
        jp, js = jopt.update(jg, jp, js)
        leaves, treedef = pytree.flatten(tg)
        with torch.no_grad():
            tp, ts, _ = TO.clip_and_update(counted, leaves, treedef, tp, ts,
                                           1e4)
    assert calls[0] == 12 * (10 + 1)
    _assert_trees_close(tp, jp, atol=0, rtol=0)
    for k in (("mu", "nu") if opt == "adamw" else ("vel",)):
        _assert_trees_close(ts[k], js[k], atol=0, rtol=0)
    assert int(ts["step"]) == int(js["step"]) == 12


def _whole_tree_step(cfg, opt):
    """``lm_train_step`` as it was composed before the update went leaf
    by leaf: the gradient tree, ``clip_by_global_norm`` on it, then
    ``opt.update`` on the clipped tree."""
    def step(state, batch):
        loss, grads = TS.value_and_grad(
            lambda p: TT.lm_loss(p, batch, cfg), state["params"])
        with torch.no_grad():
            grads, gnorm = TO.clip_by_global_norm(grads, 1.0)
            params, opt_state = opt.update(grads, state["params"],
                                           state["opt"])
        return ({"params": params, "opt": opt_state,
                 "step": state["step"] + 1},
                {"loss": loss, "grad_norm": gnorm, "step": state["step"] + 1})

    return step


@pytest.mark.parametrize("state_dtype,sliced", [
    (torch.float32, False), (torch.bfloat16, True)],
    ids=["f32_moments_whole", "bf16_moments_sliced"])
def test_three_moe_train_steps_unchanged_by_leaf_update(state_dtype, sliced,
                                                        monkeypatch):
    """Three ``lm_train_step``s of mixtral's smoke config in bf16 give the
    bits of the whole-tree composition (:func:`_whole_tree_step`): loss,
    grad norm, parameters and moments; ``sliced`` runs every leaf of more
    than 64 elements in slices (the expert stacks in runs of rows, expert
    by expert)."""
    cfg = dataclasses.replace(TT.from_jax_config(jmixtral.smoke_config()),
                              param_dtype=torch.bfloat16,
                              compute_dtype=torch.bfloat16)
    params = TT.init_params(torch.Generator().manual_seed(5), cfg,
                            device="cpu")
    opt = TO.adamw(lr=1e-3, warmup_steps=2, weight_decay=0.01,
                   state_dtype=state_dtype)
    batches = [_torch(_lm_batch(cfg.vocab_size, s=24, seed=20 + i))
               for i in range(3)]
    old = TS.make_state(params, opt)
    old_m = []
    for b in batches:
        old, m = _whole_tree_step(cfg, opt)(old, b)
        old_m.append(m)
    if sliced:
        monkeypatch.setattr(TO, "SLICE_ELEMS", 64)
    new = TS.make_state(params, opt)
    step = TS.lm_train_step(cfg, opt)
    for b, om in zip(batches, old_m):
        new, m = step(new, b)
        for k in ("loss", "grad_norm", "step"):
            assert torch.equal(m[k], om[k])
    _assert_bit_equal(new, old)


def _smoke_train_cell(arch_id, shape):
    from repro_torch.configs import base as tbase
    from repro_torch.launch import cells as tcells

    arch = tbase.get_arch(arch_id)
    arch = dataclasses.replace(arch, config=arch.smoke)
    build = {"lm": tcells._lm_cell, "vision": tcells._vision_cell,
             "diffusion": tcells._diffusion_cell}[arch.family]
    return build(arch, shape)


@pytest.mark.parametrize("arch_id,shape", [
    ("mixtral_8x22b", dict(seq_len=16, global_batch=2)),
    ("resnet_50", dict(img_res=32, batch=2)),
    ("flux_dev", dict(img_res=32, batch=1))],
    ids=["lm", "vision", "diffusion"])
def test_train_steps_free_each_gradient_before_the_next_leaf(
        arch_id, shape, monkeypatch):
    """``lm_train_step``, ``vision_train_step`` and
    ``diffusion_train_step`` keep no reference to a gradient once its
    leaf is updated: when a leaf's update starts, every earlier leaf's
    gradient is already freed (a weak reference to it is dead)."""
    from repro_torch.configs import base as tbase
    from repro_torch.launch import cells as tcells

    import weakref

    cell = _smoke_train_cell(arch_id, tbase.ShapeSpec("t", "train", **shape))
    state, batch = tcells.materialize(cell, device="cpu", seed=4)
    seen, alive_at = [], []
    inner = TO._leaf_update

    def watched(upd, g, *a):
        alive_at.append(sum(r() is not None for r in seen))
        seen.append(weakref.ref(g))
        return inner(upd, g, *a)

    monkeypatch.setattr(TO, "_leaf_update", watched)
    new, m = cell.step(state, batch)
    assert len(seen) == len(pytree.leaves(state["params"])) > 10
    assert alive_at == [0] * len(seen)
    assert bool(torch.isfinite(m["loss"])) and int(m["step"]) == 1


def test_tree_walks_and_train_step_keep_no_leaf_alive():
    """With the cyclic garbage collector off, a tensor that ``flatten``,
    ``flatten_up_to``, ``unflatten`` and ``tree_map`` saw, and a train
    step's new state, are freed as soon as the caller drops them (a
    recursive closure's reference cycle kept every leaf it saw alive
    until the collector's next pass: a train loop's old state, beside
    the new one)."""
    import gc
    import weakref

    cfg = TT.from_jax_config(jsmol.smoke_config())
    opt = TO.adamw(lr=1e-2)
    params = TT.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    state = TS.make_state(params, opt)
    batch = _torch(_lm_batch(cfg.vocab_size))
    step = TS.lm_train_step(cfg, opt)
    gc.collect()
    gc.disable()
    try:
        tree = {"a": [torch.ones(3), None, (torch.zeros(2),)],
                "b": torch.ones(1)}
        leaves, treedef = pytree.flatten(tree)
        refs = [weakref.ref(t) for t in leaves]
        treedef.flatten_up_to(tree)
        pytree.tree_map(lambda t: t + 1, treedef.unflatten(leaves))
        del tree, leaves
        new, _ = step(state, batch)
        refs += [weakref.ref(t) for t in pytree.leaves(new)]
        del new
        assert [r() for r in refs] == [None] * len(refs)
    finally:
        gc.enable()
