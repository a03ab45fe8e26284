"""The MoE LM path of ``repro_torch.models.transformer`` against
``repro.models.transformer``: ``moe_block``, the MoE model's forward,
prefill and decode, its parameters and the three configs that were not
ported before (mixtral-8x22b, qwen3-moe-235b-a22b, granite-34b).

The reference runs on the CPU without a mesh, so its ``moe_block``
dispatches every token of a call as one group (G = 1), as the port does.
Inputs come from fixed numpy seeds; the port takes the reference's
initialised parameters through ``from_jax_params``.

Tolerances: ``moe_block`` in float32 atol 1e-5 (output) and 1e-6 (aux
loss): only the float32 sums' order differs.  The models' logits and
caches atol 1e-4 in float32 and 0.05 in bf16, as
``tests/test_torch_transformer.py`` holds the dense path.

bf16: XLA's CPU backend refuses a batched bf16 x bf16 -> float32 dot
("Unsupported element type for DotThunk::Execute"), which the reference's
three expert einsums are.  So in bf16 the reference runs with its einsums
given the same bf16 values widened to float32 (:func:`wide_einsum`): a
product of two bf16 values is exact in float32 and the sums run in
float32, which is what ``preferred_element_type=jnp.float32`` asks for.
Nothing else of the reference changes.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import granite_34b as jgranite
from repro.configs import mixtral_8x22b as jmixtral
from repro.configs import qwen3_moe_235b_a22b as jqwen
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.training import steps as JS
from repro_torch.configs import granite_34b as tgranite
from repro_torch.configs import mixtral_8x22b as tmixtral
from repro_torch.configs import qwen3_moe_235b_a22b as tqwen
from repro_torch.models import transformer as TT
from repro_torch.training import steps as TS

# a prompt longer than mixtral-smoke's window of 16, so the ring wraps in
# prefill and again in decode
S, MAX_LEN, N_DECODE = 24, 32, 4


def _top8_of_16():
    return dataclasses.replace(jqwen.smoke_config(), name="top8-of-16",
                               n_experts=16, moe_top_k=8)


JAX_CONFIGS = {"mixtral": jmixtral.smoke_config,
               "qwen3": jqwen.smoke_config,
               "top8": _top8_of_16}


class _WideEinsum:
    """``jax.numpy`` with an ``einsum`` that widens its operands to
    float32 where a float32 result is asked for."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(eq, *ops, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            ops = [o.astype(jnp.float32) for o in ops]
        return jnp.einsum(eq, *ops,
                          preferred_element_type=preferred_element_type, **kw)


@pytest.fixture
def wide_einsum(monkeypatch):
    monkeypatch.setattr(JT, "jnp", _WideEinsum())


def _jax_config(name, dtype="float32", **kw):
    dt = getattr(jnp, dtype)
    return dataclasses.replace(JAX_CONFIGS[name](), param_dtype=dt,
                               compute_dtype=dt, **kw)


def _pair(jcfg, seed=0):
    """(JAX params, port config, port params)."""
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, TT.from_jax_config(jcfg), TT.from_jax_params(
        jax.tree.map(np.asarray, jp), device="cpu")


def _layer0_moe(jp):
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    return jl, TT.from_jax_params(jax.tree.map(np.asarray, jl),
                                  device="cpu")


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x, jnp.float32))


def _block_pair(jcfg, tcfg, jl, tl, x):
    """Both packages' ``moe_block`` on the (T, D) float32 array ``x`` cast
    to the compute dtype: (ref out, ref aux, out, aux, routing)."""
    jx = jnp.asarray(x, jcfg.compute_dtype)
    ref, ref_aux = jax.jit(JT.moe_block, static_argnums=2)(jl, jx, jcfg)
    routes = []
    out, aux = TT.moe_block(tl, torch.from_numpy(x).to(tcfg.compute_dtype),
                            tcfg, routes)
    assert out.dtype == tcfg.compute_dtype and out.shape == x.shape
    return ref, ref_aux, out, aux, routes[0]


def _expected_drops(expert_ids: np.ndarray, capacity: int, e: int) -> int:
    counts = np.bincount(expert_ids.reshape(-1), minlength=e)
    return int(np.maximum(counts - capacity, 0).sum())


# --------------------------------------------------------------------------
# moe_block
# --------------------------------------------------------------------------


@pytest.mark.parametrize("cf", [1.0, 16.0])
@pytest.mark.parametrize("name", ["mixtral", "qwen3", "top8"])
def test_moe_block_matches_reference(name, cf):
    """With drops (capacity factor 1.0) and without (16.0)."""
    jcfg = _jax_config(name, capacity_factor=cf)
    jp, tcfg, _ = _pair(jcfg)
    jl, tl = _layer0_moe(jp)
    t = 40
    x = np.random.default_rng(1).standard_normal((t, jcfg.d_model)).astype(
        np.float32)
    ref, ref_aux, out, aux, route = _block_pair(jcfg, tcfg, jl, tl, x)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    assert abs(float(aux) - float(ref_aux)) <= 1e-6
    e, k = jcfg.n_experts, jcfg.moe_top_k
    capacity = max(1, int(-(-t * k // e) * cf))
    assert TT.moe_capacity(tcfg, t) == capacity
    drops = int((~route.keep).sum())
    assert drops == _expected_drops(route.expert_ids.numpy(), capacity, e)
    assert (drops > 0) == (cf == 1.0)
    # a dropped pick contributes nothing: a token with all picks dropped
    # leaves the block with 0
    for i in np.flatnonzero(~route.keep.numpy().any(axis=1)):
        assert not out[i].any()


@pytest.mark.parametrize("name", ["mixtral", "top8"])
def test_bf16_moe_block_matches_reference(name, wide_einsum):
    jcfg = _jax_config(name, "bfloat16", capacity_factor=1.0)
    jp, tcfg, _ = _pair(jcfg, seed=2)
    jl, tl = _layer0_moe(jp)
    x = np.random.default_rng(3).standard_normal((40, jcfg.d_model)).astype(
        np.float32)
    ref, ref_aux, out, aux, route = _block_pair(jcfg, tcfg, jl, tl, x)
    assert int((~route.keep).sum()) > 0
    np.testing.assert_allclose(_np(out), _np(ref), atol=0.05, rtol=0)
    assert abs(float(aux) - float(ref_aux)) <= 1e-6


def test_moe_top_k_ties_take_the_lower_expert():
    """Hazard (b): a router with two identical columns ties experts 1 and
    2 for every token.  ``jax.lax.top_k`` takes the lower index first, so
    where the tie falls on the k-th pick expert 1 is in and 2 is out; the
    port's output must be the reference's."""
    jcfg = _jax_config("mixtral", capacity_factor=16.0)
    jp, tcfg, _ = _pair(jcfg)
    jl, _ = _layer0_moe(jp)
    router = np.array(jl["router"])
    router[:, 2] = router[:, 1]
    jl = dict(jl, router=jnp.asarray(router))
    tl = TT.from_jax_params(jax.tree.map(np.asarray, jl), device="cpu")
    x = np.random.default_rng(4).standard_normal((64, jcfg.d_model)).astype(
        np.float32)
    ref, _, out, _, route = _block_pair(jcfg, tcfg, jl, tl, x)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    ids = route.expert_ids.numpy()
    has1, has2 = (ids == 1).any(axis=1), (ids == 2).any(axis=1)
    assert not (has2 & ~has1).any()  # 2 never picked without 1
    assert (has1 & ~has2).sum() > 0  # and the tie did fall on the k-th pick


def test_moe_capacity_one_drops_the_second_token():
    """Hazard (d): a decode step dispatches its B tokens together, so at
    B = 2 mixtral-smoke's capacity is int(ceil(2 * 2 / 4) * 1.25) = 1 a
    expert; two tokens on the same experts keep the first's picks and drop
    the second's, which leaves the block with 0, as in the reference."""
    jcfg = _jax_config("mixtral")
    jp, tcfg, _ = _pair(jcfg)
    jl, tl = _layer0_moe(jp)
    row = np.random.default_rng(5).standard_normal(jcfg.d_model)
    x = np.stack([row, row]).astype(np.float32)
    ref, _, out, _, route = _block_pair(jcfg, tcfg, jl, tl, x)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    assert route.keep.tolist() == [[True, True], [False, False]]
    assert out[0].abs().max() > 0 and not out[1].any()


def test_moe_decode_at_capacity_one_matches_reference():
    """Hazard (d) through ``decode_step``: two identical prompts give each
    step two identical tokens, so layer 0 keeps row 0's picks and drops
    row 1's (after it the rows differ by that MoE output); the logits
    still follow the reference's."""
    jcfg = _jax_config("mixtral")
    jp, tcfg, tp = _pair(jcfg)
    row = np.random.default_rng(6).integers(0, jcfg.vocab_size, S + N_DECODE)
    toks = np.stack([row, row]).astype(np.int32)
    routes = []
    j_logits, _ = _serve(jax.jit(JS.lm_prefill_step(jcfg, MAX_LEN)),
                         jax.jit(JS.lm_decode_step(jcfg)), jp, toks,
                         jnp.asarray)
    t_logits, _ = _serve(TS.lm_prefill_step(tcfg, MAX_LEN),
                         TS.lm_decode_step(tcfg, routes), tp, toks,
                         lambda a: torch.from_numpy(np.asarray(a)).long())
    for got, ref in zip(t_logits, j_logits):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    assert len(routes) == N_DECODE * jcfg.n_layers
    for r in routes[::jcfg.n_layers]:  # layer 0 of each step
        assert r.keep.tolist() == [[True, True], [False, False]]


# --------------------------------------------------------------------------
# the model: forward, prefill, decode
# --------------------------------------------------------------------------


def _tokens(vocab, b=2, s=S + N_DECODE, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _serve(prefill, decode, params, toks, as_tokens):
    """Prefill on the first S tokens, then N_DECODE teacher-forced decode
    steps; returns the per-step logits and the final result dict."""
    out = prefill(params, {"tokens": as_tokens(toks[:, :S])})
    logits = [out["logits"]]
    for i in range(S, S + N_DECODE):
        out = decode(params, {"token": as_tokens(toks[:, i]),
                              "cache_k": out["k"], "cache_v": out["v"],
                              "cache_len": out["length"]})
        logits.append(out["logits"])
    return logits, out


DTYPE_ATOL = [("float32", 1e-4), ("bfloat16", 0.05)]


@pytest.mark.parametrize("dtype,atol", DTYPE_ATOL)
@pytest.mark.parametrize("name", ["mixtral", "qwen3"])
def test_moe_forward_matches_reference(name, dtype, atol, wide_einsum):
    jcfg = _jax_config(name, dtype)
    jp, tcfg, tp = _pair(jcfg, seed=7)
    toks = _tokens(jcfg.vocab_size)
    hidden, ref_aux = jax.jit(JT.forward, static_argnums=2)(
        jp, jnp.asarray(toks), jcfg)
    # JT.logits_fn's unembedding of that forward
    ref = JL.dense(jp["unembed"], hidden, jcfg.policy).astype(jnp.float32)
    got = TT.logits_fn(tp, torch.from_numpy(toks).long(), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol)
    _, aux = TT.forward(tp, torch.from_numpy(toks).long(), tcfg)
    # the aux loss comes from the router's probabilities, whose logits are
    # rounded to the compute dtype: in bf16 within one bf16 ulp of its size
    aux_tol = 1e-5 if dtype == "float32" else 2.0 ** -8 * abs(float(ref_aux))
    assert abs(float(aux) - float(ref_aux)) <= aux_tol


@pytest.mark.parametrize("dtype,atol", DTYPE_ATOL)
@pytest.mark.parametrize("name", ["mixtral", "qwen3"])
def test_moe_serving_steps_match_reference(name, dtype, atol, wide_einsum):
    jcfg = _jax_config(name, dtype)
    jp, tcfg, tp = _pair(jcfg, seed=8)
    toks = _tokens(jcfg.vocab_size, seed=9)
    j_logits, j_out = _serve(jax.jit(JS.lm_prefill_step(jcfg, MAX_LEN)),
                             jax.jit(JS.lm_decode_step(jcfg)), jp, toks,
                             jnp.asarray)
    t_logits, t_out = _serve(TS.lm_prefill_step(tcfg, MAX_LEN),
                             TS.lm_decode_step(tcfg), tp, toks,
                             lambda a: torch.from_numpy(np.asarray(a)).long())
    for got, ref in zip(t_logits, j_logits):
        assert got.dtype == torch.float32 and got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol)
    for key in ("k", "v"):
        assert t_out[key].shape == j_out[key].shape
        np.testing.assert_allclose(_np(t_out[key]), _np(j_out[key]),
                                   atol=atol)
    assert int(t_out["length"]) == int(j_out["length"]) == S + N_DECODE
    # mixtral-smoke's ring of 16 slots, wrapped by the 28 positions
    assert t_out["k"].shape[2] == (16 if name == "mixtral" else MAX_LEN)


@pytest.mark.parametrize("impl", ["chunked", "flash"])
@pytest.mark.parametrize("dtype,atol", DTYPE_ATOL)
def test_granite_mqa_serving_steps_match_reference(dtype, atol, impl):
    """granite's dense MQA (one KV head for all query heads) through the
    port's prefill and decode steps, under the chunked attention and the
    flash entry (its plain version on the CPU), against the reference's
    chunked steps: the logits of every step and the one-head cache."""
    dt = getattr(jnp, dtype)
    jcfg = dataclasses.replace(jgranite.smoke_config(), param_dtype=dt,
                               compute_dtype=dt)
    jp, tcfg, tp = _pair(jcfg, seed=10)
    tcfg = dataclasses.replace(tcfg, attention_impl=impl)
    assert tcfg.n_kv_heads == 1 < tcfg.n_heads
    toks = _tokens(jcfg.vocab_size, seed=11)
    j_logits, j_out = _serve(jax.jit(JS.lm_prefill_step(jcfg, MAX_LEN)),
                             jax.jit(JS.lm_decode_step(jcfg)), jp, toks,
                             jnp.asarray)
    t_logits, t_out = _serve(TS.lm_prefill_step(tcfg, MAX_LEN),
                             TS.lm_decode_step(tcfg), tp, toks,
                             lambda a: torch.from_numpy(np.asarray(a)).long())
    for got, ref in zip(t_logits, j_logits):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol)
    assert t_out["k"].shape == j_out["k"].shape == (
        tcfg.n_layers, 2, MAX_LEN, 1, tcfg.d_head)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(t_out[key]), _np(j_out[key]),
                                   atol=atol)


# --------------------------------------------------------------------------
# parameters and configs
# --------------------------------------------------------------------------


def test_moe_from_jax_params_copies_bf16_leaves_bit_for_bit():
    jcfg = _jax_config("qwen3", "bfloat16")
    jp = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(3), jcfg))
    tp = TT.from_jax_params(jp, device="cpu")
    assert jax.tree.structure(tp) == jax.tree.structure(jp)
    for got, ref in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      ref.view(np.int16))


@pytest.mark.parametrize("name", ["mixtral", "qwen3"])
def test_moe_init_params_layout_matches_reference(name):
    jcfg = _jax_config(name, "bfloat16")
    tcfg = TT.from_jax_config(jcfg)
    params = TT.init_params(torch.Generator().manual_seed(0), tcfg,
                            device="cpu")
    ref = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), jcfg))
    assert jax.tree.structure(params) == jax.tree.structure(ref)
    for got, want in zip(jax.tree.leaves(params), jax.tree.leaves(ref)):
        assert tuple(got.shape) == want.shape
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert sum(t.numel() for t in jax.tree.leaves(params)) == tcfg.n_params
    # the reference's scales: uniform in +-sqrt(1 / fan_in)
    moe = params["layers"]["moe"]
    for key, fan_in in (("router", tcfg.d_model), ("w_gate", tcfg.d_model),
                        ("w_up", tcfg.d_model),
                        ("w_down", tcfg.d_ff_expert)):
        w = moe[key].float()
        assert float(w.abs().max()) <= fan_in ** -0.5 * (1 + 2.0 ** -8)
        assert float(w.abs().max()) > 0.9 * fan_in ** -0.5
    # each layer's experts drawn apart
    assert not torch.equal(moe["w_gate"][0], moe["w_gate"][1])


CONFIGS = [(jmixtral, tmixtral), (jqwen, tqwen), (jgranite, tgranite)]


@pytest.mark.parametrize("jmod,tmod", CONFIGS,
                         ids=["mixtral", "qwen3", "granite"])
def test_configs_match_reference(jmod, tmod):
    for make in ("full_config", "smoke_config"):
        jcfg = getattr(jmod, make)()
        assert TT.from_jax_config(jcfg) == getattr(tmod, make)()
        # the mesh switches, the loss's chunk and remat carry
        carried = TT.from_jax_config(dataclasses.replace(
            jcfg, moe_a2a=True, sequence_parallel=True))
        assert carried == dataclasses.replace(
            getattr(tmod, make)(), moe_a2a=True, sequence_parallel=True)
        carried = TT.from_jax_config(dataclasses.replace(
            jcfg, remat=not jcfg.remat, ce_chunk=7))
        assert (carried.remat, carried.ce_chunk) == (not jcfg.remat, 7)
    jfull, tfull = jmod.full_config(), tmod.full_config()
    assert tfull.param_dtype == tfull.compute_dtype == torch.bfloat16
    assert tfull.n_params == jfull.n_params
    assert tfull.n_active_params == jfull.n_active_params
    if tfull.moe:
        assert tfull.n_active_params < tfull.n_params
    assert tmixtral.WINDOW == jmixtral.WINDOW == tmixtral.full_config().window
