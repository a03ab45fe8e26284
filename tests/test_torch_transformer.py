"""``repro_torch.models.transformer`` and the LM serving steps against
``repro.models.transformer`` and ``repro.training.steps``.

Configs: smollm-135m's ``smoke_config()`` and the reference's ``tiny_lm``
(``tests/test_models.py``, GQA 4:2), each with no window and with
``window=8`` (the ring-buffer cache).  The JAX side runs
``attention_impl="pallas"`` (the Pallas kernel in interpret mode on the
CPU), the port ``"flash"`` (its plain version on the CPU).  The port
takes the reference's initialised parameters through
``from_jax_params``.

Tolerances: float32 logits and caches atol 1e-4.  bfloat16 logits and
caches atol 0.05: both sides round every matmul, activation and residual
to bf16 (one ulp is 2^-8 relative), but XLA and PyTorch round at
different places and sum in another order, and three layers of that
move logits of magnitude ~1.7 by a few bf16 ulps (0.016 at most on a CPU
run of these inputs).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import mixtral_8x22b as jmixtral
from repro.configs import smollm_135m as jsmol
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.training import steps as JS
from repro_torch.configs import base as tbase
from repro_torch.configs import smollm_135m as tsmol
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.training import steps as TS

S, MAX_LEN, N_DECODE = 12, 16, 4


def tiny_lm(**kw):
    base = dict(name="tiny", n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
                d_head=16, d_ff=128, vocab_size=97, attention_impl="chunked",
                attn_chunk=16, ce_chunk=8, remat=False)
    base.update(kw)
    return JT.TransformerConfig(**base)


def _jax_config(name, **kw):
    cfg = jsmol.smoke_config() if name == "smoke" else tiny_lm()
    return dataclasses.replace(cfg, attention_impl="pallas", **kw)


def _pair(name, seed=0, **kw):
    """(JAX config, JAX params, port config, port params)."""
    jcfg = _jax_config(name, **kw)
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    tcfg = TT.from_jax_config(jcfg)
    return jcfg, jp, tcfg, TT.from_jax_params(jax.tree.map(np.asarray, jp),
                                              device="cpu")


def _tokens(vocab, b=2, s=S + N_DECODE, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


# --------------------------------------------------------------------------
# layers, configs, parameters
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_layers_match_reference(dtype):
    rng = np.random.default_rng(0)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    atol = 1e-6 if dtype == "float32" else 1e-2
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = rng.uniform(-0.3, 0.3, (16, 24)).astype(np.float32)
    bias = rng.uniform(-0.3, 0.3, 24).astype(np.float32)
    jpol = JL.DtypePolicy(jdt, jdt)
    tpol = TL.DtypePolicy(tdt, tdt)
    pairs = [
        (TL.dense({"w": torch.from_numpy(w), "b": torch.from_numpy(bias)},
                  torch.from_numpy(x), tpol),
         JL.dense({"w": jnp.asarray(w), "b": jnp.asarray(bias)},
                  jnp.asarray(x), jpol)),
        (TL.rmsnorm({"scale": torch.from_numpy(bias[:16]).to(tdt)},
                    torch.from_numpy(x).to(tdt), 1e-6),
         JL.rmsnorm({"scale": jnp.asarray(bias[:16], jdt)},
                    jnp.asarray(x, jdt), 1e-6)),
        (TL.apply_rope(torch.from_numpy(x).to(tdt), torch.arange(5) + 7),
         JL.apply_rope(jnp.asarray(x, jdt), jnp.arange(5) + 7)),
        (TL.apply_rope(torch.from_numpy(x).to(tdt),
                       torch.tensor([[3], [40]]).expand(2, 5)),
         JL.apply_rope(jnp.asarray(x, jdt),
                       jnp.broadcast_to(jnp.asarray([[3], [40]]), (2, 5)))),
        (TL.silu(torch.from_numpy(x).to(tdt)), JL.silu(jnp.asarray(x, jdt))),
        (TL.rope_frequencies(16, 500.0), JL.rope_frequencies(16, 500.0)),
    ]
    emb = rng.standard_normal((10, 6)).astype(np.float32)
    ids = np.array([[1, 9, 3], [0, 0, 7]])
    pairs.append((TL.embedding({"emb": torch.from_numpy(emb)},
                               torch.from_numpy(ids), tpol),
                  JL.embedding({"emb": jnp.asarray(emb)}, jnp.asarray(ids),
                               jpol)))
    for got, ref in pairs:
        assert got.shape == ref.shape
        np.testing.assert_allclose(_np(got), _np(ref), atol=atol, rtol=atol)


def test_configs_match_reference():
    assert TT.from_jax_config(jsmol.full_config()) == tsmol.full_config()
    assert TT.from_jax_config(jsmol.smoke_config()) == tsmol.smoke_config()
    assert tsmol.full_config().param_dtype == torch.bfloat16
    assert TT.from_jax_config(_jax_config("tiny")).attention_impl == "flash"
    assert {k: dataclasses.asdict(v) for k, v in tbase.LM_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jbase.LM_SHAPES.items()}


def test_full_width_parameter_count_matches_reference():
    cfg = tsmol.full_config()
    assert cfg.n_params == jsmol.full_config().n_params
    params = TT.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    leaves = jax.tree.leaves(params)
    assert sum(t.numel() for t in leaves) == cfg.n_params
    assert all(t.dtype == torch.bfloat16 for t in leaves)
    # the reference's layout, leaf for leaf
    ref = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0),
                                                jsmol.full_config()))
    assert jax.tree.structure(params) == jax.tree.structure(ref)
    for got, want in zip(leaves, jax.tree.leaves(ref)):
        assert tuple(got.shape) == want.shape


def test_from_jax_params_copies_bf16_leaves_bit_for_bit():
    jcfg = dataclasses.replace(tiny_lm(), param_dtype=jnp.bfloat16,
                               compute_dtype=jnp.bfloat16)
    jp = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(3), jcfg))
    tp = TT.from_jax_params(jp, device="cpu")
    assert jax.tree.structure(tp) == jax.tree.structure(jp)
    for got, ref in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      ref.view(np.int16))


def test_lm_entry_points_default_to_the_card(monkeypatch):
    """With no device named, the parameters and the cache go to the card,
    and without one the call raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tsmol.smoke_config()
    jp = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0),
                                                 jsmol.smoke_config()))
    for make in (lambda: TT.init_params(torch.Generator().manual_seed(0), cfg),
                 lambda: TT.from_jax_params(jp),
                 lambda: TT.init_cache(cfg, 1, 8)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert TT.init_cache(cfg, 1, 8, device="cpu").k.device.type == "cpu"


def test_moe_config_serves_through_the_steps():
    """An MoE config (mixtral's smoke config) serves through the same
    entry points as a dense one: parameters, a prefill and a decode step,
    each MoE layer's routing recorded (``tests/test_torch_moe.py`` holds
    the values to the reference)."""
    cfg = TT.from_jax_config(jmixtral.smoke_config())
    assert cfg.moe and cfg.n_experts == 4 and cfg.moe_top_k == 2
    params = TT.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    assert "moe" in params["layers"] and "mlp" not in params["layers"]
    routes = []
    toks = torch.from_numpy(_tokens(cfg.vocab_size, s=6)).long()
    out = TS.lm_prefill_step(cfg, 8, routes)(params, {"tokens": toks[:, :5]})
    dec = TS.lm_decode_step(cfg, routes)(params, {
        "token": toks[:, 5], "cache_k": out["k"], "cache_v": out["v"],
        "cache_len": out["length"]})
    assert torch.isfinite(dec["logits"]).all() and int(dec["length"]) == 6
    assert [tuple(r.expert_ids.shape) for r in routes] \
        == [(10, 2)] * cfg.n_layers + [(2, 2)] * cfg.n_layers
    hidden, aux = TT.forward(params, toks, cfg)
    assert hidden.shape == (2, 6, cfg.d_model) and float(aux) > 0


# --------------------------------------------------------------------------
# forward, prefill, decode, the serving steps
# --------------------------------------------------------------------------


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("name", ["smoke", "tiny"])
def test_forward_matches_reference(name, window):
    jcfg, jp, tcfg, tp = _pair(name, window=window)
    toks = _tokens(jcfg.vocab_size)
    ref = JT.logits_fn(jp, jnp.asarray(toks), jcfg)
    got = TT.logits_fn(tp, torch.from_numpy(toks).long(), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    for impl in ("naive", "chunked"):
        other = TT.logits_fn(tp, torch.from_numpy(toks).long(),
                             dataclasses.replace(tcfg, attention_impl=impl))
        np.testing.assert_allclose(other.numpy(), np.asarray(ref), atol=1e-4)


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


def _check_serving(jcfg, jp, tcfg, tp, atol):
    toks = _tokens(jcfg.vocab_size)
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


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("name", ["smoke", "tiny"])
def test_prefill_and_decode_steps_match_reference(name, window):
    _check_serving(*_pair(name, window=window), atol=1e-4)


@pytest.mark.parametrize("window", [None, 8])
def test_bf16_serving_steps_match_reference(window):
    _check_serving(*_pair("tiny", seed=4, window=window,
                          param_dtype=jnp.bfloat16,
                          compute_dtype=jnp.bfloat16), atol=0.05)


def test_windowed_cache_stays_bounded():
    """A prompt shorter than the window: the cache has the window's slots,
    the unwritten ones masked, and decode equals the forward pass."""
    _, _, tcfg, tp = _pair("tiny", window=8)
    toks = torch.from_numpy(_tokens(tcfg.vocab_size, s=6)).long()
    out = TS.lm_prefill_step(tcfg, 8)(tp, {"tokens": toks[:, :4]})
    assert out["k"].shape[2] == 8 and int(out["length"]) == 4
    dec = TS.lm_decode_step(tcfg)(tp, {
        "token": toks[:, 4], "cache_k": out["k"], "cache_v": out["v"],
        "cache_len": out["length"]})
    want = TT.logits_fn(tp, toks[:, :5], tcfg)[:, -1]
    torch.testing.assert_close(dec["logits"], want, atol=1e-4, rtol=0)
