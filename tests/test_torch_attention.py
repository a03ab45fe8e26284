"""The port's ``flash_attention`` against the JAX package's.

On the CPU the port's wrapper runs its plain PyTorch version
(``kernels/attention/ref.py``) and the reference runs its Pallas kernel
in interpret mode (``repro.kernels.attention.ops`` picks that mode
itself off the TPU).  The cases and tolerances are the reference's own
(``tests/test_kernels.py``): atol 2e-5, rtol 1e-4 in float32; atol 3e-2
in bfloat16.  The CUDA kernel itself is held to the plain version in
``test_torch_cuda.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention.ops import flash_attention as jflash
from repro.kernels.attention.ops import flash_attention_ref as jflash_ref
from repro_torch.kernels.attention.ops import HEAD_DIMS, flash_attention
from repro_torch.kernels.attention.ref import flash_attention_ref, mha_ref

CASES = [
    dict(b=2, sq=64, skv=64, hq=4, hkv=4, d=32, causal=True, window=None),
    dict(b=1, sq=128, skv=128, hq=8, hkv=2, d=64, causal=True, window=None),
    dict(b=1, sq=96, skv=96, hq=2, hkv=2, d=32, causal=True, window=32),
    dict(b=2, sq=1, skv=200, hq=4, hkv=1, d=32, causal=True, window=None),
    dict(b=1, sq=64, skv=64, hq=2, hkv=2, d=32, causal=False, window=None),
    dict(b=1, sq=80, skv=160, hq=2, hkv=2, d=16, causal=True, window=64),
]


def _qkv(rng, b, sq, skv, hq, hkv, d, dtype=np.float32):
    def mk(s, h):
        return rng.standard_normal((b, s, h, d)).astype(dtype)
    return mk(sq, hq), mk(skv, hkv), mk(skv, hkv)


@pytest.mark.parametrize("case", CASES)
def test_flash_attention_matches_reference(case):
    rng = np.random.default_rng(42)
    q, k, v = _qkv(rng, case["b"], case["sq"], case["skv"], case["hq"],
                   case["hkv"], case["d"])
    qoff = case["skv"] - case["sq"] if case["causal"] else 0
    kw = dict(causal=case["causal"], window=case["window"], q_offset=qoff)
    ref = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            **kw))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), **kw)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=1e-4)
    # and the reference's own plain version
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jflash_ref(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), **kw)),
        atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_dtypes(dtype):
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, 1, 64, 64, 4, 4, 32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = jflash(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                 causal=True)
    tdt = getattr(torch, dtype)
    got = flash_attention(torch.from_numpy(q).to(tdt),
                          torch.from_numpy(k).to(tdt),
                          torch.from_numpy(v).to(tdt), causal=True)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=3e-2 if dtype == "bfloat16" else 2e-5)


@pytest.mark.parametrize("bq,bk", [(16, 16), (32, 64), (128, 128)])
def test_flash_attention_block_sizes(bq, bk):
    """The reference at each of its block sizes against the port, which
    has one tiling (ragged tails bounds-checked, not padded)."""
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, 1, 100, 100, 2, 2, 16)
    ref = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                 block_q=bq, block_k=bk)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=1e-4)


def test_fully_masked_rows_give_zero():
    """A window that leaves a row no key (q_offset past the keys): 0, not
    NaN, in both plain versions, as in the reference kernel."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, 1, 4, 8, 2, 2, 16))
    out = flash_attention(q, k, v, causal=True, window=2, q_offset=20)
    assert torch.equal(out, torch.zeros_like(out))
    fold = mha_ref(q[0].transpose(0, 1), k[0].transpose(0, 1),
                   v[0].transpose(0, 1), scale=0.25, causal=True, window=2,
                   q_offset=20)
    assert torch.equal(fold, torch.zeros_like(fold))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros((1, 4, 3, 16))
    k = torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, q, q, window=0)
    assert HEAD_DIMS == (16, 32, 64, 128)
    torch.testing.assert_close(
        flash_attention(q, q, q), flash_attention_ref(q, q, q))
