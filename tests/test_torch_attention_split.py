"""The tensor-core flash kernel's arithmetic and routing, on the CPU.

``csrc/attention_wgmma.cu`` cannot run here, so its rounding is checked
through its plain emulation (``ref.py::flash_attention_tiled_ref``: an
online softmax over 128-key tiles, the value product on bf16 operands
with float32 sums, P split as ``bf16(p) + bf16(p - bf16(p))``) against
the JAX package's ``flash_attention`` (``mha_pallas`` in interpret mode)
on the same bf16 inputs.  The limit is the one the kernel is held to on
the card (``chip_smoke.py``'s ``ATTN_BF16_ATOL``): the excess
``|got - ref| - 2^-7 |ref|`` past one bf16 ulp of the reference at most
2e-5.  A control rounds P once to bf16 and must fail it: that is why the
kernel splits P.

The routing (which kernel serves which dtype and head size) and the TMA
rule that decides when the wrapper copies a view are plain Python and
are checked here too.  Every input is made from a fixed seed.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention.ops import flash_attention as jflash
from repro_torch.kernels.attention import ops as tattn
from repro_torch.kernels.attention.ref import flash_attention_tiled_ref

ATTN_BF16_RTOL = 2.0 ** -7
ATTN_BF16_ATOL = 2e-5

# the reference's six cases (tests/test_kernels.py) at D=64, and
# smollm-135m's head layout (9 query heads on 3 KV heads) at S=320
SPLIT_CASES = [
    dict(b=2, sq=64, skv=64, hq=4, hkv=4, causal=True, window=None),
    dict(b=1, sq=128, skv=128, hq=8, hkv=2, causal=True, window=None),
    dict(b=1, sq=96, skv=96, hq=2, hkv=2, causal=True, window=32),
    dict(b=2, sq=1, skv=200, hq=4, hkv=1, causal=True, window=None),
    dict(b=1, sq=64, skv=64, hq=2, hkv=2, causal=False, window=None),
    dict(b=1, sq=80, skv=160, hq=2, hkv=2, causal=True, window=64),
    dict(b=1, sq=320, skv=320, hq=9, hkv=3, causal=True, window=None),
]
SMOLLM = SPLIT_CASES[-1]


def _bf16_qkv(case, d=64, seed=0):
    """Seeded numpy inputs rounded to bf16, as JAX and torch arrays."""
    rng = np.random.default_rng(seed)

    def mk(s, h):
        return rng.standard_normal((case["b"], s, h, d)).astype(np.float32)
    xs = [mk(case["sq"], case["hq"]), mk(case["skv"], case["hkv"]),
          mk(case["skv"], case["hkv"])]
    jx = [jnp.asarray(x, jnp.bfloat16) for x in xs]
    tx = [torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
          for x in jx]
    return jx, tx


def _excess(got: torch.Tensor, ref: torch.Tensor) -> float:
    g, r = got.float(), ref.float()
    return float(((g - r).abs() - ATTN_BF16_RTOL * r.abs()).max())


def _both(case, split_p=True):
    (jq, jk, jv), (q, k, v) = _bf16_qkv(case)
    kw = dict(causal=case["causal"], window=case["window"],
              q_offset=case["skv"] - case["sq"] if case["causal"] else 0)
    ref = torch.from_numpy(np.asarray(jflash(jq, jk, jv, **kw), np.float32))
    got = flash_attention_tiled_ref(q, k, v, split_p=split_p, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    return got, ref


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_p_meets_the_bf16_limit(case):
    got, ref = _both(case)
    assert _excess(got, ref) <= ATTN_BF16_ATOL
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(), atol=3e-2)


def test_single_rounding_of_p_fails_the_limit():
    """P rounded once to bf16 misses the reference by ~1e-3 past one bf16
    ulp at smollm's layout (rows that nearly cancel); the split passes."""
    single, ref = _both(SMOLLM, split_p=False)
    split, _ = _both(SMOLLM)
    assert _excess(single, ref) > 10 * ATTN_BF16_ATOL
    assert _excess(split, ref) <= ATTN_BF16_ATOL


@pytest.mark.parametrize("d", [16, 32, 48, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_route(dtype, d):
    if dtype == torch.float16 or d not in tattn.HEAD_DIMS:
        with pytest.raises(ValueError,
                           match="float32 or bfloat16|head size"):
            tattn.route(dtype, d)
        return
    want = ("wgmma" if dtype == torch.bfloat16 and d in (64, 128)
            else "simt")
    assert tattn.route(dtype, d) == want


def test_launch_rejects_what_its_kernel_does_not_take():
    f32 = torch.zeros((1, 8, 2, 64))
    bf = f32.to(torch.bfloat16)
    half = f32.to(torch.float16)
    # the kernels take CUDA tensors only; the CPU goes to the plain version
    for kernel, x in (("wgmma", bf), ("simt", f32), ("simt", bf)):
        with pytest.raises(ValueError, match="unsupported device"):
            tattn.launch(kernel, x, x, x)
    with pytest.raises(ValueError, match="multiple"):
        tattn.launch("wgmma", bf, bf[:, :, :1].expand(1, 8, 3, 64),
                     bf[:, :, :1].expand(1, 8, 3, 64))
    with pytest.raises(ValueError, match="window"):
        tattn.launch("simt", f32, f32, f32, window=0)
    # nor does a device other than the CPU reach the plain version
    meta = f32.to("meta")
    for x in (meta, meta.to(torch.bfloat16)):
        with pytest.raises(ValueError, match="unsupported device"):
            tattn.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tattn.flash_attention(*(meta.to(torch.float16),) * 3)
    with pytest.raises(ValueError, match="unsupported device"):
        tattn.launch("simt", half, half, half)


def test_tma_rule_takes_packed_views_without_a_copy():
    qkv = torch.zeros((2, 70, 9 + 3 + 3, 64), dtype=torch.bfloat16)
    for x in (qkv[:, :, :9], qkv[:, :, 9:12], qkv[:, :, 12:],
              qkv[:, 40:, :9], torch.zeros((1, 5, 1, 128),
                                           dtype=torch.bfloat16)):
        assert tattn.tma_ok(x)
        assert tattn.tma_operand(x) is x
    # an axis of extent 1 is never stepped: its stride does not matter
    odd = torch.zeros((3, 1, 7, 64), dtype=torch.bfloat16
                      ).as_strided((1, 3, 1, 64), (5, 64 * 7, 3, 1))
    assert tattn.tma_ok(odd)


def _bad_view(view: str) -> torch.Tensor:
    gen = torch.Generator().manual_seed(0)

    def mk(*shape):
        return torch.randn(shape, generator=gen).to(torch.bfloat16)
    if view == "base":  # 8 bytes past an aligned base
        return mk(2 * 6 * 3 * 64 + 4)[4:].view(2, 6, 3, 64)
    if view == "head_stride":  # heads 68 elements (136 bytes) apart
        return mk(2, 6, 3, 68)[..., :64]
    if view == "seq_stride":  # rows 196 elements (392 bytes) apart
        return mk(2, 6, 196)[..., :192].unflatten(-1, (3, 64))
    if view == "dense_d":  # D is not the dense axis
        return mk(2, 6, 64, 3).transpose(2, 3)
    return mk(2, 6, 1, 64).expand(2, 6, 3, 64)  # heads 0 bytes apart


@pytest.mark.parametrize("view", ["base", "head_stride", "seq_stride",
                                  "dense_d", "zero_stride"])
def test_tma_rule_copies_what_it_cannot_map(view):
    x = _bad_view(view)
    assert not tattn.tma_ok(x)
    y = tattn.tma_operand(x)
    assert y is not x and y.is_contiguous() and tattn.tma_ok(y)
    assert torch.equal(y, x)
