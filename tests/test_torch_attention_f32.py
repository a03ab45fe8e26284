"""The float32 flash kernel's scheme, on the CPU.

``csrc/attention.cu`` cannot run here, so its arithmetic is checked
through its plain emulation (``ref.py::flash_attention_split_ref``):
64-row query tiles whose band of 64-key K/V tiles is dealt to ``split``
partial online softmaxes in base 2 (scores times ``scale * log2(e)``,
``exp2``), combined in rank order with each partial rescaled by
``exp2(m_r - m)``.  It is held to the JAX package's ``flash_attention``
(``mha_pallas`` in interpret mode) on the same float32 inputs at the
reference's tolerance (atol 2e-5, rtol 1e-4), for every split the kernel
can pick.  A control that adds the partials without the rescaling must
fail it.  The plan (which CTA takes which tiles, in which order, and how
many CTAs share a row tile) is mirrored here and in ``ref.py`` and
checked to cover every tile of every band once, heaviest row tiles
first.  Every
input is made from a fixed seed.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention.ops import flash_attention as jflash
from repro_torch.kernels.attention import ref as tref

# the reference's six cases (tests/test_kernels.py); smollm-135m's layout
# (9 query heads on 3 KV heads) at S=300; windows that cross the 64-key
# tiles the split deals out, with and without a q_offset and causality;
# and single-query decode steps
CASES = [
    dict(b=2, sq=64, skv=64, hq=4, hkv=4, d=32, causal=True, window=None),
    dict(b=1, sq=128, skv=128, hq=8, hkv=2, d=64, causal=True, window=None),
    dict(b=1, sq=96, skv=96, hq=2, hkv=2, d=32, causal=True, window=32),
    dict(b=2, sq=1, skv=200, hq=4, hkv=1, d=32, causal=True, window=None),
    dict(b=1, sq=64, skv=64, hq=2, hkv=2, d=32, causal=False, window=None),
    dict(b=1, sq=80, skv=160, hq=2, hkv=2, d=16, causal=True, window=64),
    dict(b=1, sq=300, skv=300, hq=9, hkv=3, d=64, causal=True, window=None),
    dict(b=1, sq=300, skv=300, hq=4, hkv=2, d=32, causal=True, window=100),
    dict(b=1, sq=130, skv=400, hq=2, hkv=1, d=64, causal=True, window=150),
    dict(b=1, sq=200, skv=200, hq=2, hkv=2, d=16, causal=False, window=70),
    dict(b=2, sq=1, skv=300, hq=9, hkv=3, d=64, causal=True, window=None),
    dict(b=1, sq=1, skv=450, hq=4, hkv=2, d=128, causal=True, window=200),
]
SMOLLM = CASES[6]


def _kw(case) -> dict:
    return dict(causal=case["causal"], window=case["window"],
                q_offset=case["skv"] - case["sq"] if case["causal"] else 0)


@functools.lru_cache(maxsize=None)
def _inputs(i: int):
    """Case ``i``'s seeded float32 q, k, v as torch tensors, and the JAX
    package's output on them."""
    c = CASES[i]
    rng = np.random.default_rng(100 + i)

    def mk(s, h):
        return rng.standard_normal((c["b"], s, h, c["d"])).astype(np.float32)
    xs = [mk(c["sq"], c["hq"]), mk(c["skv"], c["hkv"]),
          mk(c["skv"], c["hkv"])]
    ref = np.asarray(jflash(*(jnp.asarray(x) for x in xs), **_kw(c)))
    return [torch.from_numpy(x) for x in xs], ref


@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("i", range(len(CASES)))
def test_split_emulation_matches_reference(i, split):
    (q, k, v), ref = _inputs(i)
    got = tref.flash_attention_split_ref(q, k, v, split=split,
                                         **_kw(CASES[i]))
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("split", [2, 4])
def test_combine_without_rescaling_fails(split):
    """Partials whose maxima differ must be brought to one max before they
    are added; adding them as they are misses the reference by far more
    than its tolerance, the rescaled combine does not."""
    (q, k, v), ref = _inputs(CASES.index(SMOLLM))
    kw = _kw(SMOLLM)
    bad = tref.flash_attention_split_ref(q, k, v, split=split, rescale=False,
                                         **kw)
    assert not np.allclose(bad.numpy(), ref, atol=2e-5, rtol=1e-4)
    assert np.abs(bad.numpy() - ref).max() > 1e-2
    good = tref.flash_attention_split_ref(q, k, v, split=split, **kw)
    np.testing.assert_allclose(good.numpy(), ref, atol=2e-5, rtol=1e-4)


def test_bf16_inputs_widen_to_float32():
    """bf16 inputs (the kernel's D 16 and 32) run the same float32
    arithmetic: the emulation on bf16 q, k, v equals it on their float32
    widening, rounded once to bf16."""
    (q, k, v), _ = _inputs(CASES.index(SMOLLM))
    kw = _kw(SMOLLM)
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    got = tref.flash_attention_split_ref(qb, kb, vb, split=2, **kw)
    want = tref.flash_attention_split_ref(qb.float(), kb.float(), vb.float(),
                                          split=2, **kw)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))


def _schedule(b, sq, skv, hq, *, causal, window, q_offset, split):
    """``attention.cu``'s grid in launch order: for CTA ``x``, ``(b * Hq +
    h, row-tile start, cluster rank, its K/V tiles)``, decoded from
    ``blockIdx.x`` as the kernel decodes it (latest row tiles first; rank
    ``r`` of a cluster takes tiles ``begin + r``, ``begin + r + split``,
    ... of the band)."""
    n_qt = -(-sq // tref.SIMT_BLOCK_Q)
    out = []
    for x in range(split * n_qt * b * hq):
        item, rank = divmod(x, split)
        level, bh = divmod(item, b * hq)
        i0 = (n_qt - 1 - level) * tref.SIMT_BLOCK_Q
        begin, end = tref.kv_band(i0, sq, skv, causal=causal, window=window,
                                  q_offset=q_offset)
        out.append((bh, i0, rank, list(range(begin + rank, end, split))))
    return out


PLAN_CASES = CASES + [
    dict(b=1, sq=2048, skv=2048, hq=9, hkv=3, d=64, causal=True, window=None),
    dict(b=1, sq=2049, skv=2049, hq=9, hkv=3, d=64, causal=True, window=None),
    dict(b=1, sq=1000, skv=1500, hq=9, hkv=3, d=64, causal=True, window=700),
]


@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("case", PLAN_CASES)
def test_schedule_covers_each_band_once_heaviest_first(case, split):
    kw = _kw(case)
    b, sq, skv, hq = case["b"], case["sq"], case["skv"], case["hq"]
    plan = _schedule(b, sq, skv, hq, split=split, **kw)
    n_qt = -(-sq // tref.SIMT_BLOCK_Q)
    assert len(plan) == split * n_qt * b * hq
    seen: dict = {}
    for bh, i0, rank, tiles in plan:
        for kt in tiles:
            key = (bh, i0, kt)
            assert key not in seen, f"tile {key} taken twice"
            seen[key] = rank
    want = {(bh, i0, kt)
            for bh in range(b * hq)
            for i0 in range(0, sq, tref.SIMT_BLOCK_Q)
            for kt in range(*tref.kv_band(i0, sq, skv, **kw))}
    assert set(seen) == want
    # every key of the band is in one of its tiles, and no tile past it
    # holds one: a tile outside [begin, end) is fully masked
    for i0 in range(0, sq, tref.SIMT_BLOCK_Q):
        begin, end = tref.kv_band(i0, sq, skv, **kw)
        rows = np.arange(i0, min(i0 + tref.SIMT_BLOCK_Q, sq)) + kw["q_offset"]
        keys = np.arange(skv)
        live = np.ones((len(rows), skv), bool)
        if kw["causal"]:
            live &= keys[None] <= rows[:, None]
        if kw["window"] is not None:
            live &= keys[None] > rows[:, None] - kw["window"]
        tiles = {int(j) // tref.SIMT_BLOCK_K for j in np.nonzero(live)[1]}
        assert tiles <= set(range(begin, end))
    # heaviest first: a CTA's row tile never carries a longer band than
    # the row tile of an earlier CTA, when the band grows with the row
    if kw["causal"] and kw["window"] is None:
        loads = [len(range(*tref.kv_band(i0, sq, skv, **kw)))
                 for _, i0, _, _ in plan]
        assert loads == sorted(loads, reverse=True)
    # a cluster's ranks split a band evenly
    for x in range(0, len(plan), split):
        sizes = [len(t) for _, _, _, t in plan[x:x + split]]
        assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("b,s,want", [(1, 2048, 2), (4, 2048, 1),
                                      (1, 32768, 1), (1, 128, 2)])
def test_split_factor_at_the_path_shapes(b, s, want):
    """smollm-135m's layout (9 query heads): the float32 policy's 1 x 2048
    prefill splits its rows; 4 x 2048 and one 32k prompt give every SM
    enough row tiles on their own; a short prompt splits its one long
    band."""
    assert tref.split_factor(b, s, s, 9, causal=True, window=None,
                             q_offset=0) == want
