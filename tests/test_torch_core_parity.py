"""The port's verbatim copies of the NumPy core against the reference,
exactly, on seeded inputs (after ``tests/test_allocation.py``,
``tests/test_sroi.py`` and ``tests/test_pod_allocation.py``):

* Algorithm 2: ``allocate`` and ``allocate_bruteforce``, plain and
  through a ``CostHook`` (``apply_cost_hook``, ``plan_latency``);
* Algorithm 1: ``predict_srois`` (SRoIs, their ccv and alpha), and
  ``compute_ccv``, ``size_level_in``;
* object discovery: ``DiscoveryState``'s verdicts over a seeded trace.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest

from repro.core import allocation as j_alloc
from repro.core import discovery as j_disc
from repro.core import sroi as j_sroi
from repro_torch.core import allocation as t_alloc
from repro_torch.core import discovery as t_disc
from repro_torch.core import sroi as t_sroi


def _instance(seed, m, r):
    rng = np.random.default_rng(seed)
    acc = rng.uniform(0, 1, (m, r))
    acc[0] = 0.0
    d_pre = rng.uniform(0.01, 0.2, (m, r))
    d_pre[0] = 0.0
    d_inf = rng.uniform(0.02, 0.6, (m, r))
    d_inf[0] = 0.0
    return acc, d_pre, d_inf, float(rng.uniform(0.1, 3.0))


def _plan(p):
    return None if p is None else dataclasses.astuple(p)


def _hook(i, j, dp, di):
    return dp * (1.0 - 0.1 * (i > 0)), di * (0.5 + 0.25 * i) + 0.01 * j


@pytest.mark.parametrize("seed", range(8))
def test_allocate_matches_reference(seed):
    m, r = 2 + seed % 3, 1 + seed % 5
    acc, d_pre, d_inf, budget = _instance(seed, m, r)
    for hook in (None, _hook):
        kw = {} if hook is None else dict(cost_hook=hook)
        got = t_alloc.allocate(acc, d_pre, d_inf, budget, **kw)
        assert _plan(got) == _plan(j_alloc.allocate(acc, d_pre, d_inf,
                                                    budget, **kw))
        brute = t_alloc.allocate_bruteforce(acc, d_pre, d_inf, budget, **kw)
        assert _plan(brute) == _plan(j_alloc.allocate_bruteforce(
            acc, d_pre, d_inf, budget, **kw))
        assert (got is None) == (brute is None)
        if got is not None:
            assert np.isclose(got.value, brute.value, atol=1e-9)


@pytest.mark.parametrize("seed", range(4))
def test_cost_hook_path_matches_reference(seed):
    acc, d_pre, d_inf, budget = _instance(100 + seed, 4, 4)
    t_pre, t_inf = t_alloc.apply_cost_hook(_hook, d_pre, d_inf)
    j_pre, j_inf = j_alloc.apply_cost_hook(_hook, d_pre, d_inf)
    np.testing.assert_array_equal(t_pre, j_pre)
    np.testing.assert_array_equal(t_inf, j_inf)
    models = tuple(int(i) for i in
                   np.random.default_rng(seed).integers(0, 4, 4))
    assert t_alloc.plan_latency(models, t_pre, t_inf) == \
        j_alloc.plan_latency(models, j_pre, j_inf)
    # the identity hook is bit-identical to no hook
    ident = t_alloc.allocate(acc, d_pre, d_inf, budget,
                             cost_hook=lambda i, j, dp, di: (dp, di))
    assert _plan(ident) == _plan(j_alloc.allocate(acc, d_pre, d_inf, budget))


def _history(m, seed, n):
    rng = np.random.default_rng(seed)
    return [m.Detection(np.array([rng.uniform(-math.pi, math.pi),
                                  rng.uniform(-1.2, 1.2),
                                  rng.uniform(0.05, 2.0),
                                  rng.uniform(0.05, 1.6)]),
                        int(rng.integers(0, 80)),
                        float(rng.uniform(0.05, 1.0)))
            for _ in range(n)]


def _srois(srois):
    return [(s.center, s.fov, s.special, s.alpha, s.ccv.tolist(),
             [(o.box.tolist(), o.category) for o in s.objects])
            for s in srois]


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 5), (2, 12), (3, 20),
                                    (4, 40)])
def test_predict_srois_matches_reference(seed, n):
    for kw in (dict(), dict(gamma=1.3, n_categories=16,
                            f=math.radians(75.0))):
        got = t_sroi.predict_srois(_history(t_sroi, seed, n), **kw)
        want = j_sroi.predict_srois(_history(j_sroi, seed, n), **kw)
        assert _srois(got) == _srois(want)
        assert sum(len(s.objects) for s in got) == n
    assert t_sroi.predict_srois([]) == j_sroi.predict_srois([]) == []


def test_ccv_and_size_levels_match_reference():
    t_hist, j_hist = _history(t_sroi, 7, 30), _history(j_sroi, 7, 30)
    for ref_sr in (4 * math.pi, t_sroi.region_solid_angle(1.0, 1.0)):
        np.testing.assert_array_equal(
            t_sroi.compute_ccv(t_hist, 80, 0.0044, 0.0354, ref_sr),
            j_sroi.compute_ccv(j_hist, 80, 0.0044, 0.0354, ref_sr))
        assert [t_sroi.size_level_in(o, ref_sr, 0.0044, 0.0354)
                for o in t_hist] == \
            [j_sroi.size_level_in(o, ref_sr, 0.0044, 0.0354) for o in j_hist]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_discovery_matches_reference(seed):
    rng = np.random.default_rng(seed)
    trace = [(int(rng.integers(0, 6)), float(rng.uniform(0, 2.0)))
             for _ in range(40)]
    out = {}
    for name, m in (("t", t_disc), ("j", j_disc)):
        state = m.DiscoveryState()
        verdicts = []
        for n_srois, latency in trace:
            state.observe(n_srois)
            verdicts.append((state.should_discover(2.0, latency),
                             dataclasses.astuple(state)))
        out[name] = verdicts
    assert out["t"] == out["j"]
    assert any(v for v, _ in out["t"]) and not all(v for v, _ in out["t"])
