"""The port's verbatim copies of the NumPy core against the reference,
exactly, on seeded inputs (after ``tests/test_allocation.py``,
``tests/test_sroi.py`` and ``tests/test_pod_allocation.py``):

* Algorithm 2: ``allocate`` and ``allocate_bruteforce``, plain and
  through a ``CostHook`` (``apply_cost_hook``, ``plan_latency``);
* Algorithm 1: ``predict_srois`` (SRoIs, their ccv and alpha), and
  ``compute_ccv``, ``size_level_in``;
* object discovery: ``DiscoveryState``'s verdicts over a seeded trace;
* the synthetic ERP raster (``render_erp``, which the port paints over
  each object's rows and columns instead of a whole-frame mask), bit for
  bit, the seam and the poles included.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest

from repro.core import allocation as j_alloc
from repro.core import discovery as j_disc
from repro.core import sroi as j_sroi
from repro.data import synthetic as j_syn
from repro_torch.core import allocation as t_alloc
from repro_torch.core import discovery as t_disc
from repro_torch.core import sroi as t_sroi
from repro_torch.data import synthetic as t_syn


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


# The port's array frontier and staircase prune against the reference's
# per-plan loop, bit for bit, at the loop's width (skip + five rungs):
# ties come from accuracies rounded to 0.1, from columns that repeat, and
# from the delays of a rung equal on every SRoI (as the latency model
# prices them).
TIES = ("none", "rounded", "duplicated", "equal_delays")


def _ladder_instance(seed, r, ties):
    rng = np.random.default_rng(seed)
    acc = rng.uniform(0, 1, (6, r))
    acc[0] = 0.0
    d_pre = rng.uniform(0.01, 0.2, (6, r))
    d_pre[0] = 0.0
    d_inf = rng.uniform(0.02, 0.6, (6, r))
    d_inf[0] = 0.0
    if ties == "rounded":
        acc = np.round(acc, 1)
    elif ties == "duplicated":
        col = np.arange(r) // 2
        acc, d_pre, d_inf = acc[:, col], d_pre[:, col], d_inf[:, col]
    elif ties == "equal_delays":
        d_pre[:] = d_pre[:, :1]
        d_inf[:] = d_inf[:, :1]
    return acc, d_pre, d_inf


def _bits(p):
    return None if p is None else (
        p.models, p.value.hex(), float(p.t_pre).hex(), float(p.t_done).hex())


@pytest.mark.parametrize("ties", TIES)
@pytest.mark.parametrize("r", range(1, 15))
def test_array_dp_matches_reference_bitwise(r, ties):
    acc, d_pre, d_inf = _ladder_instance(1000 * r + TIES.index(ties), r, ties)
    # every plan fits the loose budget; the tight one skips SRoIs and the
    # mid one takes cheaper rungs.  Beyond 8 columns the reference's loose
    # frontier grows past a smoke test's time, save with equal delays
    loose = float((d_pre + d_inf).max(axis=0).sum())
    budgets = [0.15 * loose, 0.3 * loose]
    if r <= 8 or ties == "equal_delays":
        budgets.append(loose)
    for budget in budgets:
        got = t_alloc.allocate(acc, d_pre, d_inf, budget)
        want = j_alloc.allocate(acc, d_pre, d_inf, budget)
        assert _bits(got) == _bits(want)
        assert type(got.value) is float and type(got.models[0]) is int
    # infeasible: from the second column on both return None; on a
    # single column the reference's max() of an empty frontier raises
    if r > 1:
        assert t_alloc.allocate(acc, d_pre, d_inf, -1.0) is None
        assert j_alloc.allocate(acc, d_pre, d_inf, -1.0) is None
    else:
        assert t_alloc.allocate(acc, d_pre, d_inf, -1.0) is None
        with pytest.raises(ValueError):
            j_alloc.allocate(acc, d_pre, d_inf, -1.0)


@pytest.mark.parametrize("seed", range(3))
def test_array_dp_cost_hook_and_empty_match_reference(seed):
    acc, d_pre, d_inf = _ladder_instance(50 + seed, 3 + 2 * seed, TIES[seed])
    budget = 0.2 * float((d_pre + d_inf).max(axis=0).sum())
    got = t_alloc.allocate(acc, d_pre, d_inf, budget, cost_hook=_hook)
    assert _bits(got) == _bits(j_alloc.allocate(acc, d_pre, d_inf, budget,
                                                cost_hook=_hook))
    empty = np.zeros((6, 0))
    assert _bits(t_alloc.allocate(empty, empty, empty, budget)) == _bits(
        j_alloc.allocate(empty, empty, empty, budget))


@pytest.mark.parametrize("seed", range(6))
def test_staircase_prune_keeps_the_reference_plans(seed):
    rng = np.random.default_rng(seed)
    n = 40 + 60 * seed
    # coarse grids, so that values, times and whole triples repeat
    v = rng.integers(0, 8, n) / 4.0
    t_pre = rng.integers(0, 10, n) / 8.0
    t_done = t_pre + rng.integers(0, 10, n) / 8.0
    if seed % 2:
        v = v + rng.uniform(0, 1e-3, n)  # distinct values
    plans = [j_alloc.Plan(float(a), float(b), float(c), (i,))
             for i, (a, b, c) in enumerate(zip(v, t_pre, t_done))]
    want = [p.models[0] for p in j_alloc._prune_dominated(plans)]
    assert t_alloc._prune_dominated(v, t_pre, t_done).tolist() == want


def _reference_candidates(acc, d_pre, d_inf, budget):
    """The feasible (plan, model) pairs of the reference's loop, summed
    over its columns."""
    d_tot = d_pre + d_inf
    frontier = [j_alloc.Plan(float(acc[i, 0]), float(d_pre[i, 0]),
                             float(d_tot[i, 0]), ())
                for i in range(acc.shape[0]) if d_tot[i, 0] <= budget]
    n = len(frontier)
    frontier = j_alloc._prune_dominated(frontier)
    for j in range(1, acc.shape[1]):
        nxt = [j_alloc.Plan(p.value + float(acc[i, j]),
                            p.t_pre + float(d_pre[i, j]),
                            max(p.t_pre + d_tot[i, j], p.t_done + d_inf[i, j]),
                            ())
               for p in frontier for i in range(acc.shape[0])
               if max(p.t_pre + d_tot[i, j], p.t_done + d_inf[i, j]) <= budget]
        n += len(nxt)
        frontier = j_alloc._prune_dominated(nxt)
    return n


@pytest.mark.parametrize("ties", TIES)
def test_allocate_counts_the_reference_candidates(ties):
    from repro_torch import tracing

    acc, d_pre, d_inf = _ladder_instance(7, 9, ties)
    budget = 0.15 * float((d_pre + d_inf).max(axis=0).sum())
    tracing.reset()
    tracing.begin_tick(0)
    try:
        t_alloc.allocate(acc, d_pre, d_inf, budget)
        t_alloc.allocate(acc[:, :0], d_pre[:, :0], d_inf[:, :0], budget)
    finally:
        tracing.end_tick()
    counted = tracing.tick_counters(0)["alloc.candidates"]
    tracing.reset()
    assert counted == _reference_candidates(acc, d_pre, d_inf, budget)


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


@pytest.mark.parametrize("seed", [0, 21])
def test_render_erp_matches_reference(seed):
    # polar_fraction 0.3 puts objects over the poles; 60 objects over 8
    # frames of yaw put some across the seam
    kw = dict(n_frames=8, n_objects=60, seed=seed, polar_fraction=0.3)
    t_video, j_video = t_syn.make_video(**kw), j_syn.make_video(**kw)
    for f in (0, 3, 7):
        for h, w in ((96, 192), (240, 480)):
            got = t_syn.render_erp(t_video, f, height=h, width=w)
            want = j_syn.render_erp(j_video, f, height=h, width=w)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
