"""The port's analytics-task registry and action head
(``repro_torch.serving.tasks``, ``models/action.py``) against the
reference's, on the same seeded inputs.

* The registry and the stream constructors, class for class after
  ``tests/test_tasks.py``, with the registered ladders equal to the
  reference's.
* ``OracleActionBackend``: predictions equal to the reference's exactly.
* Mixed-task pods: the reference and the port record the same events
  and the same ``ServeStats`` fingerprint under the sync, deadline and
  async policies, closed and open loop.
* ``TorchActionBackend`` (on the CPU: the plain projection, or the
  gnomonic kernel's plain version) against ``JaxActionBackend(
  use_kernel=False)`` with the reference's weights (``from_jax_params``):
  the crop windows within the projection's tolerance against the
  reference (atol 5e-5, ``test_torch_kernels.py``'s
  ``test_project_sroi_matches_reference``: the float32 gnomonic maps
  round differently), logits within atol/rtol 1e-4, equal categories;
  at a two-rung toy config and at ``act-p1-4x96`` at its published
  width.
* ``trace_count`` is bounded by variants x buckets; the tick's frame is
  staged once and dropped with the tick.
* Layer pins: ``layernorm`` (eps 1e-6, population variance), ``gelu``
  (tanh), ``conv2d(padding="VALID")`` and ``vision._mha_full`` against
  ``repro.models``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sroi as j_sroi
from repro.data import synthetic as j_syn
from repro.models import action as j_act
from repro.models import layers as j_layers
from repro.models import vision as j_vision
from repro.serving import batching as j_batch
from repro.serving import replay as j_replay
from repro.serving import tasks as j_tasks
from repro.serving import telemetry as j_tel
from repro_torch.core import accuracy as acc_mod
from repro_torch.core import sroi as sroi_mod
from repro_torch.data.synthetic import make_video
from repro_torch.models import action as t_act
from repro_torch.models import layers as t_layers
from repro_torch.models import vision as t_vision
from repro_torch.serving import batching as t_batch
from repro_torch.serving import pod_allocation as pa
from repro_torch.serving import profiles
from repro_torch.serving import replay as t_replay
from repro_torch.serving import tasks as task_registry
from repro_torch.serving import telemetry as t_tel
from repro_torch.serving.batching import ShapeBuckets
from repro_torch.serving.network import NetworkModel
from repro_torch.serving.replay import (CorpusSpec, build_fleet, build_pod,
                                        record, stats_fingerprint)
from repro_torch.serving.scheduler import OmniSenseLatencyModel
from repro_torch.serving.tasks import (ACTION_LADDER, AnalyticsTask,
                                       OracleActionBackend, action_ladder,
                                       build_task_streams, get_task,
                                       register_task, stream_tasks_for,
                                       task_for_variant)
from repro_torch.serving.telemetry import MemorySink

MIXED6 = ("detection", "action_recognition") * 3

CLOSED_MIXED = CorpusSpec(mode="closed", n_streams=6, frames=5,
                          budget_s=2.4, devices=8, tasks=MIXED6)
OPEN_MIXED = CorpusSpec(mode="open", n_streams=6, frames=4, budget_s=2.4,
                        devices=8, policy="async", admission="slo",
                        slo_s=2.0, fps=0.5, jitter=0.2, horizon_s=10.0,
                        tasks=MIXED6)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


class TestRegistry:
    def test_both_tasks_registered(self):
        det = get_task("detection")
        act = get_task("action_recognition")
        assert det.accuracy_proxy == "sph_map"
        assert act.accuracy_proxy == "action_top1"
        assert act.ladder_names() == tuple(n for n, _, _ in ACTION_LADDER)
        assert not set(det.ladder_names()) & set(act.ladder_names())

    def test_duplicate_task_name_rejected(self):
        with pytest.raises(ValueError, match="already registered"):
            register_task(dataclasses.replace(get_task("detection")))

    def test_cross_task_variant_collision_rejected(self):
        clone = dataclasses.replace(get_task("detection"),
                                    name="detection_v2")
        with pytest.raises(ValueError, match="already registered to task"):
            register_task(clone)
        assert "detection_v2" not in task_registry.TASKS

    def test_unknown_task_is_a_named_error(self):
        with pytest.raises(ValueError, match="unknown task"):
            get_task("segmentation")

    def test_task_for_variant(self):
        assert task_for_variant("act-p2-8x96") == "action_recognition"
        for v in profiles.make_ladder():
            assert task_for_variant(v.name) == "detection"
        assert task_for_variant("toy-variant") == "detection"

    def test_registry_entries_are_analytics_tasks(self):
        for task in task_registry.TASKS.values():
            assert isinstance(task, AnalyticsTask)
            assert task.ladder_names()

    @pytest.mark.parametrize("name", ["detection", "action_recognition"])
    def test_ladders_and_prices_match_reference(self, name):
        """The registered ladders (names, gav tables, forward seconds,
        sizes) and each rung's (pre, inf) price equal the reference's."""
        t_task, j_task = get_task(name), j_tasks.get_task(name)
        # the port's one task beyond the reference's: region description
        assert task_registry.task_names() == sorted(
            j_tasks.task_names() + ["region_description"])
        assert t_task.accuracy_proxy == j_task.accuracy_proxy
        assert t_task.result_kind == j_task.result_kind
        t_lat, j_lat = t_task.make_latency_model(), j_task.make_latency_model()
        for a, b in zip(t_task.make_ladder(), j_task.make_ladder(),
                        strict=True):
            assert (a.name, a.index, a.input_size, a.location, a.infer_s,
                    a.model_bytes) == (b.name, b.index, b.input_size,
                                       b.location, b.infer_s, b.model_bytes)
            np.testing.assert_array_equal(a.gav, b.gav)
            assert (t_lat._pre(a), t_lat._inf(a)) == (j_lat._pre(b),
                                                      j_lat._inf(b))


# ---------------------------------------------------------------------------
# stream construction
# ---------------------------------------------------------------------------


class TestBuildStreams:
    def test_stream_tasks_for_modes(self):
        assert stream_tasks_for("detection", 3) == ["detection"] * 3
        assert stream_tasks_for("action", 2) == ["action_recognition"] * 2
        assert stream_tasks_for("mixed", 4) == [
            "detection", "action_recognition",
            "detection", "action_recognition"]
        with pytest.raises(ValueError, match="unknown task mode"):
            stream_tasks_for("tracking", 4)

    def _videos(self, n, frames=6):
        return [make_video(n_frames=frames, n_objects=20, seed=100 + s)
                for s in range(n)]

    def test_mixed_union_ladder_and_per_task_pricing(self):
        variants, loops, backends, cost_fn = build_task_streams(
            ["detection", "action_recognition"], self._videos(2),
            [1.8, 1.8])
        det_names = get_task("detection").ladder_names()
        act_names = get_task("action_recognition").ladder_names()
        assert tuple(v.name for v in variants) == det_names + act_names
        assert [loop.task for loop in loops] == ["detection",
                                                 "action_recognition"]
        act_lat = loops[1].latency_model
        for v in loops[1].variants:
            assert cost_fn(v) == act_lat._inf(v)

    def test_unknown_detection_variants_rejected(self):
        with pytest.raises(ValueError, match="unknown variants"):
            build_task_streams(["detection"], self._videos(1), [1.8],
                               detection_variants=("no-such-rung",))

    def test_shape_buckets_union(self):
        buckets = task_registry.shape_buckets_for(
            ["detection", "action_recognition"])
        ref = j_tasks.shape_buckets_for(["detection", "action_recognition"])
        assert buckets.resolutions == ref.resolutions
        assert buckets.batch_sizes == ref.batch_sizes

    def test_default_action_configs_are_the_published_rungs(self):
        got = task_registry.default_action_configs()
        want = j_tasks.default_action_configs()
        assert [(c.name, c.input_size, c.clip_len, c.patch, c.d_model,
                 c.n_layers, c.n_heads, c.d_ff, c.n_actions, c.n_params)
                for c in got] == \
            [(c.name, c.input_size, c.clip_len, c.patch, c.d_model,
              c.n_layers, c.n_heads, c.d_ff, c.n_actions, c.n_params)
             for c in want]
        assert [c.flops_per_clip for c in got] == \
            [c.flops_per_clip for c in want]


# ---------------------------------------------------------------------------
# detection through the registry: bit-identical
# ---------------------------------------------------------------------------


class TestDetectionBitIdentity:
    def test_registry_construction_is_bit_identical(self):
        base = CorpusSpec(mode="closed", n_streams=3, frames=4, devices=4)
        named = dataclasses.replace(base, tasks=("detection",) * 3)
        sink_a, sink_b = MemorySink(), MemorySink()
        stats_a = record(base, sink_a)
        stats_b = record(named, sink_b)
        assert stats_fingerprint(stats_a) == stats_fingerprint(stats_b)
        digests = [(e["stream"], e["frame_idx"], e["det_digest"])
                   for e in sink_a.events if e["event"] == "frame_finish"]
        assert digests == [
            (e["stream"], e["frame_idx"], e["det_digest"])
            for e in sink_b.events if e["event"] == "frame_finish"]
        assert digests

    def test_spec_tasks_round_trip(self):
        spec = CLOSED_MIXED
        assert CorpusSpec.from_dict(spec.to_dict()) == spec
        with pytest.raises(ValueError, match="names 2 streams"):
            record(dataclasses.replace(
                spec, tasks=("detection", "action_recognition")),
                MemorySink())


# ---------------------------------------------------------------------------
# oracle action backend
# ---------------------------------------------------------------------------


def _dets(rows):
    return [[(tuple(float(x) for x in d.box), d.category, d.score)
             for d in dets] for dets in rows]


class TestOracleActionBackend:
    def _regions(self, k, mod=sroi_mod):
        return [mod.SRoI(center=(0.6 * i - 1.0, 0.1 * i), fov=(1.0, 0.9))
                for i in range(k)]

    def test_batched_equals_inline(self):
        video = make_video(n_frames=6, n_objects=25, seed=3)
        inline, batched = OracleActionBackend(video), \
            OracleActionBackend(video)
        variant = action_ladder()[1]
        frame_img = np.zeros((4, 8, 3), np.float32)
        regions = self._regions(3)
        for f in range(4):
            inline.set_frame(f)
            batched.set_frame(f)
            want = [inline.infer_sroi(frame_img, r, variant)
                    for r in regions]
            got = batched.infer_srois_batched(
                [(frame_img, r) for r in regions], variant)
            assert _dets(got) == _dets(want)

    def test_window_fill_warms_up_and_resets(self):
        backend = OracleActionBackend(make_video(n_frames=20, seed=0))
        variant = action_ladder()[1]  # clip_len 8
        region = self._regions(1)[0]
        fills = []
        for f in (0, 1, 2, 3):
            backend.set_frame(f)
            fills.append(backend._window_fill(region, variant))
        assert fills == [1 / 8, 2 / 8, 3 / 8, 4 / 8]
        assert backend._window_fill(region, variant) == 4 / 8
        backend.set_frame(9)
        assert backend._window_fill(region, variant) == 1 / 8
        for f in range(10, 10 + 8):
            backend.set_frame(f)
            fill = backend._window_fill(region, variant)
        assert fill == 1.0

    @pytest.mark.parametrize("rung", range(len(ACTION_LADDER)))
    def test_predictions_equal_reference(self, rung):
        """Every rung's predictions (per-region and the full-ERP pass),
        frame after frame with gaps, equal the reference's exactly."""
        t_b = OracleActionBackend(make_video(n_frames=24, n_objects=30,
                                             seed=40 + rung), seed=rung)
        j_b = j_tasks.OracleActionBackend(
            j_syn.make_video(n_frames=24, n_objects=30, seed=40 + rung),
            seed=rung)
        t_var, j_var = action_ladder()[rung], j_tasks.action_ladder()[rung]
        t_regions = self._regions(4)
        j_regions = self._regions(4, j_sroi)
        n = 0
        for f in (0, 1, 2, 3, 7, 8, 9, 15):
            t_b.set_frame(f)
            j_b.set_frame(f)
            got = t_b.infer_srois_batched([(None, r) for r in t_regions],
                                          t_var)
            want = j_b.infer_srois_batched([(None, r) for r in j_regions],
                                           j_var)
            assert _dets(got) == _dets(want)
            assert _dets([t_b.infer_erp(None, t_var)]) == \
                _dets([j_b.infer_erp(None, j_var)])
            n += sum(map(len, got))
        assert n > 0
        assert t_b._windows == j_b._windows


# ---------------------------------------------------------------------------
# the torch action backend against the reference's
# ---------------------------------------------------------------------------


TOY = [dict(name=f"t{i}", input_size=16 * (i + 1), clip_len=2 + 2 * i,
            patch=8, d_model=8, n_heads=2, d_ff=16, n_actions=4)
       for i in range(2)]
PUBLISHED = [dict(name="act-p1-4x96", input_size=96, clip_len=4)]


def _variants(kws):
    return [acc_mod.ModelProfile(
        name=kw["name"], index=i + 1, input_size=kw["input_size"],
        location="edge", gav=np.full(12, 0.5), infer_s=0.01,
        model_bytes=2 ** 20) for i, kw in enumerate(kws)]


def _backends(kws, use_kernel, max_batch=4):
    j_cfgs = [j_act.ActionConfig(**kw) for kw in kws]
    t_cfgs = [t_act.ActionConfig(**kw) for kw in kws]
    jparams = [j_act.init_params(jax.random.PRNGKey(i), c)
               for i, c in enumerate(j_cfgs)]
    tparams = [t_act.from_jax_params(jax.tree_util.tree_map(np.asarray, p))
               for p in jparams]
    res = tuple(sorted({kw["input_size"] for kw in kws}))
    jb = j_tasks.JaxActionBackend(
        j_cfgs, jparams, use_kernel=False,
        buckets=j_batch.ShapeBuckets.for_max_batch(max_batch, res))
    tb = task_registry.TorchActionBackend(
        t_cfgs, tparams, use_kernel=use_kernel, device="cpu",
        buckets=t_batch.ShapeBuckets.for_max_batch(max_batch, res))
    return jb, tb


def _tubelet(win, clip_len):
    return [win[0]] * (clip_len - len(win)) + list(win)


@pytest.mark.parametrize("kws,erp", [(TOY, (48, 96)), (PUBLISHED, (192, 384))],
                         ids=["two-rung-toy", "act-p1-4x96"])
@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "kernel-plain-version"])
def test_torch_action_backend_matches_reference(kws, erp, use_kernel):
    jb, tb = _backends(kws, use_kernel)
    rng = np.random.default_rng(11)
    frames = [rng.random(erp + (3,)).astype(np.float32) for _ in range(5)]
    regions = [(0.4, 0.1), (-2.0, -0.3), (3.0, 0.6)]
    worst = 0.0
    for f, frame in enumerate(frames):
        # a region seen every frame, one every other frame, one once
        live = [c for k, c in enumerate(regions) if k == 0
                or (k == 1 and f % 2 == 0) or (k == 2 and f == 3)]
        jb.set_frame(f)
        tb.set_frame(f)
        for idx, (jv, tv) in enumerate(zip(_variants(kws), _variants(kws))):
            j_items = [(frame, j_sroi.SRoI(center=c, fov=(1.1, 0.9)))
                       for c in live]
            t_items = [(frame, sroi_mod.SRoI(center=c, fov=(1.1, 0.9)))
                       for c in live]
            want = jb.infer_srois_batched(j_items, jv)
            got = tb.infer_srois_batched(t_items, tv)
            assert [[d.category for d in r] for r in got] == \
                [[d.category for d in r] for r in want]
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a[0].box, b[0].box)
                np.testing.assert_allclose(a[0].score, b[0].score,
                                           atol=1e-4, rtol=1e-4)
            # the windows hold the same crops, and their tubelets give
            # the same logits
            clip = tb.cfgs[idx].clip_len
            assert set(tb._clips) == set(jb._clips)
            keys = [(idx, round(c[0], 1), round(c[1], 1)) for c in live]
            t_clips = torch.stack([torch.stack(_tubelet(tb._clips[k], clip))
                                   for k in keys])
            j_clips = np.stack([np.stack(_tubelet(jb._clips[k], clip))
                                for k in keys])
            np.testing.assert_allclose(t_clips.numpy(), j_clips, atol=5e-5)
            t_logits = t_act.apply(tb.params[idx], t_clips, tb.cfgs[idx])
            j_logits = np.asarray(j_act.apply(jb.params[idx],
                                              jnp.asarray(j_clips),
                                              jb.cfgs[idx]))
            np.testing.assert_allclose(t_logits.numpy(), j_logits,
                                       atol=1e-4, rtol=1e-4)
            worst = max(worst, float(np.abs(t_logits.numpy()
                                            - j_logits).max()))
    assert all(len(w) <= c.clip_len for (i, *_), w in tb._clips.items()
               for c in [tb.cfgs[i]])
    assert worst < 1e-4


def test_trace_count_bounded_by_variants_x_buckets():
    _, backend = _backends(TOY, use_kernel=True, max_batch=2)
    backend.buckets = ShapeBuckets((1, 2), resolutions=(16, 32))
    variants = _variants(TOY)
    frame_img = np.random.default_rng(0).random((32, 64, 3)) \
        .astype(np.float32)
    regions = [sroi_mod.SRoI(center=(0.3 * k, 0.0), fov=(1.0, 1.0))
               for k in range(2)]
    for f in range(3):
        backend.set_frame(f)
        for v in variants:
            for b in (1, 2):
                out = backend.infer_srois_batched(
                    [(frame_img, r) for r in regions[:b]], v)
                assert len(out) == b
                assert all(len(dets) == 1 for dets in out)
    assert backend.trace_count == len(TOY) * 2
    before = backend.trace_count
    backend.infer_sroi(frame_img, regions[0], variants[0])
    assert backend.trace_count == before
    assert backend.infer_erp(frame_img, variants[0]) == []


def test_action_backend_stages_the_tick_frame_once():
    """A staged frame serves every crop of the tick from one upload and
    is dropped with the tick; an unstaged frame uploads on every crop;
    the crop windows outlive the tick."""
    _, backend = _backends(TOY, use_kernel=True)
    variant = _variants(TOY)[1]
    frame = np.random.default_rng(2).random((48, 96, 3)).astype(np.float32)
    items = [(frame, sroi_mod.SRoI(center=(0.5 * k, 0.0), fov=(1.0, 1.0)))
             for k in range(3)]
    backend.stage_frames([frame, frame, None])
    assert backend.frame_uploads == 1
    staged = backend.infer_srois_batched(items, variant)
    assert backend.frame_uploads == 1
    backend.release_frames()
    assert not backend._staged
    assert len(backend._clips) == 3
    _, fresh = _backends(TOY, use_kernel=True)
    unstaged = fresh.infer_srois_batched(items, variant)
    assert fresh.frame_uploads == 3
    assert _dets(staged) == _dets(unstaged)


# ---------------------------------------------------------------------------
# mixed-task pods end to end
# ---------------------------------------------------------------------------


class TestMixedPod:
    def test_closed_mixed_pod_counts_both_tasks(self):
        server = build_pod(CLOSED_MIXED)
        assert server.tasks == ("detection", "action_recognition")
        stats = server.run(range(CLOSED_MIXED.frames))
        n_each = CLOSED_MIXED.frames * 3
        assert stats.frames_by_task == {"detection": n_each,
                                        "action_recognition": n_each}
        proxies = stats.accuracy_proxy_by_task
        assert set(proxies) == {"detection", "action_recognition"}
        assert all(p > 0 for p in proxies.values())
        total = sum(stats.plan_value_by_task.values())
        assert total == pytest.approx(
            stats.accuracy_proxy * stats.frames, rel=1e-9)

    def test_cross_task_variant_collision_rejected_by_pod(self):
        from repro_torch.core.omnisense import OmniSenseLoop
        from repro_torch.serving.scheduler import OracleBackend
        from repro_torch.serving.server import PodServer

        variants = profiles.make_ladder()[:2]
        lat = OmniSenseLatencyModel(profiles.paper_profile(),
                                    NetworkModel())
        loops, backends = [], []
        for s, task in enumerate(("detection", "action_recognition")):
            backend = OracleBackend(make_video(n_frames=4, seed=s))
            loop = OmniSenseLoop(variants, lat, backend, budget_s=1.8)
            loop.task = task
            loops.append(loop)
            backends.append(backend)
        with pytest.raises(ValueError, match="disjoint name spaces"):
            PodServer(loops, backends)

    def test_open_loop_per_task_conservation(self):
        stats = record(OPEN_MIXED, MemorySink())
        tasks = ("detection", "action_recognition")
        for t in tasks:
            assert stats.arrivals_by_task[t] == (
                stats.admitted_by_task.get(t, 0)
                + stats.rejected_by_task.get(t, 0)
                + stats.missed_by_task.get(t, 0)), t
        assert sum(stats.arrivals_by_task.values()) == stats.arrivals
        assert sum(stats.admitted_by_task.values()) == stats.admitted
        assert sum(stats.rejected_by_task.values()) == stats.rejected
        assert sum(stats.missed_by_task.values()) == stats.missed
        assert all(stats.arrivals_by_task[t] > 0 for t in tasks)

    def test_mixed_replay_bit_identical(self):
        from repro_torch.serving.replay import replay

        sink = MemorySink()
        record(OPEN_MIXED, sink)
        result = replay(sink.events)
        assert result.identical, "\n".join(result.drift())

    def test_task_tags_in_telemetry(self):
        sink = MemorySink()
        record(OPEN_MIXED, sink)
        meta = next(e for e in sink.events if e["event"] == "run_meta")
        assert meta["tasks"] == ["detection", "action_recognition"]
        tasks_seen = {e["task"] for e in sink.events
                      if e["event"] == "admission"}
        assert tasks_seen == {"detection", "action_recognition"}
        for ev in ("emit", "dispatch_launch", "frame_finish"):
            assert all("task" in e for e in sink.events
                       if e["event"] == ev)

    @pytest.mark.parametrize("policy", ["sync", "deadline", "async"])
    @pytest.mark.parametrize("mode", ["closed", "open"])
    def test_mixed_pod_matches_reference(self, policy, mode):
        """The same mixed pod in both packages: equal event records and
        an equal ``ServeStats`` fingerprint."""
        spec = CLOSED_MIXED if mode == "closed" else OPEN_MIXED
        kw = dict(spec.to_dict(), policy=policy, pod_allocate=True)
        t_sink, j_sink = t_tel.MemorySink(), j_tel.MemorySink()
        t_stats = t_replay.record(t_replay.CorpusSpec.from_dict(kw), t_sink)
        j_stats = j_replay.record(j_replay.CorpusSpec.from_dict(kw), j_sink)
        assert t_replay.stats_fingerprint(t_stats) == \
            j_replay.stats_fingerprint(j_stats)
        assert t_sink.events == j_sink.events
        assert t_stats.frames_by_task["action_recognition"] > 0


# ---------------------------------------------------------------------------
# coupled pricing across two curves
# ---------------------------------------------------------------------------


class TestCoupledPricing:
    def test_pre_amortization_identity_at_b1_both_tasks(self):
        det_lat = get_task("detection").make_latency_model()
        act_lat = get_task("action_recognition").make_latency_model()
        for lat, ladder in ((det_lat, profiles.make_ladder()),
                            (act_lat, action_ladder())):
            for v in ladder:
                assert lat.pre_amortization(v, 1) == 1.0
                assert lat.pre_amortization(v, 4) < 1.0

    def test_solve_pod_overrides_equal_base_is_identity(self):
        rng = np.random.default_rng(7)
        variants = tuple(profiles.make_ladder(seed=0)[:3])
        lat = OmniSenseLatencyModel(profiles.paper_profile(),
                                    NetworkModel())
        buckets = ShapeBuckets((1, 2, 4, 8))

        def problem(overridden):
            m, r = len(variants), 2
            acc = np.vstack([np.zeros((1, r)),
                             rng.uniform(0.2, 1.0, (m, r))])
            d_pre = np.vstack([np.zeros((1, r)),
                               rng.uniform(0.01, 0.1, (m, r))])
            d_inf = np.vstack([np.zeros((1, r)),
                               rng.uniform(0.05, 0.6, (m, r))])
            return pa.StreamProblem(
                acc, d_pre, d_inf, budget=1.2,
                variants=variants if overridden else None,
                latency_model=lat if overridden else None)

        rng_state = rng.bit_generator.state
        base = pa.solve_pod([problem(False) for _ in range(4)],
                            variants, lat, buckets=buckets)
        rng.bit_generator.state = rng_state
        over = pa.solve_pod([problem(True) for _ in range(4)],
                            variants, lat, buckets=buckets)
        assert base.counts == over.counts
        assert base.projected_tick == over.projected_tick
        for p, q in zip(base.plans, over.plans):
            assert (p is None) == (q is None)
            if p is not None:
                assert p.models == q.models
                assert p.value == q.value


# ---------------------------------------------------------------------------
# fleet-global SLO envelope
# ---------------------------------------------------------------------------


class TestSloEnvelope:
    def test_open_loop_begin_sets_solve_slo(self):
        server = build_pod(CLOSED_MIXED)
        assert server.solve_slo_s is None
        server.open_loop_begin(slo_s=2.0)
        assert server.solve_slo_s == 2.0

    def test_fleet_envelope_reaches_active_pods(self):
        spec = dataclasses.replace(OPEN_MIXED, pods=2)
        fleet = build_fleet(spec)
        fleet.run_open_loop(spec.traffic(), slo_s=spec.slo_s)
        assert fleet.active
        for pid in fleet.active:
            env = fleet.pods[pid].solve_slo_s
            assert env is not None
            assert 0.0 <= env <= spec.slo_s


# ---------------------------------------------------------------------------
# layer pins (hazard (c) of the port: the reference's layer constants)
# ---------------------------------------------------------------------------


def _both(x):
    return jnp.asarray(x), torch.from_numpy(np.asarray(x))


class TestLayerPins:
    def test_layernorm_eps_and_population_variance(self):
        """A last axis of 4 (where the unbiased variance is 4/3 of the
        population one) with a variance near eps (where 1e-5 and 1e-6
        differ): the port equals the reference, and the torch defaults
        would not."""
        rng = np.random.default_rng(0)
        x = (rng.standard_normal((3, 5, 4)) * 2e-3).astype(np.float32)
        p = {"scale": rng.random(4).astype(np.float32) + 0.5,
             "bias": rng.standard_normal(4).astype(np.float32)}
        jx, tx = _both(x)
        want = np.asarray(j_layers.layernorm(
            {k: jnp.asarray(v) for k, v in p.items()}, jx))
        got = t_layers.layernorm({k: torch.from_numpy(v)
                                  for k, v in p.items()}, tx).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        torch_default = torch.nn.functional.layer_norm(
            tx, (4,), torch.from_numpy(p["scale"]),
            torch.from_numpy(p["bias"])).numpy()
        assert np.abs(torch_default - want).max() > 1e-3
        x32 = tx.to(torch.float32)
        unbiased = (x32 - x32.mean(-1, keepdim=True)) * torch.rsqrt(
            x32.var(-1, keepdim=True) + 1e-6)
        assert np.abs(unbiased.numpy() * p["scale"] + p["bias"]
                      - want).max() > 1e-2
        # bf16 in, bf16 out; the arithmetic in float32
        y16 = t_layers.layernorm({k: torch.from_numpy(v)
                                  for k, v in p.items()}, tx.bfloat16())
        assert y16.dtype == torch.bfloat16
        init = t_layers.init_layernorm(4)
        assert torch.equal(init["scale"], torch.ones(4))
        assert torch.equal(init["bias"], torch.zeros(4))

    def test_gelu_is_the_tanh_approximation(self):
        x = np.linspace(-6, 6, 2001, dtype=np.float32)
        jx, tx = _both(x)
        want = np.asarray(j_layers.gelu(jx))
        got = t_layers.gelu(tx).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
        exact = torch.nn.functional.gelu(tx).numpy()
        assert np.abs(exact - want).max() > 1e-4

    @pytest.mark.parametrize("size,k,stride", [(32, 8, 8), (37, 8, 8),
                                               (96, 16, 16), (9, 3, 2)])
    def test_conv2d_valid_padding(self, size, k, stride):
        """"VALID" (no padding; a remainder row and column are dropped)
        against the reference's NHWC/HWIO convolution."""
        rng = np.random.default_rng(size)
        x = rng.random((2, size, size, 3)).astype(np.float32)
        w = rng.standard_normal((k, k, 3, 5)).astype(np.float32)
        b = rng.standard_normal(5).astype(np.float32)
        want = np.asarray(j_layers.conv2d(
            {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
            stride=stride, padding="VALID"))
        got = t_layers.conv2d(
            {"w": torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
             "b": torch.from_numpy(b)},
            torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
            stride=stride, padding="VALID").permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)
        with pytest.raises(ValueError, match="padding"):
            t_layers.conv2d({"w": torch.zeros(1, 1, 1, 1)},
                            torch.zeros(1, 1, 2, 2), padding="FULL")

    def test_mha_full_matches_reference(self):
        rng = np.random.default_rng(4)
        x = rng.standard_normal((3, 7, 16)).astype(np.float32)
        wqkv = (rng.standard_normal((16, 48)) * 0.25).astype(np.float32)
        wo = (rng.standard_normal((16, 16)) * 0.25).astype(np.float32)
        want = np.asarray(j_vision._mha_full(
            jnp.asarray(x), jnp.asarray(wqkv), jnp.asarray(wo), 4,
            j_layers.F32))
        got = t_vision._mha_full(torch.from_numpy(x), torch.from_numpy(wqkv),
                                 torch.from_numpy(wo), 4, t_layers.F32)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)

    @pytest.mark.parametrize("kw", TOY + PUBLISHED, ids=lambda kw: kw["name"])
    def test_action_apply_matches_reference(self, kw):
        jc, tc = j_act.ActionConfig(**kw), t_act.ActionConfig(**kw)
        jp = j_act.init_params(jax.random.PRNGKey(3), jc)
        tp = t_act.from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
        x = np.random.default_rng(3).random(
            (3, jc.clip_len, jc.input_size, jc.input_size, 3)
        ).astype(np.float32)
        want = np.asarray(j_act.apply(jp, jnp.asarray(x), jc))
        got = t_act.apply(tp, torch.from_numpy(x), tc)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
        # the port's own initialiser: the reference's tree, shapes and all
        own = t_act.init_params(torch.Generator().manual_seed(0), tc)
        assert jax.tree_util.tree_structure(own) == \
            jax.tree_util.tree_structure(tp)
        assert [tuple(a.shape) for a in jax.tree_util.tree_leaves(own)] == \
            [tuple(a.shape) for a in jax.tree_util.tree_leaves(tp)]
