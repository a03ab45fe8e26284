"""The port's fleet tier and elastic control plane
(``repro_torch.serving.fleet``, ``repro_torch.distributed.elastic``)
against the reference's, after ``tests/test_fleet.py``.

* The fleet's own contracts in the port: routing (least-loaded balance,
  affinity co-location and arc stability), conservation across routings
  and scale events, the retiring pod's drain, the 1-pod fleet equal to
  the plain ``PodServer``, the ``HealthTracker`` hooks and
  ``serving_scale_plan``.
* Exact parity: the same fleet run in both packages (both routings, a
  fixed active set, an always-hot grow, an always-cold shrink and drain)
  gives the same ``FleetStats`` fingerprint and the same telemetry
  records, and the elastic helpers give the same answers.
"""

from __future__ import annotations

import pytest

from repro.core import omnisense as j_omni
from repro.data import synthetic as j_syn
from repro.distributed import elastic as j_elastic
from repro.serving import fleet as j_fleet
from repro.serving import network as j_net
from repro.serving import profiles as j_prof
from repro.serving import replay as j_replay
from repro.serving import runtime as j_rt
from repro.serving import scheduler as j_sched
from repro.serving import telemetry as j_tel
from repro.serving import traffic as j_traffic
from repro_torch.core import omnisense as t_omni
from repro_torch.data import synthetic as t_syn
from repro_torch.distributed import elastic as t_elastic
from repro_torch.distributed.elastic import HealthTracker, serving_scale_plan
from repro_torch.serving import fleet as t_fleet
from repro_torch.serving import network as t_net
from repro_torch.serving import profiles as t_prof
from repro_torch.serving import replay as t_replay
from repro_torch.serving import runtime as t_rt
from repro_torch.serving import scheduler as t_sched
from repro_torch.serving import telemetry as t_tel
from repro_torch.serving import traffic as t_traffic
from repro_torch.serving.fleet import (AffinityRouting, ElasticController,
                                       FleetServer, LeastLoadedRouting,
                                       RoutingPolicy, default_affinity_key,
                                       format_fleet_report, make_routing)
from repro_torch.serving.replay import stats_fingerprint
from repro_torch.serving.runtime import make_policy
from repro_torch.serving.server import PodServer
from repro_torch.serving.telemetry import MemorySink
from repro_torch.serving.traffic import Arrival

J = dict(omni=j_omni, syn=j_syn, elastic=j_elastic, fleet=j_fleet, net=j_net,
         prof=j_prof, replay=j_replay, rt=j_rt, sched=j_sched, tel=j_tel,
         traffic=j_traffic)
T = dict(omni=t_omni, syn=t_syn, elastic=t_elastic, fleet=t_fleet, net=t_net,
         prof=t_prof, replay=t_replay, rt=t_rt, sched=t_sched, tel=t_tel,
         traffic=t_traffic)


# ---------------------------------------------------------------------------
# constructors (one per package)
# ---------------------------------------------------------------------------


def _streams(n_streams, m=T, seed0=300, budget=0.9):
    variants = m["prof"].make_ladder()[3:5]
    lat = m["sched"].OmniSenseLatencyModel(m["prof"].paper_profile(),
                                           m["net"].NetworkModel())
    return m["fleet"].make_fleet_pods(
        n_streams,
        make_backend=lambda s: m["sched"].OracleBackend(
            m["syn"].make_video(n_frames=64, n_objects=30 + 5 * (s % 4),
                                seed=seed0 + s)),
        make_loop=lambda s, b: m["omni"].OmniSenseLoop(variants, lat, b,
                                                       budget_s=budget),
        pod_server_kwargs=lambda pid: {
            "max_batch": 8,
            "policy": m["rt"].make_policy("async", admission="slo")},
    )


def _fleet(n_streams, pods, routing="least-loaded", elastic=None,
           telemetry=None, m=T):
    _, _, make_pod = _streams(n_streams, m)
    return m["fleet"].FleetServer(make_pod, pods, routing=routing,
                                  elastic=elastic, telemetry=telemetry)


def _traffic(n_streams, m=T, seed=5, horizon_s=12.0, fps=0.8):
    return m["traffic"].ArrivalProcess(n_streams, fps=fps, jitter=0.2,
                                       seed=seed, horizon_s=horizon_s)


def _check_conservation(fstats, n_arrivals):
    assert fstats.arrivals == n_arrivals
    assert fstats.arrivals == sum(s.arrivals for s in fstats.pod_stats)
    assert fstats.arrivals == sum(
        s.admitted + s.rejected + s.missed for s in fstats.pod_stats)
    for s in fstats.pod_stats:
        assert s.arrivals == s.admitted + s.rejected + s.missed
        assert s.frames == s.admitted


# ---------------------------------------------------------------------------
# routing policies
# ---------------------------------------------------------------------------


class TestRouting:
    def test_make_routing_resolves_names_and_instances(self):
        assert isinstance(make_routing("least-loaded"), LeastLoadedRouting)
        assert isinstance(make_routing("affinity"), AffinityRouting)
        inst = LeastLoadedRouting()
        assert make_routing(inst) is inst

    def test_make_routing_rejects_unknown(self):
        with pytest.raises(ValueError, match="unknown routing"):
            make_routing("round-robin")
        with pytest.raises(ValueError, match="unknown routing"):
            make_routing(None)

    def test_base_policy_is_abstract(self):
        fleet = _fleet(2, 1)
        with pytest.raises(NotImplementedError):
            RoutingPolicy().assign(0, fleet)

    def test_least_loaded_balances_new_streams(self):
        fleet = _fleet(8, 2)
        for s in range(8):
            fleet._route(Arrival(stream=s, t_s=0.1 * (s + 1), frame_idx=0))
        assert sorted(fleet.assigned_counts().values()) == [4, 4]

    def test_affinity_colocates_same_key_streams(self):
        fleet = _fleet(16, 4, routing="affinity")
        for s in range(16):
            fleet._route(Arrival(stream=s, t_s=0.1 * (s + 1), frame_idx=0))
        for s in range(16):
            assert fleet.assignment[s] == fleet.assignment[s % 4], s
            assert default_affinity_key(s) == f"c{s % 4}"

    def test_affinity_arcs_stable_on_grow(self):
        fleet = _fleet(4, 3, routing="affinity")
        keys = [f"k{i}" for i in range(64)]
        fleet.routing.affinity_key = lambda s: keys[s]
        before = {i: fleet.routing.assign(i, fleet) for i in range(64)}
        new_pid = fleet.grow(t_s=1.0, pressure=0.5)
        after = {i: fleet.routing.assign(i, fleet) for i in range(64)}
        moved = [i for i in range(64) if after[i] != before[i]]
        assert all(after[i] == new_pid for i in moved)
        assert len(moved) < 64

    def test_least_loaded_marks_overflow_for_reroute_on_scale(self):
        fleet = _fleet(6, 2)
        for s in range(6):
            fleet._route(Arrival(stream=s, t_s=0.1 * (s + 1), frame_idx=0))
        fleet.grow(t_s=1.0, pressure=0.5)
        marked = [s for s in range(6) if fleet.routing.wants_reroute(s)]
        assert len(marked) == 2

    @pytest.mark.parametrize("vnodes", [1, 4, 16])
    def test_ring_matches_reference(self, vnodes):
        """The sha1 ring: the same points, and every key of 64 assigned
        to the same pod as the reference assigns it, before and after a
        grow."""
        keys = [f"k{i}" for i in range(64)]
        out = {}
        for name, m in (("j", J), ("t", T)):
            fleet = _fleet(4, 3, m=m, routing=m["fleet"].AffinityRouting(
                affinity_key=lambda s: keys[s], vnodes=vnodes))
            first = [fleet.routing.assign(i, fleet) for i in range(64)]
            fleet.grow(t_s=1.0, pressure=0.5)
            out[name] = (list(fleet.routing._ring), first,
                         [fleet.routing.assign(i, fleet) for i in range(64)])
        assert out["t"] == out["j"]
        assert t_fleet._ring_hash("pod-0-vnode-0") == \
            j_fleet._ring_hash("pod-0-vnode-0")


# ---------------------------------------------------------------------------
# fleet serving: conservation + determinism
# ---------------------------------------------------------------------------


class TestFleetServing:
    @pytest.mark.parametrize("routing", ["least-loaded", "affinity"])
    def test_conservation_across_routings(self, routing):
        fleet = _fleet(9, 3, routing=routing)
        traffic = _traffic(9)
        fstats = fleet.run_open_loop(traffic, slo_s=2.0)
        _check_conservation(fstats, len(traffic.arrivals()))
        assert fstats.routes >= 9

    def test_single_pod_fleet_bit_identical_to_pod_server(self):
        fleet = _fleet(5, 1)
        fstats = fleet.run_open_loop(_traffic(5), slo_s=2.0)
        loops, backends, _ = _streams(5)
        solo = PodServer(loops, backends, max_batch=8,
                         policy=make_policy("async", admission="slo"))
        sstats = solo.run_open_loop(_traffic(5), slo_s=2.0)
        assert (stats_fingerprint(fstats)["pods"][0]
                == stats_fingerprint(sstats))

    def test_route_telemetry_tagged_with_pods(self):
        sink = MemorySink()
        fleet = _fleet(4, 2, telemetry=sink)
        fleet.run_open_loop(_traffic(4, horizon_s=6.0), slo_s=2.0)
        routes = [e for e in sink.events if e["event"] == "route"]
        assert {e["reason"] for e in routes} == {"new"}
        assert {e["stream"] for e in routes} == set(range(4))
        assert all("pod" in e for e in sink.events)
        assert any(e["event"] == "dispatch_launch" for e in sink.events)

    def test_fleet_requires_at_least_one_pod(self):
        _, _, make_pod = _streams(2)
        with pytest.raises(ValueError, match="n_pods"):
            FleetServer(make_pod, 0)

    def test_retire_guards(self):
        fleet = _fleet(2, 2)
        with pytest.raises(ValueError, match="not active"):
            fleet.retire(7, t_s=0.0, pressure=0.0)
        fleet.retire(1, t_s=0.0, pressure=0.0)
        with pytest.raises(ValueError, match="last active pod"):
            fleet.retire(0, t_s=0.0, pressure=0.0)

    def test_fleet_stats_aggregation_and_report(self):
        fleet = _fleet(6, 2)
        horizon = 12.0
        fstats = fleet.run_open_loop(_traffic(6, horizon_s=horizon),
                                     slo_s=2.0)
        assert fstats.n_pods == 2
        assert fstats.admitted == sum(s.admitted for s in fstats.pod_stats)
        assert fstats.frames == sum(s.frames for s in fstats.pod_stats)
        assert len(fstats.event_e2e) == sum(
            len(s.event_e2e) for s in fstats.pod_stats)
        pct = fstats.event_e2e_percentiles()
        assert pct[50] <= pct[95] <= pct[99]
        report = format_fleet_report(fstats, horizon)
        assert any("useful goodput" in line for line in report)


# ---------------------------------------------------------------------------
# elastic scaling
# ---------------------------------------------------------------------------


class TestElasticController:
    def test_invalid_args_rejected(self):
        for kw in (dict(min_pods=0), dict(min_pods=3, max_pods=2),
                   dict(interval_s=0.0), dict(sustain=0)):
            with pytest.raises(ValueError):
                ElasticController(**kw)

    def test_grow_on_sustained_pressure(self):
        fleet = _fleet(4, 1)
        ctl = ElasticController(min_pods=1, max_pods=3, interval_s=1.0,
                                sustain=2)
        t = 0.0
        for _ in range(6):
            t += 1.0
            for pid in fleet.active:
                fleet.pods[pid].stats.arrivals += 10
                fleet.pods[pid].stats.rejected += 8  # pressure 0.8
            ctl.control(fleet, t)
        assert len(fleet.active) == 3  # max_pods respected
        assert fleet.scale_ups == 2

    def test_shrink_on_sustained_cold_respects_min_pods(self):
        fleet = _fleet(4, 3)
        ctl = ElasticController(min_pods=2, max_pods=3, interval_s=1.0,
                                sustain=2)
        t = 0.0
        for _ in range(6):
            t += 1.0
            ctl.control(fleet, t)
        assert len(fleet.active) == 2
        assert fleet.scale_downs == 1

    def test_shrink_victim_prefers_empty_then_highest_id(self):
        fleet = _fleet(6, 3)
        fleet.assignment = {0: 0, 1: 0, 2: 1}
        assert ElasticController._pick_victim(fleet) == 2
        fleet.assignment = {}
        assert ElasticController._pick_victim(fleet) == 2

    def test_catch_up_after_lull_takes_one_action(self):
        fleet = _fleet(4, 3)
        ctl = ElasticController(min_pods=1, max_pods=3, interval_s=1.0,
                                sustain=1)
        ctl.control(fleet, 50.0)
        assert len(fleet.active) == 2
        assert fleet.scale_downs == 1

    def test_retiring_pod_drains_and_streams_migrate(self):
        sink = MemorySink()
        ctl = ElasticController(min_pods=1, max_pods=3, interval_s=3.0,
                                grow_threshold=2.0, shrink_threshold=1.1,
                                sustain=1)
        fleet = _fleet(6, 3, elastic=ctl, telemetry=sink)
        traffic = _traffic(6, horizon_s=15.0)
        fstats = fleet.run_open_loop(traffic, slo_s=2.0)
        assert fstats.scale_downs == 2
        assert len(fleet.active) == 1
        _check_conservation(fstats, len(traffic.arrivals()))
        migrations = [e for e in sink.events if e["event"] == "route"
                      and e["reason"] == "migrate"]
        assert migrations and fstats.migrations >= len(migrations)
        scale = [e for e in sink.events if e["event"] == "scale"]
        assert [e["action"] for e in scale] == ["shrink", "shrink"]
        for pid in set(fleet.pods) - set(fleet.active):
            assert not fleet.pods[pid]._inflight
            assert not len(fleet.pods[pid].queues)

    def test_grow_mid_run_serves_new_pod(self):
        ctl = ElasticController(min_pods=1, max_pods=3, interval_s=3.0,
                                grow_threshold=0.0, sustain=1)
        fleet = _fleet(6, 1, elastic=ctl)
        traffic = _traffic(6, horizon_s=15.0)
        fstats = fleet.run_open_loop(traffic, slo_s=2.0)
        assert fstats.scale_ups == 2
        assert len(fleet.active) == 3
        _check_conservation(fstats, len(traffic.arrivals()))

    def test_health_tracker_integration(self):
        tracker = HealthTracker(0, beat_interval=8.0)
        fleet = _fleet(4, 3)
        ctl = ElasticController(min_pods=1, max_pods=3, interval_s=1.0,
                                sustain=99, tracker=tracker)
        for pid in (0, 1):
            fleet.pods[pid].stats.arrivals += 10
            fleet.pods[pid].stats.rejected += 1
        fleet.pods[2].stats.arrivals += 10
        fleet.pods[2].stats.rejected += 10
        ctl.control(fleet, 1.0)
        assert set(tracker.hosts) >= {0, 1, 2}
        assert ctl.stragglers() == [2]
        tracker.remove_host(2)
        assert 2 not in tracker.hosts


class TestElasticHelpers:
    @pytest.mark.parametrize("total,pods", [(8, 4), (8, 3), (0, 4), (7, 2),
                                            (16, 5), (1, 1)])
    def test_serving_scale_plan_matches_reference(self, total, pods):
        assert serving_scale_plan(total, pods) == \
            j_elastic.serving_scale_plan(total, pods)

    def test_serving_scale_plan_cases(self):
        assert serving_scale_plan(8, 4) == {
            "n_pods": 4, "per_pod_devices": 2, "devices_used": 8,
            "devices_idle": 0}
        plan = serving_scale_plan(8, 3)
        assert plan["per_pod_devices"] == 2
        assert plan["devices_used"] == 6 and plan["devices_idle"] == 2
        with pytest.raises(ValueError, match="n_pods"):
            serving_scale_plan(8, 0)

    @pytest.mark.parametrize("healthy", [4, 6, 8, 13, 32])
    def test_remesh_plan_matches_reference(self, healthy):
        args = ((2, 4, 4), ("pod", "data", "model"), healthy)
        assert t_elastic.remesh_plan(*args) == j_elastic.remesh_plan(*args)
        with pytest.raises(ValueError, match="model axis"):
            t_elastic.remesh_plan((1, 1, 8), ("pod", "data", "model"), 4)

    def test_health_tracker_and_straggler_policy_match_reference(self):
        out = {}
        for name, m in (("j", J), ("t", T)):
            el = m["elastic"]
            tr = el.HealthTracker(4, beat_interval=1.0, max_missed=2)
            log = []
            for step, now in enumerate((0.5, 1.0, 2.5, 4.0, 5.5)):
                for h in (0, 1, 2):
                    if not (h == 2 and step >= 1):
                        tr.heartbeat(h, now, step_time=1.0 + h * (h == 1))
                tr.tick(now)
                log.append((tr.healthy(), tr.stragglers()))
            tr.ensure_host(9, now=6.0)
            tr.remove_host(0)
            pol = el.StragglerPolicy(margin=1.2)
            steps = [pol.step({0: 1.0, 1: 1.1, 2: 2.0, 3: 0.9}),
                     pol.step({0: 1.0, 1: 1.0})]
            out[name] = (log, sorted(tr.hosts), steps, pol.dropped_total)
        assert out["t"] == out["j"]
        assert out["t"][0][-1][0] != [0, 1, 2, 3]  # failures were marked


# ---------------------------------------------------------------------------
# exact parity with the reference's fleet
# ---------------------------------------------------------------------------


def _elastic(kind, m):
    ctl = m["fleet"].ElasticController
    if kind == "grow":
        return ctl(min_pods=1, max_pods=3, interval_s=3.0,
                   grow_threshold=0.0, sustain=1)
    if kind == "shrink":
        return ctl(min_pods=1, max_pods=3, interval_s=3.0,
                   grow_threshold=2.0, shrink_threshold=1.1, sustain=1)
    return None


@pytest.mark.parametrize("routing,pods,elastic", [
    ("least-loaded", 2, None), ("affinity", 3, None),
    ("least-loaded", 1, "grow"), ("affinity", 1, "grow"),
    ("least-loaded", 3, "shrink"), ("affinity", 3, "shrink")])
def test_fleet_matches_reference(routing, pods, elastic):
    """The same fleet run in both packages: equal ``FleetStats``
    fingerprints (every pod's ``ServeStats`` and the control plane's
    counters) and equal telemetry records (routes, scale events and
    every pod's records)."""
    out = {}
    for name, m in (("j", J), ("t", T)):
        sink = m["tel"].MemorySink()
        fleet = _fleet(6, pods, routing=routing, elastic=_elastic(elastic, m),
                       telemetry=sink, m=m)
        fstats = fleet.run_open_loop(_traffic(6, m, horizon_s=15.0),
                                     slo_s=2.0)
        out[name] = (m["replay"].stats_fingerprint(fstats), sink.events,
                     m["fleet"].format_fleet_report(fstats, 15.0))
    assert out["t"][0] == out["j"][0]
    assert out["t"][1] == out["j"][1]
    assert out["t"][2] == out["j"][2]
    fp = out["t"][0]
    if elastic == "grow":
        assert fp["scale_ups"] == 2
    if elastic == "shrink":
        assert fp["scale_downs"] == 2 and fp["migrations"] > 0
