"""The port's pod tick (``repro_torch.serving.server.PodServer`` and what
it drives) against the reference's, on the same seeded inputs.

* Oracle pods, exact parity: the reference and the port build the same
  pod (``OracleBackend`` per stream, the setups of
  ``tests/test_runtime.py``, ``test_pod_allocation.py``,
  ``test_placement.py`` and ``test_traffic.py``) and must emit the same
  ``MemorySink`` records, list for list, and the same ``ServeStats``
  (``dataclasses.asdict`` without the wall-clock ``sum_overhead``: the
  rule of ``repro.serving.replay.stats_fingerprint``), under the sync,
  deadline and async policies, pod-level allocation, a virtual
  placement and the open loop with SLO admission.
* Unit parity: ``solve_pod`` and ``solve_pod_bruteforce`` plans,
  ``VariantQueues.drain_ops`` dispatch records, ``ArrivalProcess``
  arrivals, ``detections_digest`` and the timeline report.
* The real detector: ``PodServer`` over ``TorchDetectorBackend`` (on the
  CPU, its kernels' plain versions) against the reference's
  ``PodServer`` over ``JaxDetectorBackend(use_kernel=False)`` with the
  converted weights of ``test_torch_pipeline.py``, and against the
  port's own per-stream inline loop.
* The tick's frame staging: staged and unstaged ticks give identical
  detections, a buffer refilled in place is served from its new pixels,
  and no device frame outlives its tick.
* ``_suppress_tick`` pads the NMS rows where the auto backend is the
  card's (the port's ``"cuda"``), as the reference does for its
  ``"device"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro.core import omnisense as j_omni
from repro.core import sroi as j_sroi
from repro.data import synthetic as j_syn
from repro.serving import batching as j_batch
from repro.serving import network as j_net
from repro.serving import placement as j_place
from repro.serving import pod_allocation as j_pa
from repro.serving import profiles as j_prof
from repro.serving import runtime as j_rt
from repro.serving import scheduler as j_sched
from repro.serving import server as j_server
from repro.serving import telemetry as j_tel
from repro.serving import traffic as j_traffic
from repro_torch.core import omnisense as t_omni
from repro_torch.core import sroi as t_sroi
from repro_torch.data import synthetic as t_syn
from repro_torch.serving import batching as t_batch
from repro_torch.serving import network as t_net
from repro_torch.serving import placement as t_place
from repro_torch.serving import pod_allocation as t_pa
from repro_torch.serving import profiles as t_prof
from repro_torch.serving import runtime as t_rt
from repro_torch.serving import scheduler as t_sched
from repro_torch.serving import server as t_server
from repro_torch.serving import telemetry as t_tel
from repro_torch.serving import traffic as t_traffic

J = dict(omni=j_omni, sroi=j_sroi, syn=j_syn, batch=j_batch, net=j_net,
         place=j_place, pa=j_pa, prof=j_prof, rt=j_rt, sched=j_sched,
         server=j_server, tel=j_tel, traffic=j_traffic)
T = dict(omni=t_omni, sroi=t_sroi, syn=t_syn, batch=t_batch, net=t_net,
         place=t_place, pa=t_pa, prof=t_prof, rt=t_rt, sched=t_sched,
         server=t_server, tel=t_tel, traffic=t_traffic)


def fingerprint(stats) -> dict:
    """``ServeStats`` without its wall-clock field."""
    out = dataclasses.asdict(stats)
    del out["sum_overhead"]
    return out


# -- oracle pods ---------------------------------------------------------------


def _oracle_pod(m, n_streams=3, frames=6, seed0=100, budget=1.8,
                policy="sync", pod_allocate=False, admission=None,
                devices=0, ladder=slice(3, 5), budget_fn=None):
    variants = m["prof"].make_ladder()[ladder]
    lat = m["sched"].OmniSenseLatencyModel(m["prof"].paper_profile(),
                                           m["net"].NetworkModel())
    costs = [lat._pre(v) + lat._inf(v) for v in variants]
    loops, backends = [], []
    for s in range(n_streams):
        video = m["syn"].make_video(n_frames=frames + 8,
                                    n_objects=30 + 5 * (s % 4),
                                    seed=seed0 + s)
        backend = m["sched"].OracleBackend(video)
        backends.append(backend)
        b = budget_fn(s) if budget_fn is not None else budget
        loops.append(m["omni"].OmniSenseLoop(variants, lat, backend,
                                             budget_s=b,
                                             explore_costs=costs))
    placement = None
    if devices:
        placement = m["place"].VariantPlacement.virtual(
            variants, devices, cost_fn=lat._inf)
    sink = m["tel"].MemorySink()
    server = m["server"].PodServer(
        loops, backends, max_batch=8, placement=placement,
        policy=m["rt"].make_policy(policy, pod_allocate=pod_allocate,
                                   admission=admission),
        telemetry=sink)
    return server, sink


def _closed(m, frames=6, **kw):
    server, sink = _oracle_pod(m, frames=frames, **kw)
    stats = server.run(range(frames))
    return server, sink.events, stats


def _open(m, fps=0.8, **kw):
    server, sink = _oracle_pod(m, **kw)
    traffic = m["traffic"].ArrivalProcess(
        3, fps=fps, jitter=0.2, seed=5, horizon_s=10.0,
        churn=[m["traffic"].ChurnEvent(4.0, 1, False),
               m["traffic"].ChurnEvent(7.0, 1, True)])
    stats = server.run_open_loop(traffic, slo_s=2.0)
    return server, sink.events, stats


POD_CASES = {
    "sync": (_closed, dict()),
    "deadline": (_closed, dict(policy="deadline",
                               budget_fn=lambda s: 1.2 + 0.4 * s)),
    "async": (_closed, dict(policy="async", budget=3.0, devices=4)),
    "async-pod-allocate": (_closed, dict(policy="async", pod_allocate=True,
                                         budget=3.0, devices=4,
                                         ladder=slice(0, 5))),
    "sync-pod-allocate": (_closed, dict(pod_allocate=True,
                                        ladder=slice(1, 4))),
    "virtual-placement": (_closed, dict(devices=6, ladder=slice(0, 5),
                                        n_streams=4)),
    "open-loop-slo": (_open, dict(admission="slo", devices=4)),
    "open-loop-slo-async": (_open, dict(policy="async", admission="slo",
                                        fps=1.5)),
}


@pytest.mark.parametrize("case", sorted(POD_CASES))
def test_oracle_pod_matches_reference(case):
    run, kw = POD_CASES[case]
    j_srv, j_events, j_stats = run(J, **kw)
    t_srv, t_events, t_stats = run(T, **kw)
    assert len(t_events) == len(j_events)
    for t, j in zip(t_events, j_events):
        assert t == j
    assert fingerprint(t_stats) == fingerprint(j_stats)
    assert t_stats.frames > 0 and t_stats.dispatches > 0
    assert len(t_srv.timelines) == len(j_srv.timelines)
    # per-frame detections, digest for digest
    assert [e["det_digest"] for e in t_events
            if e["event"] == "frame_finish"] == \
        [e["det_digest"] for e in j_events if e["event"] == "frame_finish"]


def test_pod_cases_reach_their_paths():
    """The parity cases are not vacuous: async carries, pod allocation
    runs rounds, placement rebalances, the open loop sheds load."""
    _, _, s = _closed(T, **POD_CASES["async"][1])
    assert s.carried_requests > 0
    _, _, s = _closed(T, **POD_CASES["async-pod-allocate"][1])
    assert s.pod_ticks > 0 and s.pod_rounds > 0
    srv, _, s = _closed(T, **POD_CASES["virtual-placement"][1])
    assert len(s.group_busy_s) > 1
    _, events, s = _open(T, **POD_CASES["open-loop-slo"][1])
    assert s.arrivals == s.admitted + s.rejected + s.missed
    assert s.degraded + s.rejected > 0
    assert {"admission", "arrival", "frame_finish"} <= {e["event"]
                                                        for e in events}


def test_report_lines_match_reference():
    j_srv, j_events, j_stats = _open(J, **POD_CASES["open-loop-slo"][1])
    t_srv, t_events, t_stats = _open(T, **POD_CASES["open-loop-slo"][1])
    assert t_server.format_open_loop_report(t_stats, 10.0) == \
        j_server.format_open_loop_report(j_stats, 10.0)
    assert t_server.format_group_report(t_stats, t_srv.placement) == \
        j_server.format_group_report(j_stats, j_srv.placement)
    assert t_server.format_pod_allocation_report(t_stats) == \
        j_server.format_pod_allocation_report(j_stats)
    assert t_tel.format_timeline_report(t_events) == \
        j_tel.format_timeline_report(j_events)


# -- unit parity ----------------------------------------------------------------


def _problems(m, seed, n_streams, n_variants, r):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_streams):
        acc = rng.uniform(0, 1, (1 + n_variants, r))
        acc[0] = 0.0
        d_pre = rng.uniform(0.01, 0.2, (1 + n_variants, r))
        d_pre[0] = 0.0
        d_inf = rng.uniform(0.02, 0.6, (1 + n_variants, r))
        d_inf[0] = 0.0
        out.append(m["pa"].StreamProblem(acc, d_pre, d_inf,
                                         float(rng.uniform(0.2, 2.5))))
    return out


def _plan_key(p):
    return None if p is None else (p.models, p.value, p.t_pre, p.t_done)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_solve_pod_matches_reference(seed):
    out = {}
    for name, m in (("j", J), ("t", T)):
        variants = m["prof"].make_ladder(seed=0)[:3]
        lat = m["sched"].OmniSenseLatencyModel(m["prof"].paper_profile(),
                                               m["net"].NetworkModel())
        placement = m["place"].VariantPlacement.virtual(variants, 2,
                                                        cost_fn=lat._inf)
        sol = m["pa"].solve_pod(
            _problems(m, seed, 4, 3, 3), variants, lat,
            buckets=m["batch"].ShapeBuckets.for_max_batch(4),
            placement=placement if seed % 2 else None,
            group_utilisation={0: 0.5, 1: 0.1} if seed % 3 == 0 else None,
            slo_s=1.0 if seed == 4 else None)
        brute = m["pa"].solve_pod_bruteforce(
            _problems(m, seed, 2, 2, 2), variants[:2], lat,
            tick_cap=sol.tick_cap)
        prices = m["pa"].stream_prices(
            variants, {variants[0].name: 3, variants[1].name: 1}, lat,
            m["batch"].ShapeBuckets())
        out[name] = ([_plan_key(p) for p in sol.plans], sol.rounds,
                     sol.converged, sol.counts, sol.tick_cap,
                     sol.projected_tick, dict(sol.projected_load),
                     [_plan_key(p) for p in brute[0]], brute[1],
                     {k: dataclasses.astuple(v) for k, v in prices.items()})
    assert out["t"] == out["j"]


def _queued(m, variants, lat, seed):
    rng = np.random.default_rng(seed)
    q = m["batch"].VariantQueues(m["batch"].ShapeBuckets.for_max_batch(4))
    video = m["syn"].make_video(n_frames=4, n_objects=20, seed=seed)
    backend = m["sched"].OracleBackend(video)
    for k in range(int(rng.integers(5, 14))):
        v = variants[int(rng.integers(len(variants)))]
        region = m["sroi"].SRoI(center=(float(rng.uniform(-3, 3)),
                                        float(rng.uniform(-1, 1))),
                                fov=(1.0, 1.0))
        q.put(m["batch"].QueuedRequest(
            request=m["omni"].InferenceRequest(region=region, variant=v,
                                               slot=k, special=False),
            owner=k, backend=backend, latency_model=lat,
            deadline=float(rng.uniform(0.5, 2)), emitted_s=0.1 * k,
            frame_idx=int(rng.integers(2))))
    return q


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drain_ops_dispatch_records_match_reference(seed):
    out = {}
    for name, m in (("j", J), ("t", T)):
        variants = m["prof"].make_ladder()[:3]
        lat = m["sched"].OmniSenseLatencyModel(m["prof"].paper_profile(),
                                               m["net"].NetworkModel())
        placement = m["place"].VariantPlacement.virtual(variants, 3)
        q = _queued(m, variants, lat, seed)
        counts = q.counts()
        ops = [(n, min(c, 3)) for n, c in sorted(counts.items())]
        results, records = q.drain_ops(ops, placement)
        rest = q.counts()
        carried = q.newly_carried()
        results2, records2 = q.drain()
        out[name] = (
            counts, rest, carried,
            [(it.request.slot, [(d.category, d.score, tuple(d.box))
                                for d in dets]) for it, dets in results],
            [(r["variant"], r["b"], r["padded"], r["forwards"],
              r["group_sizes"], r["semantic"], r["group"].index,
              [it.request.slot for it in r["items"]]) for r in records],
            [(r["variant"], r["b"], r["padded"]) for r in records2],
            len(results2))
    assert out["t"] == out["j"]
    assert out["t"][2] > 0  # the plan left requests behind


@pytest.mark.parametrize("seed", [0, 3])
def test_arrival_process_matches_reference(seed):
    def arrivals(m):
        proc = m["traffic"].ArrivalProcess(
            4, fps=[0.5, 1.0, 0.7, 2.0], jitter=0.3, seed=seed,
            horizon_s=12.0,
            rate_trace=[(0.0, 1.0), (5.0, 2.5)],
            churn=[m["traffic"].ChurnEvent(3.0, 2, False),
                   m["traffic"].ChurnEvent(6.0, 2, True)])
        got = [dataclasses.astuple(a) for a in proc.arrivals()]
        split = m["traffic"].split_arrivals(proc.arrivals(),
                                            {s: s % 2 for s in range(4)})
        records = [dict(event="arrival", **dataclasses.asdict(a))
                   for a in reversed(proc.arrivals())]
        back = m["traffic"].arrivals_from_records(records)
        return (got, {k: [dataclasses.astuple(a) for a in v]
                      for k, v in split.items()},
                [dataclasses.astuple(a) for a in back] == got)

    t, j = arrivals(T), arrivals(J)
    assert t == j
    assert len(t[0]) > 10 and t[2]


def test_detections_digest_matches_reference():
    rng = np.random.default_rng(9)
    dets = [j_sroi.Detection(box=rng.normal(size=4), category=int(c),
                             score=float(s))
            for c, s in zip(rng.integers(0, 80, 12), rng.uniform(0, 1, 12))]
    t_dets = [t_sroi.Detection(box=d.box, category=d.category, score=d.score)
              for d in dets]
    for k in (0, 1, 12):
        assert t_tel.detections_digest(t_dets[:k]) == \
            j_tel.detections_digest(dets[:k])
    assert t_tel.detections_digest(t_dets[:2]) != \
        t_tel.detections_digest(t_dets[1:3])


# -- the NMS padding on the card's path -----------------------------------------


def _record_suppress(monkeypatch, m):
    """Record the (B, N) of every row stack ``_suppress_tick`` hands
    to ``IncrementalNms.suppress``, with its rows' live lengths."""
    shapes = []
    inner = m["server"].IncrementalNms.suppress

    def suppress(self, keys, boxes, scores, mask=None, **kw):
        shapes.append((tuple(boxes.shape[:2]),
                       tuple(int(k) for k in np.asarray(mask).sum(axis=1))))
        return inner(self, keys, boxes, scores, mask, **kw)

    monkeypatch.setattr(m["server"].IncrementalNms, "suppress", suppress)
    return shapes


def test_suppress_tick_pads_rows_on_the_cuda_path(monkeypatch):
    """With the auto backend answering the card's name (the port's
    ``"cuda"``, the reference's ``"device"``), rows pad to the NMS
    ladder and to one row a stream, as the reference pads them; the
    keep masks, and so the pods' records, stay equal."""
    monkeypatch.setattr(j_server, "nms_auto_backend",
                        lambda b, n: "device")
    monkeypatch.setattr(t_server, "nms_auto_backend", lambda b, n: "cuda")
    j_shapes = _record_suppress(monkeypatch, J)
    t_shapes = _record_suppress(monkeypatch, T)
    kw = dict(n_streams=4, frames=5)
    _, j_events, j_stats = _closed(J, **kw)
    _, t_events, t_stats = _closed(T, **kw)
    assert t_shapes == j_shapes
    ladder = t_batch.DEFAULT_NMS_SIZES
    assert all(b == 4 and n in ladder for (b, n), _ in t_shapes)
    # the padding did something: the unpadded stack (the rows with
    # detections, at the longest row's length) has another shape
    assert any((b, n) != (sum(1 for k in live if k), max(live))
               for (b, n), live in t_shapes)
    assert t_events == j_events
    assert fingerprint(t_stats) == fingerprint(j_stats)


def test_suppress_tick_host_path_is_unpadded(monkeypatch):
    monkeypatch.setattr(t_server, "nms_auto_backend", lambda b, n: "host")
    shapes = _record_suppress(monkeypatch, T)
    _closed(T, n_streams=4, frames=3)
    assert shapes
    for (b, n), live in shapes:
        assert (b, n) == (len(live), max(live)) and min(live) > 0


# -- placement -------------------------------------------------------------------


def test_placement_partitions_match_reference():
    out = {}
    for name, m in (("j", J), ("t", T)):
        variants = m["prof"].make_ladder()
        p = m["place"].VariantPlacement.virtual(variants, 7)
        parts = [[(g.index, g.variants, g.devices) for g in p.groups]]
        p.observe({variants[4].name: 10, variants[0].name: 1})
        changed = p.maybe_rebalance()
        parts.append([(g.index, g.variants, g.devices) for g in p.groups])
        out[name] = (parts, changed, p.rebalances, p.device_counts(),
                     [g.is_virtual for g in p.groups],
                     p.groups[0].shard_batch(5))
    assert out["t"] == out["j"]


def test_group_mesh_names_the_multi_device_slice():
    import torch

    variants = t_prof.make_ladder()[:2]
    virtual = t_place.VariantPlacement.virtual(variants, 2)
    with pytest.raises(TypeError, match="virtual"):
        virtual.groups[0].mesh
    devices = [torch.device("cpu", i) for i in range(4)]
    real = t_place.VariantPlacement(variants, devices=devices)
    assert not real.groups[0].is_virtual
    seen = []
    for g in real.groups:
        mesh = g.mesh
        assert mesh.axis_names == ("data",)
        assert mesh.shape == (g.n_devices,) and mesh.devices == g.devices
        seen += list(mesh.devices)
    assert sorted(seen, key=lambda d: d.index) == devices


# -- the serve launcher ----------------------------------------------------------


@pytest.mark.parametrize("args", [
    [], ["--policy", "async", "--pod-allocate", "--devices", "4"],
    ["--policy", "deadline", "--devices", "3"],
    ["--open-loop", "--admission", "slo", "--devices", "4", "--fps", "1.0"]],
    ids=["sync", "async-pod-allocate", "deadline-devices", "open-loop"])
def test_serve_launcher_matches_reference(args, tmp_path, capsys,
                                          monkeypatch):
    import sys

    from repro.launch import serve as j_serve
    from repro_torch.launch import serve as t_serve

    argv = ["--streams", "4", "--frames", "5"] + args

    def run(main, name, pass_argv):
        path = tmp_path / f"{name}.jsonl"
        full = argv + ["--events", str(path)]
        monkeypatch.setattr(sys, "argv", ["serve"] + full)
        capsys.readouterr()
        main(full) if pass_argv else main()
        lines = [line for line in capsys.readouterr().out.splitlines()
                 if "control-plane overhead" not in line
                 and not line.startswith("telemetry event log")]
        return lines, t_tel.read_events(path)

    j_lines, j_events = run(j_serve.main, "j", False)
    t_lines, t_events = run(t_serve.main, "t", True)
    assert t_lines == j_lines
    assert t_events == j_events
    assert t_lines[0].startswith("served ")
    assert any(e["event"] == "frame_finish" for e in t_events)


@pytest.mark.parametrize("args", [
    ["--open-loop", "--pods", "2"],
    ["--tasks", "action"],
    ["--tasks", "mixed"],
    ["--open-loop", "--pods", "2", "--tasks", "mixed", "--routing",
     "affinity", "--devices", "8", "--admission", "slo"],
    ["--tasks", "mixed", "--policy", "async", "--pod-allocate", "--devices",
     "4"]],
    ids=["pods", "tasks-action", "tasks-mixed", "pods-mixed-affinity",
         "mixed-async-pod-allocate"])
def test_serve_launcher_fleet_and_tasks_match_reference(args, tmp_path,
                                                        capsys, monkeypatch):
    """``--pods`` (the fleet tier) and ``--tasks action|mixed`` (the task
    registry) print the reference launcher's lines and write its event
    records on the same seed."""
    import sys

    from repro.launch import serve as j_serve
    from repro_torch.launch import serve as t_serve

    argv = ["--streams", "4", "--frames", "6"] + args

    def run(main, name, pass_argv):
        path = tmp_path / f"{name}.jsonl"
        full = argv + ["--events", str(path)]
        monkeypatch.setattr(sys, "argv", ["serve"] + full)
        capsys.readouterr()
        main(full) if pass_argv else main()
        lines = [line for line in capsys.readouterr().out.splitlines()
                 if "control-plane overhead" not in line
                 and not line.startswith("telemetry event log")]
        return lines, t_tel.read_events(path)

    j_lines, j_events = run(j_serve.main, "j", False)
    t_lines, t_events = run(t_serve.main, "t", True)
    assert t_lines == j_lines
    assert t_events == j_events
    if "--pods" in args:
        assert t_lines[0].startswith("fleet [")
        assert any(e["event"] == "route" for e in t_events)
    else:
        assert t_lines[0].startswith("served ")
    if "mixed" in args:
        assert any(line.startswith("per-task") for line in t_lines) \
            or "--pods" in args
        assert {e.get("task") for e in t_events if e["event"] == "emit"} \
            == {"detection", "action_recognition"}
