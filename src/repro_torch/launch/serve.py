"""Serving driver: ``python -m repro_torch.launch.serve [...]`` (the
port of ``repro.launch.serve``).

Multiplexes N synthetic 360-degree streams through the OmniSense pod
scheduler (the paper's pipeline as the pod's control plane) and prints
per-tick throughput / batching stats on the calibrated oracle backend
(the real detector's pod tick runs on the card in ``chip_smoke.py``).

``--policy {sync,deadline,async}`` picks the drain policy of the
event-clock serving runtime (``repro.serving.runtime``):

  * ``sync``     — the tick barrier (default; pre-runtime behaviour,
    bit-identical);
  * ``deadline`` — earliest-deadline / weighted-shortest-first
    cross-variant dispatch ordering over the streams' budgets;
  * ``async``    — residual sub-bucket chunks carry to the next tick
    while their replica group is busy, priced by the overlap model:

    PYTHONPATH=src python -m repro.launch.serve --streams 8 --devices 8 \
        --policy async

``--devices D`` partitions D VIRTUAL device slots into per-variant
replica groups (``repro.serving.placement``): the V per-variant
forwards are scheduled concurrently and the tick model switches to the
device-aware max-over-groups — priced by the calibrated latency model,
no accelerators consulted:

    PYTHONPATH=src python -m repro.launch.serve --streams 8 --devices 8

``--pod-allocate`` switches admission to the pod-level allocator
(``repro.serving.pod_allocation``): each tick the per-stream knapsacks
are coupled through amortized batched costs and per-group queue
depth/utilisation by a fixed-point loop.  Since the runtime refactor
this is a property of the POLICY (``SchedulePolicy(pod_allocate=True)``;
the transitional bare-flag DeprecationWarning was removed on schedule):

    PYTHONPATH=src python -m repro.launch.serve --streams 8 --devices 8 \
        --policy sync --pod-allocate

``--open-loop`` feeds the pod arrival-clocked OPEN-LOOP traffic
(``repro.serving.traffic``) instead of the closed-loop frame barrier:
each stream's camera ticks at ``--fps`` with seeded lognormal
``--jitter``, a frame whose predecessor still occupies the depth-1
camera buffer is counted missed (never fabricated), and every arrival
passes the policy's admission hook against the ``--slo`` envelope —
``--admission slo`` degrades or rejects when the projected queueing
load would blow it:

    PYTHONPATH=src python -m repro.launch.serve --streams 8 \
        --open-loop --fps 0.5 --jitter 0.2 --slo 2.0 --admission slo

``--pods P`` serves the open-loop traffic through the FLEET tier
(``repro.serving.fleet``): P pods behind a ``--routing`` stream router
(sticky ``least-loaded`` balance, or ``affinity`` consistent hashing
so co-variant streams co-locate and batch), with ``--devices`` split
per pod by ``serving_scale_plan``:

    PYTHONPATH=src python -m repro.launch.serve --streams 32 \
        --open-loop --fps 0.5 --slo 2.0 --admission slo \
        --devices 8 --pods 4 --routing affinity

Every option runs as in the reference, on the oracle backends:
``--events``, ``--open-loop``, ``--pod-allocate``, ``--devices`` on
virtual slots, the three policies, ``--pods`` (a ``FleetServer`` whose
pods split ``--devices`` by ``serving_scale_plan``) and ``--tasks
action|mixed`` (streams built through the task registry).  ``main``
takes ``argv`` (default ``sys.argv[1:]``), so a script can drive it
in-process.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.omnisense import OmniSenseLoop
from repro_torch.data.synthetic import make_video
from repro_torch.serving import profiles
from repro_torch.serving.network import NetworkModel
from repro_torch.serving.runtime import make_policy
from repro_torch.serving.scheduler import OmniSenseLatencyModel, OracleBackend
from repro_torch.serving.server import PodServer


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--budget", type=float, default=1.8)
    ap.add_argument("--bandwidth-mbps", type=float, default=17.9)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--devices", type=int, default=0,
                    help="partition this many device slots into per-variant "
                         "replica groups (0 = single-device pod)")
    ap.add_argument("--policy", choices=("sync", "deadline", "async"),
                    default=None,
                    help="drain policy of the serving runtime "
                         "(repro.serving.runtime; default sync — the "
                         "pre-runtime tick barrier, bit-identical)")
    ap.add_argument("--pod-allocate", action="store_true",
                    help="couple the per-stream knapsacks through batched "
                         "costs and group utilisation (the fixed-point "
                         "pod-level allocator; an admission property of "
                         "the --policy object since the runtime refactor)")
    ap.add_argument("--open-loop", action="store_true",
                    help="feed arrival-clocked open-loop traffic "
                         "(repro.serving.traffic) instead of the "
                         "closed-loop frame barrier: per-stream fps "
                         "clocks, depth-1 camera buffer, admission "
                         "control, SLO goodput accounting")
    ap.add_argument("--fps", type=float, default=0.5,
                    help="per-stream arrival rate for --open-loop")
    ap.add_argument("--jitter", type=float, default=0.2,
                    help="lognormal sigma on open-loop inter-arrival times")
    ap.add_argument("--slo", type=float, default=2.0,
                    help="end-to-end SLO for open-loop goodput accounting")
    ap.add_argument("--admission", choices=("admit-all", "slo"),
                    default="admit-all",
                    help="open-loop admission policy: admit everything, or "
                         "degrade/reject when projected load exceeds the "
                         "SLO envelope")
    ap.add_argument("--events", default=None, metavar="PATH",
                    help="write the structured JSONL telemetry event log "
                         "here (repro.serving.telemetry; inspect with "
                         "python -m repro.launch.replay report PATH)")
    ap.add_argument("--pods", type=int, default=0,
                    help="serve through a FleetServer of this many pods "
                         "(repro.serving.fleet; requires --open-loop; "
                         "--devices is the FLEET-wide budget split per "
                         "pod; 0 = the single-pod server)")
    ap.add_argument("--routing", choices=("least-loaded", "affinity"),
                    default="least-loaded",
                    help="fleet stream-routing policy (with --pods): "
                         "sticky least-loaded balance, or consistent "
                         "hashing on content affinity so co-variant "
                         "streams batch together")
    ap.add_argument("--tasks", choices=("detection", "action", "mixed"),
                    default="detection",
                    help="analytics task mix (repro.serving.tasks "
                         "registry): homogeneous detection (default, "
                         "honours --bandwidth-mbps), homogeneous "
                         "action recognition, or an alternating mixed "
                         "pod whose two variant ladders share one "
                         "capacity envelope")
    args = ap.parse_args(argv)
    if args.pods and not args.open_loop:
        ap.error("--pods requires --open-loop (the fleet tier serves "
                 "arrival-clocked traffic)")

    policy = make_policy(args.policy or "sync",
                         pod_allocate=args.pod_allocate,
                         admission=args.admission if args.open_loop
                         else None)

    if args.tasks == "detection":
        variants = profiles.make_ladder()
        lat = OmniSenseLatencyModel(profiles.paper_profile(),
                                    NetworkModel(args.bandwidth_mbps))
        costs = [lat._pre(v) + lat._inf(v) for v in variants]
        cost_fn = lat._inf
        loops, backends = [], []
        for s in range(args.streams):
            video = make_video(n_frames=args.frames + 8,
                               n_objects=30 + 5 * (s % 4), seed=100 + s)
            backend = OracleBackend(video)
            backends.append(backend)
            loops.append(OmniSenseLoop(variants, lat, backend,
                                       budget_s=args.budget,
                                       explore_costs=costs))
    else:
        from repro_torch.serving import tasks as task_registry

        stream_tasks = task_registry.stream_tasks_for(args.tasks,
                                                      args.streams)
        videos = [make_video(n_frames=args.frames + 8,
                             n_objects=30 + 5 * (s % 4), seed=100 + s)
                  for s in range(args.streams)]
        variants, loops, backends, cost_fn = \
            task_registry.build_task_streams(
                stream_tasks, videos, [args.budget] * args.streams)

    placement = None
    if args.devices > 0:
        from repro_torch.serving.placement import VariantPlacement

        placement = VariantPlacement.virtual(variants, args.devices,
                                             cost_fn=cost_fn)

    telemetry = None
    if args.events:
        from repro_torch.serving.telemetry import JsonlSink

        telemetry = JsonlSink(args.events)

    if args.pods > 0:
        from repro_torch.distributed.elastic import serving_scale_plan
        from repro_torch.serving.fleet import (FleetServer,
                                               format_fleet_report)
        from repro_torch.serving.traffic import ArrivalProcess

        per_pod = serving_scale_plan(args.devices,
                                     args.pods)["per_pod_devices"]

        def make_pod(pod_id: int) -> PodServer:
            pod_placement = None
            if per_pod > 0:
                from repro_torch.serving.placement import VariantPlacement

                pod_placement = VariantPlacement.virtual(
                    variants, per_pod, cost_fn=cost_fn)
            pol = make_policy(args.policy or "sync",
                              pod_allocate=args.pod_allocate,
                              admission=args.admission)
            return PodServer(loops, backends, max_batch=args.max_batch,
                             placement=pod_placement, policy=pol)

        fleet = FleetServer(make_pod, args.pods, routing=args.routing,
                            telemetry=telemetry)
        horizon_s = args.frames / args.fps
        traffic = ArrivalProcess(args.streams, fps=args.fps,
                                 jitter=args.jitter, seed=0,
                                 horizon_s=horizon_s)
        fstats = fleet.run_open_loop(traffic, slo_s=args.slo)
        if telemetry is not None:
            telemetry.close()
            print(f"telemetry event log: {args.events}")
        for line in format_fleet_report(fstats, horizon_s):
            print(line)
        return

    server = PodServer(loops, backends, max_batch=args.max_batch,
                       placement=placement, policy=policy,
                       telemetry=telemetry)
    horizon_s = None
    if args.open_loop:
        from repro_torch.serving.traffic import ArrivalProcess

        horizon_s = args.frames / args.fps
        traffic = ArrivalProcess(args.streams, fps=args.fps,
                                 jitter=args.jitter, seed=0,
                                 horizon_s=horizon_s)
        stats = server.run_open_loop(traffic, slo_s=args.slo)
    else:
        stats = server.run(range(args.frames))
    if telemetry is not None:
        telemetry.close()
        print(f"telemetry event log: {args.events}")
    print(f"served {stats.frames} frames across {args.streams} streams "
          f"[{stats.policy} policy]")
    print(f"detections: {stats.total_detections}  "
          f"mean plan latency: {stats.mean_e2e:.2f}s (budget {args.budget}s)")
    if policy.pod_allocate:
        from repro_torch.serving.server import format_pod_allocation_report

        print(format_pod_allocation_report(stats))
    if len(server.tasks) > 1:
        per = ", ".join(
            f"{t}: {stats.frames_by_task.get(t, 0)} frames, "
            f"proxy {p:.3f}"
            for t, p in stats.accuracy_proxy_by_task.items())
        print(f"per-task ({'+'.join(server.tasks)} pod): {per}")
    print(f"control-plane overhead: "
          f"{1e3 * stats.sum_overhead / stats.frames:.2f} ms/frame")
    if stats.batch_sizes:
        print(f"variant batches: mean={stats.mean_batch:.2f} "
              f"p95={int(np.percentile(stats.batch_sizes, 95))}")
    print(f"batched dispatches: {stats.dispatches}  "
          f"inference gain: {stats.batching_gain:.2f}x "
          f"({stats.sum_batched_inf_s:.1f}s batched vs "
          f"{stats.sum_per_request_inf_s:.1f}s per-request)")
    pct = stats.event_e2e_percentiles()
    print(f"event-clock tick: mean={stats.mean_tick:.3f}s  "
          f"E2E p50/p95/p99={pct[50]:.2f}/{pct[95]:.2f}/{pct[99]:.2f}s  "
          f"carried requests: {stats.carried_requests} "
          f"({stats.carry_tick_slots} request-ticks)")
    if placement is not None:
        from repro_torch.serving.server import format_group_report

        for line in format_group_report(stats, placement):
            print(line)
    if horizon_s is not None:
        from repro_torch.serving.server import format_open_loop_report

        for line in format_open_loop_report(stats, horizon_s):
            print(line)


if __name__ == "__main__":
    main()
