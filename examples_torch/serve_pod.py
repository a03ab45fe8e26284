"""End-to-end serving driver (the PyTorch port's twin of
``examples/serve_pod.py``): many camera streams, batched + sharded.

The paper's kind is SERVING, so the end-to-end driver multiplexes 8
synthetic 360-degree streams through the pod scheduler: every stream
runs its own OmniSense loop, PI requests that picked the same detector
variant are batched per tick, and the variants are placed onto
per-variant REPLICA GROUPS (the deployment EXPERIMENTS.md §Perf Cell C
assumes: 16-chip replica groups per variant) so the V batched forwards
run concurrently — the tick pays the max over groups, not the sum.
The per-stream knapsacks are also COUPLED: the pod-level
allocator (``repro.serving.pod_allocation``) re-prices each stream's
variant costs against the co-streams' batched demand and the replica
groups' utilisation, iterating to a fixed point each tick.  The
tick itself is scheduled by a pluggable drain policy on the
event-clock runtime (``repro.serving.runtime``):

    PYTHONPATH=src python examples_torch/serve_pod.py --policy sync
    PYTHONPATH=src python examples_torch/serve_pod.py --policy deadline
    PYTHONPATH=src python examples_torch/serve_pod.py --policy async

The pod can also be fed OPEN-LOOP, arrival-clocked traffic
(``repro.serving.traffic``): each stream's camera ticks at its own
seeded-jittered fps, the event clock advances to each arrival instead
of a global frame barrier, a frame whose predecessor still occupies
the depth-1 camera buffer is counted missed, and every arrival passes
the policy's admission hook against the SLO envelope:

    PYTHONPATH=src python examples_torch/serve_pod.py --open-loop \
        --fps 0.5 --jitter 0.2 --slo 2.0 --admission slo

The oracle pod prices the device-aware tick model on virtual device
slots, so this runs anywhere without touching an accelerator, and
prints the same lines as the reference's driver (but for the
control-plane overhead, a wall-clock time).  The real detector's pod
tick on the card is driven by ``chip_smoke.py``.
"""

import argparse

import numpy as np

from repro_torch.core.omnisense import OmniSenseLoop
from repro_torch.data.synthetic import make_video
from repro_torch.serving import profiles
from repro_torch.serving.network import NetworkModel
from repro_torch.serving.placement import VariantPlacement
from repro_torch.serving.runtime import make_policy
from repro_torch.serving.scheduler import OmniSenseLatencyModel, OracleBackend
from repro_torch.serving.server import (PodServer, format_group_report,
                                  format_open_loop_report,
                                  format_pod_allocation_report)
from repro_torch.serving.traffic import ArrivalProcess


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--devices", type=int, default=16)
    ap.add_argument("--policy", choices=("sync", "deadline", "async"),
                    default="sync",
                    help="drain policy of the event-clock serving runtime")
    ap.add_argument("--open-loop", action="store_true",
                    help="feed arrival-clocked open-loop traffic instead of "
                         "the closed-loop frame barrier (per-stream fps "
                         "clocks, admission control, SLO accounting)")
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
    args = ap.parse_args()

    variants = profiles.make_ladder()
    lat = OmniSenseLatencyModel(profiles.paper_profile(), NetworkModel())
    costs = [lat._pre(v) + lat._inf(v) for v in variants]

    loops, backends = [], []
    for s in range(args.streams):
        video = make_video(n_frames=args.frames + 8, n_objects=30 + 5 * s,
                           seed=100 + s)
        backend = OracleBackend(video)
        backends.append(backend)
        loops.append(OmniSenseLoop(variants, lat, backend, budget_s=1.8,
                                   explore_costs=costs))

    placement = VariantPlacement.virtual(variants, args.devices,
                                         cost_fn=lat._inf)
    # pod_allocate on the policy: the per-stream knapsacks are coupled
    # each tick by the fixed-point pod-level allocator (amortized
    # batched costs + per-group queue depth/utilisation), so streams
    # prefer variants whose replica groups are idle instead of
    # planning solo.  The fixed point is tick-batch-synchronous, so
    # the arrival-driven open loop runs the per-stream allocator with
    # the admission hook instead.
    policy = make_policy(args.policy, pod_allocate=not args.open_loop,
                         admission=args.admission if args.open_loop
                         else None)
    server = PodServer(loops, backends, max_batch=8, placement=placement,
                       policy=policy)
    if args.open_loop:
        horizon_s = args.frames / args.fps
        traffic = ArrivalProcess(args.streams, fps=args.fps,
                                 jitter=args.jitter, seed=0,
                                 horizon_s=horizon_s)
        stats = server.run_open_loop(traffic, slo_s=args.slo)
    else:
        stats = server.run(range(args.frames))

    print(f"streams: {args.streams}, frames/stream: {args.frames}, "
          f"policy: {stats.policy}")
    print(f"total frames served: {stats.frames}")
    print(f"total detections:    {stats.total_detections}")
    print(f"mean per-frame plan latency: {stats.mean_e2e:.2f}s "
          f"(budget 1.8s)")
    print(f"mean control-plane overhead: "
          f"{1e3 * stats.sum_overhead / stats.frames:.2f} ms/frame")
    if stats.batch_sizes:
        hist = np.bincount(stats.batch_sizes)
        print(f"variant batch sizes: mean={stats.mean_batch:.2f} "
              f"hist={dict(enumerate(hist.tolist()))}")
    print(f"batched dispatches: {stats.dispatches} "
          f"(inference {stats.sum_batched_inf_s:.1f}s batched vs "
          f"{stats.sum_per_request_inf_s:.1f}s per-request -> "
          f"{stats.batching_gain:.2f}x)")
    pct = stats.event_e2e_percentiles()
    print(f"event clock: mean tick {stats.mean_tick:.3f}s, E2E "
          f"p50/p95/p99 = {pct[50]:.2f}/{pct[95]:.2f}/{pct[99]:.2f}s, "
          f"{stats.carried_requests} carried requests "
          f"({stats.carry_tick_slots} request-ticks)")
    for line in format_group_report(stats, placement):
        print(line)
    if args.open_loop:
        for line in format_open_loop_report(stats, horizon_s):
            print(line)
    else:
        print(format_pod_allocation_report(stats))
    print("\npod serving loop OK")


if __name__ == "__main__":
    main()
