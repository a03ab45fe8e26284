"""Replay CLI: ``python -m repro_torch.launch.replay <cmd> [...]``
(port of ``repro.launch.replay``; a log recorded by either package's
CLI checks clean in the other's).

The CLI surface of the deterministic replay harness
(``repro_torch.serving.replay``) over the structured telemetry event log
(``repro_torch.serving.telemetry``):

  * ``record``  — serve the standard seeded oracle corpus with
    telemetry, writing a self-contained JSONL log (leads with the
    rebuildable ``corpus_spec``, ends with the ``run_stats``
    fingerprint)::

        PYTHONPATH=src python -m repro_torch.launch.replay record \\
            --out corpus.jsonl --streams 8 --policy async

        PYTHONPATH=src python -m repro_torch.launch.replay record \\
            --out open.jsonl --streams 8 --open-loop --fps 1.0 \\
            --slo 2.0 --admission slo

  * ``check``   — re-drive a log under its recorded policy and demand
    BIT-IDENTICAL ``ServeStats`` and per-frame detection digests;
    exits 1 with the drift list otherwise (the replay-determinism CI
    lane)::

        PYTHONPATH=src python -m repro_torch.launch.replay check \\
            corpus.jsonl

  * ``diff``    — re-drive a log under a DIFFERENT schedule/admission
    policy and print the apples-to-apples metric table (same seeded
    content, same arrival trace — only the policy moved)::

        PYTHONPATH=src python -m repro_torch.launch.replay diff \\
            corpus.jsonl --policy deadline

  * ``report``  — the offline timeline summary from a log alone
    (``format_timeline_report``): per-group utilisation, queueing-
    delay histogram, admission-verdict breakdown::

        PYTHONPATH=src python -m repro_torch.launch.replay report \\
            open.jsonl
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.serving.replay import (CorpusSpec, format_policy_diff,
                                        record, replay)
from repro_torch.serving.telemetry import (JsonlSink, format_timeline_report,
                                           read_events)


def _add_record(sub) -> None:
    ap = sub.add_parser(
        "record", help="serve the seeded oracle corpus, writing the log")
    ap.add_argument("--out", required=True, metavar="PATH",
                    help="JSONL event-log path to write")
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--frames", type=int, default=8,
                    help="closed-loop tick count (open-loop: video floor)")
    ap.add_argument("--budget", type=float, default=1.8)
    ap.add_argument("--devices", type=int, default=8,
                    help="virtual replica-group device slots "
                         "(0 = single-device pod)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--policy", choices=("sync", "deadline", "async"),
                    default="sync")
    ap.add_argument("--pod-allocate", action="store_true")
    ap.add_argument("--open-loop", action="store_true",
                    help="record arrival-clocked open-loop traffic "
                         "instead of the closed-loop frame barrier")
    ap.add_argument("--fps", type=float, default=0.5)
    ap.add_argument("--jitter", type=float, default=0.2)
    ap.add_argument("--horizon", type=float, default=20.0)
    ap.add_argument("--slo", type=float, default=None)
    ap.add_argument("--admission", choices=("admit-all", "slo"),
                    default=None)
    ap.add_argument("--pods", type=int, default=0,
                    help="fleet size (requires --open-loop; 0 = the "
                         "single-pod server)")
    ap.add_argument("--routing", choices=("least-loaded", "affinity"),
                    default="least-loaded",
                    help="fleet stream-routing policy (with --pods)")
    ap.add_argument("--tasks", choices=("detection", "action", "mixed"),
                    default="detection",
                    help="analytics task mix for the corpus "
                         "(repro_torch.serving.tasks registry; mixed "
                         "alternates detection / action recognition)")


def _cmd_record(args) -> int:
    if args.pods and not args.open_loop:
        print("--pods requires --open-loop (the fleet tier serves "
              "arrival-clocked traffic)", file=sys.stderr)
        return 2
    tasks = ()
    if args.tasks != "detection":
        from repro_torch.serving.tasks import stream_tasks_for

        tasks = tuple(stream_tasks_for(args.tasks, args.streams))
    spec = CorpusSpec(
        mode="open" if args.open_loop else "closed",
        n_streams=args.streams, frames=args.frames, budget_s=args.budget,
        devices=args.devices, max_batch=args.max_batch, policy=args.policy,
        pod_allocate=args.pod_allocate, admission=args.admission,
        slo_s=args.slo, fps=args.fps, jitter=args.jitter,
        horizon_s=args.horizon, pods=args.pods, routing=args.routing,
        tasks=tasks)
    stats = record(spec, JsonlSink(args.out))
    fleet = f", {spec.pods} pods ({spec.routing} routing)" if spec.pods \
        else ""
    print(f"recorded {stats.frames} frames / {stats.dispatches} dispatches "
          f"[{spec.policy} policy, {spec.mode}-loop, {spec.n_streams} "
          f"streams{fleet}] -> {args.out}")
    return 0


def _cmd_check(args) -> int:
    result = replay(args.log)
    for line in format_policy_diff(result):
        print(line)
    return 0 if result.identical else 1


def _cmd_diff(args) -> int:
    from repro_torch.serving.runtime import make_policy

    if args.policy is None and args.admission is None:
        print("diff needs --policy and/or --admission (otherwise use "
              "'check')", file=sys.stderr)
        return 2
    policy = admission = None
    if args.policy is not None:
        policy = make_policy(args.policy, admission=args.admission)
    else:
        admission = args.admission
    result = replay(args.log, policy=policy, admission=admission)
    for line in format_policy_diff(result):
        print(line)
    return 0


def _cmd_report(args) -> int:
    for line in format_timeline_report(read_events(args.log)):
        print(line)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.replay",
        description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    _add_record(sub)
    for name, help_ in (("check", "replay under the recorded policy; "
                                  "exit 1 on any bit-level drift"),
                        ("diff", "replay under a different policy; print "
                                 "the side-by-side metric table"),
                        ("report", "offline timeline summary from the "
                                   "log alone")):
        p = sub.add_parser(name, help=help_)
        p.add_argument("log", help="JSONL event log path")
        if name == "diff":
            p.add_argument("--policy",
                           choices=("sync", "deadline", "async"),
                           default=None)
            p.add_argument("--admission", choices=("admit-all", "slo"),
                           default=None)
    args = ap.parse_args(argv)
    return {"record": _cmd_record, "check": _cmd_check,
            "diff": _cmd_diff, "report": _cmd_report}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
