"""Readings that set the correctness limits of the region-description
cell: the program's numbers on several seeds, and the control's on some
of them, in one process.

    python3 omnibench/control_describe.py --workload describe-kimivl-closed \\
        --seeds 1,2,3 --control-seeds 1 --ticks 8

Each seed runs the cell's set-up and a closed window of ``--ticks``
ticks, then the check on the sampled ticks.  For a control seed the same
requests are judged once more with the control in the program's place:
the reference with every weight matrix of the LM rounded to float8
e4m3 (``omnibench.check_describe.fp8_lm``, one step below the
configuration's bfloat16), and with the routed experts alone so rounded
(``fp8_experts``), each from the program's crops and fed ids and
routing by itself.  One JSON line a seed on standard output (and in
``chiprun_out/control_<workload>.jsonl``).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != ROOT / "omnibench"]
sys.path.insert(0, str(ROOT))
import omnibench.run  # noqa: E402,F401  (the run's environment and paths)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--ticks", type=int, default=8)
    args = ap.parse_args()

    import torch

    from omnibench import harness
    from omnibench.check_describe import fp8_experts, fp8_lm

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    out = ROOT / "chiprun_out" / f"control_{args.workload}.jsonl"
    out.parent.mkdir(exist_ok=True)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        result, rows = harness.run_cell(
            ROOT, args.workload, seed, 1e9, False, max_ticks=args.ticks,
            controls=dict(fp8_lm=fp8_lm, fp8_experts=fp8_experts)
            if seed in ctrl else None)
        line = dict(seed=seed, correct=result["correct"],
                    program={k: v for k, v, _ in rows},
                    controls=result.get("controls", {}),
                    metrics=result["metrics"],
                    memory_peak_bytes=result["device"]["memory_peak_bytes"],
                    seconds=time.perf_counter() - t)
        print(json.dumps(line), flush=True)
        with out.open("a") as f:
            f.write(json.dumps(line) + "\n")
        # a pod's wrappers hold it in reference cycles: free its weights
        # before the next seed makes its own
        del result, rows
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
