"""Readings that set the correctness limits of a cell: the program's
numbers on many seeds, and the control's on some of them, in one process.

    python3 omnibench/control.py --workload detect-p6-closed \\
        --seeds 1,2,3,4,5,6,7,8,9,10,11,12 --control-seeds 1,2,3 --ticks 8

Each seed runs the cell's set-up and a closed window of ``--ticks``
ticks, then the check on the sampled ticks; a seed listed in
``--scene-seeds`` draws its weights and videos from itself, in the
place of the traffic's ``scene_key``.  For a control seed the same
frames are judged once more with the control in the program's place: the
reference one step below the configuration's float32 with TF32 off (the
crop in bfloat16, the detector's convolutions in TF32).  One JSON line a seed
on standard output (and in ``chiprun_out/control_<workload>.jsonl``).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
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
    ap.add_argument("--scene-seeds", default="",
                    help="seeds whose run draws its weights and videos from "
                         "the seed itself, not from the traffic's scene_key")
    args = ap.parse_args()

    import torch

    from omnibench import harness
    from omnibench.check_detect import control_reference

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    own_scene = {int(s) for s in args.scene_seeds.split(",") if s}
    out = ROOT / "chiprun_out" / f"control_{args.workload}.jsonl"
    out.parent.mkdir(exist_ok=True)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        result, rows = harness.run_cell(
            ROOT, args.workload, seed, 1e9, False, max_ticks=args.ticks,
            controls={"control": control_reference} if seed in ctrl else None,
            scene_key=seed if seed in own_scene else None)
        line = dict(seed=seed, own_scene=seed in own_scene,
                    correct=result["correct"],
                    program={k: v for k, v, _ in rows},
                    controls=result.get("controls", {}),
                    metrics=result["metrics"],
                    seconds=time.perf_counter() - t)
        print(json.dumps(line), flush=True)
        with out.open("a") as f:
            f.write(json.dumps(line) + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
