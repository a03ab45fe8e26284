"""Run one benchmark cell of the PyTorch/CUDA port on the card.

    python3 omnibench/run.py --workload detect-p6-closed --seed 123 \\
        --seconds 30 --trace 0

From the root of a checkout.  Prints progress on standard error, then
each number the correctness check compared beside its limit as the last
lines there, and one JSON object as the last line of standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
and, with ``--trace 1``, ``breakdown``; ``compared`` comes last.

Exits with a code other than 0, and prints no result, where no CUDA
device is present or fewer than the cell asks for, or where the run
loaded JAX or the JAX package.  The kernels' shared libraries build into
``build/repro_torch_kernels`` and every other compiler cache into
``build/omnibench`` of the checkout, so only a checkout's first run
builds them.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the script's own folder holds modules whose names are the standard
# library's (trace): import the package from the checkout's root instead
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != ROOT / "omnibench"]
CACHE = ROOT / "build" / "omnibench"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from omnibench import harness

    bench = harness.Bench(ROOT)
    chips = int(bench.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"omnibench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " present", file=sys.stderr)
        return 2
    try:
        result, rows = harness.run_cell(ROOT, args.workload, args.seed,
                                        args.seconds, bool(args.trace),
                                        t_start=T_START)
    except harness.ForbiddenModules as e:
        print(f"omnibench: {e}", file=sys.stderr)
        return 3
    for name, value, limit in rows:
        print(f"compared {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
