"""The benchmark of ``rankaae_tpu_torch`` on one NVIDIA GPU.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Runs the cell ``NAME`` of ``BENCHMARK.json`` from the root of a checkout:
set-up (data and weights from the seed, the kernels built on first use into
the package's ``_build/``, one recorded warm-up epoch), then whole epochs
for ``S`` seconds, then with ``--trace 1`` one more epoch under the
profiler, then the check against the plain reference.  Prints the check's
numbers and limits as the last lines of standard error and one JSON object
as the last line of standard output: the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics.  Exits 3 without a result where CUDA
or the cell's GPUs are missing, and 4 where a forbidden module (JAX, or the
JAX package) was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    try:
        result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    except harness.NoDevice as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3
    forbidden = harness.loaded_forbidden()
    if forbidden:
        print(f"no result: the run loaded {forbidden}", file=sys.stderr)
        return 4
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
