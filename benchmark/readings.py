"""The readings that the check's limits are set from, on the card.

    python3 benchmark/readings.py --workload NAME --seeds S1,S2,... \\
        --modes sound,tf32,bf16,unchanged,half,altered [--out FILE]

For each mode and seed: the cell's set-up from the seed and its recorded
first epoch, the program then freed, the reference run, and one JSON line
with each number the check compares, the readings printed beside them, and
where each number is worst.  ``sound`` is the program as the cell runs it;
``tf32`` and ``bf16`` are the controls (the program's own lower-precision
paths); ``unchanged``, ``half`` and ``altered`` plant the faults of
``benchmark/faults.py``.  Every mode runs on every seed given; the
benchmark's own runs do not run this.  ``--device cpu`` with ``--small``
runs it at a CPU test's size.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import check, faults, harness  # noqa: E402


def small(params, traffic):
    """A cell cut to a CPU test's size: 3 trials, 700 rows, B 128."""
    return dict(params, batch_size=128, trials=3), dict(traffic, rows=700, check_trials=2)


def reading(workload, mode, seed, device="cuda", resize=None):
    import torch

    spec = harness.load_spec()
    cell, config, traffic = harness.load_cell(workload, spec)
    model = harness.load_model(config)
    params = harness.program_params(config, traffic)
    if resize is not None:
        params, traffic = resize(params, traffic)
    params.update(faults.CONTROLS.get(mode, {}))
    t0 = time.perf_counter()
    with faults.planted(mode if mode in faults.FAULTS else None):
        c = harness.Cell(params, traffic, seed, device, model)
        record = c.recorded_epoch()
        host = c.host
        c.free()
    if device != "cpu":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    where = {}
    numbers = check.run_reference(params, record, host, 0, device, where, model=model)
    return {"workload": workload, "mode": mode, "seed": seed, "numbers": numbers,
            "where": {k: str(v) for k, v in where.items()},
            "program_s": t1 - t0, "reference_s": time.perf_counter() - t1}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="sound")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()
    out = open(args.out, "a") if args.out else None
    for mode in args.modes.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            try:
                line = reading(args.workload, mode, seed, args.device,
                               small if args.small else None)
            except Exception as e:  # a control or fault that crashes gives no number
                line = {"workload": args.workload, "mode": mode, "seed": seed,
                        "error": f"{type(e).__name__}: {e}"}
            text = json.dumps(line)
            print(text, flush=True)
            if out:
                out.write(text + "\n")
                out.flush()
    if out:
        out.close()


if __name__ == "__main__":
    main()
