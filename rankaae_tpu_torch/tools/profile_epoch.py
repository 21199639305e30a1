"""Where an epoch of the faithful main path spends its time on the card.

    python -m rankaae_tpu_torch.tools.profile_epoch [--warmup 2] [--out FILE]

Trains ``example/fix_config.yaml`` at full width on the 7,000-row synthetic
dataset of ``example/make_data.py``, runs ``--warmup`` epochs, then profiles
one epoch with ``torch.profiler`` (CPU + CUDA activities) and prints one JSON
object: the epoch's wall time, the summed device time of its kernels (one
stream, so the sum is the device's busy time), the idle share, kernel
launches, and the kernels with the most device time, the Kendall kernels
among them.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time
from collections import defaultdict

import torch

from rankaae_tpu_torch.data.synthetic import make_synthetic_xanes_csv
from rankaae_tpu_torch.train.facade import Trainer
from rankaae_tpu_torch.utils.config import Parameters

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def profile_epoch(warmup: int = 2, top: int = 15) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_epoch needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    with tempfile.TemporaryDirectory(prefix="profile_epoch_") as tmp:
        csv = make_synthetic_xanes_csv(os.path.join(tmp, "data.csv"), n_rows=7000, seed=0)
        params = Parameters.from_yaml(os.path.join(REPO, "example", "fix_config.yaml"))
        trainer = Trainer.from_data(csv, config_parameters=params, device="cuda",
                                    work_dir=tmp, verbose=False)
    core, data = trainer.core, trainer.data
    state = core.init_state(0)
    for epoch in range(warmup):
        state, _ = core.epoch_step(state, epoch, data)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, _ = core.epoch_step(state, warmup, data)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    per_kernel = defaultdict(lambda: [0, 0.0])
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[evt.name][0] += 1
            per_kernel[evt.name][1] += (evt.time_range.end - evt.time_range.start) / 1e3
    device_ms = sum(ms for _, ms in per_kernel.values())
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])
    kendall = {n: v for n, v in per_kernel.items() if "pair_sums" in n or "grad_rows" in n}
    return {
        "card": card,
        "epoch": warmup,
        "n_train": core.n_train,
        "batches": core.n_batch,
        "wall_ms": wall_ms,
        "device_kernel_ms": device_ms,
        "device_idle_share": 1.0 - device_ms / wall_ms if wall_ms else None,
        "kernel_launches": sum(n for n, _ in per_kernel.values()),
        "kendall_kernels": {n: {"launches": c, "ms": ms} for n, (c, ms) in kendall.items()},
        "top_kernels": [{"name": n[:120], "launches": c, "ms": ms}
                        for n, (c, ms) in ranked[:top]],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    result = profile_epoch(args.warmup)
    line = json.dumps(result)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
