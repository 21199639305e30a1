"""Where an epoch of training spends its time on the card.

    python -m rankaae_tpu_torch.tools.profile_epoch [--config FILE]
        [--ae-form {FC,normal,compact}] [--cnn-discriminator] [--trials T]
        [--protocol {faithful,fused,joint}] [--flat-optim]
        [--activation-dtype {float32,bfloat16}] [--warmup 2] [--out FILE]

Trains ``--config`` (default ``example/fix_config.yaml``; ``--ae-form``,
``--cnn-discriminator``, ``--protocol``, ``--flat-optim`` and
``--activation-dtype`` override its form, discriminator, per-batch
protocol, optimizer layout and activation dtype) at full width
on the 7,000-row synthetic dataset of ``example/make_data.py``, ``--trials``
stacked trials at once (default 1; every form stacks them), runs
``--warmup`` epochs (their seconds are reported, each ending in a device
sync), then profiles one epoch with
``torch.profiler`` (CUDA activity only: recording and parsing every host
op of a 100,000-launch epoch took the profiler about a minute on the
machine of an NVIDIA H100 80GB HBM3 at 700 W) and prints
one JSON object: the epoch's wall time, the summed device time of its
kernels, the device's busy time (the union of the kernels' intervals:
cuDNN runs some kernels on streams of its own, so the sum can exceed the
wall time), the idle share (1 - busy / wall), kernel launches, and the
kernels with the most device time, the port's own kernels (Kendall, and
the fused block in the validation decodes of the conv forms) among them,
and the program's spans of the epoch totalled per name (``span_totals``:
count, host, self and device-stream ms; ``utils/tracing.py``).  Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time
from collections import defaultdict
from typing import Optional

import torch

from rankaae_tpu_torch.data.dataset import load_split_arrays
from rankaae_tpu_torch.data.synthetic import make_synthetic_xanes_csv
from rankaae_tpu_torch.train.trainer import RankAAETrainer, TrialData
from rankaae_tpu_torch.utils import tracing
from rankaae_tpu_torch.utils.config import Parameters, TrainConfig

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def profile_epoch(config: str = os.path.join(REPO, "example", "fix_config.yaml"),
                  ae_form: Optional[str] = None, cnn_discriminator: bool = False,
                  warmup: int = 2, top: int = 15, trials: int = 1,
                  protocol: Optional[str] = None, flat_optim: bool = False,
                  activation_dtype: Optional[str] = None, splits=None) -> dict:
    """The profile of one epoch (see the module docstring).  ``splits``
    (train spectra, train descriptors, val spectra, val descriptors; numpy)
    replaces the synthetic dataset this function otherwise writes and
    loads."""
    if not torch.cuda.is_available():
        raise RuntimeError("profile_epoch needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    params = Parameters.from_yaml(config)
    if ae_form is not None:
        params.update({"ae_form": ae_form})
    if cnn_discriminator:
        params.update({"use_cnn_discriminator": True})
    if protocol is not None:
        params.update({"protocol": protocol})
    if flat_optim:
        params.update({"flat_optim": True})
    if activation_dtype is not None:
        params.update({"activation_dtype": activation_dtype})
    cfg = TrainConfig.from_parameters(params)
    if splits is None:
        with tempfile.TemporaryDirectory(prefix="profile_epoch_") as tmp:
            csv = make_synthetic_xanes_csv(os.path.join(tmp, "data.csv"), n_rows=7000, seed=0)
            sp = load_split_arrays(csv, (cfg.train_ratio, cfg.validation_ratio,
                                         cfg.test_ratio), cfg.n_aux)
        splits = (sp["train"].spec, sp["train"].aux, sp["val"].spec, sp["val"].aux)
    data = TrialData(*(torch.from_numpy(a).to("cuda") for a in splits))
    core = RankAAETrainer(cfg, n_train=len(splits[0]), n_val=len(splits[2]),
                          trials=trials, device="cuda")
    state = core.init_state(0)
    warmup_seconds = []
    for epoch in range(warmup):
        t0 = time.perf_counter()
        state, _ = core.epoch_step(state, epoch, data)
        torch.cuda.synchronize()
        warmup_seconds.append(time.perf_counter() - t0)

    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = core.epoch_step(state, warmup, data)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    span_totals = tracing.totals(tracing.newest(tracing.spans(), "epoch"))

    return {"card": card, "ae_form": core.cfg.ae_form,
            "use_cnn_discriminator": core.cfg.use_cnn_discriminator,
            "protocol": core.cfg.protocol, "flat_optim": core.cfg.flat_optim,
            "activation_dtype": core.cfg.activation_dtype, "trials": trials,
            "epoch": warmup, "n_train": core.n_train, "batches": core.n_batch,
            "warmup_seconds": warmup_seconds,
            **kernel_summary(prof, wall_ms, ("pair_sums", "grad_rows", "fused_block"), top),
            "span_totals": span_totals}


def kernel_summary(prof, wall_ms: float, ours: tuple, top: int = 15) -> dict:
    """Device time (summed, and busy: the union of the kernels' intervals),
    idle share and launches of a profiled window, the kernels whose names
    contain one of ``ours``, and the ``top`` kernels by device time."""
    per_kernel = defaultdict(lambda: [0, 0.0])
    spans = []
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[evt.name][0] += 1
            per_kernel[evt.name][1] += (evt.time_range.end - evt.time_range.start) / 1e3
            spans.append((evt.time_range.start, evt.time_range.end))
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    device_ms = sum(ms for _, ms in per_kernel.values())
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])
    mine = {n: v for n, v in per_kernel.items() if any(o in n for o in ours)}
    return {
        "wall_ms": wall_ms,
        "device_kernel_ms": device_ms,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms if wall_ms else None,
        "kernel_launches": sum(n for n, _ in per_kernel.values()),
        "our_kernels": {n: {"launches": c, "ms": ms} for n, (c, ms) in mine.items()},
        "top_kernels": [{"name": n[:120], "launches": c, "ms": ms}
                        for n, (c, ms) in ranked[:top]],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=os.path.join(REPO, "example", "fix_config.yaml"))
    ap.add_argument("--ae-form", default=None, choices=("FC", "normal", "compact"),
                    help="override the config's ae_form")
    ap.add_argument("--cnn-discriminator", action="store_true",
                    help="train with DiscriminatorCNN")
    ap.add_argument("--trials", type=int, default=1, help="stacked trials")
    ap.add_argument("--protocol", default=None, choices=("faithful", "fused", "joint"),
                    help="override the config's per-batch protocol")
    ap.add_argument("--flat-optim", action="store_true",
                    help="the optimizers over one flat parameter buffer")
    ap.add_argument("--activation-dtype", default=None, choices=("float32", "bfloat16"),
                    help="override the config's activation dtype")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    result = profile_epoch(args.config, args.ae_form, args.cnn_discriminator, args.warmup,
                           trials=args.trials, protocol=args.protocol,
                           flat_optim=args.flat_optim, activation_dtype=args.activation_dtype)
    line = json.dumps(result)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
