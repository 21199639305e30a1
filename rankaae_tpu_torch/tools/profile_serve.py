"""Where a device-resident serving round of the conv forms spends its time.

    python -m rankaae_tpu_torch.tools.profile_serve [--out FILE]

For ``ae_form`` normal and compact of ``example/fix_config.yaml`` (full
width, random weights from seed 0), runs ``serve.serve_rounds`` (the rounds
of ``serve.device_benchmark``) on the card at batch 4096: three warm-up
rounds, then 5 rounds under ``torch.profiler`` (CPU + CUDA activities).
Prints one JSON object per form: the window's wall time, the summed device
time of its kernels, the idle share, kernel launches per round, K3's share
and the kernels with the most device time.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from rankaae_tpu_torch.models.inference import InferenceModel
from rankaae_tpu_torch.models.primitives import reset_parameters
from rankaae_tpu_torch.models.registry import build_autoencoder
from rankaae_tpu_torch.serve import serve_rounds
from rankaae_tpu_torch.tools.profile_epoch import REPO, kernel_summary
from rankaae_tpu_torch.utils.config import TrainConfig
from rankaae_tpu_torch.utils.weights import to_jax

BATCH, ROUNDS = 4096, 5


def profile_serve(form: str) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_serve needs a CUDA device")
    cfg = TrainConfig.from_yaml(os.path.join(REPO, "example", "fix_config.yaml")).replace(
        ae_form=form)
    encoder, decoder = build_autoencoder(cfg)
    gen = torch.Generator().manual_seed(0)
    for m in (encoder, decoder):
        reset_parameters(m, gen)
    model = InferenceModel(*to_jax({"enc": encoder, "dec": decoder}), cfg)
    x0 = torch.randn((BATCH, cfg.dim_in), generator=torch.Generator(device="cuda")
                     .manual_seed(0), device="cuda")
    serve_rounds(model, x0, 3)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        serve_rounds(model, x0, ROUNDS)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    summary = kernel_summary(prof, wall_ms, ("fused_block",))
    return {"ae_form": form, "batch": BATCH, "rounds": ROUNDS,
            "launches_per_round": summary["kernel_launches"] / ROUNDS, **summary}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    lines = [json.dumps({"card": card, **profile_serve(form)})
             for form in ("normal", "compact")]
    print("\n".join(lines))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
