"""K3's times on the card, and the host's share of a call.

    python rankaae_tpu_torch/tools/time_fused_block.py [--root DIR] [--sass] [--out FILE]

For (C, B) in (4, 1024), (4, 4096), (2, 1024), (2, 4096), on inputs drawn as
the probe's ``make_inputs`` draws them (seed 7), prints one JSON line per
shape: ``ms`` (CUDA events around 200 back-to-back ``fused_block`` calls,
after 20 warm-up calls), ``device_ms`` (the same 200 calls captured in one
CUDA graph and replayed), ``host_share_ms`` = ms - device_ms, and
``enqueue_ms`` (the host clock over the 200 calls before the synchronise:
what one wrapper call costs the host).  ``--root`` imports
``rankaae_tpu_torch`` from another checkout (say the parent commit unpacked
beside this one), so two versions of K3 compare in one run on one card.
``--sass`` also prints the static instruction mix of each
``fused_block_kernel`` instantiation, from ``cuobjdump -sass`` of the built
library.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SHAPES = ((4, 1024), (4, 4096), (2, 1024), (2, 4096))
REPS, WARMUP = 200, 20
MIX = ("FFMA", "FMUL", "FADD", "FSEL", "FSETP", "LDS", "STS", "SHFL", "LDG", "STG", "BAR")


def inputs(fb, b, c, seed=7):
    """x and the 16 parameters, drawn as the probe's ``make_inputs`` draws
    them (normal * 0.3, variances |.| + 0.5, PReLU slopes 0.01)."""
    rng = np.random.default_rng(seed)

    def f32(*shape):
        return torch.tensor(rng.normal(size=shape).astype(np.float32) * 0.3, device="cuda")

    def slope():
        return torch.full((c,), 0.01, device="cuda")

    x = f32(b, c, fb.L)
    args = (f32(c), f32(c).abs() + 0.5, f32(c, c, fb.K), f32(c), slope(),
            f32(c), f32(c).abs() + 0.5, f32(c, c, fb.K), f32(c), slope(),
            f32(fb.E, fb.L), f32(fb.E), slope(), f32(fb.L, fb.E), f32(fb.L), slope())
    return x, args


def times(fb, c, b) -> dict:
    x, args = inputs(fb, b, c)
    with torch.no_grad():
        for _ in range(WARMUP):
            fb.fused_block(x, *args)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(REPS):
            fb.fused_block(x, *args)
        enqueue_ms = (time.perf_counter() - t0) * 1e3 / REPS
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / REPS

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fb.fused_block(x, *args)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(REPS):
                fb.fused_block(x, *args)
        graph.replay()
        torch.cuda.synchronize()
        start.record()
        for _ in range(5):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        device_ms = start.elapsed_time(end) / (5 * REPS)
    return {"C": c, "B": b, "ms": ms, "device_ms": device_ms, "host_share_ms": ms - device_ms,
            "enqueue_ms": enqueue_ms}


def sass_mix(nvcc_mod, source) -> dict:
    """Static instruction counts per ``fused_block_kernel`` instantiation."""
    cuobjdump = os.path.join(os.path.dirname(nvcc_mod._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(nvcc_mod.library_path(source))],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    mixes, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if "fused_block_kernel" in m.group(1) else None
            if name:
                mixes[name] = Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", line)
        if name and m:
            mixes[name][m.group(1)] += 1
    return {n: {"total": sum(c.values()), **{op: c[op] for op in MIX}} for n, c in mixes.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO, help="the checkout whose rankaae_tpu_torch to time")
    ap.add_argument("--sass", action="store_true", help="also print the SASS instruction mix")
    ap.add_argument("--out", default=None, help="also append the JSON lines here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_fused_block needs a CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from rankaae_tpu_torch.ops import _nvcc
    from rankaae_tpu_torch.ops import fused_block_cuda as fb

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    fb.build()
    lines = [{"root": args.root, "card": card, **times(fb, c, b)} for c, b in SHAPES]
    if args.sass:
        lines.append({"root": args.root, "card": card, "sass": sass_mix(_nvcc, fb.SOURCE)})
    text = "\n".join(json.dumps(line) for line in lines)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
