"""Where K3's device time goes: the kernel timed with parts taken out.

    python -m rankaae_tpu_torch.tools.k3_ablate [--out FILE]

No profiler reads the card's pipes on the machines this port is measured
on, so this tool builds copies of ``csrc/fused_block.cu`` with one part
taken out each (into ``_build/ablate/``) and times every copy at K3's
timed shapes, as ``tools/time_fused_block.py`` times the kernel (CUDA-graph
device time):

- ``full``: the kernel as it is (timed first and last, for the spread);
- ``no_conv``: each conv replaced by its bias plus its input at the same
  position, so the work around the convs still runs per position;
- ``no_x``: x made from the sample and lane indices instead of read;
- ``no_out``: out not written (the store guarded by a test that never
  holds, so the work before it stays);
- ``no_memory``: neither read nor written.

An ablated kernel's output is wrong by design: only its time is read.
Prints one JSON line per copy.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess

import torch

from rankaae_tpu_torch.ops import _nvcc
from rankaae_tpu_torch.ops import fused_block_cuda as fb
from rankaae_tpu_torch.tools.time_fused_block import SHAPES, times

_CONV1 = "    conv<C, true>(xs, w1, ch[kB1], lane, acc);\n"
_CONV2 = "    conv<C, false>(hs, w2, ch[kB2], lane, acc);\n"
_LOAD = "        xv[c][q] = __ldcs(reinterpret_cast<const float4*>(x + base + c * kL + 4 * q));\n"
_STORE = ("        __stcs(reinterpret_cast<float4*>(dst + o * kL + 4 * q), "
          "make_float4(y[0], y[1], y[2], y[3]));\n")


def _bias_plus_input(stash: str, bias: str) -> str:
    return (f"#pragma unroll\n"
            f"    for (int o = 0; o < C; ++o)\n"
            f"#pragma unroll\n"
            f"      for (int p = 0; p < kP; ++p) {{\n"
            f"        float v[4];\n"
            f"        unpack({stash}[o][p / 4][lane], v);\n"
            f"        acc[o][p] = ch[{bias}][o] + v[p % 4];\n"
            f"      }}\n")


_NO_X = ("        xv[c][q] = make_float4(1e-3f * (b + lane), 1e-3f * (c + q), "
         "-1e-3f * lane, 1e-3f * b);\n")
_NO_OUT = ("        if (y[0] == 1234.5f && y[1] == y[2] && y[3] == -7.f) "
           "dst[o * kL + 4 * q] = y[0];\n")
ABLATIONS = {
    "no_conv": ((_CONV1, _bias_plus_input("xs", "kB1")),
                (_CONV2, _bias_plus_input("hs", "kB2"))),
    "no_x": ((_LOAD, _NO_X),),
    "no_out": ((_STORE, _NO_OUT),),
    "no_memory": ((_LOAD, _NO_X), (_STORE, _NO_OUT)),
}


def ablated_sources() -> dict:
    """Write each ablated copy of the kernel source; {name: path}."""
    text = fb.SOURCE.read_text()
    out_dir = _nvcc.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {"full": fb.SOURCE}
    for name, edits in ABLATIONS.items():
        copy = text
        for old, new in edits:
            if copy.count(old) != 1:
                raise RuntimeError(f"{name}: the kernel source no longer has the line {old!r}")
            copy = copy.replace(old, new)
        path = out_dir / f"fused_block_{name}.cu"
        path.write_text(copy)
        sources[name] = path
    return sources


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also append the JSON lines here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k3_ablate needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    sources = ablated_sources()
    _nvcc.compile_all(sources.values())
    kernel_source = fb.SOURCE
    lines = []
    try:
        for name in (*sources, "full"):
            fb.SOURCE, fb._lib = sources[name], None
            rows = [times(fb, c, b) for c, b in SHAPES]
            lines.append(json.dumps({"card": card, "copy": name, "device_us": {
                f"C{r['C']} B{r['B']}": r["device_ms"] * 1e3 for r in rows}}))
            print(lines[-1], flush=True)
    finally:
        fb.SOURCE, fb._lib = kernel_source, None
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
