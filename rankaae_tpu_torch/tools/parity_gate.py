"""Quality gate between two sets of ``--mode ours`` records (counterpart of
``scripts/fused_gate.py``).

    python -m rankaae_tpu_torch.tools.parity_gate \\
        --pair FC-300 artifacts/parity_fused/fc300_faithful/ours.json \\
                      artifacts/parity_torch/R2/ours.json \\
        [--columns "rankaae_tpu (TPU v5e)" "rankaae_tpu_torch (H100)"] \\
        [--pair ... [--columns ...]] [--out FILE]

Each ``--pair LABEL A B`` gives a section: ``fused_gate.py``'s rows
(``:57-72``: final, flex and calibrated val recon MSE, the reconstruction
floor, the best-recon and min-combined models' recon MSE, Shapiro-W,
coupling, amplitude bias, the median style<->descriptor Spearman, drifted
seeds and each run's wall), then a verdict on two medians across seeds: the
reconstruction floor (``val_recon_min``) and the per-seed median of the five
final style<->descriptor Spearmans.  Each verdict is the 95% bootstrap CI of
each side's median (20,000 resamples, seed 0, as ``_median_ci``), printed as
OVERLAP or DISJOINT.  A record that predates the floor (it holds only
``final``, ``best`` and ``best_epoch``) puts the final val recon MSE in the
floor's place, and the section says so; a row either record lacks prints
``n/a``.  ``--columns`` names the two columns of the pair it follows (given
once, it names every pair's); by default each record's ``stack`` (the
JAX package's records have none: ``rankaae_tpu``).  A wall is printed with
the record's ``device``; a record without one is the JAX package's TPU run,
and its wall is not compared.  Writes ``--out`` or the standard output.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Tuple

import numpy as np

from rankaae_tpu_torch.tools.parity_experiment import _fmt_spread, _median_ci

#: ``scripts/fused_gate.py:57-72``: (row, path in a seed's record, format)
ROWS = (
    ("final val recon MSE", ("final", "recon_mse"), "{:.5f}"),
    ("final flex-objective recon MSE", ("final", "recon_mse_flex"), "{:.5f}"),
    ("final amp-calibrated recon MSE", ("final", "recon_mse_cal"), "{:.5f}"),
    ("reconstruction floor (min val recon)", ("val_recon_min",), "{:.5f}"),
    ("best-recon bundle recon MSE", ("best_recon", "recon_mse"), "{:.5f}"),
    ("min-combined-selected recon MSE", ("best", "recon_mse"), "{:.5f}"),
    ("final min per-style Shapiro-W", ("final", "shapiro_min"), "{:.4f}"),
    ("final max inter-style |rho|", ("final", "coupling"), "{:.4f}"),
    ("signed amplitude bias", ("final", "scale_bias"), "{:+.3f}"),
)
FLOOR = ("val_recon_min",)
FINAL_MSE = ("final", "recon_mse")


def _col(seeds, path) -> Optional[np.ndarray]:
    """``path`` of every seed's record, or None where a seed lacks it."""
    out = []
    for s in seeds:
        v = s
        for p in path:
            if not isinstance(v, dict) or p not in v:
                return None
            v = v[p]
        out.append(v)
    return np.asarray(out, float)


def _spearman(seeds) -> np.ndarray:
    """Each seed's median of its five final style<->descriptor Spearmans."""
    return np.median(np.asarray([s["final"]["style_desc_rho"] for s in seeds], float), axis=1)


def _cell(vals: Optional[np.ndarray], fmt: str) -> str:
    return "n/a" if vals is None else _fmt_spread(vals, fmt)


def _wall(rec) -> str:
    if "device" in rec:
        return f"{rec['wall']:.1f} s ({rec['device']}, set-up included)"
    return f"{rec['wall']:.1f} s (the JAX package's TPU run, compile included; not compared)"


def verdict(a, b) -> Tuple[Tuple[float, float], Tuple[float, float], bool]:
    """The 95% bootstrap CIs of the two medians and whether they overlap."""
    a_ci, b_ci = _median_ci(a), _median_ci(b)
    return a_ci, b_ci, bool((b_ci[0] <= a_ci[1]) and (a_ci[0] <= b_ci[1]))


def pair_section(label: str, a_fn: str, b_fn: str, names: Tuple[str, str]):
    """The markdown section of one pair and its verdicts
    ``{"floor": bool, "spearman": bool}`` (True: OVERLAP)."""
    with open(a_fn) as f:
        a = json.load(f)
    with open(b_fn) as f:
        b = json.load(f)
    a_s, b_s = a["seeds"], b["seeds"]
    epochs = (f"{a['epochs']} epochs" if a["epochs"] == b["epochs"]
              else f"{a['epochs']} and {b['epochs']} epochs")
    lines = [
        f"## {label} ({names[0]} n={len(a_s)}, {names[1]} n={len(b_s)}, {epochs})",
        "",
        f"| Quantity | {names[0]} | {names[1]} |",
        "|---|---|---|",
    ]
    for name, path, fmt in ROWS:
        lines.append(f"| {name} | {_cell(_col(a_s, path), fmt)} "
                     f"| {_cell(_col(b_s, path), fmt)} |")
    lines.append(f"| style<->descriptor Spearman (median of 5) "
                 f"| {_fmt_spread(_spearman(a_s), '{:.4f}')} "
                 f"| {_fmt_spread(_spearman(b_s), '{:.4f}')} |")
    drift = lambda seeds: (                                     # noqa: E731
        "n/a" if _col(seeds, ("final", "scale_bias")) is None
        else f"{int(np.sum(np.abs(_col(seeds, ('final', 'scale_bias'))) > 0.03))}/{len(seeds)}")
    lines.append(f"| seeds with \\|bias\\| > 3% | {drift(a_s)} | {drift(b_s)} |")
    lines.append(f"| wall (all seeds) | {_wall(a)} | {_wall(b)} |")

    a_fl, b_fl = _col(a_s, FLOOR), _col(b_s, FLOOR)
    floor_name = "floor"
    if a_fl is None or b_fl is None:
        a_fl, b_fl = _col(a_s, FINAL_MSE), _col(b_s, FINAL_MSE)
        floor_name = "final val recon MSE"
        lines += ["", "A record of this pair predates the reconstruction floor (it holds "
                  "only `final`, `best` and `best_epoch`): the verdict below holds the "
                  "final val recon MSE in its place."]
    a_ci, b_ci, floor_ok = verdict(a_fl, b_fl)
    ratio = float(np.median(b_fl) / np.median(a_fl))
    sa_ci, sb_ci, rho_ok = verdict(_spearman(a_s), _spearman(b_s))
    word = lambda ok: "OVERLAP" if ok else "DISJOINT"           # noqa: E731
    lines += [
        "",
        f"{floor_name[0].upper() + floor_name[1:]} median 95% bootstrap CIs: {names[0]} "
        f"[{a_ci[0]:.5f}, {a_ci[1]:.5f}], {names[1]} [{b_ci[0]:.5f}, {b_ci[1]:.5f}] — "
        f"**{word(floor_ok)}**; {names[1]}/{names[0]} {floor_name} ratio {ratio:.2f}x.",
        "",
        f"Spearman (median of 5) median 95% bootstrap CIs: {names[0]} "
        f"[{sa_ci[0]:.4f}, {sa_ci[1]:.4f}], {names[1]} [{sb_ci[0]:.4f}, {sb_ci[1]:.4f}] — "
        f"**{word(rho_ok)}**.",
        "",
    ]
    return lines, {"floor": floor_ok, "spearman": rho_ok, "floor_ratio": ratio,
                   "floor_name": floor_name}


def _names(args, i: int, a_fn: str, b_fn: str) -> Tuple[str, str]:
    if args.columns:
        return tuple(args.columns[i] if len(args.columns) > 1 else args.columns[0])
    stack = []
    for fn in (a_fn, b_fn):
        with open(fn) as f:
            stack.append(json.load(f).get("stack", "rankaae_tpu"))
    return tuple(stack)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m rankaae_tpu_torch.tools.parity_gate",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--pair", nargs=3, action="append", required=True,
                    metavar=("LABEL", "A_JSON", "B_JSON"))
    ap.add_argument("--columns", nargs=2, action="append", default=[],
                    metavar=("A_NAME", "B_NAME"),
                    help="the pair's column names (once for every pair, or once a pair)")
    ap.add_argument("--out", default=None, help="markdown file (default: standard output)")
    args = ap.parse_args(argv)
    if len(args.columns) not in (0, 1, len(args.pair)):
        ap.error("give --columns once, or once for each --pair")

    lines: List[str] = []
    verdicts = []
    for i, (label, a_fn, b_fn) in enumerate(args.pair):
        sec, v = pair_section(label, a_fn, b_fn, _names(args, i, a_fn, b_fn))
        lines += sec
        verdicts.append((label, v))
    lines += ["## Verdict", ""]
    for label, v in verdicts:
        lines.append(f"- {label}: {v['floor_name']} "
                     f"{'OVERLAP' if v['floor'] else 'DISJOINT'} "
                     f"(ratio {v['floor_ratio']:.2f}x), Spearman "
                     f"{'OVERLAP' if v['spearman'] else 'DISJOINT'}")
    text = "\n".join(lines) + "\n"
    if args.out is None:
        sys.stdout.write(text)
    else:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
