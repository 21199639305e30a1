"""Synthetic XANES dataset generator (a copy of ``rankaae_tpu/data/synthetic.py``).

The reference's bundled dataset (``feff_V_CT_CN_OCN_RSTD_MOOD_spec_*.csv``)
is a git-LFS blob missing from the mirror, so tests and benchmarks run on a synthetic dataset with the exact same schema:

* 2-level row index;
* 5 ``AUX_`` descriptor columns: CT, CN, OCN, RSTD, MOOD;
* 256 ``ENE_<energy>`` spectrum columns on a uniform grid.

Spectra are built the way real XANES looks — an arctan absorption edge plus
Gaussian resonance peaks — with the descriptors *causally driving* spectral
features (edge position <- CT, white-line height <- CN, peak widths <- RSTD,
secondary-peak position <- OCN, post-edge slope <- MOOD) so the rank-correlation
losses have real structure to find.  CN is discrete {4, 5, 6} as in the real
dataset (reference ``sc/report/analysis.py:245-253``).
"""
from __future__ import annotations

import numpy as np
import pandas as pd

DESCRIPTOR_NAMES = ("CT", "CN", "OCN", "RSTD", "MOOD")


def make_synthetic_xanes(
    n_rows: int = 7000,
    dim: int = 256,
    seed: int = 0,
    e_start: float = 5460.0,
    e_stop: float = 5570.0,
):
    """Return (aux (N,5), spec (N,dim), grid (dim,)) float64 arrays."""
    rng = np.random.default_rng(seed)
    grid = np.linspace(e_start, e_stop, dim)

    ct = rng.normal(0.0, 1.0, n_rows)                     # charge transfer
    cn = rng.choice([4.0, 5.0, 6.0], n_rows, p=[0.3, 0.3, 0.4])  # coordination
    ocn = cn + rng.normal(0.0, 0.6, n_rows)               # "operative" CN, tied to CN
    rstd = np.abs(rng.normal(0.05, 0.02, n_rows)) + 0.01  # bond-length spread
    mood = rng.normal(0.0, 1.0, n_rows) + 0.3 * ct        # mean-of-distances proxy

    # CT shifts the edge by ~2.2 eV per sigma — a strong, monotonic,
    # physically-motivated signal (charge transfer moves the edge onset).
    # Edge sits a quarter of the way into the grid.
    e0 = grid[0] + 0.25 * (grid[-1] - grid[0]) + 2.2 * ct
    e0 = np.clip(e0, grid[8], grid[-9])

    x = grid[None, :]  # (1, dim)
    # absorption edge: arctan step whose position tracks CT
    edge_w = 2.0 + 5.0 * rstd[:, None] * 20.0
    spec = 0.5 + np.arctan((x - e0[:, None]) / edge_w) / np.pi

    # white line: main peak just above the edge; height anti-correlates with
    # CN and gains a mild CT component (intensity borrowing)
    wl_height = (1.6 - 0.15 * (cn - 5.0) - 0.08 * ct
                 + 0.05 * rng.normal(0.0, 1.0, n_rows))
    wl_width = 3.0 + 40.0 * rstd
    wl_pos = e0 + 6.0 + 0.8 * (cn - 5.0)
    spec += wl_height[:, None] * np.exp(-0.5 * ((x - wl_pos[:, None]) / wl_width[:, None]) ** 2)

    # secondary resonance: position follows OCN
    p2_pos = e0 + 25.0 + 3.0 * (ocn - 5.0)
    p2_h = 0.35 + 0.05 * mood
    spec += p2_h[:, None] * np.exp(-0.5 * ((x - p2_pos[:, None]) / 6.0) ** 2)

    # post-edge slope follows MOOD
    post = np.clip((x - e0[:, None]) / (grid[-1] - grid[0]), 0.0, None)
    spec += 0.1 * mood[:, None] * post

    spec += rng.normal(0.0, 0.01, spec.shape)             # measurement noise
    spec = np.clip(spec, 0.0, None)

    aux = np.stack([ct, cn, ocn, rstd, mood], axis=1)
    return aux, spec, grid


def make_synthetic_xanes_csv(
    path: str,
    n_rows: int = 7000,
    dim: int = 256,
    seed: int = 0,
) -> str:
    """Write a schema-exact CSV (2-level index, AUX_* then ENE_* columns)."""
    aux, spec, grid = make_synthetic_xanes(n_rows=n_rows, dim=dim, seed=seed)
    cols = [f"AUX_{n}" for n in DESCRIPTOR_NAMES] + [f"ENE_{e:.2f}" for e in grid]
    idx = pd.MultiIndex.from_arrays(
        [[f"mp-{i // 10}" for i in range(n_rows)], list(range(n_rows))],
        names=["material", "site"],
    )
    df = pd.DataFrame(np.concatenate([aux, spec], axis=1), columns=cols, index=idx)
    df.to_csv(path)
    return path
