"""The traffic's data: the synthetic XANES dataset, made in memory from the
seed (a copy of ``rankaae_tpu_torch/data/synthetic.py``'s generator that
writes no CSV), and split as the reference splits a CSV: contiguous rows,
``int(N * ratio)`` for train and validation, the rest for test.

The spectra are an arctan edge and Gaussian resonances whose positions,
heights and widths follow the five descriptors (CT, CN, OCN, RSTD, MOOD);
CN takes the values 4, 5 and 6, so the Kendall loss meets tied pairs.
"""
from __future__ import annotations

import numpy as np


def make_xanes(rng: np.random.Generator, n_rows: int, dim: int = 256,
               e_start: float = 5460.0, e_stop: float = 5570.0):
    """(aux (N, 5), spec (N, dim)) float64, drawn from ``rng``."""
    grid = np.linspace(e_start, e_stop, dim)
    ct = rng.normal(0.0, 1.0, n_rows)
    cn = rng.choice([4.0, 5.0, 6.0], n_rows, p=[0.3, 0.3, 0.4])
    ocn = cn + rng.normal(0.0, 0.6, n_rows)
    rstd = np.abs(rng.normal(0.05, 0.02, n_rows)) + 0.01
    mood = rng.normal(0.0, 1.0, n_rows) + 0.3 * ct

    e0 = np.clip(grid[0] + 0.25 * (grid[-1] - grid[0]) + 2.2 * ct, grid[8], grid[-9])
    x = grid[None, :]
    spec = 0.5 + np.arctan((x - e0[:, None]) / (2.0 + 100.0 * rstd[:, None])) / np.pi
    wl_height = 1.6 - 0.15 * (cn - 5.0) - 0.08 * ct + 0.05 * rng.normal(0.0, 1.0, n_rows)
    wl_width = 3.0 + 40.0 * rstd
    wl_pos = e0 + 6.0 + 0.8 * (cn - 5.0)
    spec += wl_height[:, None] * np.exp(-0.5 * ((x - wl_pos[:, None]) / wl_width[:, None]) ** 2)
    p2_pos = e0 + 25.0 + 3.0 * (ocn - 5.0)
    spec += (0.35 + 0.05 * mood)[:, None] * np.exp(-0.5 * ((x - p2_pos[:, None]) / 6.0) ** 2)
    spec += 0.1 * mood[:, None] * np.clip((x - e0[:, None]) / (grid[-1] - grid[0]), 0.0, None)
    spec += rng.normal(0.0, 0.01, spec.shape)
    spec = np.clip(spec, 0.0, None)
    return np.stack([ct, cn, ocn, rstd, mood], axis=1), spec


def split_sizes(n: int, ratios):
    sizes = [int(n * r) for r in ratios]
    sizes[-1] = n - sum(sizes[:-1])
    return sizes


def make_splits(seed: int, traffic: dict, dim: int, n_aux: int):
    """(train_spec, train_aux, val_spec, val_aux) float32 numpy arrays of the
    traffic's ``rows`` and ``split``, drawn from ``seed``."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0]))
    aux, spec = make_xanes(rng, traffic["rows"], dim)
    n_train, n_val, _ = split_sizes(traffic["rows"], traffic["split"])
    aux, spec = aux[:, :n_aux].astype(np.float32), spec.astype(np.float32)
    return (spec[:n_train], aux[:n_train],
            spec[n_train:n_train + n_val], aux[n_train:n_train + n_val])
