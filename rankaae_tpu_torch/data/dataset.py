"""Data layer: spectra CSV -> host arrays (counterpart of
``rankaae_tpu/data/dataset.py:29-154``, pandas engine only).

Parity contract with the reference (``sc/clustering/dataloader.py:8-56``):

* CSV read with a 2-level row index (``index_col=[0, 1]``) and ``comment='#'``;
* energy grid parsed from ``ENE_*`` column names;
* first ``n_aux`` columns are ``AUX_*`` physical descriptors
  (CT, CN, OCN, RSTD, MOOD), the remaining 256 ``ENE_*`` columns the spectrum;
* train/val/test split by **contiguous row slices** (NOT shuffled) of sizes
  ``int(N*r_train)``, ``int(N*r_val)``, remainder.

The whole dataset (~7000 x 261 float32) is moved to the device once by the
trainer; an epoch's batches are index gathers of a permutation.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import pandas as pd

PORTIONS = ("train", "val", "test")


def split_sizes(n: int, ratios: Tuple[float, float, float]) -> Tuple[int, int, int]:
    """Contiguous split sizes; last portion takes the remainder
    (reference dataloader.py:14-16)."""
    sizes = [int(n * r) for r in ratios]
    sizes[-1] = n - sum(sizes[:-1])
    return tuple(sizes)


@dataclasses.dataclass
class SplitArrays:
    """One split's data as host numpy arrays (moved to device by the trainer)."""

    spec: np.ndarray          # (N, dim_in) float32
    aux: Optional[np.ndarray]  # (N, n_aux) float32 or None
    grid: np.ndarray          # (dim_in,) energy grid
    atom_index: list          # 2-level row index as list of tuples
    portion: str

    def __len__(self) -> int:
        return self.spec.shape[0]


def load_split_arrays(
    csv_fn: str,
    ratios: Tuple[float, float, float] = (0.7, 0.15, 0.15),
    n_aux: int = 0,
    dtype=np.float32,
) -> Dict[str, SplitArrays]:
    """Load the CSV once and return all three contiguous splits."""
    full_df = pd.read_csv(csv_fn, index_col=[0, 1], comment="#")
    cols = full_df.columns.to_list()
    data = full_df.to_numpy().astype(dtype)
    index = full_df.index.to_list()
    grid = np.array([float(c[len("ENE_"):]) for c in cols if c.startswith("ENE_")])

    # Column-layout checks, as in the reference (dataloader.py:21-25).
    if not cols[n_aux].startswith("ENE_"):
        raise ValueError(f"column {n_aux} must be ENE_*, got {cols[n_aux]}")
    if n_aux > 0 and (cols[n_aux - 1].startswith("ENE_")
                      or not cols[0].startswith("AUX_")
                      or not cols[n_aux - 1].startswith("AUX_")):
        raise ValueError(f"the first {n_aux} columns must be AUX_*, got {cols[:n_aux]}")

    sizes = split_sizes(data.shape[0], ratios)
    out: Dict[str, SplitArrays] = {}
    start = 0
    for portion, size in zip(PORTIONS, sizes):
        sl = slice(start, start + size)
        out[portion] = SplitArrays(
            spec=np.ascontiguousarray(data[sl, n_aux:]),
            aux=np.ascontiguousarray(data[sl, :n_aux]) if n_aux > 0 else None,
            grid=grid,
            atom_index=index[start:start + size],
            portion=portion,
        )
        start += size
    return out
