"""Data layer: spectra CSV -> host arrays (counterpart of
``rankaae_tpu/data/dataset.py``), the reference's dataset facade
:class:`AuxSpectraDataset` and its loader API (:func:`get_dataloaders`,
:class:`DataLoader`, :class:`ToTensor`).  The CSV is parsed by the native
C++ loader (``data/native.py``) or by pandas, to the same floats.

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
import torch

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


class AuxSpectraDataset:
    """One split of the CSV with the reference dataset's surface
    (``sc/clustering/dataloader.py:8-56``; ``rankaae_tpu/data/dataset.py:
    51-75``): ``.spec``, ``.aux``, ``.grid``, ``.atom_index``,
    ``.metadata``, ``__len__`` and ``__getitem__``."""

    def __init__(self, csv_fn: str, split_portion: str,
                 train_val_test_ratios: Tuple[float, float, float] = (0.7, 0.15, 0.15),
                 n_aux: int = 0):
        arrays = load_split_arrays(csv_fn, train_val_test_ratios, n_aux)[split_portion]
        self.metadata = {"path": csv_fn, "train_test_val_split_ratio": train_val_test_ratios}
        self.spec = arrays.spec
        self.aux = arrays.aux
        self.grid = arrays.grid
        self.atom_index = arrays.atom_index

    def __len__(self) -> int:
        return self.spec.shape[0]

    def __getitem__(self, idx):
        if self.aux is None:
            return self.spec[idx], np.array([0.0], dtype=np.float32)
        return self.spec[idx], self.aux[idx]


def _read_csv_pandas(csv_fn: str, dtype):
    full_df = pd.read_csv(csv_fn, index_col=[0, 1], comment="#")
    return full_df.columns.to_list(), full_df.to_numpy().astype(dtype), full_df.index.to_list()


def _read_index(csv_fn: str, n: int) -> list:
    """The 2-level row index (the first two CSV fields of every data row,
    the second an int where it is all digits, as pandas reads it)."""
    index = []
    with open(csv_fn) as f:
        header_seen = False
        for line in f:
            ls = line.lstrip()
            if not ls or ls.startswith("#"):
                continue
            if not header_seen:
                header_seen = True
                continue
            a, b, _ = line.split(",", 2)
            index.append((a, int(b) if b.isdigit() else b))
    if len(index) != n:
        raise ValueError(f"{len(index)} index rows for {n} data rows in {csv_fn}")
    return index


def read_csv(csv_fn: str, dtype=np.float32, engine: str = "auto"):
    """CSV -> (column names, float payload, 2-level row index)
    (``rankaae_tpu/data/dataset.py:102-120``): ``engine="native"`` parses
    with the native loader and raises if it cannot be built, ``"pandas"``
    with pandas, and ``"auto"`` with the native loader where it builds,
    else pandas."""
    if engine not in ("auto", "native", "pandas"):
        raise ValueError(f'engine must be "auto", "native" or "pandas", got {engine!r}')
    if engine != "pandas":
        try:
            from rankaae_tpu_torch.data.native import load_csv_native

            cols, data = load_csv_native(csv_fn, n_index_cols=2)
            return cols, data.astype(dtype, copy=False), _read_index(csv_fn, data.shape[0])
        except (RuntimeError, OSError, ValueError):
            if engine == "native":
                raise
    return _read_csv_pandas(csv_fn, dtype)


def load_split_arrays(
    csv_fn: str,
    ratios: Tuple[float, float, float] = (0.7, 0.15, 0.15),
    n_aux: int = 0,
    dtype=np.float32,
    engine: str = "auto",
) -> Dict[str, SplitArrays]:
    """Load the CSV once (``engine`` as :func:`read_csv`) and return all
    three contiguous splits."""
    cols, data, index = read_csv(csv_fn, dtype, engine)
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


def epoch_batch_indices(rng: np.random.Generator, n: int, batch_size: int) -> np.ndarray:
    """The JAX package's host helper (``rankaae_tpu/data/dataset.py:157-171``):
    a permutation of [0, n) from ``rng``, padded by wrapping to ceil(n/B)
    batches of ``batch_size`` each, as (n_batch, batch_size).  Static XLA
    shapes forbid a ragged last batch there; this package's trainer runs
    the ragged batch at its own size and does not use it."""
    n_batch = -(-n // batch_size)
    perm = rng.permutation(n)
    padded = np.concatenate([perm, perm[: n_batch * batch_size - n]])
    return padded.reshape(n_batch, batch_size)


class ToTensor:
    """The reference's transform (``dataloader.py:59-61``): a sample as a
    CPU float32 tensor."""

    def __call__(self, sample):
        return torch.from_numpy(np.array(sample, dtype=np.float32))


class DataLoader:
    """Batches of an :class:`AuxSpectraDataset` with the reference
    DataLoader's semantics (``dataloader.py:64-77``;
    ``rankaae_tpu/data/dataset.py:181-210``): shuffled from
    ``np.random.default_rng(seed)`` anew each pass where ``shuffle``, in
    order otherwise, the last batch ragged, ``len()`` ceil(n/B), and a
    ``.dataset`` attribute.  A batch is (spectra (b, dim), descriptors
    (b, n_aux), or (b, 1) zeros for a split without them), as CPU float32
    tensors, the rows the JAX loader gives for the same seed.  The trainer
    does not use it: it gathers its batches on the device."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self):
        n = len(self.dataset)
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        for start in range(0, n, self.batch_size):
            idx = order[start:start + self.batch_size]
            aux = (self.dataset.aux[idx] if self.dataset.aux is not None
                   else np.zeros((len(idx), 1), np.float32))
            yield (torch.from_numpy(np.array(self.dataset.spec[idx], np.float32)),
                   torch.from_numpy(np.array(aux, np.float32)))


def get_dataloaders(csv_fn: str, batch_size: int,
                    train_val_test_ratios: Tuple[float, float, float] = (0.7, 0.15, 0.15),
                    n_aux: int = 0):
    """The reference's loader factory (``dataloader.py:64-77``): (train
    shuffled, val, test) :class:`DataLoader`s over the contiguous splits."""
    ds_train, ds_val, ds_test = [
        AuxSpectraDataset(csv_fn, p, train_val_test_ratios, n_aux=n_aux) for p in PORTIONS
    ]
    return (DataLoader(ds_train, batch_size, shuffle=True),
            DataLoader(ds_val, batch_size),
            DataLoader(ds_test, batch_size))
