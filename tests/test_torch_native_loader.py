"""The port's native CSV loader (``rankaae_tpu_torch/data/native.py`` over
its copy of the C++ source) against the JAX package's loader and pandas,
and ``read_csv``/``load_split_arrays``' ``engine`` argument
(``rankaae_tpu/data/dataset.py:102-120``): every float and every index
entry equal, exactly, on a synthetic dataset and on a file of comments,
exponents, NaN and infinities.  ``engine="native"`` raises when the
library cannot be built (a PATH without ``g++`` and an empty build dir);
``"auto"`` then reads with pandas.
"""
import numpy as np
import pandas as pd
import pytest

from rankaae_tpu.data.dataset import load_split_arrays as jax_load_split_arrays
from rankaae_tpu.data.native import load_csv_native as jax_load_csv_native

from rankaae_tpu_torch.data import native
from rankaae_tpu_torch.data.dataset import load_split_arrays, read_csv
from tests import torch_parity  # noqa: F401  (one torch thread a process)

TRICKY = ("# leading comment\n"
          "material,site,AUX_CT,ENE_1.00,ENE_2.00\n"
          "mp-1,0,1.5e-3,-2.75,+3.25E2\n"
          "# interior comment\n"
          "mp-1,1,nan,inf,-0.0\n")


def test_native_equals_jax_loader_and_pandas(synthetic_csv):
    cols, data = native.load_csv_native(synthetic_csv)
    jcols, jdata = jax_load_csv_native(synthetic_csv)
    assert cols == jcols and data.dtype == np.float32
    np.testing.assert_array_equal(data, jdata)
    df = pd.read_csv(synthetic_csv, index_col=[0, 1], comment="#")
    assert cols == df.columns.tolist()
    np.testing.assert_array_equal(data, df.to_numpy().astype(np.float32))


def test_split_arrays_identical_across_engines(synthetic_csv):
    splits = {engine: load_split_arrays(synthetic_csv, n_aux=5, engine=engine)
              for engine in ("native", "pandas", "auto")}
    ref = jax_load_split_arrays(synthetic_csv, n_aux=5, engine="native")
    for got in splits.values():
        for portion in ("train", "val", "test"):
            np.testing.assert_array_equal(got[portion].spec, ref[portion].spec)
            np.testing.assert_array_equal(got[portion].aux, ref[portion].aux)
            np.testing.assert_array_equal(got[portion].grid, ref[portion].grid)
            assert got[portion].atom_index == ref[portion].atom_index


def test_comments_exponents_and_specials_equal_jax(tmp_path):
    path = tmp_path / "tricky.csv"
    path.write_text(TRICKY)
    cols, data = native.load_csv_native(str(path))
    jcols, jdata = jax_load_csv_native(str(path))
    assert cols == jcols == ["AUX_CT", "ENE_1.00", "ENE_2.00"]
    np.testing.assert_array_equal(data, jdata)
    assert np.signbit(data[1, 2]) and np.isnan(data[1, 0]) and np.isinf(data[1, 1])
    assert read_csv(str(path), engine="native")[2] == [("mp-1", 0), ("mp-1", 1)]


def test_native_engine_raises_without_a_build(synthetic_csv, tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        read_csv(synthetic_csv, engine="native")
    cols, data, index = read_csv(synthetic_csv, engine="auto")
    pcols, pdata, pindex = read_csv(synthetic_csv, engine="pandas")
    assert cols == pcols and index == pindex
    np.testing.assert_array_equal(data, pdata)
    assert not (tmp_path / "build").exists()


def test_missing_file_and_bad_engine_raise(tmp_path):
    with pytest.raises(RuntimeError):
        native.load_csv_native(str(tmp_path / "absent.csv"))
    with pytest.raises(ValueError, match="engine"):
        read_csv(str(tmp_path / "absent.csv"), engine="arrow")
