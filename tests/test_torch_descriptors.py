"""The port's copy of the descriptor extraction
(``rankaae_tpu_torch/utils/descriptors.py``) against the JAX package's
(``rankaae_tpu/utils/descriptors.py``) on the cases of
``tests/test_descriptors.py``: every descriptor equal (the same numpy and
scipy code on the same spectra; NaN where the JAX package gives NaN)."""
import numpy as np
import pytest

from rankaae_tpu.utils import descriptors as jax_descriptors

from rankaae_tpu_torch.utils import descriptors
from tests import torch_parity  # noqa: F401  (one torch thread a process)
from tests.test_descriptors import _synthetic_spectrum


def _assert_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal(x, y)
    elif a is None or isinstance(a, str):
        assert a == b
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _fitted(module, grid, spec):
    sd = module.SpecDescriptors.from_spline(grid[::4], spec[::4], fine_grid=grid, s=0.001)
    sd.find_descriptors("all")
    sd.find_intensity_at_energy(10.0)
    return sd


@pytest.mark.parametrize("edge", [5488.0, 5490.0, 5493.5])
def test_fit_edge_arctan_equals_jax(edge):
    grid, spec = _synthetic_spectrum(edge_pos=edge)
    _assert_equal(descriptors.fit_edge_arctan(grid, spec),
                  jax_descriptors.fit_edge_arctan(grid, spec))


def test_spec_descriptors_equal_jax():
    grid, spec = _synthetic_spectrum()
    got, ref = _fitted(descriptors, grid, spec), _fitted(jax_descriptors, grid, spec)
    for group in ref.GROUPS:
        _assert_equal(getattr(got, group), getattr(ref, group))
    _assert_equal(got.other, ref.other)
    _assert_equal(got.as_dict(), ref.as_dict())
    assert "edge_intensity" not in got.as_dict()


def test_functional_core_and_batch_equal_jax():
    grid, spec = _synthetic_spectrum()
    nested = descriptors.extract_descriptors(descriptors.SpectrumView.build(grid, spec))
    ref = jax_descriptors.extract_descriptors(jax_descriptors.SpectrumView.build(grid, spec))
    _assert_equal(nested, ref)
    _assert_equal(descriptors.flatten_descriptors(nested),
                  jax_descriptors.flatten_descriptors(ref))
    # one garbage row must not abort the batch
    specs = np.stack([spec, spec * 1.1, np.zeros_like(spec)])
    _assert_equal(descriptors.extract_descriptors_batch(grid, specs),
                  jax_descriptors.extract_descriptors_batch(grid, specs))


def test_plot_draws_what_jax_draws():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    grid, spec = _synthetic_spectrum()
    lines = []
    for module in (descriptors, jax_descriptors):
        fig, ax = plt.subplots()
        _fitted(module, grid, spec).plot(ax, vlines=[5500.0], hlines=[1.0])
        lines.append([np.asarray(line.get_xydata()) for line in ax.get_lines()])
        plt.close(fig)
    _assert_equal(*lines)
