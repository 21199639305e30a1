"""Data layer: CSV loading and the synthetic XANES generator."""
from rankaae_tpu_torch.data.dataset import SplitArrays, load_split_arrays, split_sizes  # noqa: F401
from rankaae_tpu_torch.data.synthetic import make_synthetic_xanes, make_synthetic_xanes_csv  # noqa: F401
