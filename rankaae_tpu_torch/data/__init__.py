"""Data layer: CSV loading (native or pandas), the reference's dataset and
loader API, and the synthetic XANES generator."""
from rankaae_tpu_torch.data.dataset import (  # noqa: F401
    AuxSpectraDataset,
    DataLoader,
    SplitArrays,
    ToTensor,
    get_dataloaders,
    load_split_arrays,
    split_sizes,
)
from rankaae_tpu_torch.data.native import native_available  # noqa: F401
from rankaae_tpu_torch.data.synthetic import make_synthetic_xanes, make_synthetic_xanes_csv  # noqa: F401
