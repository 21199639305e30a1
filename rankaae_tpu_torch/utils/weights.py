"""Weight bridge between the JAX trainer's pytrees and this package's modules.

``rankaae_tpu``'s trainer keeps ``params`` and ``batch_stats`` as
``{'enc', 'dec', 'dis'}`` pytrees of flax leaves; this package keeps the
same numbers in ``nn.Module`` ``state_dict``s whose submodule names match the
flax module names.  The mapping per leaf:

=================================  ====================================
flax (numpy arrays)                torch ``state_dict``
=================================  ====================================
``params/<lin>/kernel`` (in, out)  ``<lin>.weight`` (out, in)
``params/<lin>/bias``              ``<lin>.bias``
``params/<prelu>/alpha``           ``<prelu>.weight``
``batch_stats/<bn>/mean``          ``<bn>.running_mean``
``batch_stats/<bn>/var``           ``<bn>.running_var``
=================================  ====================================

``num_batches_tracked`` has no flax counterpart: :func:`from_jax` sets it to
0 and :func:`to_jax` drops it (momentum is fixed, so torch never reads it).
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

MODULES = ("enc", "dec", "dis")

_PARAM_LEAVES = {"kernel": "weight", "bias": "bias", "alpha": "weight"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _module_from_jax(params: Mapping, stats: Mapping) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for layer, leaves in params.items():
        for leaf, value in leaves.items():
            arr = np.asarray(value, np.float32)
            if leaf == "kernel":
                arr = arr.T
            sd[f"{layer}.{_PARAM_LEAVES[leaf]}"] = torch.tensor(arr)   # copies
    for layer, leaves in stats.items():
        for leaf, value in leaves.items():
            sd[f"{layer}.{_STAT_LEAVES[leaf]}"] = torch.tensor(np.asarray(value, np.float32))
        sd[f"{layer}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return sd


def from_jax(params: Mapping, batch_stats: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """JAX ``{'enc','dec','dis'}`` params/batch_stats (numpy leaves) ->
    ``{'enc','dec','dis'}`` torch ``state_dict``s (CPU tensors)."""
    return {m: _module_from_jax(params[m], batch_stats.get(m, {}) or {})
            for m in MODULES}


def _module_to_jax(sd: Mapping[str, torch.Tensor]) -> Tuple[dict, dict]:
    params: dict = {}
    stats: dict = {}
    for key, value in sd.items():
        layer, name = key.rsplit(".", 1)
        if name == "num_batches_tracked":
            continue
        arr = value.detach().cpu().numpy()
        if name in ("running_mean", "running_var"):
            stats.setdefault(layer, {})["mean" if name == "running_mean" else "var"] = arr
        elif name == "bias":
            params.setdefault(layer, {})["bias"] = arr
        elif arr.ndim == 2:       # Linear weight (out, in) -> kernel (in, out)
            params.setdefault(layer, {})["kernel"] = np.ascontiguousarray(arr.T)
        else:                     # PReLU weight
            params.setdefault(layer, {})["alpha"] = arr
    return params, stats


def to_jax(state_dicts: Mapping[str, Mapping[str, torch.Tensor]]) -> Tuple[dict, dict]:
    """Inverse of :func:`from_jax`: ``(params, batch_stats)`` as nested dicts
    of numpy arrays, in the JAX trainer's layout."""
    params, batch_stats = {}, {}
    for m in MODULES:
        params[m], batch_stats[m] = _module_to_jax(state_dicts[m])
    return params, batch_stats
