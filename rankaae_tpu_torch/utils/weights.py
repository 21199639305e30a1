"""Weight bridge between the JAX package's pytrees and this package's modules.

``rankaae_tpu`` keeps ``params`` and ``batch_stats`` as ``{'enc', 'dec',
'dis'}`` pytrees of flax leaves, nested by submodule (``dec/eblock0/conv1/
weight``); this package keeps the same numbers in ``nn.Module``s whose
submodule names match the flax names, so a flax path joined with ``.`` is a
``state_dict`` key.  The mapping per leaf:

=======================================  ==========================================
flax (numpy arrays)                      torch module, ``state_dict`` entry
=======================================  ==========================================
``params/.../kernel`` (in, out)          ``nn.Linear``, ``weight`` (out, in)
``params/.../weight``                    ``nn.Conv1d``/``nn.ConvTranspose1d``,
                                         ``weight`` (same layout)
``params/.../alpha``                     ``nn.PReLU``, ``weight``
``params/.../bias``                      ``bias`` (Linear and the convs)
``batch_stats/.../mean``                 ``nn.BatchNorm1d``, ``running_mean``
``batch_stats/.../var``                  ``nn.BatchNorm1d``, ``running_var``
=======================================  ==========================================

:func:`from_jax` decides by the flax leaf name, :func:`to_jax` by the torch
module's type; neither looks at a leaf's rank.  :func:`to_jax` reads the
numbers from the modules or from ``state_dict`` snapshots of them.
``num_batches_tracked`` has no flax counterpart: :func:`from_jax` sets it
to 0 and :func:`to_jax` drops it (momentum is fixed, so torch never reads
it).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

_PARAM_LEAVES = {"kernel": "weight", "weight": "weight", "alpha": "weight", "bias": "bias"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix, key, value


def _module_from_jax(params: Mapping, stats: Mapping) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf, value in _leaves(params):
        if leaf not in _PARAM_LEAVES:
            raise KeyError(f"unknown flax parameter leaf {'/'.join(path + (leaf,))!r}")
        arr = np.asarray(value, np.float32)
        if leaf == "kernel":
            arr = arr.T
        sd[".".join(path + (_PARAM_LEAVES[leaf],))] = torch.tensor(arr)   # copies
    layers = set()
    for path, leaf, value in _leaves(stats):
        if leaf not in _STAT_LEAVES:
            raise KeyError(f"unknown flax batch_stats leaf {'/'.join(path + (leaf,))!r}")
        sd[".".join(path + (_STAT_LEAVES[leaf],))] = torch.tensor(np.asarray(value, np.float32))
        layers.add(path)
    for path in layers:
        sd[".".join(path + ("num_batches_tracked",))] = torch.zeros((), dtype=torch.long)
    return sd


def from_jax(params: Mapping, batch_stats: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """JAX ``{role: params}``/``{role: batch_stats}`` (numpy leaves, nested
    by submodule) -> ``{role: state_dict}`` (CPU tensors), for every role in
    ``params``."""
    return {m: _module_from_jax(params[m], batch_stats.get(m) or {}) for m in params}


def from_jax_variables(variables: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """flax variables by role, ``{role: {"params": ..., "batch_stats": ...}}``
    (what the JAX ``DualAAE.init`` returns for ``enc``, ``dec`` and ``dis``;
    ``rankaae_tpu/models/registry.py:68-75``) -> ``{role: state_dict}``, as
    :func:`from_jax`."""
    return from_jax({role: v["params"] for role, v in variables.items()},
                    {role: v.get("batch_stats") or {} for role, v in variables.items()})


def _module_to_jax(module: nn.Module, sd: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> Tuple[dict, dict]:
    params: dict = {}
    stats: dict = {}
    sd = module.state_dict() if sd is None else sd

    def put(tree, name, leaf, attr, transpose=False):
        tensor = sd[f"{name}.{attr}" if name else attr].detach()
        node = tree
        for part in name.split(".") if name else ():
            node = node.setdefault(part, {})
        # a copy: numpy() of a CPU tensor shares its memory, and a later
        # train-mode forward updates the running statistics in place
        node[leaf] = np.array((tensor.T if transpose else tensor).cpu().numpy(),
                              order="C", copy=True)

    for name, m in module.named_modules():
        if isinstance(m, nn.Linear):
            put(params, name, "kernel", "weight", transpose=True)
            put(params, name, "bias", "bias")
        elif isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
            put(params, name, "weight", "weight")
            put(params, name, "bias", "bias")
        elif isinstance(m, nn.PReLU):
            put(params, name, "alpha", "weight")
        elif isinstance(m, nn.BatchNorm1d):
            put(stats, name, "mean", "running_mean")
            put(stats, name, "var", "running_var")
    return params, stats


def to_jax(models: Mapping[str, nn.Module],
           state_dicts: Optional[Mapping[str, Mapping[str, torch.Tensor]]] = None
           ) -> Tuple[dict, dict]:
    """Inverse of :func:`from_jax`: ``(params, batch_stats)`` of the given
    ``{role: module}`` as nested dicts of numpy arrays, in the JAX package's
    layout.  With ``state_dicts`` (``{role: state_dict}``, e.g. a snapshot
    the best trackers keep) the numbers come from those, the layout from
    the modules."""
    params, batch_stats = {}, {}
    for role, module in models.items():
        sd = None if state_dicts is None else state_dicts[role]
        params[role], batch_stats[role] = _module_to_jax(module, sd)
    return params, batch_stats
