"""Trials spread over several processes (counterpart of
``rankaae_tpu/parallel/multihost.py:25-37``).

The workload is embarrassingly parallel over trials: a trial exchanges no
byte with another while it trains.  So several processes, one GPU each (or
several on one GPU), split the trial axis: :func:`initialize` joins the
process group on every process, and ``parallel/trials.py::run_trials``
gives rank r of W a contiguous block of the trials, trains it as the
1-process run would, and gathers the results in trial order at the end.
That gather of host numpy arrays is the only collective of the trial
layout, and it runs on a gloo group (:func:`host_group`), so it works on
any layout, two ranks on one GPU included.  The trial x dp layout
(``run_trials(dp=n)``) also gathers each minibatch's rows from the row
shards of its group, a device collective: NCCL on CUDA, gloo on the CPU.

Under ``python -m torch.distributed.run --nproc-per-node N ...`` (torchrun)
:func:`initialize` takes everything from the environment; elsewhere the
caller names the coordinator (``host:port``), the number of processes and
this process's rank, as ``jax.distributed.initialize`` takes them.
"""
from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed as dist

from rankaae_tpu_torch.utils.device import resolve_device

_HOST_GROUP = None


def launched() -> bool:
    """True in a process that torchrun started as one of several ranks."""
    return int(os.environ.get("WORLD_SIZE", "1")) > 1


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the process group (``torch.distributed.init_process_group``,
    backend gloo).  With no argument, from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); else all
    three arguments are needed: the coordinator as ``host:port``, the
    number of processes and this process's rank."""
    given = (coordinator_address, num_processes, process_id)
    if all(a is None for a in given):
        dist.init_process_group("gloo", init_method="env://")
    elif any(a is None for a in given):
        raise ValueError("initialize takes all of coordinator_address, num_processes and "
                         "process_id, or none of them (torchrun's environment)")
    else:
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes), rank=int(process_id))


def world() -> tuple:
    """(rank, world size): (0, 1) outside a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def rank_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """This rank's device: ``device`` where the caller names one (raising
    when it is absent), else ``cuda:LOCAL_RANK`` (torchrun's local rank, or
    the rank where that is not set) in a process group, else ``cuda``."""
    if device is None and world()[1] > 1:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', world()[0]))}"
    return resolve_device(device)


def host_group():
    """A gloo group of every rank, for the gathers of host objects (made
    once; every rank must call it the first time)."""
    global _HOST_GROUP
    if _HOST_GROUP is None:
        _HOST_GROUP = dist.new_group(backend="gloo")
    return _HOST_GROUP


def all_gather_objects(obj) -> list:
    """Every rank's ``obj`` in rank order, on every rank (pickled, over the
    gloo group)."""
    out = [None] * world()[1]
    dist.all_gather_object(out, obj, group=host_group())
    return out
