"""Device selection for the package's entry points.

Entry points run on the card unless the caller asks for the CPU: ``None``
means ``"cuda"``, and a CUDA device that is not present raises instead of
carrying on quietly on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            "pass device='cpu' explicitly to run on the CPU")
    return dev
