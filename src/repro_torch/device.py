"""Device resolution for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device.  Asking for CUDA
    where there is no card raises: nothing quietly runs on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is "
                           f"available; pass device='cpu' to run on the CPU")
    return dev


def init_device(generator: torch.Generator, device=None) -> torch.device:
    """The device an ``init`` makes its tensors on: ``device``, else the
    generator's.  A CPU generator with ``device="meta"`` gives shapes and
    types only (``torch.Generator`` cannot be made on ``meta``)."""
    return generator.device if device is None else torch.device(device)
