"""Weights carried between the JAX package and the port, through numpy.

Both packages keep a model's parameters as a flat dict with the same keys
(``bias``, ``linear``, ``embedding``, and ``U``/``e`` for dplr or ``R`` for
fwfm) and the same layouts, so the JAX parameters, passed through
``np.asarray``, become the port's tensors unchanged.  The parity tests
hand one set of weights to both packages this way; two independent inits
would not agree, since the random streams differ.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def params_from_numpy(tree: dict, device=None) -> dict:
    """``{name: array}`` -> ``{name: tensor}`` on ``device`` (default cuda)."""
    dev = resolve_device(device)
    return {name: torch.as_tensor(np.array(value), device=dev)
            for name, value in tree.items()}


def params_to_numpy(params: dict) -> dict:
    """``{name: tensor}`` -> ``{name: numpy array}``."""
    return {name: t.detach().cpu().numpy() for name, t in params.items()}
