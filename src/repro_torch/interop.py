"""Weights carried between the JAX package and the port, through numpy.

Both packages keep a model's parameters as a dict with the same keys and
layouts: flat for the recsys models (``bias``, ``linear``, ``embedding``,
and ``U``/``e`` for dplr or ``R`` for fwfm), nested for the LM family
(``{"embed", "layers": {name: (L, ...)}, "final_ln"}``).  So the JAX
parameters, passed through ``np.asarray``, become the port's tensors
unchanged.  The parity tests
hand one set of weights to both packages this way; two independent inits
would not agree, since the random streams differ.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def params_from_numpy(tree: dict, device=None, dtype=None) -> dict:
    """``{name: array or subtree}`` -> the same tree of tensors on
    ``device`` (default cuda), with ``dtype`` (``torch.bfloat16``: the
    serving type) given to the float32 leaves; other leaves keep theirs.
    numpy has no bf16, so a bf16 tree travels as float32 and is cast on
    each side: JAX and torch both round to nearest even, so the two
    packages hold the same bits."""
    dev = resolve_device(device)

    def leaf(value):
        t = torch.as_tensor(np.array(value), device=dev)
        return t.to(dtype) if dtype is not None and t.dtype == torch.float32 else t

    return {name: params_from_numpy(value, dev, dtype) if isinstance(value, dict)
            else leaf(value) for name, value in tree.items()}


def params_to_numpy(params: dict) -> dict:
    """``{name: tensor or subtree}`` -> the same tree of numpy arrays."""
    return {name: params_to_numpy(t) if isinstance(t, dict) else t.detach().cpu().numpy()
            for name, t in params.items()}
