"""Magnitude pruning of the FwFM field-interaction matrix (the baseline
heuristic the paper replaces, Sections 3.3 and 5.1).  Port of
``repro.core.pruning``: the same numpy selection (the same ``np.argsort``
call, so the kept entries are the JAX package's for the same R), with
the result as tensors on R's device (the CPU for a numpy R).

Parameter matching (Section 5.1): a rank-rho DPLR model has
``rho * (m + 1)`` interaction parameters, so the "equivalent" pruned model
keeps the ``rho * (m + 1)`` largest-|R_ij| upper-triangular entries.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class PrunedR(NamedTuple):
    """Static sparse representation of a pruned field matrix."""

    mask: torch.Tensor        # (m, m) f32 symmetric 0/1, zero diagonal
    entries_i: torch.Tensor   # (t,) int32 upper-triangular rows
    entries_j: torch.Tensor   # (t,) int32 cols (j > i)
    entries_r: torch.Tensor   # (t,) f32 surviving values


def matched_param_count(m: int, rank: int) -> int:
    """Kept upper-triangular entries matching a rank-``rank`` DPLR model."""
    return min(rank * (m + 1), m * (m - 1) // 2)


def kept_fraction(m: int, rank: int) -> float:
    """'Pruned sparsity' column of Table 1."""
    return 2.0 * matched_param_count(m, rank) / (m * (m - 1))


def prune_topk(R, n_keep: int) -> PrunedR:
    """Keep the ``n_keep`` largest-magnitude upper-triangular entries of R."""
    device = R.device if isinstance(R, torch.Tensor) else torch.device("cpu")
    if isinstance(R, torch.Tensor):
        R = R.detach().cpu().numpy()
    R = np.asarray(R, dtype=np.float32)
    m = R.shape[0]
    iu, ju = np.triu_indices(m, k=1)
    vals = R[iu, ju]
    order = np.argsort(-np.abs(vals))[:n_keep]
    ei, ej, er = iu[order], ju[order], vals[order]
    mask = np.zeros((m, m), np.float32)
    mask[ei, ej] = 1.0
    mask[ej, ei] = 1.0
    return PrunedR(*(torch.as_tensor(a, device=device)
                     for a in (mask, ei.astype(np.int32), ej.astype(np.int32), er)))


def prune_matched(R, m: int, rank: int) -> PrunedR:
    """Prune R to the DPLR-rank-matched parameter count (Table 1 protocol)."""
    return prune_topk(R, matched_param_count(m, rank))
