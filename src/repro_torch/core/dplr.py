"""Diagonal-plus-low-rank (DPLR) parameterization of the FwFM field matrix.

Port of ``repro.core.dplr``.  The field matrix is never learned directly:

    R = U^T diag(e) U + diag(d),   d = -diag_of(U^T diag(e) U)      (Eq. 10)

so diag(R) = 0 by construction, and Proposition 1 reduces the pairwise
interaction to ``sum_i d_i ||v_i||^2 + sum_r e_r ||P_r||^2`` with
``P = U V``.  ``posthoc_dplr`` waits for the training slice of the port.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class DPLRParams(NamedTuple):
    """Learned DPLR factors.  U: (rho, m);  e: (rho,)."""

    U: torch.Tensor
    e: torch.Tensor

    @property
    def rank(self) -> int:
        return self.U.shape[0]

    @property
    def n_fields(self) -> int:
        return self.U.shape[1]


def init_dplr(generator: torch.Generator, n_fields: int, rank: int, *,
              scale: float | None = None, dtype=torch.float32) -> DPLRParams:
    """Rank-1 ``U = 1^T, e = 1`` is a plain FM (R = 11^T - I); the init
    starts there, with small noise on every row.  Tensors are made on the
    generator's device."""
    if scale is None:
        scale = 1.0 / np.sqrt(n_fields)
    dev = generator.device
    U = torch.randn((rank, n_fields), generator=generator, device=dev) * scale
    if rank >= 1:
        U[0] += 1.0
    e = torch.ones((rank,), device=dev)
    return DPLRParams(U.to(dtype), e.to(dtype))


def dplr_diagonal(p: DPLRParams) -> torch.Tensor:
    """d = -diag_of(U^T diag(e) U); d_m = -sum_r e_r U_{r,m}^2.  O(rho*m)."""
    return -torch.einsum("r,rm,rm->m", p.e, p.U, p.U)


def materialize_R(p: DPLRParams) -> torch.Tensor:
    """(m, m) full field matrix; for tests and analysis, never the hot path."""
    low = torch.einsum("rm,r,rn->mn", p.U, p.e, p.U)
    return low + torch.diag(dplr_diagonal(p))
