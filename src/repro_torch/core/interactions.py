"""Pairwise-interaction modules: FM, FwFM, DPLR-FwFM.  Port of
``repro.core.interactions`` (the terms ``fwfm.apply`` needs).

Each takes the field-embedding matrix ``V (..., m, k)`` and returns
``sum_{i<j} <v_i, v_j> * weight_ij`` per batch element:

    fm_pairwise        O(m k)          (Rendle's identity, Eq. 1)
    fwfm_pairwise      O(m^2 k)        (Eq. 3, the cost the paper removes)
    dplr_pairwise      O(rho m k)      (Proposition 1)
"""
from __future__ import annotations

import torch

from repro_torch.core.dplr import DPLRParams, dplr_diagonal


def fm_pairwise(V: torch.Tensor) -> torch.Tensor:
    """Plain FM: 0.5 * (||sum_i v_i||^2 - sum_i ||v_i||^2)."""
    s = V.sum(dim=-2)
    return 0.5 * ((s * s).sum(dim=-1) - (V * V).sum(dim=(-1, -2)))


def fwfm_pairwise(V: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Full FwFM: 0.5 * sum_ij <v_i, v_j> R_ij (R symmetric, zero diagonal)."""
    G = torch.einsum("...ik,...jk->...ij", V, V)
    return 0.5 * torch.einsum("...ij,ij->...", G, R)


def dplr_pairwise(V: torch.Tensor, p: DPLRParams) -> torch.Tensor:
    """DPLR-FwFM, Proposition 1: 0.5 * (sum_i d_i ||v_i||^2 + sum_r e_r ||P_r||^2)."""
    d = dplr_diagonal(p)
    P = torch.einsum("rm,...mk->...rk", p.U, V)
    term_d = torch.einsum("...mk,m->...", V * V, d)
    term_e = torch.einsum("...rk,r->...", P * P, p.e)
    return 0.5 * (term_d + term_e)
