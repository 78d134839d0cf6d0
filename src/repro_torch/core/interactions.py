"""Pairwise-interaction modules: FM, FwFM, pruned FwFM, DPLR-FwFM.  Port
of ``repro.core.interactions``.

Each takes the field-embedding matrix ``V (..., m, k)`` and returns
``sum_{i<j} <v_i, v_j> * weight_ij`` per batch element:

    fm_pairwise        O(m k)          (Rendle's identity, Eq. 1)
    fwfm_pairwise      O(m^2 k)        (Eq. 3, the cost the paper removes)
    pruned_pairwise    O(t k)          (sparse path; dense-masked: kernel 6)
    dplr_pairwise      O(rho m k)      (Proposition 1)

``fwfm_pairwise`` (and so ``pruned_pairwise_dense``) is
``kops.fwfm_pairwise``: the CUDA kernel for tensors on the card, its plain
version on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core.dplr import DPLRParams, dplr_diagonal
from repro_torch.kernels import ops as kops


def fm_pairwise(V: torch.Tensor) -> torch.Tensor:
    """Plain FM: 0.5 * (||sum_i v_i||^2 - sum_i ||v_i||^2)."""
    s = V.sum(dim=-2)
    return 0.5 * ((s * s).sum(dim=-1) - (V * V).sum(dim=(-1, -2)))


def fwfm_pairwise(V: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Full FwFM: 0.5 * sum_ij <v_i, v_j> R_ij (R symmetric, zero diagonal)."""
    return kops.fwfm_pairwise(V.contiguous(), R.contiguous())


def pruned_pairwise_dense(V: torch.Tensor, R: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """Pruned FwFM as the full contraction with a zero-masked R: the same
    kernel as the full FwFM, so pruning saves parameters, not work."""
    return fwfm_pairwise(V, R * mask)


def pruned_pairwise_sparse(V: torch.Tensor, entries_i: torch.Tensor,
                           entries_j: torch.Tensor, entries_r: torch.Tensor) -> torch.Tensor:
    """Pruned FwFM as a sparse sum over the t surviving entries, O(t k):
    the CPU production form the paper benchmarks against (Fig. 1)."""
    Vi = V.index_select(-2, entries_i)
    Vj = V.index_select(-2, entries_j)
    return (Vi * Vj).sum(dim=-1) @ entries_r


def dplr_pairwise(V: torch.Tensor, p: DPLRParams) -> torch.Tensor:
    """DPLR-FwFM, Proposition 1: 0.5 * (sum_i d_i ||v_i||^2 + sum_r e_r ||P_r||^2)."""
    d = dplr_diagonal(p)
    P = torch.einsum("rm,...mk->...rk", p.U, V)
    term_d = torch.einsum("...mk,m->...", V * V, d)
    term_e = torch.einsum("...rk,r->...", P * P, p.e)
    return 0.5 * (term_d + term_e)


def dplr_pairwise_explicit_d(V: torch.Tensor, U: torch.Tensor, e: torch.Tensor,
                             d: torch.Tensor) -> torch.Tensor:
    """Proposition 1 with an explicit diagonal (post-hoc factorizations)."""
    P = torch.einsum("rm,...mk->...rk", U, V)
    term_d = torch.einsum("...mk,m->...", V * V, d)
    term_e = torch.einsum("...rk,r->...", P * P, e)
    return 0.5 * (term_d + term_e)
