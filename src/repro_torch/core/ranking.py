"""Context-cached item ranking (the paper's Algorithm 1 and its cached
baselines).  Port of ``repro.core.ranking`` for the dplr, fm and fwfm
interactions; the pruned-FwFM path waits for the pruning port.

One query carries context field embeddings ``V_C (..., m_C, k)``; ``n``
candidates carry item field embeddings ``V_I (..., n, m_I, k)``.  What
depends on the context alone is computed once per query.  Fields are
ordered context first, then item, as in ``FeatureLayout``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.dplr import DPLRParams, dplr_diagonal
from repro_torch.kernels.ref import dplr_score_items_ref


class DPLRContextCache(NamedTuple):
    P_C: torch.Tensor   # (..., rho, k)   U_C @ V_C
    s_C: torch.Tensor   # (...,)          sum_{i in C} d_i ||v_i||^2


def dplr_context_cache(p: DPLRParams, V_C: torch.Tensor, n_context: int) -> DPLRContextCache:
    """Step (1) of Algorithm 1, once per query.  O(rho m_C k)."""
    d = dplr_diagonal(p)
    P_C = torch.einsum("rm,...mk->...rk", p.U[:, :n_context], V_C)
    s_C = torch.einsum("...mk,m->...", V_C * V_C, d[:n_context])
    return DPLRContextCache(P_C=P_C, s_C=s_C)


def dplr_score_items(p: DPLRParams, cache: DPLRContextCache, V_I: torch.Tensor,
                     n_context: int) -> torch.Tensor:
    """Steps (2)-(3) of Algorithm 1 in plain PyTorch, per item O(rho m_I k):
    the pairwise term per item, shape (..., n).  The arithmetic is the
    item kernel's plain version."""
    d = dplr_diagonal(p)
    return dplr_score_items_ref(V_I, p.U[:, n_context:], p.e, d[n_context:],
                                cache.P_C, cache.s_C)


class FMContextCache(NamedTuple):
    sum_C: torch.Tensor   # (..., k)  sum of context vectors
    sqn_C: torch.Tensor   # (...,)    sum of squared norms


def fm_context_cache(V_C: torch.Tensor) -> FMContextCache:
    return FMContextCache(sum_C=V_C.sum(dim=-2), sqn_C=(V_C * V_C).sum(dim=(-1, -2)))


def fm_score_items(cache: FMContextCache, V_I: torch.Tensor) -> torch.Tensor:
    s = cache.sum_C[..., None, :] + V_I.sum(dim=-2)        # (..., n, k)
    sqn = cache.sqn_C[..., None] + (V_I * V_I).sum(dim=(-1, -2))
    return 0.5 * ((s * s).sum(dim=-1) - sqn)


class FwFMContextCache(NamedTuple):
    cc: torch.Tensor    # (...,)          context-context interactions
    W_I: torch.Tensor   # (..., m_I, k)   per item-field context aggregate


def fwfm_context_cache(R: torch.Tensor, V_C: torch.Tensor, n_context: int) -> FwFMContextCache:
    G = torch.einsum("...ik,...jk->...ij", V_C, V_C)
    cc = 0.5 * torch.einsum("...ij,ij->...", G, R[:n_context, :n_context])
    W_I = torch.einsum("im,...mk->...ik", R[n_context:, :n_context], V_C)
    return FwFMContextCache(cc=cc, W_I=W_I)


def fwfm_score_items(R: torch.Tensor, cache: FwFMContextCache, V_I: torch.Tensor,
                     n_context: int) -> torch.Tensor:
    ci = torch.einsum("...nik,...ik->...n", V_I, cache.W_I)
    G = torch.einsum("...nik,...njk->...nij", V_I, V_I)     # O(m_I^2 k) per item
    ii = 0.5 * torch.einsum("...nij,ij->...n", G, R[n_context:, n_context:])
    return cache.cc[..., None] + ci + ii
