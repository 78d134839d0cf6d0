"""Context-cached item ranking (the paper's Algorithm 1 and its cached
baselines).  Port of ``repro.core.ranking``: dplr, fm, full fwfm and
pruned fwfm.

One query carries context field embeddings ``V_C (..., m_C, k)``; ``n``
candidates carry item field embeddings ``V_I (..., n, m_I, k)``.  What
depends on the context alone is computed once per query.  Fields are
ordered context first, then item, as in ``FeatureLayout``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
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


# Pruned FwFM with caching (sparse path): the surviving entries split by
# which side of the context/item boundary they touch.

def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def split_pruned_entries(entries_i, entries_j, entries_r, n_context: int) -> dict:
    """Static (numpy) split of the surviving entries into CC / CI / II
    groups of (i, j, r); CI pairs are oriented as (local item field,
    context field)."""
    ei, ej, er = _np(entries_i), _np(entries_j), _np(entries_r)
    is_ctx_i = ei < n_context
    is_ctx_j = ej < n_context
    cc = is_ctx_i & is_ctx_j
    ii = (~is_ctx_i) & (~is_ctx_j)
    ci = ~(cc | ii)
    ci_item = np.where(is_ctx_i[ci], ej[ci], ei[ci]) - n_context
    ci_ctx = np.where(is_ctx_i[ci], ei[ci], ej[ci])
    return {
        "cc": (ei[cc], ej[cc], er[cc]),
        "ci": (ci_item, ci_ctx, er[ci]),
        "ii": (ei[ii] - n_context, ej[ii] - n_context, er[ii]),
    }


def _pair_sum(V, i, j, r):
    """sum_t <v_{i_t}, v_{j_t}> r_t over the (..., m, k) rows of V."""
    dev = V.device
    Vi = V.index_select(-2, torch.as_tensor(i, device=dev))
    Vj = V.index_select(-2, torch.as_tensor(j, device=dev))
    return (Vi * Vj).sum(dim=-1) @ torch.as_tensor(r, dtype=V.dtype, device=dev)


class PrunedContextCache(NamedTuple):
    cc: torch.Tensor    # (...,)
    W_I: torch.Tensor   # (..., m_I, k) context aggregates of the surviving CI pairs


def pruned_context_cache(groups: dict, V_C: torch.Tensor, m_item: int) -> PrunedContextCache:
    cc_i, cc_j, cc_r = groups["cc"]
    cc = _pair_sum(V_C, cc_i, cc_j, cc_r) if len(cc_r) else V_C.new_zeros(V_C.shape[:-2])
    ci_item, ci_ctx, ci_r = groups["ci"]
    W_I = V_C.new_zeros((*V_C.shape[:-2], m_item, V_C.shape[-1]))
    if len(ci_r):
        dev = V_C.device
        contrib = (V_C.index_select(-2, torch.as_tensor(ci_ctx, device=dev))
                   * torch.as_tensor(ci_r, dtype=V_C.dtype, device=dev)[:, None])
        W_I.index_add_(W_I.ndim - 2, torch.as_tensor(ci_item, device=dev), contrib)
    return PrunedContextCache(cc=cc, W_I=W_I)


def pruned_score_items(groups: dict, cache: PrunedContextCache,
                       V_I: torch.Tensor) -> torch.Tensor:
    ci = torch.einsum("...nik,...ik->...n", V_I, cache.W_I)
    ii_i, ii_j, ii_r = groups["ii"]
    ii = _pair_sum(V_I, ii_i, ii_j, ii_r) if len(ii_r) else V_I.new_zeros(V_I.shape[:-2])
    return cache.cc[..., None] + ci + ii
