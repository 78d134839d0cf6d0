"""Plain PyTorch versions of the kernels: the counterpart of the JAX
package's ``ORACLES`` map (``repro.kernels.ref``).

``repro_torch.kernels.ops`` runs these for tensors on the CPU; the tests
hold them against the JAX oracles and Pallas kernels, and ``chip_smoke.py``
holds each CUDA kernel against them on the card.  Nothing on the serving
path calls them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dplr_corpus_score import NEG_INF


def dplr_score_items_ref(V_I, U_I, e, d_I, P_C, s_C):
    """Algorithm 1 per item, ``(..., n)``: ``V_I (..., n, m_I, k)``,
    ``P_C (..., rho, k)``, ``s_C (...)``."""
    P = P_C[..., None, :, :] + torch.einsum("rm,...nmk->...nrk", U_I, V_I)
    term_e = torch.einsum("...nrk,r->...n", P * P, e)
    term_d = torch.einsum("...nmk,m->...n", V_I * V_I, d_I)
    return 0.5 * (s_C[..., None] + term_d + term_e)


def dplr_corpus_score_ref(Q_I, a_I, e, P_C, a_C, valid=None):
    """``(Bq, n)`` corpus-cached scores ``a_C + a_I + 0.5 e.||P_C + Q_I||^2``,
    dead slots (``valid[i] == False``) pinned to ``NEG_INF``."""
    P = P_C[:, None] + Q_I[None]
    term_e = torch.einsum("qnrk,r->qn", P * P, e)
    s = a_C[:, None] + a_I[None, :] + 0.5 * term_e
    if valid is not None:
        s = torch.where(valid[None, :], s, torch.full_like(s, NEG_INF))
    return s


def topk_stable(scores, K: int):
    """``((Bq, K) values, (Bq, K) int64 positions)``, best first, ties to
    the lowest position: a stable descending sort (``torch.topk``
    promises no tie order)."""
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :K], idx[:, :K]


def dplr_corpus_topk_ref(Q_I, a_I, e, P_C, a_C, topk, valid=None,
                         index_offset=0, index_stride=1):
    """``((Bq, K) scores, (Bq, K) int32 ids)``; local row ``i`` is labeled
    ``index_offset + index_stride * i``."""
    vals, idx = topk_stable(dplr_corpus_score_ref(Q_I, a_I, e, P_C, a_C,
                                                  valid), topk)
    return vals, (index_offset + index_stride * idx).to(torch.int32)


def dplr_corpus_multi_topk_ref(Q_parts, a_parts, valid_parts, e, P_C, a_C, topk,
                               index_offset=0, index_stride=1):
    """``((S, Bq, K) scores, (S, Bq, K) int32 ids)``: S single-segment
    top-K passes stacked, segment ``s`` scored against its own slab with
    its own eigenvalues ``e[s]``, ids segment-local before the relabel."""
    if valid_parts is None:
        valid_parts = (None,) * len(Q_parts)
    vals, ids = zip(*(
        dplr_corpus_topk_ref(Q_parts[s], a_parts[s], e[s], P_C[s], a_C[s], topk,
                             valid_parts[s], index_offset, index_stride)
        for s in range(len(Q_parts))))
    return torch.stack(vals), torch.stack(ids)
