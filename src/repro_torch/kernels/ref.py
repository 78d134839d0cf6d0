"""Plain PyTorch versions of the kernels: the counterpart of the JAX
package's ``ORACLES`` map (``repro.kernels.ref``).

``repro_torch.kernels.ops`` runs these for tensors on the CPU; the tests
hold them against the JAX oracles and Pallas kernels, and ``chip_smoke.py``
holds each CUDA kernel against them on the card.  Nothing on the serving
path calls them on the card.
"""
from __future__ import annotations

import numpy as np
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


def embedding_bag_ref(table, ids, weights, segment_ids, n_bags: int):
    """``(..., n_bags, k)``: ``out[..., b, :] = sum_{s: seg[s] = b} w_s *
    table[id_s]`` for arena-global ``ids (..., n_slots)``, the weights cast
    to the table dtype before the product.  An id outside ``[0, rows)``
    raises ``IndexError`` (indexing alone would wrap a negative one)."""
    if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= table.shape[0]):
        raise IndexError(f"embedding ids must lie in [0, {table.shape[0]})")
    flat = table[ids.long()]                                  # (..., n_slots, k)
    weighted = flat * weights[..., None].to(flat.dtype)
    out = torch.zeros((*ids.shape[:-1], n_bags, table.shape[-1]),
                      dtype=flat.dtype, device=flat.device)
    return out.index_add_(out.ndim - 2, _segments(segment_ids, table.device), weighted)


def _segments(segment_ids, device) -> torch.Tensor:
    if isinstance(segment_ids, torch.Tensor):
        return segment_ids.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(segment_ids, np.int64), device=device)


def embedding_bag_vjp(table, ids, weights, segment_ids, grad):
    """``(d table, d weights)`` of ``embedding_bag_ref`` for the output
    gradient ``grad (..., n_bags, k)``: each slot's bag gradient, times its
    weight, added into its row; and its dot with the row."""
    g = grad.index_select(grad.ndim - 2, _segments(segment_ids, grad.device))
    rows = ids.reshape(-1).long()
    d_table = torch.zeros_like(table).index_add_(
        0, rows, (g * weights[..., None].to(g.dtype)).reshape(-1, table.shape[-1]))
    d_weights = (g * table[rows].view(g.shape)).sum(-1).to(weights.dtype)
    return d_table, d_weights


def fwfm_pairwise_ref(V, R):
    """``(...,)`` full FwFM term ``0.5 * sum_ij <v_i, v_j> R_ij`` for
    ``V (..., m, k)``, ``R (m, m)``."""
    G = torch.einsum("...ik,...jk->...ij", V, V)
    return 0.5 * torch.einsum("...ij,ij->...", G, R)


def fwfm_pairwise_vjp(V, R, grad):
    """``(d V, d R)`` of ``fwfm_pairwise_ref`` for the output gradient
    ``grad (...,)``: ``d v_i = g * 0.5 * sum_j (R_ij + R_ji) v_j`` and
    ``d R = 0.5 * sum_b g_b G_b``."""
    d_V = grad[..., None, None] * torch.einsum("ij,...jk->...ik", 0.5 * (R + R.T), V)
    d_R = 0.5 * torch.einsum("...,...ik,...jk->ij", grad, V, V)
    return d_V, d_R
