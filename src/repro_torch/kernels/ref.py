"""Plain PyTorch versions of the kernels: the counterpart of the JAX
package's ``ORACLES`` map (``repro.kernels.ref``).

``repro_torch.kernels.ops`` runs these for tensors on the CPU; the tests
hold them against the JAX oracles and Pallas kernels, and ``chip_smoke.py``
holds each CUDA kernel against them on the card.  Nothing on the serving
path calls them on the card.

The scorers upcast bf16 operands to float32 on entry, as the JAX
package's kernel wrappers do, so a bf16 call is the float32 call on the
upcast tensors; the embedding bag computes in its table's type.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.dplr_corpus_score import NEG_INF


def _f32(*tensors):
    return tuple(t.to(torch.float32) for t in tensors)


def round_bf16(x):
    """``x`` rounded to the nearest bf16 (ties to even), as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def dplr_score_items_ref(V_I, U_I, e, d_I, P_C, s_C):
    """Algorithm 1 per item, ``(..., n)`` float32: ``V_I (..., n, m_I, k)``,
    ``P_C (..., rho, k)``, ``s_C (...)``."""
    V_I, U_I, e, d_I, P_C, s_C = _f32(V_I, U_I, e, d_I, P_C, s_C)
    P = P_C[..., None, :, :] + torch.einsum("rm,...nmk->...nrk", U_I, V_I)
    term_e = torch.einsum("...nrk,r->...n", P * P, e)
    term_d = torch.einsum("...nmk,m->...n", V_I * V_I, d_I)
    return 0.5 * (s_C[..., None] + term_d + term_e)


def dplr_corpus_score_ref(Q_I, a_I, e, P_C, a_C, valid=None, acc_dtype="float32"):
    """``(Bq, n)`` float32 corpus-cached scores ``a_C + a_I + 0.5
    e.||P_C + Q_I||^2``, dead slots (``valid[i] == False``) pinned to
    ``NEG_INF``.  ``acc_dtype='bfloat16'``: each square and each ``e_r``
    rounded to bf16, their products summed in float32, the sum rounded to
    bf16 (the reference's ``_einsum_acc``, rounded as the kernel rounds)."""
    Q_I, a_I, e, P_C, a_C = _f32(Q_I, a_I, e, P_C, a_C)
    P = P_C[:, None] + Q_I[None]
    if acc_dtype == "bfloat16":
        term_e = round_bf16(torch.einsum("qnrk,r->qn", round_bf16(P * P), round_bf16(e)))
    else:
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
                         index_offset=0, index_stride=1, acc_dtype="float32"):
    """``((Bq, K) scores, (Bq, K) int32 ids)``; local row ``i`` is labeled
    ``index_offset + index_stride * i``."""
    vals, idx = topk_stable(dplr_corpus_score_ref(Q_I, a_I, e, P_C, a_C,
                                                  valid, acc_dtype), topk)
    return vals, (index_offset + index_stride * idx).to(torch.int32)


def dplr_corpus_multi_topk_ref(Q_parts, a_parts, valid_parts, e, P_C, a_C, topk,
                               index_offset=0, index_stride=1, acc_dtype="float32"):
    """``((S, Bq, K) scores, (S, Bq, K) int32 ids)``: S single-segment
    top-K passes stacked, segment ``s`` scored against its own slab with
    its own eigenvalues ``e[s]``, ids segment-local before the relabel."""
    if valid_parts is None:
        valid_parts = (None,) * len(Q_parts)
    vals, ids = zip(*(
        dplr_corpus_topk_ref(Q_parts[s], a_parts[s], e[s], P_C[s], a_C[s], topk,
                             valid_parts[s], index_offset, index_stride, acc_dtype)
        for s in range(len(Q_parts))))
    return torch.stack(vals), torch.stack(ids)


def embedding_bag_ref(table, ids, weights, segment_ids, n_bags: int):
    """``(..., n_bags, k)`` in the table's dtype: ``out[..., b, :] =
    sum_{s: seg[s] = b} w_s * table[id_s]`` for arena-global ``ids (...,
    n_slots)``, the weights cast to the table dtype before the product, each
    product and add in that dtype.  An id outside ``[0, rows)``
    raises ``IndexError`` (indexing alone would wrap a negative one)."""
    if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= table.shape[0]):
        raise IndexError(f"embedding ids must lie in [0, {table.shape[0]})")
    flat = table[ids.long()]                                  # (..., n_slots, k)
    weighted = flat * weights[..., None].to(flat.dtype)
    out = torch.zeros((*ids.shape[:-1], n_bags, table.shape[-1]),
                      dtype=flat.dtype, device=flat.device)
    return out.index_add_(out.ndim - 2, _segments(segment_ids, table.device), weighted)


def embedding_bag_in_order(table, ids, weights, segment_ids, n_bags: int):
    """``embedding_bag_ref`` summed as the kernel sums: each bag from zero,
    its slots in ascending order, each product and add rounded to the
    table's dtype (one slot of every bag at a time).  Bitwise the kernel
    on any layout; ``index_add_`` promises no order on the card."""
    seg = np.asarray(_segments(segment_ids, "cpu"))
    rank = np.zeros(seg.size, np.int64)            # a slot's place in its bag
    seen: dict = {}
    for s, b in enumerate(seg):
        rank[s] = seen.get(b, 0)
        seen[b] = rank[s] + 1
    rows = table[ids.long()]                                   # (..., n_slots, k)
    w = weights.to(table.dtype)
    out = torch.zeros((*ids.shape[:-1], n_bags, table.shape[-1]), dtype=table.dtype,
                      device=table.device)
    for j in range(int(rank.max()) + 1 if seg.size else 0):
        slots = torch.as_tensor(np.flatnonzero(rank == j), device=table.device)
        bags = torch.as_tensor(seg[rank == j], device=table.device)
        out[..., bags, :] = out[..., bags, :] + rows[..., slots, :] * w[..., slots, None]
    return out


def _segments(segment_ids, device) -> torch.Tensor:
    if isinstance(segment_ids, torch.Tensor):
        return segment_ids.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(segment_ids, np.int64), device=device)


def embedding_bag_vjp(table, ids, weights, segment_ids, grad):
    """``(d table, d weights)`` of ``embedding_bag_ref`` for the output
    gradient ``grad (..., n_bags, k)``: each slot's bag gradient, times its
    weight, added into its row; and its dot with the row.  A slot whose id
    lies outside ``[0, rows)`` adds to no row, as in the backward kernel
    (and in ``jax.grad`` of the reference for an id past the table), and
    its weight's gradient is NaN, as its bag is in the forward kernel."""
    g = grad.index_select(grad.ndim - 2, _segments(segment_ids, grad.device))
    rows = ids.reshape(-1).long()
    n = table.shape[0]
    src = (g * weights[..., None].to(g.dtype)).reshape(-1, table.shape[-1])
    ok = (rows >= 0) & (rows < n)
    d_table = torch.zeros_like(table).index_add_(0, rows[ok], src[ok])
    d_weights = (g * table[rows.clamp(0, n - 1)].view(g.shape)).sum(-1)
    d_weights = d_weights.masked_fill(~ok.view(d_weights.shape), float("nan"))
    return d_table, d_weights.to(weights.dtype)


def bag_rows_sort(ids, rows: int):
    """``(keys, perm)`` = ``torch.sort(keys, stable=True)`` of the flat
    ``ids`` with each id outside ``[0, rows)`` set to ``rows``: the slots
    in row order, ascending within a row (keys in the ids' type, perm
    int64).  The plain version of the backward's radix sort."""
    flat = ids.reshape(-1)
    keys = flat.masked_fill((flat < 0) | (flat >= rows), rows)
    out = torch.sort(keys, stable=True)
    return out.values, out.indices


def fwfm_pairwise_ref(V, R):
    """``(...,)`` float32 full FwFM term ``0.5 * sum_ij <v_i, v_j> R_ij``
    for ``V (..., m, k)``, ``R (m, m)``, bf16 upcast on entry (the Pallas
    kernel forms the Gram of any float ``V`` in f32)."""
    V, R = (t.float() if t.dtype == torch.bfloat16 else t for t in (V, R))
    G = torch.einsum("...ik,...jk->...ij", V, V)
    return 0.5 * torch.einsum("...ij,ij->...", G, R)


def fwfm_pairwise_vjp(V, R, grad):
    """``(d V, d R)`` of ``fwfm_pairwise_ref`` for the output gradient
    ``grad (...,)``: ``d v_i = g * 0.5 * sum_j (R_ij + R_ji) v_j`` and
    ``d R = 0.5 * sum_b g_b G_b``."""
    d_V = grad[..., None, None] * torch.einsum("ij,...jk->...ik", 0.5 * (R + R.T), V)
    d_R = 0.5 * torch.einsum("...,...ik,...jk->ij", grad, V, V)
    return d_V, d_R


def flash_attention_ref(q, k, v, *, causal=True, window=None, q_offset: int = 0):
    """``(B, Sq, H, hd)`` f32 causal (optionally windowed) GQA for
    ``q (B, Sq, H, hd)``, ``k, v (B, S_k, KV, hd)``, query row r at position
    ``q_offset + r``: the JAX oracle, with the whole score matrix in memory
    (test sizes only)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd).float()
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) / np.sqrt(hd)
    q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = torch.ones((Sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    p = torch.softmax(torch.where(mask, logits, torch.full_like(logits, NEG_INF)), dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return out.reshape(B, Sq, H, hd)


def flash_attention_plain(q, k, v, *, window=None, block: int = 512, with_size: bool = False,
                          q_offset: int = 0):
    """The plain version of the flash-attention kernel: ``(B, Sq, H, hd)`` in
    q's dtype for ``q (B, Sq, H, hd)``, ``k, v (B, S, KV, hd)``, query row r
    at position ``q_offset + r`` (``q_offset + Sq <= S``), rounded where
    the kernel rounds: scores in f32 times ``1/sqrt(hd)``, masked scores
    ``NEG_INF``, max and sum in f32, ``p`` cast to v's dtype before the PV
    product (f32 sums), the sum divided by ``max(l, 1e-30)`` and cast to q's
    dtype.  One pass over the keys per block of ``block`` query positions
    (the kernel streams them), so scores take ``B H block S`` floats.

    With ``with_size``, also returns each output's size ``sum_j p_ij |v_j| /
    l_i`` in f32 (unrounded p): what one rounding of every p can move it
    by, in units of that rounding."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = np.float32(1.0 / np.sqrt(hd))
    kg = k.permute(0, 2, 1, 3).float()                      # (B, KV, S, hd)
    vg = v.permute(0, 2, 1, 3)
    pos = torch.arange(q_offset + Sq, device=q.device)
    out = torch.empty_like(q)
    size = torch.empty(q.shape, dtype=torch.float32, device=q.device) if with_size else None
    for lo in range(0, Sq, block):
        hi = min(lo + block, Sq)
        p_lo, p_hi = q_offset + lo, q_offset + hi            # the rows' positions
        k_lo = 0 if window is None else max(0, p_lo - window + 1)
        qc = q[:, lo:hi].reshape(B, hi - lo, KV, G, hd).float()
        s = torch.einsum("bqkgh,bksh->bkgqs", qc, kg[:, :, k_lo:p_hi]) * scale
        qp, kp = pos[p_lo:p_hi, None], pos[None, k_lo:p_hi]
        mask = kp <= qp
        if window is not None:
            mask &= kp > qp - window
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        p = torch.exp(s - s.amax(-1, keepdim=True))
        l = p.sum(-1, keepdim=True)
        acc = torch.einsum("bkgqs,bksh->bkgqh", p.to(v.dtype).float(),
                           vg[:, :, k_lo:p_hi].float())
        o = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)   # (B, KV, G, n, hd)
        out[:, lo:hi] = o.permute(0, 3, 1, 2, 4).reshape(B, hi - lo, H, hd)
        if with_size:
            mag = torch.einsum("bkgqs,bksh->bkgqh", p, vg[:, :, k_lo:p_hi].float().abs())
            size[:, lo:hi] = (mag / torch.clamp(l, min=1e-30)).permute(0, 3, 1, 2, 4).reshape(
                B, hi - lo, H, hd)
    return (out, size) if with_size else out
