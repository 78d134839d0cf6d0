"""Item-corpus precomputation for DPLR-FwFM serving.  Port of
``repro.serving.corpus``.

Proposition 1's projection ``P = U V`` is linear in the field embeddings,
so the item side of every score is context-independent.  It is computed
once per row per model refresh, and again only for the rows that churn:

    Q_I[i]   = U_I @ V_I[i]                      (cap, rho, k)
    t_I[i]   = sum_{f in item fields} d_f ||v_f||^2        (cap,)
    lin_I[i] = <b_item, x_item[i]>                         (cap,)

and a query costs only its context cache (P_C, s_C, lin_C) plus O(rho k)
per item:

    score[q, i] = b0 + lin_C[q] + lin_I[i]
                + 0.5 * (s_C[q] + t_I[i] + sum_r e_r ||P_C[q,r] + Q_I[i,r]||^2)

The cache is a capacity-padded slab: every leading axis is ``capacity``
(a power of two), ``valid`` marks the live slots, a dead slot scores
exactly ``NEG_INF``, and slot assignments are stable across churn and
model refresh; the slab grows only by doubling.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.dplr import DPLRParams, dplr_diagonal
from repro_torch.embedding.bag import (
    item_arena_ids,
    lookup_item_embeddings,
    lookup_linear_terms,
)
# Mask fill for dead slots: the one definition, the kernels' own.
from repro_torch.kernels.dplr_corpus_score import NEG_INF

# Slab rows computed per step of build_corpus_cache.
BUILD_CHUNK = 1 << 16


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


class ItemCorpusCache(NamedTuple):
    """Context-independent per-item precomputations (one model, one corpus).

    Leading axis is the slab ``capacity``; ``valid`` marks live slots."""

    Q_I: torch.Tensor     # (cap, rho, k)  rank-space item projections U_I V_I
    t_I: torch.Tensor     # (cap,)         sum_f d_f ||v_f||^2 (item fields)
    lin_I: torch.Tensor   # (cap,)         first-order item term
    valid: torch.Tensor   # (cap,)         bool liveness mask

    @property
    def capacity(self) -> int:
        return self.Q_I.shape[0]

    @property
    def a_I(self) -> torch.Tensor:
        """(cap,) fused per-item scalar addend: lin_I + 0.5 * t_I."""
        return self.lin_I + 0.5 * self.t_I


def corpus_rows(params: dict, cfg, item_ids, item_weights):
    """(Q_I, t_I, lin_I) rows for a batch of items: the per-row math of
    ``build_corpus_cache``, shared by the full build and churn writes so
    a written row equals the same row of a rebuild."""
    layout = cfg.layout
    nC = layout.n_context
    p = DPLRParams(params["U"], params["e"])
    d = dplr_diagonal(p)
    V_I = lookup_item_embeddings(params["embedding"], layout, item_ids,
                                 item_weights)                      # (n, mI, k)
    Q_I = torch.einsum("rm,...mk->...rk", p.U[:, nC:], V_I)
    t_I = torch.einsum("...mk,m->...", V_I * V_I, d[nC:])
    lin_I = lookup_linear_terms(params["linear"], layout.subset("item"),
                                item_arena_ids(layout, item_ids), item_weights)
    return Q_I.contiguous(), t_I, lin_I


def masked_slab_scores(params: dict, Q_I, t_I, lin_I, valid, P_C, s_C,
                       lin_C) -> torch.Tensor:
    """(Bq, n) masked scores in the JAX package's jnp order
    (``bias + lin_C + lin_I + 0.5 (s_C + t_I + term_e)``): the plain
    scoring form, which the tests and the chip check hold the kernel
    path (``a_C + a_I + 0.5 term_e``) against."""
    P = P_C[:, None] + Q_I[None]                       # (Bq, n, rho, k)
    term_e = torch.einsum("qnrk,r->qn", P * P, params["e"])
    pw = 0.5 * (s_C[:, None] + t_I[None, :] + term_e)
    s = params["bias"] + lin_C[:, None] + lin_I[None, :] + pw
    return torch.where(valid[None, :], s, torch.full_like(s, NEG_INF))


def build_corpus_cache(params: dict, cfg, item_ids, item_weights, *,
                       capacity: int | None = None, valid=None) -> ItemCorpusCache:
    """Precompute the item side of a candidate-corpus slab.

    ``item_ids``/``item_weights``: (n, n_item_slots) local item-side slot
    ids on the parameters' device.  ``capacity`` pads the slab (rows past
    n are zero-id filler marked dead); ``valid`` is the (capacity,)
    liveness mask, by default the first n rows.  Rows are computed
    ``BUILD_CHUNK`` at a time, which bounds the transient ``V_I`` gather
    (160 MB at the full config instead of 2.55 GB for a 2^20 slab)
    without changing any row's arithmetic."""
    if cfg.interaction != "dplr":
        raise ValueError("corpus precompute requires interaction='dplr'")
    n = item_ids.shape[0]
    cap = n if capacity is None else int(capacity)
    if cap < n:
        raise ValueError(f"capacity={cap} < corpus size n={n}")
    dev = params["embedding"].device
    if cap > n:
        item_ids = torch.cat([item_ids, item_ids.new_zeros((cap - n, item_ids.shape[1]))])
        item_weights = torch.cat([item_weights,
                                  item_weights.new_zeros((cap - n, item_weights.shape[1]))])
    if valid is None:
        valid = torch.arange(cap, device=dev) < n
    parts = [corpus_rows(params, cfg, item_ids[s:s + BUILD_CHUNK],
                         item_weights[s:s + BUILD_CHUNK])
             for s in range(0, cap, BUILD_CHUNK)]
    Q_I, t_I, lin_I = (torch.cat(x) for x in zip(*parts))
    return ItemCorpusCache(Q_I=Q_I, t_I=t_I, lin_I=lin_I, valid=valid.to(dev))
