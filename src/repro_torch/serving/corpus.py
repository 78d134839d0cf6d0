"""Item-corpus precomputation for DPLR-FwFM serving.  Port of
``repro.serving.corpus``.

Proposition 1's projection ``P = U V`` is linear in the field embeddings,
so the item side of every score is context-independent.  It is computed
once per row per model refresh, and again only for the rows that churn:

    Q_I[i]   = U_I @ V_I[i]                      (cap, rho, k)
    t_I[i]   = sum_{f in item fields} d_f ||v_f||^2        (cap,)
    lin_I[i] = <b_item, x_item[i]>                         (cap,)
    a_I[i]   = lin_I[i] + 0.5 * t_I[i]                     (cap,)

and a query costs only its context cache (P_C, s_C, lin_C) plus O(rho k)
per item:

    score[q, i] = b0 + lin_C[q] + lin_I[i]
                + 0.5 * (s_C[q] + t_I[i] + sum_r e_r ||P_C[q,r] + Q_I[i,r]||^2)

The cache is a capacity-padded slab: every leading axis is ``capacity``
(a power of two), ``valid`` marks the live slots, a dead slot scores
exactly ``NEG_INF``, and slot assignments are stable across churn and
model refresh; the slab grows only by doubling.

A row's bits depend on its item alone: ``corpus_rows`` sums in a fixed
pairwise order with elementwise operations only, so a row computed in a churn
write of any size, in a rebuild, or on a shard of a sharded slab is the
same row.  (A matrix product or a reduction chooses its summation order
by the shape of the batch it is given.)

Sharded layout (``serving.sharded``): on a mesh of D shards, global slot
``g`` is owned by shard ``g % D`` at its local row ``g // D``.  The
physical view of a global-order array is ``physical(x, D)``, a
``(capacity // D, D, ...)`` reshape whose ``[l, s]`` is global slot
``l * D + s``: shard ``s``'s rows are its column ``[:, s]``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.dplr import DPLRParams, dplr_diagonal
from repro_torch.embedding.bag import (
    item_arena_ids,
    linear_products,
    lookup_item_embeddings,
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
    a_I: torch.Tensor     # (cap,)         the kernels' per-item addend, item_addend()

    @property
    def capacity(self) -> int:
        return self.Q_I.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        """The slab's type (``Q_I``'s, ``a_I``'s)."""
        return self.Q_I.dtype


def physical(x, D: int):
    """The ``(capacity // D, D, ...)`` view of a global-order
    ``(capacity, ...)`` array (numpy or torch): ``[l, s]`` is global slot
    ``l * D + s``, shard ``s``'s local row ``l``.  A reshape, no copy."""
    return x.reshape(x.shape[0] // D, D, *x.shape[1:])


def pad_cache(c: ItemCorpusCache, extra: int) -> ItemCorpusCache:
    """``c`` with ``extra`` dead zero rows appended (slab growth): every
    existing row keeps its index."""
    return ItemCorpusCache(
        Q_I=torch.cat([c.Q_I, c.Q_I.new_zeros((extra, *c.Q_I.shape[1:]))]),
        t_I=torch.cat([c.t_I, c.t_I.new_zeros(extra)]),
        lin_I=torch.cat([c.lin_I, c.lin_I.new_zeros(extra)]),
        valid=torch.cat([c.valid, c.valid.new_zeros(extra)]),
        a_I=torch.cat([c.a_I, c.a_I.new_zeros(extra)]),
    )


def item_addend(t_I, lin_I):
    """The fused per-item scalar the kernels add, ``lin_I + 0.5 * t_I``:
    stored in the slab when its rows are built or written, so that no
    scoring call recomputes it over the whole capacity."""
    return lin_I + 0.5 * t_I


def _tree_sum(x, dim: int):
    """``x`` summed over ``dim`` in a fixed pairwise order: the first half
    added elementwise to the second until one remains, an odd one out
    added to the last sum.  Each element's bits depend on its own values
    alone, not on the other axes' sizes (a reduction picks its order by
    the shape it is given), and the whole sum is O(log size) launches."""
    while x.shape[dim] > 1:
        n = x.shape[dim]
        h = n // 2
        head = x.narrow(dim, 0, h) + x.narrow(dim, h, h)
        if n % 2:
            head.narrow(dim, h - 1, 1).add_(x.narrow(dim, n - 1, 1))
        x = head
    return x.squeeze(dim)


def corpus_rows(params: dict, cfg, item_ids, item_weights):
    """(Q_I, t_I, lin_I) rows for a batch of items: the per-row math of
    ``build_corpus_cache``, shared by the full build, churn writes and
    every shard of a sharded slab.

        Q_I[i, r] = sum_m U_I[r, m] V_I[i, m]
        t_I[i]    = sum_m d_m sum_k V_I[i, m, k]^2
        lin_I[i]  = sum_s w_s b[id_s]

    each sum over one stacked product in ``_tree_sum``'s fixed order, so
    a row's bits depend on its item alone, not on the batch it is
    computed in, nor on the device's choice of a product's algorithm for
    that batch's shape.  The sums run in float64 and are rounded once to
    the params' type (the squares and the products ``w_s b[id_s]`` in
    that type first, as ``einsum`` and ``lookup_linear_terms`` form
    them): the row is then the rounding of its exact value in all but
    rare cases, whatever the order, as close to the reference's
    ``einsum`` rows as any order of float32 adds could be."""
    layout = cfg.layout
    nC = layout.n_context
    acc = torch.float64
    p = DPLRParams(params["U"], params["e"])
    d = dplr_diagonal(p)[nC:].to(acc)
    U_I = p.U[:, nC:].to(acc)
    V_I = lookup_item_embeddings(params["embedding"], layout, item_ids,
                                 item_weights)                      # (n, mI, k)
    Q = _tree_sum(U_I[:, :, None] * V_I.to(acc)[:, None], dim=-2)    # (n, rho, k)
    t = _tree_sum(_tree_sum((V_I * V_I).to(acc), dim=-1) * d, dim=-1)
    lin = _tree_sum(linear_products(params["linear"], layout.subset("item"),
                                    item_arena_ids(layout, item_ids),
                                    item_weights).to(acc), dim=-1)
    dt = V_I.dtype
    return Q.to(dt).contiguous(), t.to(dt), lin.to(params["linear"].dtype)


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
    return ItemCorpusCache(Q_I=Q_I, t_I=t_I, lin_I=lin_I, valid=valid.to(dev),
                           a_I=item_addend(t_I, lin_I))
