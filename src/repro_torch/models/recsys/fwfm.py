"""The paper's model family: FM / FwFM / DPLR-FwFM.  Port of
``repro.models.recsys.fwfm``.

    phi(x) = b0 + <b, x> + pairwise(V)                    (Sections 3-4)

with ``pairwise`` selected by ``cfg.interaction`` ("fm", "fwfm" or
"dplr").  Parameters are a plain dict of tensors with the JAX package's
keys (``bias``, ``linear``, ``embedding``, and ``U``/``e`` or ``R``), so
``repro_torch.interop`` carries weights across unchanged.

Three scoring entry points:
  * ``apply``         - pointwise scoring of full rows (training / eval):
                        the field lookup is the ``embedding_bag`` kernel,
                        and for "fwfm" (full, or pruned by ``pruned_mask``)
                        the pairwise term is the ``fwfm_pairwise`` kernel.
  * ``rank_items``    - Algorithm 1: context cached once per query, then n
                        candidates; for "dplr" the item step is the
                        ``dplr_score_items`` kernel, one launch per batch;
                        ``pruned=`` serves a pruned fwfm model.
  * ``rank_items_mp`` - Algorithm 1 for "dplr" with the arena row-blocked
                        over a mesh's model axis (``launch.mesh``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import ranking as rk
from repro_torch.core.dplr import DPLRParams, dplr_diagonal, init_dplr
from repro_torch.core.fields import FeatureLayout
from repro_torch.core.interactions import (
    dplr_pairwise,
    fm_pairwise,
    fwfm_pairwise,
    pruned_pairwise_dense,
)
from repro_torch.embedding.bag import (
    init_embedding_table,
    item_arena_ids,
    lookup_field_embeddings,
    lookup_item_embeddings,
    lookup_linear_terms,
    padded_rows,
)
from repro_torch.embedding.sharded import block_rows, shard_rows
from repro_torch.kernels import ops as kops
from repro_torch.device import init_device
from repro_torch.models.layers import logistic_loss
from repro_torch.sharding import collectives


@dataclasses.dataclass(frozen=True)
class FwFMConfig:
    layout: FeatureLayout
    embed_dim: int = 8
    interaction: str = "dplr"        # fm | fwfm | dplr
    rank: int = 3                    # DPLR rank rho
    task: str = "ctr"                # ctr (logloss) | rating (mse)
    dtype: Any = torch.float32

    @property
    def n_fields(self) -> int:
        return self.layout.n_fields


def init(generator: torch.Generator, cfg: FwFMConfig, device=None) -> dict:
    """Random parameters on ``device`` (default: the generator's)."""
    dev = init_device(generator, device)
    rows = padded_rows(cfg.layout.total_vocab)
    params = {
        "bias": torch.zeros((), dtype=cfg.dtype, device=dev),
        "linear": torch.zeros((rows,), dtype=cfg.dtype, device=dev),
        "embedding": init_embedding_table(generator, rows, cfg.embed_dim, dtype=cfg.dtype,
                                          device=dev),
    }
    m = cfg.n_fields
    if cfg.interaction == "fwfm":
        # symmetric, zero-diagonal; the full matrix is stored and
        # symmetrized by field_matrix
        R = torch.randn((m, m), generator=generator, device=dev) * 0.1
        params["R"] = R.to(cfg.dtype)
    elif cfg.interaction == "dplr":
        params["U"], params["e"] = init_dplr(generator, m, cfg.rank, dtype=cfg.dtype,
                                             device=dev)
    elif cfg.interaction != "fm":
        raise ValueError(cfg.interaction)
    return params


def field_matrix(params: dict, cfg: FwFMConfig) -> torch.Tensor:
    """Symmetric zero-diagonal R from the raw parameter (fwfm only)."""
    Rp = params["R"]
    R = 0.5 * (Rp + Rp.T)
    return R - torch.diag(torch.diag(R))


def _pairwise(params: dict, cfg: FwFMConfig, V: torch.Tensor,
              pruned_mask: torch.Tensor | None) -> torch.Tensor:
    if cfg.interaction == "fm":
        return fm_pairwise(V)
    if cfg.interaction == "fwfm":
        R = field_matrix(params, cfg)
        if pruned_mask is not None:
            return pruned_pairwise_dense(V, R, pruned_mask)
        return fwfm_pairwise(V, R)
    return dplr_pairwise(V, DPLRParams(params["U"], params["e"]))


def apply(params: dict, cfg: FwFMConfig, batch: dict,
          pruned_mask: torch.Tensor | None = None, take_fn=None) -> torch.Tensor:
    """Pointwise logits/scores for full rows: batch = {ids, weights};
    ``pruned_mask`` (m, m) scores a pruned fwfm model; ``take_fn(table,
    ids)`` gathers the arena rows (``embedding.sharded.make_sharded_take``:
    a row-blocked arena)."""
    ids, w = batch["ids"], batch["weights"]
    V = lookup_field_embeddings(params["embedding"], cfg.layout, ids, w, take_fn=take_fn)
    lin = lookup_linear_terms(params["linear"], cfg.layout, ids, w, take_fn=take_fn)
    return params["bias"] + lin + _pairwise(params, cfg, V, pruned_mask)


def loss(params: dict, cfg: FwFMConfig, batch: dict, take_fn=None) -> torch.Tensor:
    logits = apply(params, cfg, batch, take_fn=take_fn)
    if cfg.task == "ctr":
        return logistic_loss(logits, batch["label"])
    return ((logits - batch["label"].to(logits.dtype)) ** 2).mean()


def _check_context_first(layout: FeatureLayout) -> None:
    kinds = [f.kind for f in layout.fields]
    nC = layout.n_context
    if kinds != ["context"] * nC + ["item"] * (len(kinds) - nC):
        raise ValueError("rank_items requires context fields before item fields")


def context_inputs(params: dict, cfg: FwFMConfig, ctx_ids, ctx_w, take_fn=None):
    """(V_C, lin_C): the context-side lookups shared by ``rank_items`` and
    the corpus serving engine."""
    ctx_layout = cfg.layout.subset("context")
    V_C = lookup_field_embeddings(params["embedding"], ctx_layout, ctx_ids, ctx_w,
                                  take_fn=take_fn)
    lin_C = lookup_linear_terms(params["linear"], ctx_layout, ctx_ids, ctx_w, take_fn=take_fn)
    return V_C, lin_C


def rank_items(params: dict, cfg: FwFMConfig, query: dict, pruned=None,
               take_fn=None) -> torch.Tensor:
    """Score n items for each query context.  Shapes:

        query = {
          "context_ids":     (Bq, n_ctx_slots),
          "context_weights": (Bq, n_ctx_slots),
          "item_ids":        (Bq, n, n_item_slots),
          "item_weights":    (Bq, n, n_item_slots),
        }

    Returns (Bq, n) scores; the context-only work is O(1) per query.
    ``pruned`` is an optional ``repro_torch.core.pruning.PrunedR`` for
    serving a pruned fwfm model; ``take_fn`` as ``apply``'s."""
    layout = cfg.layout
    _check_context_first(layout)
    V_C, lin_C = context_inputs(params, cfg, query["context_ids"],
                                query["context_weights"], take_fn=take_fn)
    V_I = lookup_item_embeddings(params["embedding"], layout, query["item_ids"],
                                 query["item_weights"], take_fn=take_fn)
    lin_I = lookup_linear_terms(params["linear"], layout.subset("item"),
                                item_arena_ids(layout, query["item_ids"]),
                                query["item_weights"], take_fn=take_fn)
    first_order = params["bias"] + lin_C[..., None] + lin_I

    nC = layout.n_context
    if cfg.interaction == "fm":
        pw = rk.fm_score_items(rk.fm_context_cache(V_C), V_I)
    elif cfg.interaction == "dplr":
        p = DPLRParams(params["U"], params["e"])
        cache = rk.dplr_context_cache(p, V_C, nC)
        d = dplr_diagonal(p)
        pw = kops.dplr_score_items(V_I, p.U[:, nC:].contiguous(), p.e,
                                   d[nC:].contiguous(), cache.P_C.contiguous(),
                                   cache.s_C.contiguous())
    elif pruned is not None:
        groups = rk.split_pruned_entries(pruned.entries_i, pruned.entries_j,
                                         pruned.entries_r, nC)
        cache = rk.pruned_context_cache(groups, V_C, layout.n_item)
        pw = rk.pruned_score_items(groups, cache, V_I)
    else:
        R = field_matrix(params, cfg)
        pw = rk.fwfm_score_items(R, rk.fwfm_context_cache(R, V_C, nC), V_I, nC)
    return first_order + pw


# ---------------------------------------------------------------------------
# Model-parallel DPLR scoring: Proposition 1's projection is linear in the
# field embeddings, so it distributes over the arena's row blocks,
#
#     P = U V = U (sum_s V_s) = sum_s (U V_s),
#
# and each shard projects its own rows to rank rho before the partials are
# summed: (rho k + 2) floats an item cross shards instead of (m_I k + ...).
# The d-term stays exact because each one-hot field's row lives on exactly
# one shard (sum ||v_i||^2 = sum_s ||v_i^s||^2).
# ---------------------------------------------------------------------------

def rank_items_mp(params: dict, cfg: FwFMConfig, query: dict, *, mesh) -> torch.Tensor:
    """Algorithm 1 for ``interaction == 'dplr'`` with the arena (and the
    first-order table) row-blocked over ``mesh``'s model axis: shard s
    reads rows ``[s R/D, (s+1) R/D)``, a contiguous view of the arena moved
    to ``mesh.devices[s]`` (no copy where that is the arena's device).
    Each shard projects its own rows to rank rho and forms its part of the
    d-term and first-order scalars; the partials are summed on the mesh's
    first device, in shard order.  ``query`` as ``rank_items``'s; returns
    (Bq, n) scores on the first device.  Requires a one-hot layout
    (multiplicity 1 for every field) and an arena whose rows divide by D.

    ``mesh``: one data replica's model axis (``Mesh.replica``); on a mesh
    with data replicas each replica calls it on its items
    (``launch.steps``' ``+mp`` cells), the reference's ``item_spec``.
    Each shard's work is its position's, and the partials are
    all-reduced over the model axis (``sharding.collectives``)."""
    if cfg.interaction != "dplr":
        raise ValueError("rank_items_mp requires interaction='dplr'")
    layout = cfg.layout
    _check_context_first(layout)
    if not all(f.multiplicity == 1 for f in layout.fields):
        raise ValueError("model-parallel d-term requires one-hot fields")
    nC = layout.n_context
    table, lin = params["embedding"], params["linear"]
    rows_per = block_rows(table, mesh.shape["model"])
    offsets = torch.as_tensor(np.asarray(layout.field_offsets, np.int64))
    first = mesh.devices[0]
    d = -torch.einsum("r,rm,rm->m", params["e"], params["U"], params["U"])
    parts = []
    for s, dev in enumerate(mesh.devices):
        with collectives.at(mesh.coords(s)):
            parts.append(_shard_projection(params, query, table, lin, d, offsets, nC,
                                           s * rows_per, rows_per, dev))
    # the one cross-shard traffic: rank-rho projections and two scalars
    group = mesh.positions()[:len(mesh.devices)]
    P_C, s_C, P_I, s_I = (collectives.all_reduce(list(ts), group)[0] for ts in zip(*parts))
    e = params["e"].to(device=first, dtype=table.dtype)
    P = P_C[:, None] + P_I
    term_e = 0.5 * torch.einsum("qnrk,r->qn", P * P, e)
    return params["bias"].to(first) + s_C[:, None] + s_I + term_e


def _shard_projection(params, query, table, lin, d, offsets, nC, lo, rows_per, dev):
    """One shard's part of ``rank_items_mp``: its rows' rank-rho projections
    of the context and the items, and its parts of the d-term and the
    first-order scalars."""
    block = table[lo:lo + rows_per].to(dev)
    lin_block = lin[lo:lo + rows_per].to(dev)
    U, d_s = params["U"].to(device=dev, dtype=table.dtype), d.to(dev)
    off = offsets.to(dev)
    ctx_w, item_w = (query[k].to(dev) for k in ("context_weights", "item_weights"))
    vC, linC = shard_rows(block, lin_block, lo, query["context_ids"].to(dev) + off[:nC], ctx_w)
    vI, linI = shard_rows(block, lin_block, lo, query["item_ids"].to(dev) + off[nC:], item_w)
    return (
        torch.einsum("rm,qmk->qrk", U[:, :nC], vC),
        0.5 * torch.einsum("qmk,m->q", vC * vC, d_s[:nC]) + linC.sum(-1),
        torch.einsum("rm,qnmk->qnrk", U[:, nC:], vI),
        0.5 * torch.einsum("qnmk,m->qn", vI * vI, d_s[nC:]) + linI.sum(-1),
    )
