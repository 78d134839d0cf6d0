"""The paper's model family: FM / FwFM / DPLR-FwFM.  Port of
``repro.models.recsys.fwfm``.

    phi(x) = b0 + <b, x> + pairwise(V)                    (Sections 3-4)

with ``pairwise`` selected by ``cfg.interaction`` ("fm", "fwfm" or
"dplr").  Parameters are a plain dict of tensors with the JAX package's
keys (``bias``, ``linear``, ``embedding``, and ``U``/``e`` or ``R``), so
``repro_torch.interop`` carries weights across unchanged.

Two scoring entry points:
  * ``apply``       - pointwise scoring of full rows (training / eval)
  * ``rank_items``  - Algorithm 1: context cached once per query, then n
                      candidates; for "dplr" the item step is the
                      ``dplr_score_items`` kernel, one launch per batch.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import ranking as rk
from repro_torch.core.dplr import DPLRParams, dplr_diagonal, init_dplr
from repro_torch.core.fields import FeatureLayout
from repro_torch.core.interactions import dplr_pairwise, fm_pairwise, fwfm_pairwise
from repro_torch.embedding.bag import (
    init_embedding_table,
    item_arena_ids,
    lookup_field_embeddings,
    lookup_item_embeddings,
    lookup_linear_terms,
    padded_rows,
)
from repro_torch.kernels import ops as kops


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


def init(generator: torch.Generator, cfg: FwFMConfig) -> dict:
    """Random parameters on the generator's device."""
    dev = generator.device
    rows = padded_rows(cfg.layout.total_vocab)
    params = {
        "bias": torch.zeros((), dtype=cfg.dtype, device=dev),
        "linear": torch.zeros((rows,), dtype=cfg.dtype, device=dev),
        "embedding": init_embedding_table(generator, rows, cfg.embed_dim, dtype=cfg.dtype),
    }
    m = cfg.n_fields
    if cfg.interaction == "fwfm":
        # symmetric, zero-diagonal; the full matrix is stored and
        # symmetrized by field_matrix
        R = torch.randn((m, m), generator=generator, device=dev) * 0.1
        params["R"] = R.to(cfg.dtype)
    elif cfg.interaction == "dplr":
        params["U"], params["e"] = init_dplr(generator, m, cfg.rank, dtype=cfg.dtype)
    elif cfg.interaction != "fm":
        raise ValueError(cfg.interaction)
    return params


def field_matrix(params: dict, cfg: FwFMConfig) -> torch.Tensor:
    """Symmetric zero-diagonal R from the raw parameter (fwfm only)."""
    Rp = params["R"]
    R = 0.5 * (Rp + Rp.T)
    return R - torch.diag(torch.diag(R))


def _pairwise(params: dict, cfg: FwFMConfig, V: torch.Tensor) -> torch.Tensor:
    if cfg.interaction == "fm":
        return fm_pairwise(V)
    if cfg.interaction == "fwfm":
        return fwfm_pairwise(V, field_matrix(params, cfg))
    return dplr_pairwise(V, DPLRParams(params["U"], params["e"]))


def apply(params: dict, cfg: FwFMConfig, batch: dict) -> torch.Tensor:
    """Pointwise logits/scores for full rows: batch = {ids, weights}."""
    ids, w = batch["ids"], batch["weights"]
    V = lookup_field_embeddings(params["embedding"], cfg.layout, ids, w)
    lin = lookup_linear_terms(params["linear"], cfg.layout, ids, w)
    return params["bias"] + lin + _pairwise(params, cfg, V)


def loss(params: dict, cfg: FwFMConfig, batch: dict) -> torch.Tensor:
    logits = apply(params, cfg, batch)
    y = batch["label"].to(logits.dtype)
    if cfg.task == "ctr":
        # numerically stable binary cross-entropy on logits
        per = (torch.clamp(logits, min=0) - logits * y
               + torch.log1p(torch.exp(-torch.abs(logits))))
    else:
        per = (logits - y) ** 2
    return per.mean()


def _check_context_first(layout: FeatureLayout) -> None:
    kinds = [f.kind for f in layout.fields]
    nC = layout.n_context
    if kinds != ["context"] * nC + ["item"] * (len(kinds) - nC):
        raise ValueError("rank_items requires context fields before item fields")


def context_inputs(params: dict, cfg: FwFMConfig, ctx_ids, ctx_w):
    """(V_C, lin_C): the context-side lookups shared by ``rank_items`` and
    the corpus serving engine."""
    ctx_layout = cfg.layout.subset("context")
    V_C = lookup_field_embeddings(params["embedding"], ctx_layout, ctx_ids, ctx_w)
    lin_C = lookup_linear_terms(params["linear"], ctx_layout, ctx_ids, ctx_w)
    return V_C, lin_C


def rank_items(params: dict, cfg: FwFMConfig, query: dict) -> torch.Tensor:
    """Score n items for each query context.  Shapes:

        query = {
          "context_ids":     (Bq, n_ctx_slots),
          "context_weights": (Bq, n_ctx_slots),
          "item_ids":        (Bq, n, n_item_slots),
          "item_weights":    (Bq, n, n_item_slots),
        }

    Returns (Bq, n) scores; the context-only work is O(1) per query."""
    layout = cfg.layout
    _check_context_first(layout)
    V_C, lin_C = context_inputs(params, cfg, query["context_ids"],
                                query["context_weights"])
    V_I = lookup_item_embeddings(params["embedding"], layout, query["item_ids"],
                                 query["item_weights"])
    lin_I = lookup_linear_terms(params["linear"], layout.subset("item"),
                                item_arena_ids(layout, query["item_ids"]),
                                query["item_weights"])
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
    else:
        R = field_matrix(params, cfg)
        pw = rk.fwfm_score_items(R, rk.fwfm_context_cache(R, V_C, nC), V_I, nC)
    return first_order + pw
