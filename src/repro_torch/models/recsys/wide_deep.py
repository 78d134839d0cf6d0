"""Wide & Deep (Cheng et al. 2016, arXiv:1606.07792).  Port of
``repro.models.recsys.wide_deep``.

Assigned config: n_sparse=40 fields, embed_dim=32, MLP 1024-512-256,
interaction = concat.  Wide part: first-order weights over all sparse
features.  Deep part: concat of field embeddings -> ReLU MLP -> logit.
Output: wide + deep (joint training).

``use_dplr_head`` adds a DPLR-FwFM pairwise branch, the paper's technique
as a composable head: second-order field interactions at O(rho m k).

Parameters are a nested dict with the JAX package's keys (``bias``,
``wide``, ``embedding``, ``deep/layer_i/{w,b}``, and ``U``/``e`` for the
head).  Every field lookup is the ``embedding_bag`` kernel on the card
(``embedding.bag``); the MLP is ``torch.matmul``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.dplr import DPLRParams, init_dplr
from repro_torch.core.fields import FeatureLayout
from repro_torch.core.interactions import dplr_pairwise
from repro_torch.embedding.bag import (
    init_embedding_table,
    item_arena_ids,
    lookup_field_embeddings,
    lookup_item_embeddings,
    lookup_linear_terms,
    padded_rows,
)
from repro_torch.device import init_device
from repro_torch.models.layers import apply_mlp, init_mlp, logistic_loss


@dataclasses.dataclass(frozen=True)
class WideDeepConfig:
    layout: FeatureLayout
    embed_dim: int = 32
    mlp_dims: tuple[int, ...] = (1024, 512, 256)
    use_dplr_head: bool = False
    dplr_rank: int = 3
    dtype: Any = torch.float32


def init(generator: torch.Generator, cfg: WideDeepConfig, device=None) -> dict:
    """Random parameters on ``device`` (default: the generator's)."""
    dev = init_device(generator, device)
    d_in = cfg.layout.n_fields * cfg.embed_dim
    rows = padded_rows(cfg.layout.total_vocab)
    params = {
        "bias": torch.zeros((), dtype=cfg.dtype, device=dev),
        "wide": torch.zeros((rows,), dtype=cfg.dtype, device=dev),
        "embedding": init_embedding_table(generator, rows, cfg.embed_dim, dtype=cfg.dtype,
                                          device=dev),
        "deep": init_mlp(generator, [d_in, *cfg.mlp_dims, 1], cfg.dtype, dev),
    }
    if cfg.use_dplr_head:
        params["U"], params["e"] = init_dplr(generator, cfg.layout.n_fields, cfg.dplr_rank,
                                             dtype=cfg.dtype, device=dev)
    return params


def apply(params: dict, cfg: WideDeepConfig, batch: dict, take_fn=None):
    ids, w = batch["ids"], batch["weights"]
    V = lookup_field_embeddings(params["embedding"], cfg.layout, ids, w, take_fn=take_fn)
    wide = lookup_linear_terms(params["wide"], cfg.layout, ids, w, take_fn=take_fn)
    deep = apply_mlp(params["deep"], V.reshape(*V.shape[:-2], -1))[..., 0]
    out = params["bias"] + wide + deep
    if cfg.use_dplr_head:
        out = out + dplr_pairwise(V, DPLRParams(params["U"], params["e"]))
    return out


def loss(params: dict, cfg: WideDeepConfig, batch: dict, take_fn=None):
    return logistic_loss(apply(params, cfg, batch, take_fn=take_fn), batch["label"])


def rank_items(params: dict, cfg: WideDeepConfig, query: dict, take_fn=None):
    """Candidate scoring: context embeddings gathered once, MLP per item.

    Unlike the FwFM family there is no factorization that removes the
    per-item MLP cost: the concat interaction forces a full deep pass per
    candidate.  (This is exactly the serving-cost contrast the paper draws.)

    query: context_ids/context_weights (Bq, n_ctx_slots), item_ids/
    item_weights (Bq, n, n_item_slots).  Returns (Bq, n) scores."""
    layout = cfg.layout
    ctx_layout = layout.subset("context")
    V_C = lookup_field_embeddings(params["embedding"], ctx_layout, query["context_ids"],
                                  query["context_weights"], take_fn=take_fn)
    V_I = lookup_item_embeddings(params["embedding"], layout, query["item_ids"],
                                 query["item_weights"], take_fn=take_fn)
    V_Cb = V_C[..., None, :, :].expand(*V_I.shape[:-2], ctx_layout.n_fields, cfg.embed_dim)
    V = torch.cat([V_Cb, V_I], dim=-2)
    wide_c = lookup_linear_terms(params["wide"], ctx_layout, query["context_ids"],
                                 query["context_weights"], take_fn=take_fn)
    wide_i = lookup_linear_terms(params["wide"], layout.subset("item"),
                                 item_arena_ids(layout, query["item_ids"]),
                                 query["item_weights"], take_fn=take_fn)
    deep = apply_mlp(params["deep"], V.reshape(*V.shape[:-2], -1))[..., 0]
    out = params["bias"] + wide_c[..., None] + wide_i + deep
    if cfg.use_dplr_head:
        out = out + dplr_pairwise(V, DPLRParams(params["U"], params["e"]))
    return out
