"""AutoInt (Song et al. 2019, arXiv:1810.11921).  Port of
``repro.models.recsys.autoint``.

Assigned config: n_sparse=39, embed_dim=16, 3 interacting (self-attention)
layers, 2 heads, d_attn=32.  Each interacting layer applies multi-head
self-attention over the m field embeddings (unscaled, as the JAX model)
with a residual projection and ReLU; the final field states are
concatenated and mapped to a logit, plus a global first-order term.

AutoInt's field self-attention is O(m^2 (d_attn + k)) per example, the
same quadratic-in-fields cost class as full FwFM.  ``use_dplr_head``
optionally adds the paper's O(rho m k) DPLR-FwFM branch.

Parameters: ``bias``, ``linear``, ``embedding``, ``out_w``, ``attn_i/
{wq,wk,wv,wo}``, ``res_i``, and ``U``/``e`` for the head.  Field lookups
are the ``embedding_bag`` kernel on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

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
from repro_torch.models.layers import apply_mha, glorot, init_mha, logistic_loss


@dataclasses.dataclass(frozen=True)
class AutoIntConfig:
    layout: FeatureLayout
    embed_dim: int = 16
    n_attn_layers: int = 3
    n_heads: int = 2
    d_attn: int = 32          # total attention width (per paper's config)
    use_dplr_head: bool = False
    dplr_rank: int = 3
    dtype: Any = torch.float32


def init(generator: torch.Generator, cfg: AutoIntConfig, device=None) -> dict:
    """Random parameters on ``device`` (default: the generator's)."""
    dev = init_device(generator, device)
    d_head = cfg.d_attn // cfg.n_heads
    d = cfg.embed_dim
    layers = {}
    for i in range(cfg.n_attn_layers):
        d_in = d if i == 0 else cfg.d_attn
        layers[f"attn_{i}"] = init_mha(generator, d_in, d_head, cfg.n_heads,
                                       d_out=cfg.d_attn, dtype=cfg.dtype, device=dev)
        layers[f"res_{i}"] = glorot(generator, (d_in, cfg.d_attn), cfg.dtype, dev)
    rows = padded_rows(cfg.layout.total_vocab)
    params = {
        "bias": torch.zeros((), dtype=cfg.dtype, device=dev),
        "linear": torch.zeros((rows,), dtype=cfg.dtype, device=dev),
        "embedding": init_embedding_table(generator, rows, d, dtype=cfg.dtype, device=dev),
        "out_w": glorot(generator, (cfg.layout.n_fields * cfg.d_attn, 1), cfg.dtype, dev),
        **layers,
    }
    if cfg.use_dplr_head:
        params["U"], params["e"] = init_dplr(generator, cfg.layout.n_fields, cfg.dplr_rank,
                                             dtype=cfg.dtype, device=dev)
    return params


def _interact(params: dict, cfg: AutoIntConfig, V):
    h = V
    for i in range(cfg.n_attn_layers):
        attn = apply_mha(params[f"attn_{i}"], h, n_heads=cfg.n_heads, scaled=False)
        h = F.relu(attn + h @ params[f"res_{i}"])
    return h


def _logit(params: dict, cfg: AutoIntConfig, V):
    h = _interact(params, cfg, V)
    return (h.reshape(*h.shape[:-2], -1) @ params["out_w"])[..., 0]


def apply(params: dict, cfg: AutoIntConfig, batch: dict, take_fn=None):
    ids, w = batch["ids"], batch["weights"]
    V = lookup_field_embeddings(params["embedding"], cfg.layout, ids, w, take_fn=take_fn)
    logit = _logit(params, cfg, V)
    lin = lookup_linear_terms(params["linear"], cfg.layout, ids, w, take_fn=take_fn)
    out = params["bias"] + lin + logit
    if cfg.use_dplr_head:
        out = out + dplr_pairwise(V, DPLRParams(params["U"], params["e"]))
    return out


def loss(params: dict, cfg: AutoIntConfig, batch: dict, take_fn=None):
    return logistic_loss(apply(params, cfg, batch, take_fn=take_fn), batch["label"])


def rank_items(params: dict, cfg: AutoIntConfig, query: dict, take_fn=None):
    """Candidate scoring.  Field self-attention must see the joint
    (context + item) field set, so, unlike DPLR-FwFM, the full O(m^2)
    interaction re-runs per candidate; only the embedding gathers of the
    context side are shared.  This is the cost profile the paper's
    technique removes for FwFM-class models.  Query as
    ``wide_deep.rank_items``'s; returns (Bq, n) scores."""
    layout = cfg.layout
    ctx_layout = layout.subset("context")
    V_C = lookup_field_embeddings(params["embedding"], ctx_layout, query["context_ids"],
                                  query["context_weights"], take_fn=take_fn)
    V_I = lookup_item_embeddings(params["embedding"], layout, query["item_ids"],
                                 query["item_weights"], take_fn=take_fn)
    V_Cb = V_C[..., None, :, :].expand(*V_I.shape[:-2], ctx_layout.n_fields, cfg.embed_dim)
    V = torch.cat([V_Cb, V_I], dim=-2)
    logit = _logit(params, cfg, V)
    lin_c = lookup_linear_terms(params["linear"], ctx_layout, query["context_ids"],
                                query["context_weights"], take_fn=take_fn)
    lin_i = lookup_linear_terms(params["linear"], layout.subset("item"),
                                item_arena_ids(layout, query["item_ids"]),
                                query["item_weights"], take_fn=take_fn)
    out = params["bias"] + lin_c[..., None] + lin_i + logit
    if cfg.use_dplr_head:
        out = out + dplr_pairwise(V, DPLRParams(params["U"], params["e"]))
    return out
