"""EmbeddingBag substrate.  Port of ``repro.embedding.bag``.

All fields share one arena table with per-field row offsets (one
allocation, one gather).  A lookup gathers the slot rows, weights them,
and adds them into per-field bags over the static slot -> bag map with
``index_add_`` (multi-hot fields average their values, Section 3.2).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fields import FeatureLayout


def init_embedding_table(generator: torch.Generator, n_rows: int, dim: int, *,
                         scale: float | None = None,
                         dtype=torch.float32) -> torch.Tensor:
    """An embedding arena on the generator's device, N(0, scale^2) with
    default scale 1/sqrt(dim) (FM-standard)."""
    if scale is None:
        scale = 1.0 / np.sqrt(dim)
    table = torch.randn((n_rows, dim), generator=generator, device=generator.device)
    return table.mul_(scale).to(dtype)


def _static(index: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(index, np.int64), device=like.device)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor,
                  segment_ids: np.ndarray, n_bags: int) -> torch.Tensor:
    """``out[..., b, :] = sum_{s: seg[s] = b} w_s * table[id_s]`` for
    arena-global ``ids (..., n_slots)``; weights are cast to the table
    dtype before the product."""
    flat = table[ids.long()]                                  # (..., n_slots, k)
    weighted = flat * weights[..., None].to(flat.dtype)
    out = torch.zeros((*ids.shape[:-1], n_bags, table.shape[-1]),
                      dtype=flat.dtype, device=flat.device)
    return out.index_add_(out.ndim - 2, _static(segment_ids, table), weighted)


def lookup_field_embeddings(table, layout: FeatureLayout, ids, weights):
    """(batch..., n_fields, k) field embedding matrix V from local ids."""
    arena_ids = ids.long() + _static(layout.slot_offsets, table)
    return embedding_bag(table, arena_ids, weights, layout.slot_to_field,
                         layout.n_fields)


def item_arena_ids(layout: FeatureLayout, ids):
    """Arena-global ids for item-side local slot ids: the arena stores the
    context fields' rows first, so item ids shift by the context vocab."""
    return ids.long() + layout.subset("context").total_vocab


def lookup_item_embeddings(table, layout: FeatureLayout, ids, weights):
    """(..., m_item, k) item-field embedding matrix V_I from local item ids
    (``layout`` is the full context + item layout)."""
    item_layout = layout.subset("item")
    arena = item_arena_ids(layout, ids) + _static(item_layout.slot_offsets, table)
    return embedding_bag(table, arena, weights, item_layout.slot_to_field,
                         item_layout.n_fields)


def lookup_linear_terms(table, layout: FeatureLayout, ids, weights):
    """(batch...,) first-order term <b, x> of the FM/FwFM model."""
    tab = table.reshape(-1)
    arena_ids = ids.long() + _static(layout.slot_offsets, table)
    return (tab[arena_ids] * weights.to(tab.dtype)).sum(dim=-1)


def padded_rows(n_rows: int, multiple: int = 2048) -> int:
    """Arena rows padded to a multiple (row-sharding divides any mesh axis)."""
    return ((n_rows + multiple - 1) // multiple) * multiple
