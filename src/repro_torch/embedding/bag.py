"""EmbeddingBag substrate.  Port of ``repro.embedding.bag``.

All fields share one arena table with per-field row offsets (one
allocation, one gather).  A lookup adds each slot's field offset to its
local id and sums the weighted rows into per-field bags over the static
slot -> bag map (multi-hot fields average their values, Section 3.2).
The gather and bag-sum is one call of ``kops.embedding_bag``: the CUDA
kernel for a table on the card, its plain version for one on the CPU.

A layout's static arrays (slot offsets, the slot -> field map and its
CSR for the kernel) are made and copied to the device once per (layout,
device) and kept (``_statics``), not on every lookup.

Every lookup takes ``take_fn(table, ids) -> rows``, as the reference's
do: the gather of arena rows for a table that is not whole on one device
(``embedding.sharded.make_sharded_take``: the arena row-blocked over a
mesh).  With one, a lookup gathers its rows through it and sums them
into bags by kernel 5 over the gathered rows (one row each slot, in slot
order); without one (the default) the one kernel call above does both.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.fields import FeatureLayout
from repro_torch.device import init_device
from repro_torch.kernels import ops as kops


class _Statics(NamedTuple):
    offsets: torch.Tensor    # (n_slots,) arena offset added to each local id
    bags: kops.BagMap        # slot -> bag (field) map


@functools.lru_cache(maxsize=None)
def _statics(layout: FeatureLayout, kind: str | None, device: str) -> _Statics:
    """The static maps of ``layout`` (``kind="item"``: of its item fields,
    offsets shifted past the context rows), on ``device``.  Offsets are
    int32 where every arena row id fits, so int32 local ids stay int32."""
    shift = 0
    if kind == "item":
        shift = layout.subset("context").total_vocab
        layout = layout.subset("item")
    offsets = layout.slot_offsets.astype(np.int64) + shift
    dtype = torch.int32 if shift + layout.total_vocab < 2**31 else torch.int64
    return _Statics(torch.as_tensor(offsets, dtype=dtype, device=device),
                    kops.bag_map(layout.slot_to_field, layout.n_fields, device))


def prepare_lookups(layout: FeatureLayout, device) -> None:
    """Copy ``layout``'s static maps to ``device`` now, unless they are
    there already.  Otherwise the first lookup of a layout on a device
    makes those host-to-device copies, which wait for the card: the
    serving runtime calls this when it builds a slab, so that no scoring
    dispatch copies (``serving.sanitize.scoring_guard`` raises on one).
    ``device`` as the table's (``cuda:0``, not ``cuda``)."""
    _statics(layout, None, str(torch.device(device)))


def init_embedding_table(generator: torch.Generator, n_rows: int, dim: int, *,
                         scale: float | None = None,
                         dtype=torch.float32, device=None) -> torch.Tensor:
    """An embedding arena on ``device`` (default: the generator's), N(0,
    scale^2) with default scale 1/sqrt(dim) (FM-standard)."""
    if scale is None:
        scale = 1.0 / np.sqrt(dim)
    table = torch.randn((n_rows, dim), generator=generator,
                        device=init_device(generator, device))
    return table.mul_(scale).to(dtype)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor,
                  segment_ids: np.ndarray, n_bags: int, take_fn=None) -> torch.Tensor:
    """``out[..., b, :] = sum_{s: seg[s] = b} w_s * table[id_s]`` for
    arena-global ``ids (..., n_slots)``; weights are cast to the table
    dtype before the product.  Copies the map to the table's device on
    every call: the lookups below use the copy that ``_statics`` keeps."""
    if take_fn is not None:
        rows = take_fn(table, ids)
        return bag_rows(rows, weights, kops.bag_map(segment_ids, n_bags, rows.device))
    return _bag(table, ids, weights, kops.bag_map(segment_ids, n_bags, table.device))


def _bag(table, ids, weights, bags: kops.BagMap):
    w = weights.to(table.dtype).contiguous()
    return kops.embedding_bag(table, ids.contiguous(), w, bags)


def bag_rows(rows, weights, bags: kops.BagMap):
    """``(..., n_bags, k)`` bags of gathered ``rows (..., n_slots, k)``:
    ``sum_{s: seg[s] = b} w_s * rows[..., s, :]``, kernel 5 over the rows
    as a table of their own (slot ``s`` of row ``i`` of the batch names its
    row ``i * n_slots + s``), differentiable in ``rows``."""
    n_slots, k = rows.shape[-2:]
    flat = rows.reshape(-1, k)
    dtype = torch.int32 if flat.shape[0] < 2**31 else torch.int64
    ids = torch.arange(flat.shape[0], dtype=dtype, device=rows.device)
    return _bag(flat, ids.view(*rows.shape[:-1]), weights, bags)


def _lookup(table, st: _Statics, ids, weights, take_fn=None):
    if take_fn is None:
        return _bag(table, ids + st.offsets, weights, st.bags)
    return bag_rows(take_fn(table, ids + st.offsets), weights, st.bags)


def lookup_field_embeddings(table, layout: FeatureLayout, ids, weights, take_fn=None):
    """(batch..., n_fields, k) field embedding matrix V from local ids."""
    return _lookup(table, _statics(layout, None, str(table.device)), ids, weights, take_fn)


def item_arena_ids(layout: FeatureLayout, ids):
    """Arena-global ids for item-side local slot ids: the arena stores the
    context fields' rows first, so item ids shift by the context vocab."""
    return ids + layout.subset("context").total_vocab


def lookup_item_embeddings(table, layout: FeatureLayout, ids, weights, take_fn=None):
    """(..., m_item, k) item-field embedding matrix V_I from local item ids
    (``layout`` is the full context + item layout)."""
    return _lookup(table, _statics(layout, "item", str(table.device)), ids, weights, take_fn)


@functools.lru_cache(maxsize=None)
def one_slot_bags(n: int, device: str) -> kops.BagMap:
    """The map of ``n`` slots, each its own bag, on ``device`` (kept)."""
    return kops.bag_map(np.arange(n), n, device)


def gather_rows(table, ids):
    """``(..., k)`` rows ``table[ids]`` for arena-global ``ids (...)``: the
    JAX models' ``jnp.take(table, ids, axis=0)`` for a behaviour history,
    a target or sampled negatives.  One ``kops.embedding_bag`` call with
    one slot a bag and weight 1, which is bitwise the row; on the card its
    gradient in the table is the backward kernel's fixed-order sum, so a
    training step repeats bitwise (``index_put_`` with accumulation does
    not promise an order there)."""
    ids = ids[..., None].contiguous()
    ones = torch.ones(ids.shape, dtype=table.dtype, device=table.device)
    return kops.embedding_bag(table, ids, ones, one_slot_bags(1, str(table.device)))[..., 0, :]


def linear_products(table, layout: FeatureLayout, ids, weights, take_fn=None):
    """(batch..., n_slots) products ``w_s * b[id_s]`` of the first-order
    term, before their sum (``lookup_linear_terms``)."""
    tab = table.reshape(-1)
    offsets = _statics(layout, None, str(table.device)).offsets
    if take_fn is not None:
        return take_fn(tab.reshape(-1, 1), ids + offsets)[..., 0] * weights.to(tab.dtype)
    return tab[ids.long() + offsets] * weights.to(tab.dtype)


def lookup_linear_terms(table, layout: FeatureLayout, ids, weights, take_fn=None):
    """(batch...,) first-order term <b, x> of the FM/FwFM model."""
    return linear_products(table, layout, ids, weights, take_fn).sum(dim=-1)


def padded_rows(n_rows: int, multiple: int = 2048) -> int:
    """Arena rows padded to a multiple (row-sharding divides any mesh axis)."""
    return ((n_rows + multiple - 1) // multiple) * multiple
