"""Behavior Sequence Transformer (Chen et al. 2019, arXiv:1905.06874).
Port of ``repro.models.recsys.bst``.

Assigned config: embed_dim=32, seq_len=20, n_blocks=1, n_heads=8,
MLP 1024-512-256.  The user's behaviour history (item ids) plus the target
item form a (seq_len+1)-token sequence; learned positional embeddings are
added; ``n_blocks`` post-LN transformer blocks run over it; the flattened
sequence states are concatenated with the "other features" (context field
embeddings) and fed to the MLP head.

Layout convention: all context fields first, then exactly ONE item field,
the item id vocabulary shared between history tokens and the target item.

The field lookup is the ``embedding_bag`` kernel on the card, and so are
the history and target gathers (``gather_rows``: one slot a bag), whose
gradient in the table is then the backward kernel's fixed-order sum.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.fields import FeatureLayout
from repro_torch.device import init_device
from repro_torch.embedding.bag import (
    gather_rows,
    init_embedding_table,
    lookup_field_embeddings,
    padded_rows,
)
from repro_torch.models.layers import (
    apply_layer_norm,
    apply_mha,
    apply_mlp,
    init_layer_norm,
    init_mha,
    init_mlp,
    logistic_loss,
)


@dataclasses.dataclass(frozen=True)
class BSTConfig:
    layout: FeatureLayout          # context fields + 1 item field
    embed_dim: int = 32
    seq_len: int = 20
    n_blocks: int = 1
    n_heads: int = 8
    ffn_mult: int = 4
    mlp_dims: tuple[int, ...] = (1024, 512, 256)
    dtype: Any = torch.float32

    @property
    def n_tokens(self) -> int:
        return self.seq_len + 1   # history + target item


def init(generator: torch.Generator, cfg: BSTConfig, device=None) -> dict:
    """Random parameters on ``device`` (default: the generator's)."""
    dev = init_device(generator, device)
    d = cfg.embed_dim
    n_ctx = cfg.layout.n_context
    params = {
        "embedding": init_embedding_table(generator, padded_rows(cfg.layout.total_vocab), d,
                                          dtype=cfg.dtype, device=dev),
        "pos": (torch.randn((cfg.n_tokens, d), generator=generator, device=dev)
                * 0.02).to(cfg.dtype),
        "head": init_mlp(generator, [cfg.n_tokens * d + n_ctx * d, *cfg.mlp_dims, 1],
                         cfg.dtype, dev),
    }
    for i in range(cfg.n_blocks):
        params[f"block_{i}"] = {
            "ln1": init_layer_norm(d, cfg.dtype, dev),
            "mha": init_mha(generator, d, d // cfg.n_heads, cfg.n_heads, dtype=cfg.dtype,
                            device=dev),
            "ln2": init_layer_norm(d, cfg.dtype, dev),
            "ffn": init_mlp(generator, [d, cfg.ffn_mult * d, d], cfg.dtype, dev),
        }
    return params


def _item_arena_offset(cfg: BSTConfig) -> int:
    return int(cfg.layout.field_offsets[cfg.layout.n_context])


def _encode_sequence(params: dict, cfg: BSTConfig, hist_ids, hist_mask, target_ids,
                     take_fn=None):
    """(batch..., L) history + (batch...,) target -> (batch..., L+1, d)."""
    table = params["embedding"]
    take = take_fn or gather_rows
    off = _item_arena_offset(cfg)
    hist_e = take(table, hist_ids + off)
    tgt_e = take(table, target_ids + off)
    seq = torch.cat([hist_e, tgt_e[..., None, :]], dim=-2) + params["pos"]
    mask1d = torch.cat([hist_mask, hist_mask.new_ones((*hist_mask.shape[:-1], 1))], dim=-1)
    attn_mask = mask1d[..., None, :] * mask1d[..., :, None]
    h = seq
    for i in range(cfg.n_blocks):
        blk = params[f"block_{i}"]
        a = apply_mha(blk["mha"], h, n_heads=cfg.n_heads, mask=attn_mask)
        h = apply_layer_norm(blk["ln1"], h + a)
        f = apply_mlp(blk["ffn"], h, activation=F.leaky_relu)
        h = apply_layer_norm(blk["ln2"], h + f)
    return h * mask1d[..., None]


def apply(params: dict, cfg: BSTConfig, batch: dict, take_fn=None):
    """batch: ids/weights (context + item slots), hist_ids, hist_mask."""
    layout = cfg.layout
    V = lookup_field_embeddings(params["embedding"], layout, batch["ids"], batch["weights"],
                                take_fn=take_fn)
    n_ctx = layout.n_context
    target_ids = batch["ids"][..., layout.n_slots - 1]   # single item slot (last)
    h = _encode_sequence(params, cfg, batch["hist_ids"], batch["hist_mask"], target_ids,
                         take_fn=take_fn)
    feats = torch.cat([h.reshape(*h.shape[:-2], -1),
                       V[..., :n_ctx, :].reshape(*V.shape[:-2], -1)], dim=-1)
    return apply_mlp(params["head"], feats, activation=F.leaky_relu)[..., 0]


def loss(params: dict, cfg: BSTConfig, batch: dict, take_fn=None):
    return logistic_loss(apply(params, cfg, batch, take_fn=take_fn), batch["label"])


def rank_items(params: dict, cfg: BSTConfig, query: dict, take_fn=None):
    """Score n candidate items: the target item sits INSIDE the transformer
    sequence, so the whole encoder re-runs per candidate (cost profile:
    O(n * L^2 d), the expensive end of the serving spectrum).

    query: context_ids/context_weights, hist_ids (Bq, L), hist_mask,
           item_ids (Bq, n, 1).  Returns (Bq, n) scores.
    """
    layout = cfg.layout
    ctx_layout = layout.subset("context")
    V_C = lookup_field_embeddings(params["embedding"], ctx_layout, query["context_ids"],
                                  query["context_weights"], take_fn=take_fn)
    n = query["item_ids"].shape[-2]
    lead = query["hist_ids"].shape[:-1]
    hist_ids = query["hist_ids"][..., None, :].expand(*lead, n, cfg.seq_len)
    hist_mask = query["hist_mask"][..., None, :].expand(*lead, n, cfg.seq_len)
    h = _encode_sequence(params, cfg, hist_ids, hist_mask, query["item_ids"][..., 0],
                         take_fn=take_fn)
    ctx_flat = V_C.reshape(*V_C.shape[:-2], -1)
    ctx_flat = ctx_flat[..., None, :].expand(*h.shape[:-3], n, ctx_flat.shape[-1])
    feats = torch.cat([h.reshape(*h.shape[:-2], -1), ctx_flat], dim=-1)
    return apply_mlp(params["head"], feats, activation=F.leaky_relu)[..., 0]
