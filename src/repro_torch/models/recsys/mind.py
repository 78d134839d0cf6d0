"""MIND: Multi-Interest Network with Dynamic routing (Li et al. 2019,
arXiv:1904.08030).  Port of ``repro.models.recsys.mind``.

Assigned config: embed_dim=64, n_interests=4, capsule_iters=3.

Pipeline: user behaviour history (item ids) -> behaviour capsules ->
Behavior-to-Interest (B2I) dynamic routing with a shared bilinear map S ->
``n_interests`` interest capsules (squash nonlinearity) -> label-aware
attention for training.  Retrieval serving scores a candidate as
max_k <interest_k, e_item>: the per-candidate cost is O(K k), already
"item-only" in the paper's sense.

Routing logits are randomly initialized and NOT learned (fixed random init
breaks interest symmetry): ``b_init`` is detached, so its gradient is zero,
as ``stop_gradient`` gives in the JAX model.  Label-aware attention is what
the JAX code computes, ``softmax(label_pow * dots)``.

Every history, target, negative and candidate gather is ``gather_rows``
(the ``embedding_bag`` kernel on the card, one slot a bag), or the
``take_fn`` that ``loss`` and ``rank_items`` take, as the JAX model's do
(``apply`` takes none there either).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.fields import FeatureLayout
from repro_torch.embedding.bag import gather_rows, init_embedding_table, padded_rows
from repro_torch.device import init_device
from repro_torch.models.layers import glorot


@dataclasses.dataclass(frozen=True)
class MINDConfig:
    layout: FeatureLayout          # context fields + 1 item field (shared vocab)
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    seq_len: int = 50
    label_pow: float = 2.0         # p in label-aware attention
    n_neg: int = 8                 # sampled-softmax negatives (training)
    dtype: Any = torch.float32


def init(generator: torch.Generator, cfg: MINDConfig, device=None) -> dict:
    """Random parameters on ``device`` (default: the generator's)."""
    d, dev = cfg.embed_dim, init_device(generator, device)
    return {
        "embedding": init_embedding_table(generator, padded_rows(cfg.layout.total_vocab), d,
                                          dtype=cfg.dtype, device=dev),
        "S": glorot(generator, (d, d), cfg.dtype, dev),          # shared bilinear map
        "b_init": torch.randn((cfg.n_interests, cfg.seq_len), generator=generator,
                              device=dev).to(cfg.dtype),
    }


def _item_arena_offset(cfg: MINDConfig) -> int:
    return int(cfg.layout.field_offsets[cfg.layout.n_context])


def _squash(v):
    n2 = (v * v).sum(dim=-1, keepdim=True)
    return (n2 / (1.0 + n2)) * v * torch.rsqrt(n2 + 1e-9)


def user_interests(params: dict, cfg: MINDConfig, hist_ids, hist_mask, take_fn=None):
    """(batch..., L) -> (batch..., K, d) interest capsules via B2I routing."""
    take = take_fn or gather_rows
    e = take(params["embedding"], hist_ids + _item_arena_offset(cfg))         # (..., L, d)
    low = (e @ params["S"]) * hist_mask[..., None]                           # S e_i
    b = params["b_init"].detach()                                            # (K, L), frozen
    b = b.expand(*low.shape[:-2], cfg.n_interests, cfg.seq_len)
    for _ in range(cfg.capsule_iters):
        logits = torch.where(hist_mask[..., None, :] > 0, b, -1e30)
        w = torch.softmax(logits, dim=-2)                                    # over interests
        caps = _squash(torch.einsum("...kl,...ld->...kd", w * hist_mask[..., None, :], low))
        b = b + torch.einsum("...kd,...ld->...kl", caps, low)
    return caps


def label_aware_user_vec(cfg: MINDConfig, interests, target_e):
    """Label-aware attention: softmax(label_pow * dots) combination."""
    dots = torch.einsum("...kd,...d->...k", interests, target_e)
    attn = torch.softmax(cfg.label_pow * dots, dim=-1)
    return torch.einsum("...k,...kd->...d", attn, interests)


def loss(params: dict, cfg: MINDConfig, batch: dict, take_fn=None):
    """Sampled softmax over {target} + n_neg sampled item ids.

    batch: hist_ids (B, L), hist_mask (B, L), target_id (B,),
           neg_ids (B, n_neg).
    """
    off = _item_arena_offset(cfg)
    take = take_fn or gather_rows
    interests = user_interests(params, cfg, batch["hist_ids"], batch["hist_mask"],
                               take_fn=take_fn)
    tgt_e = take(params["embedding"], batch["target_id"] + off)
    user = label_aware_user_vec(cfg, interests, tgt_e)
    neg_e = take(params["embedding"], batch["neg_ids"] + off)
    pos_logit = (user * tgt_e).sum(dim=-1, keepdim=True)
    neg_logit = torch.einsum("...d,...nd->...n", user, neg_e)
    logits = torch.cat([pos_logit, neg_logit], dim=-1)
    return -torch.log_softmax(logits, dim=-1)[..., 0].mean()


def apply(params: dict, cfg: MINDConfig, batch: dict):
    """Pointwise score of (user history, target item), eval convenience."""
    interests = user_interests(params, cfg, batch["hist_ids"], batch["hist_mask"])
    tgt_e = gather_rows(params["embedding"], batch["target_id"] + _item_arena_offset(cfg))
    return torch.einsum("...kd,...d->...k", interests, tgt_e).amax(dim=-1)


def rank_items(params: dict, cfg: MINDConfig, query: dict, take_fn=None):
    """Retrieval scoring: max over interests of <interest, item>.

    query: hist_ids (Bq, L), hist_mask (Bq, L), item_ids (Bq, n, 1).
    The interest extraction runs ONCE per query; per-candidate cost is a
    K x d dot, a batched (n, d) @ (d, K) product -> max over K.
    """
    interests = user_interests(params, cfg, query["hist_ids"], query["hist_mask"],
                               take_fn=take_fn)
    item_e = (take_fn or gather_rows)(params["embedding"],
                                      query["item_ids"][..., 0] + _item_arena_offset(cfg))
    scores = torch.einsum("...nd,...kd->...nk", item_e, interests)
    return scores.amax(dim=-1)
