"""Shared layout builders for the recsys architectures.

Production embedding tables are 1e6–1e9 rows; we size each arch's arena from
its paper's described workload, with a few huge id fields (user/item ids), a
middle tier, and many small categorical fields — the Zipf-shaped reality of
ads/recsys feature sets.
"""
from __future__ import annotations

from repro_torch.core.fields import CONTEXT, ITEM, FieldSpec, FeatureLayout


def tiered_layout(context_tiers, item_tiers, multi_hot: dict | None = None):
    """tiers: list of (count, vocab).  Context fields first (required by the
    ranking engine)."""
    fields = []
    i = 0
    for count, vocab in context_tiers:
        for _ in range(count):
            mult = (multi_hot or {}).get(i, 1)
            fields.append(FieldSpec(f"ctx_{i}", vocab, CONTEXT, mult))
            i += 1
    j = 0
    for count, vocab in item_tiers:
        for _ in range(count):
            mult = (multi_hot or {}).get(-(j + 1), 1)
            fields.append(FieldSpec(f"item_{j}", vocab, ITEM, mult))
            j += 1
    return FeatureLayout(tuple(fields))


def smoke_layout(n_context: int, n_item: int, vocab: int = 64):
    return tiered_layout([(n_context, vocab)], [(n_item, vocab)])
