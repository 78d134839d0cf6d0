"""autoint [arXiv:1810.11921]: n_sparse=39 (Criteo), embed_dim=16,
3 self-attention interacting layers, 2 heads, d_attn=32.  Port of
``repro.configs.autoint`` (no registry).

Arena ~5e7 rows x 16 dim (Criteo-scale: 26 categorical fields incl. several
1e6+ id spaces + 13 log-binned numeric fields).  Split: 19 context / 20 item.
"""
from repro_torch.configs._recsys_common import smoke_layout, tiered_layout
from repro_torch.models.recsys.autoint import AutoIntConfig


def make_layout():
    return tiered_layout(
        context_tiers=[(2, 10_000_000), (4, 1_000_000), (6, 100_000),
                       (7, 100)],      # 19 fields (7 binned numerics)
        item_tiers=[(2, 10_000_000), (4, 1_000_000), (8, 100_000),
                    (6, 100)],         # 20 fields (6 binned numerics)
    )


def make_config() -> AutoIntConfig:
    return AutoIntConfig(layout=make_layout(), embed_dim=16,
                         n_attn_layers=3, n_heads=2, d_attn=32)


def make_smoke() -> AutoIntConfig:
    return AutoIntConfig(layout=smoke_layout(4, 4), embed_dim=8,
                         n_attn_layers=2, n_heads=2, d_attn=16,
                         use_dplr_head=True, dplr_rank=2)
