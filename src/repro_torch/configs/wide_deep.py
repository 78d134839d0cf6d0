"""wide-deep [arXiv:1606.07792]: n_sparse=40 fields, embed_dim=32,
MLP 1024-512-256, concat interaction.  Port of ``repro.configs.wide_deep``
(no registry).

Arena: ~1.27e8 rows (user id 5e7 + item id 5e7 + mid/small tiers) x 32 dim
= 16.3 GB of embedding parameters.  Split: 20 context fields / 20 item
fields.
"""
from repro_torch.configs._recsys_common import smoke_layout, tiered_layout
from repro_torch.models.recsys.wide_deep import WideDeepConfig


def make_layout():
    return tiered_layout(
        context_tiers=[(1, 50_000_000), (1, 10_000_000), (3, 1_000_000),
                       (5, 100_000), (10, 10_000)],
        item_tiers=[(1, 50_000_000), (1, 10_000_000), (3, 1_000_000),
                    (5, 100_000), (10, 10_000)],
    )


def make_config() -> WideDeepConfig:
    return WideDeepConfig(layout=make_layout(), embed_dim=32,
                          mlp_dims=(1024, 512, 256))


def make_smoke() -> WideDeepConfig:
    return WideDeepConfig(layout=smoke_layout(4, 4), embed_dim=8,
                          mlp_dims=(32, 16), use_dplr_head=True, dplr_rank=2)
