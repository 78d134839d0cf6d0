"""dplr-fwfm: the paper's own architecture.  Port of
``repro.configs.dplr_fwfm`` (no registry).

Sized from the paper's deployment (Section 5.3): 82 fields (44 context,
38 item), embed_dim k = 16, rank rho = 3.  Arena about 3.3e7 rows.
"""
from repro_torch.configs._recsys_common import smoke_layout, tiered_layout
from repro_torch.models.recsys.fwfm import FwFMConfig


def make_layout():
    return tiered_layout(
        context_tiers=[(1, 10_000_000), (5, 1_000_000), (15, 100_000),
                       (23, 1_000)],   # 44 context fields
        item_tiers=[(1, 10_000_000), (5, 1_000_000), (15, 100_000),
                    (17, 1_000)],      # 38 item fields
    )


def make_config() -> FwFMConfig:
    return FwFMConfig(layout=make_layout(), embed_dim=16, interaction="dplr", rank=3)


def make_smoke() -> FwFMConfig:
    return FwFMConfig(layout=smoke_layout(7, 5), embed_dim=8, interaction="dplr", rank=2)
