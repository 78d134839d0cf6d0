"""bst [arXiv:1905.06874] (Alibaba Behavior Sequence Transformer):
embed_dim=32, seq_len=20, n_blocks=1, n_heads=8, MLP 1024-512-256.  Port
of ``repro.configs.bst`` (no registry).

Layout: 8 context fields (user id 1e7 + profile/context) + 1 item field
(1e8 ids, Taobao-scale).  History tokens share the item vocabulary.
"""
from repro_torch.core.fields import CONTEXT, ITEM, FieldSpec, FeatureLayout
from repro_torch.models.recsys.bst import BSTConfig


def make_layout():
    ctx = [
        FieldSpec("user_id", 10_000_000, CONTEXT),
        FieldSpec("age", 10, CONTEXT),
        FieldSpec("gender", 3, CONTEXT),
        FieldSpec("city", 1_000, CONTEXT),
        FieldSpec("device", 100, CONTEXT),
        FieldSpec("hour", 24, CONTEXT),
        FieldSpec("dow", 7, CONTEXT),
        FieldSpec("page", 50, CONTEXT),
    ]
    item = [FieldSpec("item_id", 100_000_000, ITEM)]
    return FeatureLayout(tuple(ctx + item))


def make_config() -> BSTConfig:
    return BSTConfig(layout=make_layout(), embed_dim=32, seq_len=20,
                     n_blocks=1, n_heads=8, mlp_dims=(1024, 512, 256))


def make_smoke() -> BSTConfig:
    fields = tuple(
        [FieldSpec(f"c{i}", 32, CONTEXT) for i in range(3)]
        + [FieldSpec("item", 128, ITEM)]
    )
    return BSTConfig(layout=FeatureLayout(fields), embed_dim=16, seq_len=6,
                     n_blocks=1, n_heads=4, mlp_dims=(32,))
