"""mind [arXiv:1904.08030]: embed_dim=64, n_interests=4, capsule_iters=3,
multi-interest dynamic-routing retrieval.  Port of ``repro.configs.mind``
(no registry).

Layout: 4 small context fields + 1 item field (5e7 ids, Tmall-scale);
history length 50.  retrieval_cand (1 query x 1e6 candidates) is MIND's
native serving shape: interests extracted once, candidates scored by
max-over-interests dot products.
"""
from repro_torch.core.fields import CONTEXT, ITEM, FieldSpec, FeatureLayout
from repro_torch.models.recsys.mind import MINDConfig


def make_layout():
    ctx = [
        FieldSpec("age", 10, CONTEXT),
        FieldSpec("gender", 3, CONTEXT),
        FieldSpec("city", 1_000, CONTEXT),
        FieldSpec("device", 100, CONTEXT),
    ]
    item = [FieldSpec("item_id", 50_000_000, ITEM)]
    return FeatureLayout(tuple(ctx + item))


def make_config() -> MINDConfig:
    return MINDConfig(layout=make_layout(), embed_dim=64, n_interests=4,
                      capsule_iters=3, seq_len=50)


def make_smoke() -> MINDConfig:
    fields = tuple(
        [FieldSpec(f"c{i}", 16, CONTEXT) for i in range(2)]
        + [FieldSpec("item", 256, ITEM)]
    )
    return MINDConfig(layout=FeatureLayout(fields), embed_dim=16,
                      n_interests=3, capsule_iters=3, seq_len=8, n_neg=4)
