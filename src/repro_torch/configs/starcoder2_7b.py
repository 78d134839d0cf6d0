"""starcoder2-7b [arXiv:2402.19173] (``repro.configs.starcoder2_7b``):
dense, 32L, d_model=4608, 36H (GQA kv=4, head_dim=128, so 9 query heads
a kv head), d_ff=18432 (GELU MLP), vocab=49152, RoPE.  Full attention:
long_500k is skipped (pure full-attention arch).  About 7.2e9 parameters,
28.9 GB in f32."""
from repro_torch.models.transformer.model import TransformerConfig


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="starcoder2-7b",
        n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
        d_ff=18432, vocab=49152, head_dim=128,
        mlp_type="gelu", rope_theta=1e5,
        layer_pattern=(None,), remat=True, q_chunk=512,
        micro_batches=16,
    )


def make_smoke() -> TransformerConfig:
    return TransformerConfig(
        name="starcoder2-7b-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab=128, head_dim=16,
        mlp_type="gelu", layer_pattern=(None,), remat=False, q_chunk=8,
    )
