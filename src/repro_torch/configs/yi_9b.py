"""yi-9b [arXiv:2403.04652] (``repro.configs.yi_9b``): llama-arch dense,
48L, d_model=4096, 32H (GQA kv=4, head_dim=128, so 8 query heads a kv
head), d_ff=11008 (SwiGLU), vocab=64000.  Full attention: long_500k is
skipped.  About 8.8e9 parameters, 35.3 GB in f32."""
from repro_torch.models.transformer.model import TransformerConfig


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="yi-9b",
        n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4,
        d_ff=11008, vocab=64000, head_dim=128,
        mlp_type="swiglu", rope_theta=1e4,
        layer_pattern=(None,), remat=True, q_chunk=512,
        micro_batches=8, fsdp=True,
    )


def make_smoke() -> TransformerConfig:
    return TransformerConfig(
        name="yi-9b-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=128, head_dim=16,
        mlp_type="swiglu", layer_pattern=(None,), remat=False, q_chunk=8,
    )
