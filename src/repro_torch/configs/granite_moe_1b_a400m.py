"""granite-3.0-1b-a400m [hf:ibm-granite] (``repro.configs.granite_moe_1b_a400m``):
MoE, 24L, d_model=1024, 16H (GQA kv=8, head_dim=64), d_ff=512 per expert,
vocab=49155, 32 experts top-8 (SwiGLU), capacity factor 1.25 in groups of
512 tokens.  Full attention: long_500k is skipped.  1,385,219,072
parameters (5.54 GB in f32), 479,249,408 of them active a token."""
from repro_torch.models.transformer.model import TransformerConfig


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="granite-moe-1b-a400m",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
        d_ff=512, vocab=49155, head_dim=64,
        mlp_type="swiglu", rope_theta=1e4,
        n_experts=32, top_k=8, capacity_factor=1.25, moe_group_size=512,
        layer_pattern=(None,), remat=True, q_chunk=512,
    )


def make_smoke() -> TransformerConfig:
    return TransformerConfig(
        name="granite-moe-smoke",
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
        d_ff=32, vocab=131, head_dim=8,
        mlp_type="swiglu", n_experts=8, top_k=2, moe_group_size=16,
        layer_pattern=(None,), remat=False, q_chunk=8,
    )
