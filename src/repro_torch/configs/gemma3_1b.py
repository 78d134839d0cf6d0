"""gemma3-1b [hf:google/gemma-3-1b-pt] (``repro.configs.gemma3_1b``):
dense, 26L, d_model=1152, 4H (GQA kv=1, head_dim=256), d_ff=6912 (GeGLU),
vocab=262144, tied embeddings, 5 local (sliding window 1024) : 1 global
attention pattern.  About 1.0e9 parameters, 4.0 GB in f32."""
from repro_torch.models.transformer.model import TransformerConfig

LOCAL_WINDOW = 1024


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="gemma3-1b",
        n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1,
        d_ff=6912, vocab=262144, head_dim=256,
        mlp_type="geglu", rope_theta=1e6, tie_embeddings=True,
        layer_pattern=(LOCAL_WINDOW,) * 5 + (None,),
        remat=True, q_chunk=512, micro_batches=4,
    )


def make_smoke() -> TransformerConfig:
    return TransformerConfig(
        name="gemma3-1b-smoke",
        n_layers=8, d_model=48, n_heads=4, n_kv_heads=1,
        d_ff=96, vocab=256, head_dim=16,
        mlp_type="geglu", tie_embeddings=True,
        layer_pattern=(8,) * 5 + (None,), remat=False, q_chunk=8,
    )
