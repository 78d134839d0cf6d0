"""mixtral-8x7b [arXiv:2401.04088] (``repro.configs.mixtral_8x7b``): MoE,
32L, d_model=4096, 32H (GQA kv=8, head_dim=128), d_ff=14336 per expert,
vocab=32000, 8 experts top-2 (SwiGLU), sliding-window attention (W=4096).
SWA is sub-quadratic: long_500k runs.  46,702,792,704 parameters (187 GB
in f32: one 80 GB card holds it only with its depth cut; its full depth
waits for FSDP across data replicas, ROADMAP item 3c)."""
from repro_torch.models.transformer.model import TransformerConfig

SLIDING_WINDOW = 4096


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="mixtral-8x7b",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=32000, head_dim=128,
        mlp_type="swiglu", rope_theta=1e6,
        n_experts=8, top_k=2, capacity_factor=1.25, moe_group_size=512,
        layer_pattern=(SLIDING_WINDOW,),
        remat=True, q_chunk=512, micro_batches=16, fsdp=True,
    )


def make_smoke() -> TransformerConfig:
    return TransformerConfig(
        name="mixtral-smoke",
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
        d_ff=64, vocab=128, head_dim=8,
        mlp_type="swiglu", n_experts=4, top_k=2, moe_group_size=16,
        layer_pattern=(8,), remat=False, q_chunk=8,
    )
