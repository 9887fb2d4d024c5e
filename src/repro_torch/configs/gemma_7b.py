"""gemma-7b [dense] — 28L d=3072 16H (kv=16) d_ff=24576 V=256000, GeGLU,
head_dim=256, tied embeddings, embedding scaling.  [arXiv:2403.08295]"""
from repro_torch.models.config import LayerSpec, ModelConfig, uniform_groups

_SPEC = LayerSpec(kind="attn", mlp="glu")


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b",
        groups=uniform_groups(28, _SPEC),
        d_model=3072, num_heads=16, num_kv_heads=16, head_dim=256,
        d_ff=24576, vocab_size=256000,
        activation="gelu", tie_embeddings=True, scale_embed=True,
        rope_theta=10000.0, remat="full",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b-smoke",
        groups=uniform_groups(2, _SPEC),
        d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256,
        activation="gelu", tie_embeddings=True, scale_embed=True,
        dtype="float32", remat="none",
    )
