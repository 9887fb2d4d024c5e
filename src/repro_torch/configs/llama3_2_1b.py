"""llama3.2-1b [dense] — 16L d=2048 32H (GQA kv=8) d_ff=8192 V=128256,
SwiGLU, rope theta 5e5, tied embeddings.  [hf:meta-llama/Llama-3.2-1B]"""
from repro_torch.models.config import LayerSpec, ModelConfig, uniform_groups

_SPEC = LayerSpec(kind="attn", mlp="glu")


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b",
        groups=uniform_groups(16, _SPEC),
        d_model=2048, num_heads=32, num_kv_heads=8, head_dim=64,
        d_ff=8192, vocab_size=128256,
        activation="silu", tie_embeddings=True,
        rope_theta=500000.0, remat="full",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b-smoke",
        groups=uniform_groups(2, _SPEC),
        d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
        d_ff=128, vocab_size=256,
        activation="silu", tie_embeddings=True,
        dtype="float32", remat="none",
    )
