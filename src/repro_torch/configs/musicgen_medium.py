"""musicgen-medium [audio] — 48L d=1536 24H (kv=24) d_ff=6144 V=2048,
decoder-only over EnCodec tokens: 4 codebooks, summed input embeddings and
4 parallel output heads.  The EnCodec frontend is a STUB per the
assignment (token streams arrive precomputed).  Plain (non-gated) GELU MLP.
[arXiv:2306.05284]"""
from repro_torch.models.config import LayerSpec, ModelConfig, uniform_groups

_SPEC = LayerSpec(kind="attn", mlp="glu")


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        groups=uniform_groups(48, _SPEC),
        d_model=1536, num_heads=24, num_kv_heads=24, head_dim=64,
        d_ff=6144, vocab_size=2048,
        num_codebooks=4, gated_mlp=False,
        activation="gelu", tie_embeddings=False,
        rope_theta=10000.0, remat="dots",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium-smoke",
        groups=uniform_groups(2, _SPEC),
        d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=64,
        num_codebooks=4, gated_mlp=False,
        activation="gelu", tie_embeddings=False,
        dtype="float32", remat="none",
    )
