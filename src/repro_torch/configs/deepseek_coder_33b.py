"""deepseek-coder-33b [dense] — 62L d=7168 56H (GQA kv=8) d_ff=19200
V=32256, llama-arch SwiGLU, untied.  [arXiv:2401.14196]"""
from repro_torch.models.config import LayerSpec, ModelConfig, uniform_groups

_SPEC = LayerSpec(kind="attn", mlp="glu")


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b",
        groups=uniform_groups(62, _SPEC),
        d_model=7168, num_heads=56, num_kv_heads=8, head_dim=128,
        d_ff=19200, vocab_size=32256,
        activation="silu", tie_embeddings=False,
        rope_theta=100000.0, remat="full", fsdp=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b-smoke",
        groups=uniform_groups(2, _SPEC),
        d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
        d_ff=160, vocab_size=256,
        activation="silu", tie_embeddings=False,
        dtype="float32", remat="none",
    )
