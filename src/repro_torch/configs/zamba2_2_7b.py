"""zamba2-2.7b [hybrid] — 54L d=2560 32H (kv=32) d_ff=10240 V=32000,
ssm_state=64.  Mamba2 backbone with a weight-SHARED attention+MLP block
applied every 6th layer (9 groups x [5 mamba2 + 1 shared attn]).
[arXiv:2411.15242]"""
from repro_torch.models.config import (GroupSpec, LayerSpec, MambaConfig,
                                       ModelConfig)

_MAMBA = LayerSpec(kind="mamba2", mlp="none")
_SHARED = LayerSpec(kind="attn", mlp="glu", shared=True)


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        groups=(GroupSpec(pattern=(_MAMBA,) * 5 + (_SHARED,), repeat=9),),
        d_model=2560, num_heads=32, num_kv_heads=32, head_dim=80,
        d_ff=10240, vocab_size=32000,
        mamba=MambaConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                          chunk=128),
        activation="gelu", tie_embeddings=True,
        subquadratic=True, remat="full",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b-smoke",
        groups=(GroupSpec(pattern=(_MAMBA, _MAMBA, _SHARED), repeat=2),),
        d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256,
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2, head_dim=32,
                          chunk=16),
        activation="gelu", tie_embeddings=True,
        subquadratic=True, dtype="float32", remat="none",
    )
