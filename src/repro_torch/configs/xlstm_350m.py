"""xlstm-350m [ssm] — 24L d=1024 4H V=50304, mLSTM + sLSTM blocks (7:1
ratio -> pattern [7x mLSTM, 1x sLSTM] x 3), no separate FFN (d_ff=0; the
blocks carry their own projections).  [arXiv:2405.04517]"""
from repro_torch.models.config import (GroupSpec, LayerSpec, ModelConfig,
                                       XLSTMConfig)

_M = LayerSpec(kind="mlstm", mlp="none")
_S = LayerSpec(kind="slstm", mlp="none")


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m",
        groups=(GroupSpec(pattern=(_M,) * 7 + (_S,), repeat=3),),
        d_model=1024, num_heads=4, num_kv_heads=4, head_dim=256,
        d_ff=0, vocab_size=50304,
        xlstm=XLSTMConfig(proj_factor=2.0, slstm_proj_factor=4 / 3),
        activation="gelu", tie_embeddings=True,
        subquadratic=True, remat="dots",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m-smoke",
        groups=(GroupSpec(pattern=(_M, _M, _S), repeat=2),),
        d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=0, vocab_size=256,
        xlstm=XLSTMConfig(proj_factor=2.0, slstm_proj_factor=4 / 3,
                          chunk=16),
        activation="gelu", tie_embeddings=True,
        subquadratic=True, dtype="float32", remat="none",
    )
