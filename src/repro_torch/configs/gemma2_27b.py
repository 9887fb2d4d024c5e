"""gemma2-27b [dense] — 46L d=4608 32H (GQA kv=16) d_ff=36864 V=256000.
Local(4096-window)/global alternating, attn softcap 50, final softcap 30,
post-norms, GeGLU, embedding scaling.  [arXiv:2408.00118]"""
from repro_torch.models.config import GroupSpec, LayerSpec, ModelConfig

_LOCAL = LayerSpec(kind="attn", mlp="glu", window=4096, post_norms=True)
_GLOBAL = LayerSpec(kind="attn", mlp="glu", post_norms=True)


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b",
        groups=(GroupSpec(pattern=(_LOCAL, _GLOBAL), repeat=23),),
        d_model=4608, num_heads=32, num_kv_heads=16, head_dim=128,
        d_ff=36864, vocab_size=256000,
        attn_softcap=50.0, final_softcap=30.0,
        # gemma2-27b scales queries by 1/sqrt(d_model/num_heads)=1/12
        attn_scale=1.0 / 12.0,
        activation="gelu", tie_embeddings=True, scale_embed=True,
        rope_theta=10000.0, remat="full", fsdp=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b-smoke",
        groups=(GroupSpec(pattern=(
            LayerSpec(kind="attn", mlp="glu", window=8, post_norms=True),
            LayerSpec(kind="attn", mlp="glu", post_norms=True)), repeat=2),),
        d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256,
        attn_softcap=50.0, final_softcap=30.0,
        activation="gelu", tie_embeddings=True, scale_embed=True,
        dtype="float32", remat="none",
    )
