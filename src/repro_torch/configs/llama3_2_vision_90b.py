"""llama-3.2-vision-90b [vlm] — 100L d=8192 64H (GQA kv=8) d_ff=28672
V=128256.  Gated cross-attention to image embeddings every 5th layer
(pattern [4x self-attn, 1x cross-attn] x 20).  The vision frontend is a
stub: the model takes precomputed patch embeddings (B, 2048, 7680).  [hf:meta-llama/Llama-3.2-90B-Vision]"""
from repro_torch.models.config import GroupSpec, LayerSpec, ModelConfig

_SELF = LayerSpec(kind="attn", mlp="glu")
_CROSS = LayerSpec(kind="cross_attn", mlp="glu")


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b",
        groups=(GroupSpec(pattern=(_SELF,) * 4 + (_CROSS,), repeat=20),),
        d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
        d_ff=28672, vocab_size=128256,
        vision_dim=7680, num_image_tokens=2048,
        activation="silu", tie_embeddings=False,
        rope_theta=500000.0, remat="full", fsdp=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b-smoke",
        groups=(GroupSpec(pattern=(_SELF, _CROSS), repeat=2),),
        d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
        d_ff=128, vocab_size=256,
        vision_dim=48, num_image_tokens=16,
        activation="silu", tie_embeddings=False,
        dtype="float32", remat="none",
    )
