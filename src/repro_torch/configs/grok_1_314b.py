"""grok-1-314b [moe] — 64L d=6144 48H (GQA kv=8) d_ff=32768 V=131072,
8 experts top-2, attention/final logit softcap 30, untied.
[hf:xai-org/grok-1]"""
from repro_torch.models.config import LayerSpec, ModelConfig, MoEConfig, uniform_groups

_SPEC = LayerSpec(kind="attn", mlp="moe")


def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b",
        groups=uniform_groups(64, _SPEC),
        d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
        d_ff=32768, vocab_size=131072,
        moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=1.25,
                      router="softmax", aux_loss_weight=0.01),
        attn_softcap=30.0, final_softcap=30.0,
        activation="gelu", tie_embeddings=False,
        rope_theta=10000.0, remat="full", fsdp=True,
        optimizer="adafactor",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b-smoke",
        groups=uniform_groups(2, _SPEC),
        d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
        d_ff=128, vocab_size=256,
        moe=MoEConfig(num_experts=4, top_k=2, capacity_factor=2.0,
                      router="softmax", aux_loss_weight=0.01),
        attn_softcap=30.0, final_softcap=30.0,
        activation="gelu", tie_embeddings=False,
        dtype="float32", remat="none",
    )
