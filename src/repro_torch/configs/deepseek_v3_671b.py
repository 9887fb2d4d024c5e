"""deepseek-v3-671b [moe] — 61L d=7168 128H, MLA (kv_lora 512, q_lora 1536,
rope 64, nope 128, v 128), first 3 layers dense (d_ff 18432), 58 MoE layers
with 1 shared + 256 routed experts (expert dim 2048), sigmoid top-8 router
with aux-loss-free bias.  V=129280.  [arXiv:2412.19437]"""
from repro_torch.models.config import (GroupSpec, LayerSpec, MLAConfig,
                                 ModelConfig, MoEConfig)

_DENSE = LayerSpec(kind="mla", mlp="glu")
_MOE = LayerSpec(kind="mla", mlp="moe")


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        groups=(GroupSpec(pattern=(_DENSE,), repeat=3),
                GroupSpec(pattern=(_MOE,), repeat=58)),
        d_model=7168, num_heads=128, num_kv_heads=128, head_dim=128,
        d_ff=18432, vocab_size=129280,
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, rope_head_dim=64,
                      nope_head_dim=128, v_head_dim=128),
        moe=MoEConfig(num_experts=256, top_k=8, d_expert=2048, num_shared=1,
                      capacity_factor=1.25, router="sigmoid",
                      router_bias=True),
        activation="silu", tie_embeddings=False,
        rope_theta=10000.0, remat="full", fsdp=True,
        optimizer="adafactor",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b-smoke",
        groups=(GroupSpec(pattern=(_DENSE,), repeat=1),
                GroupSpec(pattern=(_MOE,), repeat=2)),
        d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, rope_head_dim=8,
                      nope_head_dim=16, v_head_dim=16),
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=32, num_shared=1,
                      capacity_factor=2.0, router="sigmoid",
                      router_bias=True),
        activation="silu", tie_embeddings=False,
        dtype="float32", remat="none",
    )
