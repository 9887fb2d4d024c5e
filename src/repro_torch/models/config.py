"""Model configuration dataclasses (the port's own copy).

A model is a stack of *groups*; each group is a repeating *pattern* of layer
specs with params stacked over the repeat axis.  The fields and defaults are
those of :mod:`repro.models.config`; ``compute_dtype`` is replaced by
:func:`dtype_of`.  ``param_count`` and ``active_param_count`` build the
param tree on the ``meta`` device, so nothing is allocated.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    d_expert: int = 0                 # expert hidden dim (0 -> use d_ff)
    num_shared: int = 0               # dense "shared" experts (DeepSeek-MoE)
    capacity_factor: float = 1.25
    group_size: int = 2048            # dispatch-group tokens
    router: str = "softmax"           # 'softmax' | 'sigmoid' (DeepSeek-V3)
    router_bias: bool = False         # aux-loss-free bias update (DSv3)
    aux_loss_weight: float = 0.0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64                # mamba2 SSD head dim
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    proj_factor: float = 2.0          # mLSTM up-projection
    slstm_proj_factor: float = 1.3334
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One slot in a group pattern.

    kind: 'attn' | 'mla' | 'mamba2' | 'mlstm' | 'slstm' | 'cross_attn'
          | 'none' (pure-MLP layer)
    mlp:  'glu' | 'moe' | 'none'
    """
    kind: str = "attn"
    mlp: str = "glu"
    window: int = 0                   # >0 -> sliding-window attention
    shared: bool = False              # weight-shared across group repeats
    post_norms: bool = False          # gemma2-style post-block RMSNorm
    qk_norm: bool = False


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    pattern: tuple[LayerSpec, ...]
    repeat: int


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    groups: tuple[GroupSpec, ...]
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention extras
    rope_theta: float = 10000.0
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    attn_scale: float = 0.0           # 0 -> 1/sqrt(head_dim)
    # sub-configs
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    mamba: MambaConfig | None = None
    xlstm: XLSTMConfig | None = None
    # embedding / head
    tie_embeddings: bool = True
    scale_embed: bool = False         # gemma multiplies embeds by sqrt(d)
    num_codebooks: int = 0            # musicgen: parallel codebook streams
    # modality frontend stubs
    vision_dim: int = 0               # >0 -> expects precomputed image embeds
    num_image_tokens: int = 0
    # numerics / training
    activation: str = "silu"
    gated_mlp: bool = True            # GLU (False -> plain 2-matrix MLP)
    unroll: bool = False              # Python-loop layers (dry-run costing)
    # perf knobs
    fuse_qkv: bool = False            # single QKV projection matmul
    fuse_glu: bool = False            # single gate+up projection matmul
    seq_parallel: bool = False        # shard residual-stream seq over TP
    loss_dtype: str = "float32"       # logsumexp accumulation dtype
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: str = "full"               # 'none' | 'full' | 'dots'
    # distribution policy
    fsdp: bool = False                # shard big weight dims over 'data' too
    moe_sharding: str = "auto"        # 'auto' | 'ep2d' | 'ep_fsdp' | 'tp'
    # sub-quadratic? (controls long_500k applicability)
    subquadratic: bool = False
    # optimizer choice for train_step lowering
    optimizer: str = "adamw"          # 'adamw' | 'adafactor' | 'lion'

    @property
    def num_layers(self) -> int:
        return sum(len(g.pattern) * g.repeat for g in self.groups)

    def _meta_params(self) -> list:
        """(path, leaf) pairs of the param tree, built on the meta
        device."""
        from repro_torch.models import model as model_lib
        from repro_torch.models.common import tree_paths
        return tree_paths(model_lib.init_params(torch.Generator(), self,
                                                "meta"))

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once if tied)."""
        return sum(leaf.numel() for _, leaf in self._meta_params())

    def active_param_count(self) -> int:
        """Params active per token (MoE counts top_k+shared experts only)."""
        if self.moe is None:
            return self.param_count()
        leaves = self._meta_params()
        frac = 1.0 - (self.moe.top_k / self.moe.num_experts)
        inactive = sum(int(leaf.numel() * frac) for path, leaf in leaves
                       if "['experts']" in path)
        return sum(leaf.numel() for _, leaf in leaves) - inactive


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_named(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype string (``"bfloat16"``, ...)."""
    return _DTYPES[name]


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    """The torch dtype named by ``cfg.dtype``."""
    return dtype_named(cfg.dtype)


def uniform_groups(n_layers: int, spec: LayerSpec) -> tuple[GroupSpec, ...]:
    return (GroupSpec(pattern=(spec,), repeat=n_layers),)
