"""The optimized configurations of :mod:`repro.configs.optimized`.

``optimized_config(name)`` layers each arch's fusion and sharding choices
over its published config, with the overrides of the JAX package.
``seq_parallel`` and ``moe_sharding`` equal JAX's field by field and act
through :func:`repro_torch.parallel.annotate.make_rules` on a mesh (the
``seq`` rule, the MoE layout); on one card they change nothing.  ``_moe_group_size`` sets ``moe.group_size``, the tokens of an
MoE dispatch group.  Any other name raises "not ported yet" through
:func:`get_config`.
"""
from __future__ import annotations

import dataclasses

from repro_torch import configs

_OVERRIDES: dict[str, dict] = {
    "gemma_7b": dict(fuse_qkv=True, fuse_glu=True, seq_parallel=True),
    "gemma2_27b": dict(fuse_qkv=True, fuse_glu=True, seq_parallel=True),
    "llama3_2_1b": dict(fuse_qkv=True, fuse_glu=True, seq_parallel=True),
    "deepseek_coder_33b": dict(fuse_qkv=True, fuse_glu=True,
                               seq_parallel=True),
    "zamba2_2_7b": dict(fuse_glu=True),
    "grok_1_314b": dict(fuse_qkv=True, fuse_glu=True),
    "deepseek_v3_671b": dict(moe_sharding="ep_fsdp", _moe_group_size=512,
                             fuse_glu=True),
    "xlstm_350m": dict(),
    "llama3_2_vision_90b": dict(fuse_qkv=True, fuse_glu=True,
                                seq_parallel=True),
    "musicgen_medium": dict(remat="full", fuse_qkv=True, fuse_glu=True,
                            seq_parallel=True),
}


def optimized_config(name: str):
    cfg = configs.get_config(name)
    over = dict(_OVERRIDES[configs.canonical(name)])
    gsize = over.pop("_moe_group_size", None)
    if gsize is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, group_size=gsize))
    return dataclasses.replace(cfg, **over)
