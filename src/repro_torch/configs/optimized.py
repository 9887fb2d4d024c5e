"""The optimized configurations of :mod:`repro.configs.optimized`, for the
architectures ported so far.

``optimized_config(name)`` layers each arch's fusion and sharding choices
over its published config, with the overrides of the JAX package for the
ported archs.  ``seq_parallel`` is kept so that the configs equal JAX's
field by field; on one card it changes nothing (the port has no mesh
yet).  Any other name raises "not ported yet" through :func:`get_config`.
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
    "xlstm_350m": dict(),
    "musicgen_medium": dict(remat="full", fuse_qkv=True, fuse_glu=True,
                            seq_parallel=True),
}


def optimized_config(name: str):
    cfg = configs.get_config(name)
    return dataclasses.replace(cfg, **_OVERRIDES[configs.canonical(name)])
