"""Gated-linear-unit MLPs (SwiGLU / GeGLU) and the plain 2-matrix MLP.
``cfg.fuse_glu`` keeps the gate and up projections as one (D, 2, F)
``wgu``, as the JAX version does."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.common import ACTIVATIONS, dense_init
from repro_torch.models.config import ModelConfig, dtype_of

Params = Any


def init_mlp(gen: torch.Generator, cfg: ModelConfig,
             device: torch.device, d_ff: int | None = None) -> Params:
    """``d_ff`` replaces ``cfg.d_ff`` (an MoE layer's shared experts)."""
    dt = dtype_of(cfg)
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.gated_mlp and cfg.fuse_glu:
        # (D, 2, F) layout: F stays contiguous after the split
        return {"wgu": dense_init(gen, d, (2, f), dt, device),
                "wo": dense_init(gen, f, (d,), dt, device)}
    p = {
        "wi": dense_init(gen, d, (f,), dt, device),   # gate (or sole up) proj
        "wo": dense_init(gen, f, (d,), dt, device),   # down proj
    }
    if cfg.gated_mlp:
        p["wu"] = dense_init(gen, d, (f,), dt, device)  # up proj
    return p


def apply_mlp(params: Params, cfg: ModelConfig,
              x: torch.Tensor) -> torch.Tensor:
    act = ACTIVATIONS[cfg.activation]
    if "wgu" in params:  # fused gate+up: one matmul
        gu = (x @ params["wgu"].flatten(1)).unflatten(-1, (2, -1))
        return (act(gu[..., 0, :]) * gu[..., 1, :]) @ params["wo"]
    h = act(x @ params["wi"])
    if "wu" in params:
        h = h * (x @ params["wu"])
    return h @ params["wo"]
