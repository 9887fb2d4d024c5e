"""Gated-linear-unit MLPs (SwiGLU / GeGLU) and the plain 2-matrix MLP.
``fuse_glu`` is not ported yet."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.common import ACTIVATIONS, dense_init
from repro_torch.models.config import ModelConfig, dtype_of

Params = Any


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.gated_mlp and cfg.fuse_glu:
        raise NotImplementedError("fuse_glu: not ported yet")


def init_mlp(gen: torch.Generator, cfg: ModelConfig,
             device: torch.device) -> Params:
    _check_supported(cfg)
    dt = dtype_of(cfg)
    d, f = cfg.d_model, cfg.d_ff
    p = {
        "wi": dense_init(gen, d, (f,), dt, device),   # gate (or sole up) proj
        "wo": dense_init(gen, f, (d,), dt, device),   # down proj
    }
    if cfg.gated_mlp:
        p["wu"] = dense_init(gen, d, (f,), dt, device)  # up proj
    return p


def apply_mlp(params: Params, cfg: ModelConfig,
              x: torch.Tensor) -> torch.Tensor:
    _check_supported(cfg)
    act = ACTIVATIONS[cfg.activation]
    h = act(x @ params["wi"])
    if "wu" in params:
        h = h * (x @ params["wu"])
    return h @ params["wo"]
