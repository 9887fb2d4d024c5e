"""Gated-linear-unit MLPs (SwiGLU / GeGLU) and the plain 2-matrix MLP.
``cfg.fuse_glu`` keeps the gate and up projections as one (D, 2, F)
``wgu``, as the JAX version does."""
from __future__ import annotations

from typing import Any

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.common import ACTIVATIONS, dense_init
from repro_torch.models.config import ModelConfig, dtype_of
from repro_torch.parallel.annotate import gather_for, hint, matmul

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
    # weight hints: the just-in-time FSDP gather (strip any 'data' shard)
    # and the TP layout of the hidden dim
    wo = hint(params["wo"], "ffn", "wt_d")
    if "wgu" in params:  # fused gate+up: one matmul
        # a sequence-parallel x takes the weight whole (local_matmul's
        # gather, made before the flatten)
        wgu = gather_for(x, hint(params["wgu"], "wt_d", None, "ffn"))
        if isinstance(wgu, DTensor) and any(p.is_shard(2)
                                            for p in wgu.placements):
            # F sharded: (D, 2, F) flattened as (D, F * 2), F outermost,
            # so a shard of F stays a shard of the product's columns
            # (flattening (2, F) would gather the weight and repeat the
            # whole product on every rank of the ffn axis)
            gu = matmul(x, wgu.transpose(1, 2).flatten(1)).unflatten(
                -1, (-1, 2)).transpose(-1, -2)
        else:
            gu = matmul(x, wgu.flatten(1)).unflatten(-1, (2, -1))
        h = act(gu[..., 0, :]) * gu[..., 1, :]
    else:
        h = act(matmul(x, hint(params["wi"], "wt_d", "ffn")))
        if "wu" in params:
            h = h * matmul(x, hint(params["wu"], "wt_d", "ffn"))
    return matmul(hint(h, "batch", "seq", "ffn"), wo)
