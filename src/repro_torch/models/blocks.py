"""Layer composition and the loop-over-layers group machinery.

One *layer* = (pre-norm -> attention -> residual) + (pre-norm -> MLP ->
residual).  A *group* repeats a pattern of layers whose params are stacked
over the repeat axis, as in :mod:`repro.models.blocks`; a Python loop over
that axis takes the place of ``lax.scan``.  Caches are written in place.
``cfg.remat`` has no effect here (no backward in the serving path); the
training port maps it to activation checkpointing.

Ported: ``kind="attn"`` with ``mlp="glu"`` (gated or plain).  Not yet:
the other mixers, MoE, pure-MLP layers, post-norms and weight-shared
slots.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import attention
from repro_torch.models.common import rmsnorm, rmsnorm_init, tree_map
from repro_torch.models.config import (GroupSpec, LayerSpec, ModelConfig,
                                       dtype_of)
from repro_torch.models.mlp import apply_mlp, init_mlp

Params = Any


def _check_supported(spec: LayerSpec) -> None:
    if spec.kind != "attn" or spec.mlp != "glu":
        raise NotImplementedError(
            f"layer kind={spec.kind!r} mlp={spec.mlp!r}: not ported yet")
    if spec.post_norms or spec.shared:
        raise NotImplementedError("post_norms / shared slots: not ported yet")


# ---------------------------------------------------------------------------
# Single layer
# ---------------------------------------------------------------------------

def init_layer(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
               device: torch.device) -> Params:
    _check_supported(spec)
    dt = dtype_of(cfg)
    return {
        "pre_norm": rmsnorm_init(cfg.d_model, dt, device),
        "mixer": attention.init_attn(gen, cfg, spec, device),
        "pre_mlp_norm": rmsnorm_init(cfg.d_model, dt, device),
        "mlp": init_mlp(gen, cfg, device),
    }


def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, dtype: torch.dtype,
                     device: torch.device) -> Params:
    _check_supported(spec)
    return attention.init_attn_cache(cfg, spec, batch, max_len, dtype, device)


def apply_layer(params: Params, cfg: ModelConfig, spec: LayerSpec,
                x: torch.Tensor, ctx: dict, cache: Params | None
                ) -> tuple[torch.Tensor, Params | None]:
    _check_supported(spec)
    h = rmsnorm(params["pre_norm"], x, eps=cfg.norm_eps)
    h, new_cache = attention.apply_attn(
        params["mixer"], cfg, spec, h, ctx["positions"], cache)
    x = x + h
    h = rmsnorm(params["pre_mlp_norm"], x, eps=cfg.norm_eps)
    return x + apply_mlp(params["mlp"], cfg, h), new_cache


# ---------------------------------------------------------------------------
# Groups (loop over repeats)
# ---------------------------------------------------------------------------

def init_group(gen: torch.Generator, cfg: ModelConfig, gspec: GroupSpec,
               device: torch.device) -> Params:
    slot_params = []
    for spec in gspec.pattern:
        reps = [init_layer(gen, cfg, spec, device)
                for _ in range(gspec.repeat)]
        slot_params.append(tree_map(lambda *a: torch.stack(a), *reps))
    return {"slots": tuple(slot_params)}


def init_group_cache(cfg: ModelConfig, gspec: GroupSpec, batch: int,
                     max_len: int, dtype: torch.dtype,
                     device: torch.device) -> Params:
    slots = []
    for spec in gspec.pattern:
        one = init_layer_cache(cfg, spec, batch, max_len, dtype, device)
        slots.append(tree_map(
            lambda a: a.expand(gspec.repeat, *a.shape).clone(), one))
    return {"slots": tuple(slots)}


def apply_group(params: Params, cfg: ModelConfig, gspec: GroupSpec,
                x: torch.Tensor, ctx: dict, cache: Params | None
                ) -> tuple[torch.Tensor, Params | None]:
    """Run the group's repeats in order.  ``cache`` (stacked over the
    repeat axis) is updated in place through per-repeat views and
    returned."""
    for r in range(gspec.repeat):
        for i, spec in enumerate(gspec.pattern):
            p = tree_map(lambda a: a[r], params["slots"][i])
            c = None
            if cache is not None:
                c = tree_map(lambda a: a[r], cache["slots"][i])
            x, _ = apply_layer(p, cfg, spec, x, ctx, c)
    return x, cache
