"""Layer composition and the loop-over-layers group machinery.

One *layer* = (pre-norm -> mixer block -> residual) + optional
(pre-norm -> MLP -> residual).  A *group* repeats a pattern of layers whose
params are stacked over the repeat axis, as in :mod:`repro.models.blocks`;
a Python loop over that axis takes the place of ``lax.scan``.
Weight-shared slots (zamba2's shared attention) are not stacked: every
repeat uses the same params, but each repeat keeps its own cache.  Caches
are written in place.  ``cfg.remat`` has no effect here (no backward in
the serving path); the training port maps it to activation checkpointing.

Ported: mixers ``attn`` and ``mamba2`` and pure-MLP layers (``kind="none"``),
with ``mlp="glu"`` (gated or plain) or ``"none"``.  Not yet: ``mla``,
``mlstm``/``slstm``, ``cross_attn``, MoE and post-norms.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import attention, mamba2
from repro_torch.models.common import rmsnorm, rmsnorm_init, tree_map
from repro_torch.models.config import (GroupSpec, LayerSpec, ModelConfig,
                                       dtype_of)
from repro_torch.models.mlp import apply_mlp, init_mlp

Params = Any


_MIXER_INIT = {"attn": attention.init_attn, "mamba2": mamba2.init_mamba2}
_CACHE_INIT = {"attn": attention.init_attn_cache,
               "mamba2": mamba2.init_mamba_cache}


def _check_supported(spec: LayerSpec) -> None:
    if spec.kind not in (*_MIXER_INIT, "none") or \
            spec.mlp not in ("glu", "none"):
        raise NotImplementedError(
            f"layer kind={spec.kind!r} mlp={spec.mlp!r}: not ported yet")
    if spec.post_norms:
        raise NotImplementedError("post_norms: not ported yet")


# ---------------------------------------------------------------------------
# Single layer
# ---------------------------------------------------------------------------

def init_layer(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
               device: torch.device) -> Params:
    _check_supported(spec)
    dt = dtype_of(cfg)
    p: dict = {}
    if spec.kind != "none":
        p["pre_norm"] = rmsnorm_init(cfg.d_model, dt, device)
        p["mixer"] = _MIXER_INIT[spec.kind](gen, cfg, spec, device)
    if spec.mlp != "none":
        p["pre_mlp_norm"] = rmsnorm_init(cfg.d_model, dt, device)
        p["mlp"] = init_mlp(gen, cfg, device)
    return p


def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, dtype: torch.dtype,
                     device: torch.device) -> Params:
    _check_supported(spec)
    if spec.kind == "none":
        return {}
    return _CACHE_INIT[spec.kind](cfg, spec, batch, max_len, dtype, device)


def apply_layer(params: Params, cfg: ModelConfig, spec: LayerSpec,
                x: torch.Tensor, ctx: dict, cache: Params | None
                ) -> tuple[torch.Tensor, Params | None]:
    _check_supported(spec)
    if spec.kind != "none":
        h = rmsnorm(params["pre_norm"], x, eps=cfg.norm_eps)
        if spec.kind == "attn":
            h, cache = attention.apply_attn(
                params["mixer"], cfg, spec, h, ctx["positions"], cache)
        else:
            h, cache = mamba2.apply_mamba2(params["mixer"], cfg, spec, h,
                                           cache)
        x = x + h
    if spec.mlp != "none":
        h = rmsnorm(params["pre_mlp_norm"], x, eps=cfg.norm_eps)
        x = x + apply_mlp(params["mlp"], cfg, h)
    return x, cache


# ---------------------------------------------------------------------------
# Groups (loop over repeats)
# ---------------------------------------------------------------------------

def init_group(gen: torch.Generator, cfg: ModelConfig, gspec: GroupSpec,
               device: torch.device) -> Params:
    slot_params = []
    for spec in gspec.pattern:
        if spec.shared:
            slot_params.append(init_layer(gen, cfg, spec, device))
            continue
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
    repeat axis for every slot, shared ones included) is updated in place
    through per-repeat views and returned."""
    for r in range(gspec.repeat):
        for i, spec in enumerate(gspec.pattern):
            p = params["slots"][i]
            if not spec.shared:
                p = tree_map(lambda a: a[r], p)
            c = None
            if cache is not None and cache["slots"][i]:
                c = tree_map(lambda a: a[r], cache["slots"][i])
            x, _ = apply_layer(p, cfg, spec, x, ctx, c)
    return x, cache
