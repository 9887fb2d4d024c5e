"""Layer composition and the loop-over-layers group machinery.

One *layer* = (pre-norm -> mixer block -> residual) + optional
(pre-norm -> MLP/MoE -> residual), with gemma2-style post-norms (a norm of the
block's output before the residual add) when ``spec.post_norms``.  A
*group* repeats a pattern of layers whose params are stacked over the
repeat axis, as in :mod:`repro.models.blocks`; a Python loop over that
axis takes the place of ``lax.scan``.
Weight-shared slots (zamba2's shared attention) are not stacked: every
repeat uses the same params, but each repeat keeps its own cache.  Caches
are written in place.  ``cfg.remat="full"`` checkpoints one repeat of the
group body when autograd records it (``torch.utils.checkpoint``, as the
JAX model ``jax.checkpoint``s its scan body): the repeat's activations are
dropped after the forward and recomputed in the backward.  ``"dots"`` runs
the same checkpoint with a selective policy, JAX's ``checkpoint_dots``:
the outputs of the matrix products (``mm``, ``bmm``, ``addmm``,
``baddbmm``) are kept and everything else is recomputed.  The port's
kernels launch outside PyTorch's dispatcher, so the policy never sees
them: they run again in the recomputation, as under ``"full"`` (and as
``checkpoint_dots`` recomputes a ``pallas_call``, which is not a dot).

Mixers ``attn``, ``mla``, ``cross_attn``, ``mamba2``, ``mlstm`` and
``slstm`` and pure-MLP layers (``kind="none"``), with ``mlp="glu"``
(gated or plain), ``"moe"`` or ``"none"``, and post-norms.  Every layer
returns the MoE statistics ``moe_aux_loss`` and ``moe_dropped``
(``ZERO_AUX`` where it has no MoE, or where ``ctx["moe_stats"]`` is
not set: the training forwards set it, serving reads no statistics and
skips their work), and a group sums them over its layers and repeats,
as the JAX scan body carries them.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import attention, mamba2, moe, xlstm
from repro_torch.models.common import (rmsnorm, rmsnorm_init, tree_leaves,
                                       tree_map)
from repro_torch.models.config import (GroupSpec, LayerSpec, ModelConfig,
                                       dtype_of)
from repro_torch.models.mlp import apply_mlp, init_mlp

Params = Any


_MIXER_INIT = {"attn": attention.init_attn, "mla": attention.init_mla,
               "cross_attn": attention.init_cross_attn,
               "mamba2": mamba2.init_mamba2,
               "mlstm": xlstm.init_mlstm, "slstm": xlstm.init_slstm}

# remat="dots": the ops whose outputs the backward keeps (JAX's dots)
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default,
                   torch.ops.aten.baddbmm.default})


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


_REMAT = {
    "full": {},
    "dots": {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _save_dots)},
}
_CACHE_INIT = {"attn": attention.init_attn_cache,
               "mla": attention.init_mla_cache,
               "cross_attn": attention.init_cross_cache,
               "mamba2": mamba2.init_mamba_cache,
               "mlstm": xlstm.init_mlstm_cache,
               "slstm": xlstm.init_slstm_cache}


# a layer's MoE statistics where it has no MoE; apply_layer fills a copy
ZERO_AUX = {"moe_aux_loss": 0.0, "moe_dropped": 0.0}


def _check_supported(spec: LayerSpec) -> None:
    if spec.kind not in (*_MIXER_INIT, "none") or \
            spec.mlp not in ("glu", "moe", "none"):
        raise NotImplementedError(
            f"layer kind={spec.kind!r} mlp={spec.mlp!r}: not ported yet")


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
        if spec.post_norms:
            p["post_norm"] = rmsnorm_init(cfg.d_model, dt, device)
    if spec.mlp != "none":
        p["pre_mlp_norm"] = rmsnorm_init(cfg.d_model, dt, device)
        p["mlp"] = (moe.init_moe(gen, cfg, device) if spec.mlp == "moe"
                    else init_mlp(gen, cfg, device))
        if spec.post_norms:
            p["post_mlp_norm"] = rmsnorm_init(cfg.d_model, dt, device)
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
                ) -> tuple[torch.Tensor, Params | None, dict]:
    """One layer: (x, cache, aux), aux as ``ZERO_AUX`` or the MoE's fp32
    ``moe_aux_loss`` and ``moe_dropped``."""
    _check_supported(spec)
    aux = dict(ZERO_AUX)
    if spec.kind != "none":
        h = rmsnorm(params["pre_norm"], x, eps=cfg.norm_eps)
        if spec.kind == "attn":
            h, cache = attention.apply_attn(
                params["mixer"], cfg, spec, h, ctx["positions"], cache)
        elif spec.kind == "mla":
            h, cache = attention.apply_mla(
                params["mixer"], cfg, spec, h, ctx["positions"], cache,
                absorbed=ctx.get("mla_absorbed", False))
        elif spec.kind == "cross_attn":
            h, cache = attention.apply_cross_attn(
                params["mixer"], cfg, spec, h, ctx.get("image_embeds"), cache)
        elif spec.kind == "mamba2":
            h, cache = mamba2.apply_mamba2(params["mixer"], cfg, spec, h,
                                           cache)
        elif spec.kind == "mlstm":
            h, cache = xlstm.apply_mlstm(params["mixer"], cfg, spec, h,
                                         cache)
        else:
            h, cache = xlstm.apply_slstm(params["mixer"], cfg, spec, h,
                                         cache)
        if spec.post_norms:
            h = rmsnorm(params["post_norm"], h, eps=cfg.norm_eps)
        x = x + h
    if spec.mlp != "none":
        h = rmsnorm(params["pre_mlp_norm"], x, eps=cfg.norm_eps)
        if spec.mlp == "moe":
            stats = ctx.get("moe_stats", False)
            h, moe_aux = moe.apply_moe(params["mlp"], cfg, h, stats=stats)
            if stats:
                aux = {k: moe_aux[k].float() for k in ZERO_AUX}
        else:
            h = apply_mlp(params["mlp"], cfg, h)
        if spec.post_norms:
            h = rmsnorm(params["post_mlp_norm"], h, eps=cfg.norm_eps)
        x = x + h
    return x, cache, aux


# ---------------------------------------------------------------------------
# Groups (loop over repeats)
# ---------------------------------------------------------------------------

def init_group(gen: torch.Generator, cfg: ModelConfig, gspec: GroupSpec,
               device: torch.device) -> Params:
    """Each unshared slot's params stacked over the repeats, drawn repeat
    by repeat and copied into the stack as they come, so the card holds
    the stack and one repeat, not the stack twice (gemma2-27b's two slots
    are 26 GB each in bf16).  A group of one repeat stacks its layer as a
    view, without a copy (deepseek-v3's MoE layer is 45 GB in fp32)."""
    slot_params = []
    for spec in gspec.pattern:
        if spec.shared:
            slot_params.append(init_layer(gen, cfg, spec, device))
            continue
        first = init_layer(gen, cfg, spec, device)
        if gspec.repeat == 1:
            slot_params.append(tree_map(lambda a: a[None], first))
            continue
        stack = tree_map(lambda a: a.new_empty((gspec.repeat, *a.shape)),
                         first)
        tree_map(lambda s, a: s[0].copy_(a), stack, first)
        del first  # before the next repeat is drawn
        for r in range(1, gspec.repeat):
            layer = init_layer(gen, cfg, spec, device)
            tree_map(lambda s, a: s[r].copy_(a), stack, layer)
            del layer
        slot_params.append(stack)
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
                ) -> tuple[torch.Tensor, Params | None, dict]:
    """Run the group's repeats in order: (x, cache, aux), aux summed over
    the group's layers.  ``cache`` (stacked over the repeat axis for every
    slot, shared ones included) is updated in place through per-repeat
    views and returned.

    Each stacked param is unbound into its repeats once, so the backward
    stacks each param's gradient once rather than adding a stack-sized
    zero tensor for every repeat's ``a[r]``."""
    training = cache is None and torch.is_grad_enabled()
    if training and cfg.remat not in ("none", *_REMAT):
        raise ValueError(f"remat={cfg.remat!r}: not one of 'none', 'full', "
                         f"'dots'")
    slots = [p if spec.shared else _unstack(p, gspec.repeat)
             for spec, p in zip(gspec.pattern, params["slots"])]

    def body(x: torch.Tensor, r: int):
        aux = dict(ZERO_AUX)
        for i, spec in enumerate(gspec.pattern):
            p = slots[i] if spec.shared else slots[i][r]
            c = None
            if cache is not None and cache["slots"][i]:
                c = tree_map(lambda a: a[r], cache["slots"][i])
            x, _, la = apply_layer(p, cfg, spec, x, ctx, c)
            aux = {k: aux[k] + la[k] for k in aux}
        return x, aux

    aux = dict(ZERO_AUX)
    for r in range(gspec.repeat):
        if training and cfg.remat in _REMAT:
            x, ra = checkpoint(body, x, r, use_reentrant=False,
                               **_REMAT[cfg.remat])
        else:
            x, ra = body(x, r)
        aux = {k: aux[k] + ra[k] for k in aux}
    return x, cache, aux


def _unstack(tree: Params, n: int) -> list[Params]:
    """The ``n`` per-repeat trees of a tree stacked over its leading axis,
    each leaf unbound once."""
    parts = [a.unbind(0) for a in tree_leaves(tree)]
    out = []
    for r in range(n):
        it = iter([q[r] for q in parts])
        out.append(tree_map(lambda _: next(it), tree))
    return out
