"""Mixture-of-Experts FFN: grouped GShard-style top-k capacity dispatch
(counterpart of :mod:`repro.models.moe`).

Grok-1-style softmax top-2 over 8 experts and DeepSeek-V3-style sigmoid
top-8 over 256 routed experts plus shared ones, with aux-loss-free bias
routing.  Tokens are cut into dispatch groups of ``cfg.moe.group_size``
(the whole batch when that does not divide it); each expert takes at most
``cap`` tokens a group, and the tokens' k = 0 choices claim slots before
any k = 1 choice, each in token order.

The JAX version dispatches and combines with one-hot einsums over
(group, token, k, expert, slot); here the same slots are filled and read
with index ops, which copy the same values (a one-hot product adds exact
zeros).  The expert products are plain batched matmuls over all E experts
at their capacity, as in JAX, where they sit outside any Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.kernels import ref as kref
from repro_torch.models.common import ACTIVATIONS, dense_init
from repro_torch.models.config import ModelConfig, dtype_of
from repro_torch.models.mlp import apply_mlp, init_mlp
from repro_torch.parallel.annotate import hint, place

Params = Any


def init_moe(gen: torch.Generator, cfg: ModelConfig,
             device: torch.device) -> Params:
    """Router ``w`` (and ``bias``) in fp32; experts stacked (E, D, F)."""
    dt = dtype_of(cfg)
    m = cfg.moe
    d, e = cfg.d_model, m.num_experts
    f = m.d_expert or cfg.d_ff
    p = {
        "router": {"w": dense_init(gen, d, (e,), torch.float32, device)},
        "experts": {"wi": _stack_init(gen, e, d, f, dt, device),
                    "wu": _stack_init(gen, e, d, f, dt, device),
                    "wo": _stack_init(gen, e, f, d, dt, device)},
    }
    if m.router_bias:
        p["router"]["bias"] = torch.zeros((e,), dtype=torch.float32,
                                          device=device)
    if m.num_shared:
        p["shared"] = init_mlp(gen, cfg, device, d_ff=f * m.num_shared)
    return p


# elements of fp32 draws one _stack_init call holds at once (1 GiB)
_DRAW_ELEMS = 2**28


def _stack_init(gen, e: int, din: int, dout: int, dt,
                device) -> torch.Tensor:
    """``e`` fan-in scaled (din, dout) matrices, drawn a few experts at a
    time into the stack, so that at most ``_DRAW_ELEMS`` are ever held
    in fp32 (deepseek-v3's 256 experts a layer are 15 GB in fp32)."""
    out = torch.empty((e, din, dout), dtype=dt, device=device)
    step = max(1, _DRAW_ELEMS // (din * dout))
    for i in range(0, e, step):
        n = min(step, e - i)
        w = torch.randn((n, din, dout), generator=gen, device=device)
        out[i:i + n] = (w / math.sqrt(max(din, 1))).to(dt)  # dense_init's
    return out


def _group(tokens: torch.Tensor, group_size: int) -> torch.Tensor:
    t = tokens.shape[0]
    sg = group_size if t % group_size == 0 else t
    return tokens.reshape(t // sg, sg, tokens.shape[-1])


def route(params: Params, cfg: ModelConfig, xt: torch.Tensor):
    """The router and the capacity dispatch of grouped tokens xt (G,Sg,D):
    (fp32 logits (G,Sg,E), weights (G,Sg,K) fp32, idx (G,Sg,K), keep
    (G,Sg,K) bool, slot (G,Sg,K), cap).  Choice (s, k) of group g goes to
    slot ``slot[g,s,k]`` of expert ``idx[g,s,k]`` where ``keep``."""
    m = cfg.moe
    g, sg, _ = xt.shape
    e, k = m.num_experts, m.top_k
    cap = min(max(int(sg * k * m.capacity_factor / e), 1), sg)
    # bf16 tokens times the fp32 router promote to fp32, as in JAX
    logits = torch.matmul(xt.float(), params["router"]["w"])
    bias = params["router"].get("bias")
    if bias is not None:
        bias = bias.detach()   # JAX's stop_gradient: selection only
    weights, idx = kref.topk_gating(logits, k, router=m.router, bias=bias)
    # slot of each choice: a running count per expert over the k = 0
    # choices of every token, then the k = 1 choices, ... (in int32)
    onehot = torch.zeros((g, k, sg, e), dtype=torch.int32,
                         device=xt.device).scatter_(
        -1, idx.transpose(1, 2)[..., None], 1)               # (G,K,Sg,E)
    pos = torch.cumsum(onehot.reshape(g, k * sg, e), dim=1,
                       dtype=torch.int32).reshape(g, k, sg, e)
    pos = torch.gather(pos.transpose(1, 2), -1, idx[..., None])[..., 0]
    pos = pos.long() - 1
    keep = pos < cap
    slot = torch.where(keep, pos, 0)
    return logits, weights, idx, keep, slot, cap


def apply_moe(params: Params, cfg: ModelConfig, x: torch.Tensor, *,
              stats: bool = True) -> tuple[torch.Tensor, dict]:
    """x: (B, S, D) -> (y, aux), aux with the Switch load-balance loss
    ``moe_aux_loss``, the experts' share of choices ``moe_load`` (E,) and
    the share of choices dropped for capacity ``moe_dropped``; with
    ``stats=False`` (serving, which reads none of them) aux is empty and
    none of them is computed."""
    m = cfg.moe
    b, s, d = x.shape
    act = ACTIVATIONS[cfg.activation]
    xt = _group(x.reshape(b * s, d), m.group_size)          # (G, Sg, D)
    from torch.distributed.tensor import DTensor
    if isinstance(xt, DTensor):
        y, aux = _apply_moe_sharded(params, cfg, xt, stats=stats)
        return y.reshape(b, s, d), aux
    g, sg, _ = xt.shape
    e, k = m.num_experts, m.top_k
    logits, weights, idx, keep, slot, cap = route(params, cfg, xt)

    # dispatch: xin[g, idx, slot] = token for the kept choices; a dropped
    # choice lands in a spare slot ``cap``, cut off before the experts
    # (index ops of a fixed size: no host sync on a count of kept choices)
    grp = torch.arange(g, device=x.device)[:, None, None]
    xin = xt.new_zeros((g, e, cap + 1, d)).index_put(
        (grp, idx, torch.where(keep, slot, cap)),
        xt[:, :, None, :].expand(g, sg, k, d))[:, :, :cap]
    ex = params["experts"]
    h = act(torch.einsum("gecd,edf->gecf", xin, ex["wi"]))
    h = h * torch.einsum("gecd,edf->gecf", xin, ex["wu"])
    xout = torch.einsum("gecf,efd->gecd", h, ex["wo"])
    # combine: each choice's expert output times its weight (0 where
    # dropped), the weights cast to the compute dtype first as JAX casts
    # its combine tensor
    wk = (weights * keep).to(xt.dtype)                        # (G,Sg,K)
    y = torch.einsum("gskd,gsk->gsd", xout[grp, idx, slot], wk)
    if m.num_shared:
        y = y + apply_mlp(params["shared"], cfg, xt)
    if not stats:
        return y.reshape(b, s, d), {}

    probs = (torch.softmax(logits, dim=-1) if m.router == "softmax"
             else torch.sigmoid(logits))
    frac_tokens = torch.nn.functional.one_hot(idx, e).sum(2).float().mean(
        dim=(0, 1))                                            # (E,)
    frac_prob = probs.mean(dim=(0, 1))
    aux_loss = e * torch.sum(frac_tokens * frac_prob) * m.aux_loss_weight
    # the kept count in the compute dtype, as JAX sums its dispatch tensor
    dropped = 1.0 - keep.to(xt.dtype).sum() / (g * sg * k)
    aux = {"moe_aux_loss": aux_loss, "moe_load": frac_tokens,
           "moe_dropped": dropped}
    return y.reshape(b, s, d), aux


def _apply_moe_sharded(params: Params, cfg: ModelConfig, xt, *,
                       stats: bool):
    """:func:`apply_moe` on DTensors, at JAX's hint sites.  The routing,
    the slot dispatch and the combine are index ops with no DTensor
    sharding rule: they run on each rank's groups through ``local_map``
    (a dispatch group never spans ranks when the groups are sharded as
    the tokens are; a group that spans ranks, as when there are fewer
    groups than ranks, is first gathered whole), and the statistics come back as ``Partial`` sums over
    the ranks' groups.  Between them the expert products run as DTensor
    expert FFN runs on each rank's experts (:func:`_experts_local`), in
    the ``experts`` / ``expert_ffn`` layout of the rules; the hints on
    ``xin`` and ``xout`` move the tokens there and back a mesh dim at a
    time (an all-to-all where the groups and the experts share a mesh
    axis)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    m = cfg.moe
    g, sg, d = xt.shape
    e, k = m.num_experts, m.top_k
    act = ACTIVATIONS[cfg.activation]
    mesh = xt.device_mesh
    # a group split over ranks (fewer groups than ranks) is gathered whole
    gpl = tuple(p if p == Shard(0) else Replicate() for p in xt.placements)
    if tuple(xt.placements) != gpl:
        xt = xt.redistribute(mesh, gpl)
    part = tuple(Partial() if p.is_shard() else Replicate() for p in gpl)
    router = params["router"]
    rkeys = sorted(router)

    def dispatch(xl, *rl):
        rp = {"router": dict(zip(rkeys, rl))}
        logits, weights, idx, keep, slot, cap = route(rp, cfg, xl)
        gl = xl.shape[0]
        grp = torch.arange(gl, device=xl.device)[:, None, None]
        xin = xl.new_zeros((gl, e, cap + 1, d)).index_put(
            (grp, idx, torch.where(keep, slot, cap)),
            xl[:, :, None, :].expand(gl, sg, k, d))[:, :, :cap]
        wk = (weights * keep).to(xl.dtype)
        probs = (torch.softmax(logits, dim=-1) if m.router == "softmax"
                 else torch.sigmoid(logits))
        ft = torch.nn.functional.one_hot(idx, e).sum(2).float().sum((0, 1))
        kept = keep.to(xl.dtype).sum()
        return xin, idx, slot, wk, ft, probs.sum((0, 1)), kept

    xin, idx, slot, wk, ft, fp, kept = local_map(
        dispatch, out_placements=(gpl,) * 4 + (part,) * 3,
        in_placements=(gpl,) + tuple(router[n].placements for n in rkeys),
        in_grad_placements=(gpl,) + (part,) * len(rkeys),
        device_mesh=mesh)(xt, *(router[n] for n in rkeys))
    xin_pl = tuple(xin.placements)
    xin = hint(xin, "moe_groups", "experts", None, None, stepwise=True)
    ex = params["experts"]
    wi = hint(ex["wi"], "experts", "wt_d", "expert_ffn")
    wu = hint(ex["wu"], "experts", "wt_d", "expert_ffn")
    wo = hint(ex["wo"], "experts", "expert_ffn", "wt_d")
    xout = _experts_local(xin, wi, wu, wo, act)
    xout = hint(xout, "moe_groups", "experts", None, None)
    # back to the groups' ranks
    xout = place(xout, xin_pl, stepwise=True, inner_first=True)

    def combine(xo, il, sl, wl):
        grp = torch.arange(xo.shape[0], device=xo.device)[:, None, None]
        return torch.einsum("gskd,gsk->gsd", xo[grp, il, sl], wl)

    y = local_map(combine, out_placements=list(gpl),
                  in_placements=(xin_pl, gpl, gpl, gpl),
                  device_mesh=mesh)(xout, idx, slot, wk)
    y = hint(y, "moe_groups", None, None)
    if m.num_shared:
        y = y + apply_mlp(params["shared"], cfg, xt)
    if not stats:
        return y, {}
    frac_tokens = ft / (g * sg)
    aux_loss = e * torch.sum(frac_tokens * (fp / (g * sg))) \
        * m.aux_loss_weight
    dropped = 1.0 - kept / (g * sg * k)
    return y, {"moe_aux_loss": aux_loss, "moe_load": frac_tokens,
               "moe_dropped": dropped}


def _experts_local(xin, wi, wu, wo, act):
    """The expert FFN on DTensors (G,E,C,D) by (E,D,F), (E,F,D), each
    rank on its own experts, groups and slice of F (``local_map``): per
    mesh dim the tokens' experts shard with the weights' (EP), or their
    groups with the weights replicated (the weights' gradient summed), or
    the weights' F with the tokens replicated (TP: the output a partial
    sum; JAX's hint of h on ``expert_ffn`` is this layout).  DTensor's
    einsum would gather an expert dim that two mesh dims shard (ep2d)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    out, gx, gi, go = [], [], [], []
    for px, pi, po in zip(xin.placements, wi.placements, wo.placements):
        if px == Shard(1) and pi == Shard(0) and po == Shard(0):
            out.append(px), gx.append(px), gi.append(pi), go.append(po)
        elif px == Shard(0) and pi.is_replicate() and po.is_replicate():
            out.append(px), gx.append(px)
            gi.append(Partial()), go.append(Partial())
        elif px.is_replicate() and pi == Shard(2) and po == Shard(1):
            out.append(Partial()), gx.append(Partial())
            gi.append(pi), go.append(po)
        elif px.is_replicate() and pi.is_replicate() and po.is_replicate():
            out.append(px), gx.append(px), gi.append(pi), go.append(po)
        else:
            raise NotImplementedError(
                f"MoE experts on DTensors: tokens placed {xin.placements}, "
                f"weights {wi.placements} / {wo.placements}")

    def experts(xl, il, ul, ol):
        h = act(torch.einsum("gecd,edf->gecf", xl, il))
        h = h * torch.einsum("gecd,edf->gecf", xl, ul)
        return torch.einsum("gecf,efd->gecd", h, ol)

    return local_map(experts, out_placements=out,
                     in_placements=(xin.placements, wi.placements,
                                    wu.placements, wo.placements),
                     in_grad_placements=tuple(map(tuple, (gx, gi, gi, go))),
                     device_mesh=xin.device_mesh)(xin, wi, wu, wo)
