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
