"""The reference side of a training cell's check: the first steps of
training in fp32, from the benchmark's weights and batches.

The loss is the mean token cross-entropy (log-sum-exp of the fp32 logits
less the label's logit).  Each layer is checkpointed
(``torch.utils.checkpoint``), which changes what is kept, not what is
computed.  The optimizer is AdamW as the configuration's ``optimizer``
block states it: global-norm clipping, linear warm-up then cosine decay,
bias-corrected moments, decoupled weight decay on every leaf.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from perfbench.reference import lm
from perfbench.reference.tree import tree_items, tree_map


def loss(params: dict, m: dict, tokens: torch.Tensor, labels: torch.Tensor,
         ops: lm.Ops, drop_half: bool = False) -> torch.Tensor:
    """Mean cross-entropy; ``drop_half`` leaves out the second half of the
    batch (a fault the check must catch)."""
    if drop_half:
        tokens, labels = tokens[:len(tokens) // 2], labels[:len(labels) // 2]
    x = lm.embed(params, tokens)
    for spec, p in lm.layers(params, m):
        x = checkpoint(lm.layer, p, spec, m, x, ops, use_reentrant=False)
    x = lm.final_norm(params, m, x)
    logits = ops.mm(x, lm.head_matrix(params))
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    return (torch.logsumexp(logits, -1) - gold).mean()


def lr_at(o: dict, step: int) -> float:
    warm = min(step / max(o["warmup"], 1), 1.0)
    t = min(max((step - o["warmup"]) / max(o["decay_steps"] - o["warmup"],
                                           1), 0.0), 1.0)
    cos = o["min_lr_frac"] + (1 - o["min_lr_frac"]) * 0.5 * (
        1 + math.cos(math.pi * t))
    return o["lr"] * warm * cos


def leaf_norms(tree) -> dict:
    return {k: float(v.detach().float().norm()) for k, v in tree_items(tree)}


def run(params: dict, m: dict, o: dict, batches: list, ops: lm.Ops,
        drop_half: bool = False) -> dict:
    """AdamW steps over ``batches`` (each (tokens, labels) on the device)
    from fp32 copies of ``params``: the losses, each leaf's first
    gradient as the optimizer takes it (after the clip), and each leaf's
    change over all the steps."""
    p = tree_map(lambda a: a.detach().float().clone().requires_grad_(True),
                 params)
    leaves = [v for _, v in tree_items(p)]
    mom = [torch.zeros_like(v) for v in leaves]
    var = [torch.zeros_like(v) for v in leaves]
    losses, first = [], None
    for step, (tokens, labels) in enumerate(batches, start=1):
        with torch.enable_grad():
            val = loss(p, m, tokens, labels, ops, drop_half)
            grads = torch.autograd.grad(val, leaves)
        losses.append(float(val.detach()))
        with torch.no_grad():
            norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
            clip = min(1.0, o["grad_clip"] / (float(norm) + 1e-9))
            if first is None:
                first = {k: float(g.norm()) * clip
                         for (k, _), g in zip(tree_items(p), grads)}
            lr = lr_at(o, step)
            bc1, bc2 = 1 - o["b1"] ** step, 1 - o["b2"] ** step
            for w, g, mm, vv in zip(leaves, grads, mom, var):
                g = g * clip
                mm.mul_(o["b1"]).add_((1 - o["b1"]) * g)
                vv.mul_(o["b2"]).add_((1 - o["b2"]) * g.square())
                u = (mm / bc1) / ((vv / bc2).sqrt() + o["eps"])
                w.sub_(lr * (u + o["weight_decay"] * w))
        del grads
    change = {k: float((v.detach() - params_leaf.float()).norm())
              for (k, v), (_, params_leaf) in zip(tree_items(p),
                                                  tree_items(params))}
    return {"losses": losses, "first_grad": first, "change": change}
