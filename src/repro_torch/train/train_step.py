"""Loss and train-step factories (counterpart of
:mod:`repro.train.train_step`): forward + backward + optimizer update, with
optional gradient accumulation over microbatches.

Gradients come from ``torch.autograd.grad`` over the param leaves and are
returned in the params' tree layout, stacked over each group's repeat axis,
as ``jax.value_and_grad`` gives them.  A batch is a dict of tensors on the
params' device.
"""
from __future__ import annotations

import torch

from repro_torch.models import model as model_lib
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import Optimizer


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy.  logits: (B,S,V)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    return (lse - gold).mean()


def make_loss_fn(cfg: ModelConfig):
    def loss_fn(params, batch):
        loss, aux = model_lib.forward_loss(params, cfg, batch["tokens"],
                                           batch["labels"])
        total = loss + aux["moe_aux_loss"]
        metrics = {"loss": loss, "moe_aux_loss": aux["moe_aux_loss"],
                   "moe_dropped": aux["moe_dropped"]}
        return total, metrics
    return loss_fn


def make_grad_fn(cfg: ModelConfig):
    """grad_fn(params, batch) -> ((total, metrics), grads): the port's
    ``jax.value_and_grad(loss_fn, has_aux=True)``; metrics are detached."""
    loss_fn = make_loss_fn(cfg)

    def grad_fn(params, batch):
        with torch.enable_grad():
            total, metrics = loss_fn(params, batch)
            leaves = tree_leaves(params)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = iter(torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves, grads))
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (total.detach(), metrics), tree_map(lambda _: next(grads),
                                                   params)
    return grad_fn


def make_train_step(cfg: ModelConfig, opt: Optimizer, *,
                    grad_accum: int = 1):
    """Returns train_step(params, opt_state, batch) ->
    (params, opt_state, metrics); params and state are updated in place
    (:mod:`.optimizer`)."""
    grad_fn = make_grad_fn(cfg)

    def single(params, opt_state, batch):
        (_, metrics), grads = grad_fn(params, batch)
        params, opt_state, om = opt.apply(params, grads, opt_state)
        metrics.update(om)
        return params, opt_state, metrics

    if grad_accum == 1:
        return single

    def accumulated(params, opt_state, batch):
        def split(x):
            b = x.shape[0]
            return x.reshape(grad_accum, b // grad_accum, *x.shape[1:])
        micro = {k: split(v) for k, v in batch.items()}
        gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
        lsum = 0.0
        for i in range(grad_accum):
            (loss, _), grads = grad_fn(params, {k: v[i] for k, v in
                                                micro.items()})
            tree_map(lambda s, g: s.add_(g), gsum, grads)
            lsum = lsum + loss
        grads = tree_map(lambda g: g / grad_accum, gsum)
        params, opt_state, om = opt.apply(params, grads, opt_state)
        om["loss"] = lsum / grad_accum
        return params, opt_state, om

    return accumulated


def make_eval_step(cfg: ModelConfig):
    loss_fn = make_loss_fn(cfg)

    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = loss_fn(params, batch)
        return metrics
    return eval_step
