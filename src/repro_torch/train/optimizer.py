"""Optimizers (counterpart of :mod:`repro.train.optimizer`).

Same functional API: ``opt.init(params) -> state``;
``opt.apply(params, grads, state) -> (params, state, metrics)``, with the
state tree ``{"m", "v", "step"}`` of AdamW (``step`` an int32 scalar), so
checkpoints of the two packages share leaf keys.  Unlike the JAX version,
``apply`` updates ``params``, ``m`` and ``v`` in place under
``torch.no_grad()`` and returns the same trees: an H100 step at full width
would otherwise hold a second copy of the params and of the fp32 moments,
and the params stay the autograd leaves they were.  The schedule and bias
corrections run as fp32 tensors on the params' device, as the JAX version
computes them, so no step waits for the host.

Ported: AdamW.  Not yet: Adafactor and Lion (``make_optimizer`` raises).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models.common import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(c: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``; fp32."""
    step = step.float()
    warm = torch.clamp(step / max(c.warmup, 1), max=1.0)
    t = torch.clamp((step - c.warmup) / max(c.decay_steps - c.warmup, 1),
                    0.0, 1.0)
    cos = c.min_lr_frac + (1 - c.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return c.lr * warm * cos


def global_norm(tree) -> torch.Tensor:
    leaves = [x.float().square().sum() for x in tree_leaves(tree)]
    return torch.stack(leaves).sum().sqrt()


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled to global norm <= max_norm, in fp32; the norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, tree), norm


class Optimizer:
    def __init__(self, cfg: OptConfig):
        self.cfg = cfg

    def init(self, params) -> Any:
        raise NotImplementedError

    def apply(self, params, grads, state) -> tuple[Any, Any, dict]:
        raise NotImplementedError


class AdamW(Optimizer):
    def init(self, params):
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else None
        zeros = lambda: tree_map(  # noqa: E731
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
        return {"m": zeros(), "v": zeros(),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    @torch.no_grad()
    def apply(self, params, grads, state):
        c = self.cfg
        step = state["step"] + 1
        norm = global_norm(grads)
        clip = torch.clamp(c.grad_clip / (norm + 1e-9), max=1.0)
        lr = schedule(c, step)
        bc1 = 1 - c.b1 ** step.float()
        bc2 = 1 - c.b2 ** step.float()

        def upd(p, g, m, v):
            g = g.float() * clip
            m.mul_(c.b1).add_((1 - c.b1) * g)
            v.mul_(c.b2).add_((1 - c.b2) * g.square())
            u = (m / bc1) / ((v / bc2).sqrt() + c.eps)
            pf = p.float()
            u = u + c.weight_decay * pf
            p.copy_(pf - lr * u)

        tree_map(upd, params, grads, state["m"], state["v"])
        state["step"] = step
        return params, state, {"grad_norm": norm, "lr": lr}


def make_optimizer(name: str, **kw) -> Optimizer:
    if name in ("adafactor", "lion"):
        raise NotImplementedError(f"optimizer {name!r}: not ported yet")
    cfg = OptConfig(name=name, **kw)
    return {"adamw": AdamW}[name](cfg)
