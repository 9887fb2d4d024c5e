"""The benchmark's weights: made on the device from the run's seed, in the
port's param-tree layout and dtypes, one random draw a leaf.

The layout (leaf paths, shapes, dtypes) is the port's
``abstract_params``; the values are drawn here, so the same seed gives
the same weights to the port and to the reference.  Each leaf is drawn
by the rule of its key:

* ``embed``: normal, sd 0.02;
* a norm's ``scale`` (the norm multiplies by 1 + scale): normal, sd 0.02;
* ``conv_w``: normal, sd 0.1; ``conv_b``: normal, sd 0.02;
* ``a_log``: log of uniform [1, 16]; ``dt_bias``: the inverse softplus
  of a step size log-uniform in [1e-3, 1e-1]; ``d_skip``: 1 + normal,
  sd 0.1;
* every other leaf, a matrix (in, out) or a stack of them: normal, sd
  1 / sqrt(in).
"""
from __future__ import annotations

import math

import torch

from perfbench.reference.tree import tree_items


def _draw(key: str, shape, dtype, gen, device) -> torch.Tensor:
    def normal(sd):
        return torch.randn(shape, dtype=dtype, generator=gen,
                           device=device).mul_(sd)

    def uniform(lo, hi):
        return torch.rand(shape, dtype=torch.float32, generator=gen,
                          device=device).mul_(hi - lo).add_(lo)

    if key == "embed":
        return normal(0.02)
    if key == "scale":
        return normal(0.02)
    if key == "conv_w":
        return normal(0.1)
    if key == "conv_b":
        return normal(0.02)
    if key == "a_log":
        return uniform(1.0, 16.0).log_().to(dtype)
    if key == "dt_bias":
        dt = uniform(math.log(1e-3), math.log(1e-1)).exp_()
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    if key == "d_skip":
        return normal(0.1).add_(1.0)
    return normal(1.0 / math.sqrt(shape[-2]))


def make(cfg, seed: int, device) -> dict:
    """The weights of the port's ``ModelConfig`` ``cfg`` for ``seed``."""
    from repro_torch.models import model as model_lib
    layout = model_lib.abstract_params(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    values = {}
    for path, leaf in tree_items(layout):
        values[path] = _draw(path.rsplit("/", 1)[-1], tuple(leaf.shape),
                             leaf.dtype, gen, device)
    return _rebuild(layout, values)


def _rebuild(tree, values: dict, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return values[prefix.rstrip("/")]


def n_params(params: dict) -> int:
    return sum(v.numel() for _, v in tree_items(params))
