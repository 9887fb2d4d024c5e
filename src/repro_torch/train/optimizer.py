"""Optimizers (counterpart of :mod:`repro.train.optimizer`).

Same functional API: ``opt.init(params) -> state``;
``opt.apply(params, grads, state) -> (params, state, metrics)``, with the
state trees of the JAX version (``step`` an int32 scalar), so checkpoints
of the two packages share leaf keys:

* AdamW: ``{"m", "v", "step"}``, fp32 moments shaped as the params;
* Adafactor: ``{"stats", "step"}``; every param of rank >= 2 has factored
  second moments ``{"vr", "vc"}`` over its last two axes (a stacked
  leaf's repeat axis included, so ``wgu`` (R, D, 2, F) keeps ``vr``
  (R, D, 2) and ``vc`` (R, D, F)), every other ``{"v"}``;
* Lion: ``{"m", "step"}``.

Unlike the JAX version, ``apply`` updates the params and the state in
place under ``torch.no_grad()`` and returns the same trees: an H100 step
at full width would otherwise hold a second copy of the params and of the
fp32 state, and the params stay the autograd leaves they were.  The
schedule and bias corrections run as fp32 tensors on the params' device,
as the JAX version computes them, so no step waits for the host.

A leaf is also updated in slices of at most ``SLICE_ELEMS`` elements
(:func:`_slices`), so that the fp32 temporaries of its update are one
slice's: grok-1's expert leaf at one layer is 1.61e9 elements, 6.4 GB a
temporary, and its whole-leaf Adafactor update held ~32 GB at once.  This
is how the port lays out its work on the card, not a change of the
update: AdamW and Lion are elementwise, so any slicing gives the bits of
the whole-leaf update; Adafactor's factored moments are per matrix over
the last two axes, so it slices only the axes before them (a stacked
leaf's repeat or expert axes), and its update clip, the RMS of the update
over the whole leaf, takes a first pass over the slices for the sum of
squares and a second to apply it (equal up to the order of that sum).

Params may be DTensors (a step sharded over a ``DeviceMesh``): the state
then mirrors each param's placements (:meth:`Optimizer.abstract_state`),
with Adafactor's row and column statistics dropping the placement of the
axis they average over, as JAX's state specs drop their trailing entries.
Each gradient is first placed as its param.  AdamW and Lion, elementwise,
then update each rank's local shard (sliced as above); Adafactor runs on
the DTensors, whose means over a sharded axis DTensor reduces.  The
global norm and the clip reduce over every shard.
"""
from __future__ import annotations

import dataclasses
import itertools
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


def _is_dt(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _local(t):
    """A DTensor's local shard (a replicated scalar's value), else t."""
    return t.to_local() if _is_dt(t) else t


def global_norm(tree) -> torch.Tensor:
    """The L2 norm over every leaf; over DTensor leaves each leaf's sum of
    squares is reduced over its shards, and the norm is a plain tensor."""
    leaves = [x.float().square().sum() for x in tree_leaves(tree)]
    leaves = [x.full_tensor() if _is_dt(x) else x for x in leaves]
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

    def abstract_state(self, params, mesh=None) -> Any:
        """The state of ``params`` (``meta`` DTensors in the dry-run):
        each leaf placed as its param, reduced-rank statistics dropping
        the placements of the axes they reduce.  ``mesh`` is JAX's
        argument; a DTensor carries its own."""
        return self.init(params)


# elements of one slice of a leaf's update (:func:`_slices`): 1 GiB for
# each fp32 temporary
SLICE_ELEMS = 1 << 28


def _slices(shape: torch.Size, keep: int) -> list[tuple]:
    """Index tuples that cut a leaf of ``shape`` into slices of at most
    ``SLICE_ELEMS`` elements along its axes before the last ``keep`` (as
    far as those allow: a slice never cuts the last ``keep`` axes).  Each
    tuple indexes the leading axes and ends with a range of rows of the
    axis it cuts, so a slice is a contiguous view; one tuple ``(...,)``
    where the whole leaf fits."""
    n = math.prod(shape)
    if n <= SLICE_ELEMS:
        return [(...,)]
    lead = max(len(shape) - keep, 0)
    # cut axis a - 1 into ranges, a the first axis from which the trailing
    # block fits (at most ``lead``)
    a = next((a for a in range(1, lead + 1)
              if math.prod(shape[a:]) <= SLICE_ELEMS), lead)
    if a == 0:
        return [(...,)]
    rows = max(1, SLICE_ELEMS // math.prod(shape[a:]))
    return [(*outer, slice(r, min(r + rows, shape[a - 1])))
            for outer in itertools.product(*map(range, shape[:a - 1]))
            for r in range(0, shape[a - 1], rows)]


def _device(p) -> torch.device:
    return _local(p).device


def _step0(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    return torch.zeros((), dtype=torch.int32,
                       device=_device(leaves[0]) if leaves else None)


def _zeros(p, shape, drop: int | None = None) -> torch.Tensor:
    """fp32 zeros of ``shape`` on p's device; for a DTensor p, placed as p
    with axis ``drop`` of p (the one a statistic averages over) removed."""
    if not _is_dt(p):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    pls = []
    for pl in p.placements:
        if drop is not None and pl.is_shard():
            d = pl.dim % p.dim()
            pl = (Replicate() if d == drop % p.dim() else
                  Shard(d - 1) if d > drop % p.dim() else pl)
        pls.append(pl)
    local, _ = compute_local_shape_and_global_offset(
        torch.Size(shape), p.device_mesh, pls)
    return DTensor.from_local(
        torch.zeros(local, dtype=torch.float32, device=_device(p)),
        p.device_mesh, pls, run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def _zeros_f32(params):
    return tree_map(lambda p: _zeros(p, p.shape), params)


def _clip_factor(c: OptConfig, grads) -> tuple[torch.Tensor, torch.Tensor]:
    """(the factor that scales ``grads`` to global norm <= grad_clip, the
    norm), as :func:`clip_by_global_norm` applies it; each update scales
    its own leaf, so no clipped copy of the gradients is held."""
    norm = global_norm(grads)
    return torch.clamp(c.grad_clip / (norm + 1e-9), max=1.0), norm


def _placed(g, p):
    """Gradient ``g`` in its param's placements."""
    if _is_dt(p) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _sliced(upd, p, g, *leaves) -> None:
    """An elementwise update ``upd(p, g, *state)`` of one leaf, slice by
    slice (:func:`_slices`, any axis but the last); of a DTensor leaf, on
    its local shard."""
    p, g = _local(p), _local(_placed(g, p))
    leaves = [_local(t) for t in leaves]
    for i in _slices(p.shape, 1):
        upd(p[i], g[i], *(t[i] for t in leaves))


class AdamW(Optimizer):
    def init(self, params):
        return {"m": _zeros_f32(params), "v": _zeros_f32(params),
                "step": _step0(params)}

    @torch.no_grad()
    def apply(self, params, grads, state):
        c = self.cfg
        step = state["step"] + 1
        clip, norm = _clip_factor(c, grads)
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

        tree_map(lambda *t: _sliced(upd, *t), params, grads, state["m"],
                 state["v"])
        state["step"] = step
        return params, state, {"grad_norm": norm, "lr": lr}


class Adafactor(Optimizer):
    """Momentum-free Adafactor with factored second moments for rank >= 2
    (:class:`repro.train.optimizer.Adafactor`): the factors are the row
    and column means over a leaf's last two axes; the update is clipped to
    an RMS of 1 over the whole (stacked) leaf."""

    def init(self, params):
        def stat(p):
            if p.dim() >= 2:
                return {"vr": _zeros(p, p.shape[:-1], drop=-1),
                        "vc": _zeros(p, p.shape[:-2] + p.shape[-1:],
                                     drop=-2)}
            return {"v": _zeros(p, p.shape)}
        return {"stats": tree_map(stat, params), "step": _step0(params)}

    @torch.no_grad()
    def apply(self, params, grads, state):
        c = self.cfg
        step = state["step"] + 1
        clip, norm = _clip_factor(c, grads)
        lr = schedule(c, step)
        decay = 1.0 - (step.float() + 1.0) ** -0.8

        def update(g, s, moments: bool):
            """A slice's update before clipping, from its gradient g and
            stat slices s; ``moments``: first move the moments."""
            g = g.float() * clip
            if "vr" in s:
                vr, vc = s["vr"], s["vc"]
                if moments:
                    g2 = g.square() + 1e-30
                    vr.mul_(decay).add_((1 - decay) * g2.mean(-1))
                    vc.mul_(decay).add_((1 - decay) * g2.mean(-2))
                denom = (vr[..., None] * vc[..., None, :]
                         / (vr.mean(-1, keepdim=True)[..., None] + 1e-30)
                         ).sqrt()
            else:
                if moments:
                    s["v"].mul_(decay).add_((1 - decay) * (g.square() + 1e-30))
                denom = s["v"].sqrt()
            return g / (denom + c.eps)

        def upd(p, g, s):  # s: this leaf's stat dict
            if _is_dt(p):
                return upd_dt(p, _placed(g, p), s)
            cuts = _slices(p.shape, 2 if "vr" in s else 0)
            sq = 0.0
            for i in cuts:  # pass 1: the moments, and the sum of squares
                u = update(g[i], {k: v[i] for k, v in s.items()}, True)
                sq = sq + u.square().sum()
            rms = (sq / p.numel() + 1e-30).sqrt()
            for i in cuts:  # pass 2 (a whole leaf keeps pass 1's update)
                if len(cuts) > 1:
                    u = update(g[i], {k: v[i] for k, v in s.items()}, False)
                u = u / torch.clamp(rms, min=1.0)  # update clip: RMS <= 1
                pf = p[i].float()
                u = u + c.weight_decay * pf
                p[i].copy_(pf - lr * u)

        def upd_dt(p, g, s):
            """A DTensor leaf, whole: its means over a sharded axis are
            reduced by DTensor (plain scalars act as replicated)."""
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                u = update(g, s, True)
                rms = (u.square().sum() / p.numel() + 1e-30).sqrt()
                u = u / torch.clamp(rms, min=1.0)
                pf = p.float()
                p.copy_(pf - lr * (u + c.weight_decay * pf))

        # tree_map follows the params' structure, so each param leaf meets
        # its whole stat dict
        tree_map(upd, params, grads, state["stats"])
        state["step"] = step
        return params, state, {"grad_norm": norm, "lr": lr}


class Lion(Optimizer):
    """Sign updates from an interpolated momentum
    (:class:`repro.train.optimizer.Lion`): the update interpolates with
    ``b1``, the momentum with ``b2``; ``sign(0) = 0``."""

    def init(self, params):
        return {"m": _zeros_f32(params), "step": _step0(params)}

    @torch.no_grad()
    def apply(self, params, grads, state):
        c = self.cfg
        step = state["step"] + 1
        clip, norm = _clip_factor(c, grads)
        lr = schedule(c, step)

        def upd(p, g, m):
            g = g.float() * clip
            u = torch.sign(c.b1 * m + (1 - c.b1) * g)
            pf = p.float()
            u = u + c.weight_decay * pf
            p.copy_(pf - lr * u)
            m.mul_(c.b2).add_((1 - c.b2) * g)

        tree_map(lambda *t: _sliced(upd, *t), params, grads, state["m"])
        state["step"] = step
        return params, state, {"grad_norm": norm, "lr": lr}


def make_optimizer(name: str, **kw) -> Optimizer:
    cfg = OptConfig(name=name, **kw)
    return {"adamw": AdamW, "adafactor": Adafactor, "lion": Lion}[name](cfg)
