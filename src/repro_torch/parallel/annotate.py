"""Logical-axis sharding hints (counterpart of
:mod:`repro.parallel.annotate`).

Model code calls ``hint(x, 'batch', 'seq', 'heads', None)`` at JAX's
sites; inside a ``logical_rules`` context each logical name maps to a mesh
axis (or a tuple of axes, or None) and a DTensor ``x`` is redistributed to
the placements of that spec (JAX's ``with_sharding_constraint``; here the
move is explicit, so a gather or an all-to-all that it needs shows as a
collective), and so is its gradient in the backward, as JAX constrains
the cotangent.  Outside any context, or for a tensor that is not a DTensor,
``hint`` returns ``x`` itself, so single-device runs never see mesh
machinery.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any

import torch

_STATE = threading.local()


def current_rules():
    return getattr(_STATE, "rules", None)


@contextlib.contextmanager
def logical_rules(mesh, rules: dict[str, Any]):
    """Map logical axes to ``mesh`` by ``rules`` inside the block.  The
    block also runs under DTensor's ``implicit_replication``: the plain
    tensors a step makes for itself (positions, rotary tables, masks, the
    embedding scale) act as replicated where they meet DTensors."""
    from torch.distributed.tensor.experimental import implicit_replication
    prev = getattr(_STATE, "rules", None)
    _STATE.rules = (mesh, dict(rules))
    try:
        with implicit_replication():
            yield
    finally:
        _STATE.rules = prev


def logical_spec(mesh, rules: dict[str, Any], shape, axes) -> tuple:
    """The spec of logical ``axes`` for a tensor of ``shape``: an axis an
    earlier dim already uses is dropped, and so is one whose size does not
    divide its dim (JAX's rules for reuse and divisibility)."""
    from repro_torch.parallel.sharding import _spec, mesh_axes
    sizes = mesh_axes(mesh)
    spec = []
    used: set = set()
    for a in axes:
        m = rules.get(a) if a is not None else None
        if m is not None:
            flat = m if isinstance(m, tuple) else (m,)
            if any(f in used for f in flat):
                m = None
            else:
                used.update(flat)
        if m is not None:
            flat = m if isinstance(m, tuple) else (m,)
            size = 1
            for f in flat:
                size *= sizes[f]
            if shape[len(spec)] % size != 0:
                m = None
        spec.append(m)
    return _spec(*spec)


def hint(x, *axes, stepwise: bool = False):
    """Constrain ``x``'s sharding by logical axis names (None = replicated
    on that dim).  ``x`` itself outside a ``logical_rules`` context or
    when it is not a DTensor.  ``stepwise``: see :func:`place`."""
    ctx = current_rules()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from repro_torch.parallel.sharding import to_placements
    mesh, rules = ctx
    placements = to_placements(logical_spec(mesh, rules, x.shape, axes),
                               mesh)
    return place(x, placements, stepwise=stepwise)


def place(x, placements, *, stepwise: bool = False,
          inner_first: bool = False):
    """``x`` redistributed to ``placements``, its gradient too
    (:class:`_Cotangent`).  ``stepwise`` moves one mesh dim at a time, in
    mesh-dim order (``inner_first``: the reverse), so that each step is
    one collective on one mesh dim: a tensor dim that two mesh dims shard
    (ep2d's experts) is reached by an all-to-all on the outer dim and a
    local slice on the inner one, where DTensor's planner gathers the
    whole tensor first."""
    mesh = x.device_mesh
    placements = tuple(placements)
    if tuple(x.placements) != placements:
        if stepwise:
            cur = list(x.placements)
            order = range(len(cur))
            for i in (reversed(order) if inner_first else order):
                if cur[i] != placements[i]:
                    cur[i] = placements[i]
                    x = x.redistribute(mesh, cur)
        else:
            x = x.redistribute(mesh, placements)
    if torch.is_grad_enabled() and x.requires_grad:
        x = _Cotangent.apply(x, placements)
    return x


class _Cotangent(torch.autograd.Function):
    """The identity, whose backward places the gradient as the forward
    value: JAX's sharding constraint binds the cotangent too."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def batch_local(fn, batched, shared=(), n_out: int = 1):
    """``fn(*batched, *shared)`` on each rank's rows of the batch, for an
    op with no DTensor sharding rule that is independent across rows (dim
    0 of every ``batched`` tensor and of every output).  The rows are
    sharded as ``batched[0]``'s dim 0; any other shard of a batched input
    or a ``shared`` one (replicated weights, whose gradient comes back
    summed over the row shards) is gathered first, a collective the
    dry-run records.  ``fn``'s outputs are a flat tuple of ``n_out``
    tensors (or one tensor)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = batched[0].device_mesh
    rows = tuple(Shard(0) if p == Shard(0) else Replicate()
                 for p in batched[0].placements)
    same = tuple(Replicate() for _ in rows)
    part = tuple(Partial() if p.is_shard() else Replicate() for p in rows)

    def placed(t, pls):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, same, run_check=False)
        return t if tuple(t.placements) == pls else t.redistribute(mesh, pls)

    args = [placed(t, rows) for t in batched] + \
        [placed(t, same) for t in shared]
    outs = (list(rows),) if n_out == 1 else (rows,) * n_out
    return local_map(fn, out_placements=outs[0] if n_out == 1 else outs,
                     in_placements=(rows,) * len(batched)
                     + (same,) * len(shared),
                     in_grad_placements=(rows,) * len(batched)
                     + (part,) * len(shared),
                     device_mesh=mesh)(*args)


def local_matmul(x, w):
    """``x @ w`` for DTensors x (..., K) and w (K, N) on each rank's
    shards (``local_map``), where per mesh dim x is sharded on a leading
    dim over a replicated w, or on K against w's K (the output then a
    partial sum), or replicated against w sharded on N.  DTensor's own
    matmul flattens x's leading dims, which PyTorch before 2.13 refuses
    when two of them are sharded (the batch, and the sequence of a
    query-sharded attention's output)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    last = x.ndim - 1
    out, gx, gw = [], [], []
    for px, pw in zip(x.placements, w.placements):
        if px.is_shard() and px.dim < last and pw.is_replicate():
            out.append(px), gx.append(px), gw.append(Partial())
        elif px.is_shard(last) and pw == Shard(0):
            out.append(Partial()), gx.append(px), gw.append(pw)
        elif px.is_replicate() and pw == Shard(1):
            out.append(Shard(last)), gx.append(Partial()), gw.append(pw)
        elif px.is_replicate() and pw.is_replicate():
            out.append(px), gx.append(px), gw.append(pw)
        else:
            return x @ w
    return local_map(torch.matmul, out_placements=out,
                     in_placements=(tuple(x.placements), tuple(w.placements)),
                     in_grad_placements=(tuple(gx), tuple(gw)),
                     device_mesh=x.device_mesh)(x, w)


def make_rules(cfg, mesh, batch: int) -> dict[str, Any]:
    """Default logical->mesh mapping for a model config on a mesh."""
    from repro_torch.parallel.sharding import (batch_axes, mesh_axes,
                                               moe_mode)
    sizes = mesh_axes(mesh)
    tp = sizes.get("model", 1)
    b_axes = batch_axes(mesh, batch)
    rules: dict[str, Any] = {
        "batch": b_axes if b_axes else None,
        # sequence parallelism: shard the residual stream's seq dim over TP
        "seq": "model" if cfg.seq_parallel else None,
        "heads": "model" if cfg.num_heads % tp == 0 else None,
        "kv_heads": "model" if cfg.num_kv_heads % tp == 0 else None,
        # when the head count does not divide TP, shard the query
        # sequence dim instead (a no-op for decode's S=1)
        "attn_seq": "model" if cfg.num_heads % tp != 0 else None,
        "ffn": "model",
        "vocab": "model",
        "embed": None,
        # weight-side logical axes: hints on weights at their use sites act
        # as just-in-time FSDP all-gathers (wt_d strips the 'data' shard)
        "wt_d": None,
        "heads_out": "model" if cfg.num_heads % tp == 0 else None,
        "kv_out": "model" if cfg.num_kv_heads % tp == 0 else None,
    }
    if cfg.moe is not None:
        e = cfg.moe.num_experts
        dp = sizes.get("data", 1)
        mode = moe_mode(cfg, mesh)
        if mode == "ep2d" and e % (tp * dp) == 0 and tp * dp > 1:
            rules["experts"] = ("model", "data")
            rules["expert_ffn"] = None
            rules["moe_groups"] = None
        elif mode in ("ep", "ep_fsdp") and e % tp == 0 and tp > 1:
            # EP over model; expert weights FSDP-gathered over data at use
            rules["experts"] = "model"
            rules["expert_ffn"] = None
            rules["moe_groups"] = b_axes if b_axes else None
        else:
            rules["experts"] = None
            rules["expert_ffn"] = "model"
            rules["moe_groups"] = b_axes if b_axes else None
    if cfg.mamba is not None:
        d_inner = cfg.mamba.expand * cfg.d_model
        nh = d_inner // cfg.mamba.head_dim
        rules["mamba_heads"] = "model" if nh % tp == 0 else None
        rules["d_inner"] = "model" if d_inner % tp == 0 else None
    return rules
