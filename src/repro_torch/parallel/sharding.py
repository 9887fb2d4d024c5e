"""Sharding rules: parameter / cache / input specs and their DTensors
(counterpart of :mod:`repro.parallel.sharding`).

Policy, as in the JAX package:
  * TP over the ``model`` axis: attention heads, FFN hidden dim, vocab.
  * FSDP over ``data`` for archs flagged ``cfg.fsdp`` (big dense weights get
    their non-TP dim sharded over data; the weight hints gather them).
  * EP: expert dim over ``model`` when divisible; for very large expert
    counts (DeepSeek-V3) over ``(model, data)`` jointly (1 expert/device).
  * DP: batch over ``(pod, data)`` (or whatever prefix divides the batch).
  * KV caches: heads over ``model`` when divisible, otherwise the sequence
    dim, batch over data axes.

A spec is a plain tuple with one entry a tensor dim, each entry equal to
the matching entry of JAX's ``PartitionSpec``: ``None``, an axis name, or
a tuple of names (a one-name tuple is written as the bare name, as
``PartitionSpec`` normalises it).  A mesh is a
:class:`~torch.distributed.device_mesh.DeviceMesh` with named dims, or any
object with JAX's ``axis_names`` and ``shape`` (a dict of sizes).  Paths
are those of :func:`repro_torch.models.common.tree_paths` (``"['groups']
[0]['slots'][0]['mixer']['wq']"``), parsed into JAX's key list.

:func:`to_placements` turns a spec into DTensor placements.  Two mesh
axes on one tensor dim (ep2d's ``("model", "data")``) shard it in mesh-dim
order, data-major, where JAX's order is model-major: every rank holds the
same bytes, but which expert a rank holds differs.
"""
from __future__ import annotations

import re
from typing import Any, NamedTuple

import torch

from repro_torch.models import model as model_lib
from repro_torch.models.common import (SHAPE_CASES, ShapeCase,
                                       tree_map_with_path)
from repro_torch.models.config import ModelConfig, dtype_named

Spec = tuple


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a DeviceMesh or a JAX-style mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: mesh.size(i) for i, n in enumerate(names)}
    return {n: mesh.shape[n] for n in mesh.axis_names}


def _axis_size(mesh, name: str) -> int:
    return mesh_axes(mesh).get(name, 1)


_KEY_RE = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def _path_keys(path) -> list[str]:
    """JAX's key list of a port path: dict keys bare, indices ``"[i]"``."""
    if not isinstance(path, str):
        return list(path)
    return [m.group(1) if m.group(1) is not None else f"[{m.group(2)}]"
            for m in _KEY_RE.finditer(path)]


def _entry(e):
    if isinstance(e, tuple):
        return None if not e else (e[0] if len(e) == 1 else e)
    return e


def _spec(*entries) -> Spec:
    return tuple(_entry(e) for e in entries)


def batch_axes(mesh, batch: int) -> tuple[str, ...]:
    """Longest prefix of (pod, data) whose product divides the batch."""
    axes = [a for a in ("pod", "data") if a in mesh_axes(mesh)]
    chosen: list[str] = []
    size = 1
    for a in sorted(axes, key=lambda a: a != "data"):  # prefer data first
        if batch % (size * _axis_size(mesh, a)) == 0:
            chosen.append(a)
            size *= _axis_size(mesh, a)
    return tuple(chosen)


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def param_spec(cfg: ModelConfig, mesh, path, leaf) -> Spec:
    keys = _path_keys(path)
    name = keys[-1]
    shape = tuple(leaf.shape)
    # stacked slot params carry a leading repeat axis: rules apply to
    # shape[1:], with the repeat dim replicated
    stacked = False
    if len(keys) >= 4 and keys[0] == "groups" and keys[2] == "slots":
        gi = int(keys[1].strip("[]"))
        si = int(keys[3].strip("[]"))
        stacked = not cfg.groups[gi].pattern[si].shared
    if stacked:
        shape = shape[1:]
    entries = tuple(_spec_entries(cfg, mesh, keys, name, shape))
    if stacked:
        entries = (None,) + entries
    return _spec(*entries)


def moe_mode(cfg: ModelConfig, mesh) -> str:
    """``cfg.moe_sharding`` with ``"auto"`` resolved for ``mesh``."""
    e = cfg.moe.num_experts
    tp, dp = _axis_size(mesh, "model"), _axis_size(mesh, "data")
    mode = cfg.moe_sharding
    if mode == "auto":
        if e % (tp * dp) == 0 and tp * dp > 1:
            mode = "ep2d"
        elif e % tp == 0 and tp > 1:
            mode = "ep_fsdp" if cfg.fsdp else "ep"
        else:
            mode = "tp"
    return mode


def _spec_entries(cfg: ModelConfig, mesh, keys, name, shape) -> tuple:
    tp = _axis_size(mesh, "model")
    dp = _axis_size(mesh, "data")
    fsdp = "data" if cfg.fsdp else None

    def ok(dim, ax):  # divisibility check for an axis name
        n = _axis_size(mesh, ax) if ax else 1
        return ax is not None and shape[dim] % n == 0 and n > 1

    # --- embeddings / heads ---
    if name == "embed":
        if cfg.num_codebooks:
            return (None, "model" if ok(1, "model") else None, None)
        return ("model" if ok(0, "model") else None, None)
    if name == "head":
        if cfg.num_codebooks:
            return (None, None, "model" if ok(2, "model") else None)
        return (None, "model" if ok(1, "model") else None)

    # --- MoE experts ---
    if "experts" in keys:
        e = cfg.moe.num_experts
        mode = moe_mode(cfg, mesh)
        if mode == "ep2d" and e % (tp * dp) == 0:     # EP over model+data
            return (("model", "data"), None, None)
        if mode == "ep_fsdp" and e % tp == 0:         # EP(model)+FSDP(data)
            return ("model", "data" if ok(1, "data") else None, None)
        if mode == "ep" and e % tp == 0 and tp > 1:   # EP over model
            return ("model", fsdp if ok(1, fsdp) else None, None)
        # TP inside experts: shard the F dim (dim2 for wi/wu, dim1 for wo)
        if name in ("wi", "wu"):
            return (None, fsdp if ok(1, fsdp) else None,
                    "model" if ok(2, "model") else None)
        return (None, "model" if ok(1, "model") else None,
                fsdp if ok(2, fsdp) else None)
    if "router" in keys:
        return ()

    # --- mamba / xlstm (small models: replicate projections) ---
    if name in ("in_proj", "out_proj", "conv_w", "conv_b", "a_log",
                "dt_bias", "d_skip", "r", "w_gates", "up", "down",
                "up_gate", "w_in"):
        return tuple([None] * len(shape))

    # --- fused projections ---
    if name == "wqkv":
        return (fsdp if ok(0, fsdp) else None,
                "model" if ok(1, "model") else None)
    if name == "wgu":  # (D, 2, F)
        return (fsdp if ok(0, fsdp) else None, None,
                "model" if ok(2, "model") else None)

    # --- attention / MLP 2D weights ---
    if name in ("wq", "wq_b", "wk_b", "wv_b"):
        return (fsdp if ok(0, fsdp) else None,
                "model" if ok(1, "model") else None)
    if name in ("wk", "wv"):
        # shard KV projection over model only if kv heads divide tp
        kv_ok = cfg.num_kv_heads % tp == 0 and tp > 1 and ok(1, "model")
        return (fsdp if ok(0, fsdp) else None, "model" if kv_ok else None)
    if name == "wo":
        return ("model" if ok(0, "model") else None,
                fsdp if ok(1, fsdp) else None)
    if name in ("wi", "wu"):
        return (fsdp if ok(0, fsdp) else None,
                "model" if ok(1, "model") else None)
    if name in ("wq_a", "wkv_a"):
        return (fsdp if ok(0, fsdp) else None, None)

    # norms, gates, scalars
    return tuple([None] * len(shape))


# ---------------------------------------------------------------------------
# Specs -> DTensors
# ---------------------------------------------------------------------------

def to_placements(spec: Spec, mesh) -> tuple:
    """DTensor placements, one a mesh dim, of ``spec``: ``Shard(d)`` on
    every mesh dim that spec entry ``d`` names, ``Replicate()`` on the
    rest."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh_axes(mesh):
        dims = [d for d, e in enumerate(spec) if e is not None
                and name in (e if isinstance(e, tuple) else (e,))]
        assert len(dims) <= 1, (spec, name)
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def local_shape(shape, spec: Spec, mesh) -> tuple[int, ...]:
    """The shape each rank holds of a tensor of ``shape`` under ``spec``
    (every spec here divides its dim evenly)."""
    sizes = mesh_axes(mesh)
    out = list(shape)
    for d, e in enumerate(spec):
        for a in (() if e is None else e if isinstance(e, tuple) else (e,)):
            assert out[d] % sizes[a] == 0, (shape, spec)
            out[d] //= sizes[a]
    return tuple(out)


def abstract_dtensor(shape, dtype: torch.dtype, spec: Spec, mesh):
    """A ``meta`` DTensor of global ``shape`` placed by ``spec``."""
    from torch.distributed.tensor import DTensor
    loc = torch.empty(local_shape(shape, spec, mesh), dtype=dtype,
                      device="meta")
    return DTensor.from_local(loc, mesh, to_placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def distribute(tensor: torch.Tensor, spec: Spec, mesh):
    """A full tensor, the same on every rank, as the DTensor of ``spec``
    (each rank keeps its own shard; no communication)."""
    from torch.distributed.tensor import DTensor, Replicate
    full = DTensor.from_local(tensor, mesh,
                              [Replicate()] * len(mesh_axes(mesh)),
                              run_check=False)
    return full.redistribute(mesh, to_placements(spec, mesh))


def param_shardings(cfg: ModelConfig, mesh) -> Any:
    """The param tree with each leaf's placements (JAX's tree of
    ``NamedSharding``)."""
    return tree_map_with_path(
        lambda p, l: to_placements(param_spec(cfg, mesh, p, l), mesh),
        model_lib.abstract_params(cfg))


def abstract_sharded_params(cfg: ModelConfig, mesh) -> Any:
    """The param tree as ``meta`` DTensors of the param specs."""
    return tree_map_with_path(
        lambda p, l: abstract_dtensor(l.shape, l.dtype,
                                      param_spec(cfg, mesh, p, l), mesh),
        model_lib.abstract_params(cfg))


def shard_params(params, cfg: ModelConfig, mesh) -> Any:
    """Full params, the same on every rank, as DTensors of the param
    specs (leaves stay leaves: ``requires_grad`` is kept)."""
    def one(p, leaf):
        d = distribute(leaf.detach(), param_spec(cfg, mesh, p, leaf), mesh)
        return d.requires_grad_(leaf.requires_grad)
    return tree_map_with_path(one, params)


# ---------------------------------------------------------------------------
# Cache specs
# ---------------------------------------------------------------------------

def cache_spec(cfg: ModelConfig, mesh, batch: int, path, leaf) -> Spec:
    keys = _path_keys(path)
    name = keys[-1]
    tp = _axis_size(mesh, "model")
    b_axes = batch_axes(mesh, batch)
    b = b_axes if b_axes else None
    shape = tuple(leaf.shape)  # leading dims: (repeat, B, ...)

    if name in ("k", "v"):            # (R, B, S, KV, hd) attention cache
        kv = shape[3]
        if kv % tp == 0 and tp > 1:
            return _spec(None, b, None, "model", None)
        if shape[2] % tp == 0 and tp > 1:
            return _spec(None, b, "model", None, None)  # shard sequence
        return _spec(None, b, None, None, None)
    if name == "ckv":                 # (R, B, S, r) MLA latent
        if shape[3] % tp == 0 and tp > 1:
            return _spec(None, b, None, "model")
        return _spec(None, b, None, None)
    if name == "krope":
        return _spec(None, b, None, None)
    if name == "ssm":                 # (R, B, NH, HD, NS)
        if shape[2] % tp == 0 and tp > 1:
            return _spec(None, b, "model", None, None)
        return _spec(None, b, None, None, None)
    if name == "conv":                # (R, B, K-1, conv_dim)
        return _spec(None, b, None, "model" if shape[3] % tp == 0 and tp > 1
                     else None)
    if name in ("c", "n", "h", "m"):  # xLSTM states (R, B, NH, ...)
        return _spec(None, b, *([None] * (len(shape) - 2)))
    if name == "filled":
        return _spec(*([None] * len(shape)))
    return _spec(None, b, *([None] * (len(shape) - 2)))


def cache_shardings(cfg: ModelConfig, mesh, batch: int,
                    max_len: int) -> Any:
    """The cache tree as ``meta`` DTensors of the cache specs."""
    return tree_map_with_path(
        lambda p, l: abstract_dtensor(
            l.shape, l.dtype, cache_spec(cfg, mesh, batch, p, l), mesh),
        model_lib.abstract_cache(cfg, batch, max_len))


def shard_cache(cache, cfg: ModelConfig, mesh, batch: int) -> Any:
    """A full cache, the same on every rank, as DTensors of the specs."""
    return tree_map_with_path(
        lambda p, l: distribute(l, cache_spec(cfg, mesh, batch, p, l), mesh),
        cache)


# ---------------------------------------------------------------------------
# Input specs (the assigned shape cells)
# ---------------------------------------------------------------------------

class InputSpec(NamedTuple):
    shape: tuple
    dtype: torch.dtype
    spec: Spec


def input_specs(cfg: ModelConfig, case: ShapeCase | str, mesh) -> dict:
    """Shape, dtype and spec of every model input of a shape cell (JAX's
    ``ShapeDtypeStruct`` stand-ins)."""
    if isinstance(case, str):
        case = SHAPE_CASES[case]
    b, s = case.global_batch, case.seq_len
    b_axes = batch_axes(mesh, b) or None
    seq_axes = None
    if b_axes is None and s % _axis_size(mesh, "data") == 0:
        seq_axes = "data"  # long-context batch=1: shard sequence

    def tok(shape):
        return InputSpec(shape, torch.int32,
                         _spec(b_axes, *([seq_axes]
                                         + [None] * (len(shape) - 2))))

    out: dict = {}
    tok_shape = ((b, s, cfg.num_codebooks) if cfg.num_codebooks else (b, s))
    if case.kind == "train":
        out["tokens"] = tok(tok_shape)
        out["labels"] = tok(tok_shape)
    elif case.kind == "prefill":
        out["tokens"] = tok(tok_shape)
    else:  # decode: one new token against a seq_len cache
        one = ((b, 1, cfg.num_codebooks) if cfg.num_codebooks else (b, 1))
        out["tokens"] = InputSpec(one, torch.int32,
                                  _spec(b_axes, *([None] * (len(one) - 1))))
        out["pos"] = InputSpec((b,), torch.int32, _spec(b_axes))
    if cfg.vision_dim and case.kind != "decode":
        out["image_embeds"] = InputSpec(
            (b, cfg.num_image_tokens, cfg.vision_dim),
            dtype_named(cfg.dtype), _spec(b_axes, None, None))
    return out


def abstract_inputs(cfg: ModelConfig, case: ShapeCase | str, mesh) -> dict:
    """The inputs of :func:`input_specs` as ``meta`` DTensors."""
    return {k: abstract_dtensor(i.shape, i.dtype, i.spec, mesh)
            for k, i in input_specs(cfg, case, mesh).items()}

