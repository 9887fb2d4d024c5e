"""Shared model building blocks: norms, rotary embeddings, initializers.

Parameters are nested dicts of tensors with the keys and shapes of
:mod:`repro.models.common`; every layer is an ``init(gen, cfg, ...)`` plus
an ``apply(params, ...)`` pair.  Initializers draw from an explicit
``torch.Generator`` on the target device.  Compute dtype policy: matmuls
in ``cfg.dtype``, softmax / norm statistics / rotary angles in fp32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

Params = Any  # nested dict tree of tensors


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, in_dim: int, out_shape: Sequence[int],
               dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Fan-in scaled normal init (matches common LM practice)."""
    scale = 1.0 / math.sqrt(max(in_dim, 1))
    w = torch.randn((in_dim, *out_shape), generator=gen, device=device)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    w = torch.randn((vocab, dim), generator=gen, device=device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_init(dim: int, dtype: torch.dtype,
                 device: torch.device) -> Params:
    return {"scale": torch.zeros((dim,), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, *, eps: float = 1e-6,
            zero_centered: bool = True) -> torch.Tensor:
    """RMSNorm with (1 + scale) parameterisation (gemma-style zero-centred).

    The JAX model computes it in jnp; the port routes it through
    ``ops.rmsnorm``: the CUDA kernels (forward and backward) on the card,
    the same arithmetic in plain torch on the CPU."""
    return ops.rmsnorm(x, params["scale"], eps=eps,
                       zero_centered=zero_centered)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim//2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0) -> torch.Tensor:
    """Apply rotary embedding.

    x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq).
    Uses the "rotate half" convention (llama/gemma), in fp32.
    """
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, device=x.device)
    angles = positions[..., None].float() * freqs  # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------

def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over trees of dicts, lists and tuples of the
    same structure as ``tree``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs in JAX's flattening order (dict keys sorted), each
    path as ``jax.tree_util.keystr`` writes it, e.g.
    ``['groups'][0]['slots'][0]['mixer']['wq']``."""
    if isinstance(tree, dict):
        return [e for k in sorted(tree)
                for e in tree_paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [e for i, v in enumerate(tree)
                for e in tree_paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def tree_map_with_path(fn, tree, prefix: str = ""):
    """:func:`tree_map` of one tree whose ``fn(path, leaf)`` also gets the
    leaf's path as :func:`tree_paths` writes it."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in :func:`tree_map` order (dict insertion
    order, not JAX's sorted-key order)."""
    out: list = []
    tree_map(out.append, tree)
    return out


def soft_cap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None or cap <= 0:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class ShapeCase:
    """One assigned input-shape cell (seq_len x global_batch, kind)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPE_CASES = {
    "train_4k": ShapeCase("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCase("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCase("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCase("long_500k", 524288, 1, "decode"),
}


ACTIVATIONS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "relu2": lambda x: F.relu(x).square(),
}
