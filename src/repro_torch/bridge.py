"""Move parameter and cache trees between numpy and the port.

The JAX package's params reach the port as a tree (dicts, lists, tuples)
of numpy arrays, e.g. ``jax.tree.map(np.asarray, params)``; the port keeps
the same keys, shapes and tree structure.  numpy has no bfloat16 of its
own: ``np.asarray`` of a bf16 JAX array gives an ``ml_dtypes`` array that
``torch.from_numpy`` rejects, so bf16 leaves travel as their uint16 bit
patterns.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import tree_map


def _to_torch(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy: the port updates caches in place
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def params_from_numpy(tree, device: torch.device | str) -> object:
    """Tree of numpy arrays (bf16 ones from ``ml_dtypes``) -> same tree of
    tensors on ``device``."""
    return tree_map(lambda a: _to_torch(a, device), tree)


def params_to_numpy(tree) -> object:
    """Inverse of :func:`params_from_numpy`.  A bf16 leaf comes back as
    its uint16 bit pattern; ``.view(jnp.bfloat16)`` on the JAX side (or
    ``.view(ml_dtypes.bfloat16)``) restores it exactly."""
    return tree_map(_to_numpy, tree)
