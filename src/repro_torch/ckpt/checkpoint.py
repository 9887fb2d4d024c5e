"""Checkpoints in the on-disk layout of :mod:`repro.ckpt.checkpoint`, with
manifest + async save.

Layout:  <dir>/step_<n>/manifest.json + one .npy per leaf.  Leaves are keyed
by the strings ``jax.tree_util.keystr`` gives their tree paths (e.g.
``['opt']['m']['groups'][0]['slots'][0]['mixer']['wq']``; dict keys in
sorted order, as JAX flattens them) and numbered in sorted key order; the
manifest records shapes, dtypes, the step and ``meta``.  So each package
restores the other's checkpoints.

numpy has no bfloat16 of its own, and the port does not need
``ml_dtypes``: a bf16 leaf is written as numpy writes an
``ml_dtypes.bfloat16`` array (header descr ``'<V2'``, the raw 2-byte
patterns), with ``"dtype": "bfloat16"`` in the manifest, and read back
through a uint16 view.

``AsyncCheckpointer`` copies the tree to host memory synchronously (the
optimizer then updates the device params in place without touching the
copy) and writes it on a background thread; ``wait()`` joins the write.
"""
from __future__ import annotations

import json
import pathlib
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.models.common import tree_paths

BF16_DESCR = "<V2"  # the npy header numpy writes for ml_dtypes.bfloat16


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves replaced, in :func:`tree_paths`
    order, from the iterator ``leaves``."""
    if isinstance(tree, dict):
        new = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _host(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host copy of a tensor and its dtype name; bf16 as its uint16 bit
    patterns."""
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.dtype).removeprefix("torch.")


def _write(path: pathlib.Path, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    arr = np.ascontiguousarray(arr)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": BF16_DESCR, "fortran_order": False,
                "shape": arr.shape})
        f.write(arr.tobytes())


def _read(path: pathlib.Path) -> tuple[np.ndarray, bool]:
    """(array, is_bf16); a bf16 leaf comes back as uint16 bit patterns."""
    arr = np.load(path)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return arr.view(np.uint16), True
    return arr, False


def _to_tensor(arr: np.ndarray, bf16: bool, like: torch.Tensor
               ) -> torch.Tensor:
    if bf16:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device, dtype=like.dtype)


def save(directory: str | pathlib.Path, step: int, tree: Any,
         meta: dict | None = None) -> pathlib.Path:
    """Write ``tree`` (of tensors) as step ``step``."""
    return _save(directory, step,
                 [(k, *_host(leaf)) for k, leaf in tree_paths(tree)], meta)


def _save(directory, step, flat, meta) -> pathlib.Path:
    d = pathlib.Path(directory) / f"step_{step:08d}"
    tmp = d.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "meta": meta or {}, "leaves": {}}
    for i, (key, arr, dtype) in enumerate(sorted(flat, key=lambda e: e[0])):
        fname = f"leaf_{i:05d}.npy"
        _write(tmp / fname, arr, dtype)
        manifest["leaves"][key] = {
            "file": fname, "shape": list(arr.shape), "dtype": dtype}
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if d.exists():
        shutil.rmtree(d)
    tmp.rename(d)  # publish: a partial write never looks valid
    return d


def restore(directory: str | pathlib.Path, tree: Any,
            step: int | None = None) -> tuple[Any, int, dict]:
    """Restore into the structure of ``tree`` (shapes validated); each leaf
    takes the dtype and device of ``tree``'s tensor at its path."""
    d = pathlib.Path(directory)
    if step is None:
        step = latest_step(d)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {d}")
    cdir = d / f"step_{step:08d}"
    manifest = json.loads((cdir / "manifest.json").read_text())
    leaves = []
    for key, leaf in tree_paths(tree):
        ent = manifest["leaves"].get(key)
        if ent is None:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr, bf16 = _read(cdir / ent["file"])
        if list(arr.shape) != list(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {tuple(leaf.shape)}")
        leaves.append(_to_tensor(arr, bf16, leaf))
    return (_unflatten(tree, iter(leaves)), manifest["step"],
            manifest["meta"])


def latest_step(directory: str | pathlib.Path) -> int | None:
    d = pathlib.Path(directory)
    if not d.exists():
        return None
    steps = [int(m.group(1)) for p in d.iterdir()
             if (m := re.fullmatch(r"step_(\d+)", p.name))]
    return max(steps) if steps else None


class AsyncCheckpointer:
    def __init__(self, directory: str | pathlib.Path, keep: int = 3):
        self.directory = pathlib.Path(directory)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.saved: list[int] = []

    def save(self, step: int, tree: Any, meta: dict | None = None) -> None:
        self.wait()
        flat = [(k, *_host(leaf)) for k, leaf in tree_paths(tree)]

        def _write_all():
            _save(self.directory, step, flat, meta)
            self.saved.append(step)
            self._gc()

        self._thread = threading.Thread(target=_write_all, daemon=True)
        self._thread.start()

    def _gc(self) -> None:
        steps = sorted(int(m.group(1)) for p in self.directory.iterdir()
                       if (m := re.fullmatch(r"step_(\d+)", p.name)))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.directory / f"step_{s:08d}",
                          ignore_errors=True)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
