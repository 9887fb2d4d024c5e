"""Production and host meshes (counterpart of :mod:`repro.launch.mesh`).

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with JAX's
axis names.  The production meshes span 256 ranks, (16, 16) over
``("data", "model")``, or 512 ranks, (2, 16, 16) over ``("pod", "data",
"model")``, of a fake process group (backend ``"fake"``): this process is
rank 0 and every collective returns at once, so a step on ``meta`` tensors
can be traced at that scale on one host (:mod:`.dryrun`); both live on
one fake group of 512 ranks, the single-pod mesh on its first 256.  The host mesh
spans the ranks of a live process group (gloo on the CPU, NCCL on the
card).

A process holds one default process group: the fake one is made here on
first use; :func:`release` destroys it.  A live group that is not fake is never
replaced.  Meshes are of device type ``cuda`` unless ``device="cpu"``.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _device_type(device) -> str:
    return "cuda" if device is None else torch.device(device).type


def _fake_group(world_size: int) -> None:
    """A fake default group of ``world_size`` ranks; a live fake group of
    at least as many is kept (a group destroyed under DTensor's caches
    leaves names they can no longer resolve)."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()!r} process group is live; the "
                f"production mesh needs a fake group of {world_size} ranks")
        if dist.get_world_size() >= world_size:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def release() -> None:
    """Destroy the fake process group, if one is live."""
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    _fake_group(512)  # both meshes on one group: ranks 0-255 or 0-511
    return DeviceMesh(_device_type(device),
                      torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=axes)


def make_host_mesh(shape=(1, 1), axes=("data", "model"),
                   device=None) -> DeviceMesh:
    """A mesh of ``shape`` over every rank of the live process group (the
    product of ``shape`` must be its world size)."""
    n = dist.get_world_size()
    if math.prod(shape) != n:
        raise ValueError(f"mesh {tuple(shape)} over a group of {n} ranks")
    return DeviceMesh(_device_type(device),
                      torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))
