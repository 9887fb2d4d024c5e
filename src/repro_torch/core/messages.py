"""Dask-style protocol messages (paper §III-B / §IV-B): the part of
:mod:`repro.core.messages` that the thread runtime needs.

The Dask-style :class:`repro_torch.core.reactor.ObjectReactor` round-trips
every message through msgpack at the server boundary, mirroring Dask's
serialize-per-message behaviour.  The RSDS-style ArrayReactor keeps static
in-process structures (the paper's protocol modification keeps message
structure static, so deserialization cost collapses); it skips the codec
entirely.

Not copied: the other message ops, and the wire codecs (``DaskWire``,
``StaticWire``) and frame ops of the process runtime, which the port does
not have yet.
"""
from __future__ import annotations

import msgpack

# message ops (subset of the Dask protocol the paper's RSDS implements)
COMPUTE_TASK = "compute-task"
TASK_FINISHED = "task-finished"


def pack(msg: dict) -> bytes:
    return msgpack.packb(msg, use_bin_type=True)


def unpack(raw: bytes) -> dict:
    return msgpack.unpackb(raw, raw=False)


def compute_task(tid: int, wid: int, inputs, who_has) -> dict:
    return {"op": COMPUTE_TASK, "key": int(tid), "worker": int(wid),
            "inputs": [int(i) for i in inputs],
            "who_has": {int(k): [int(w) for w in v]
                        for k, v in who_has.items()}}


def task_finished(tid: int, wid: int, nbytes: float) -> dict:
    return {"op": TASK_FINISHED, "key": int(tid), "worker": int(wid),
            "nbytes": float(nbytes)}
