"""The ``glu`` MLP: ``(act(x wi) * (x wu)) wo``; act ``silu`` or
tanh-``gelu``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.lm import Ops

ACT = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh")}


def forward(p: dict, m: dict, x: torch.Tensor, ops: Ops) -> torch.Tensor:
    act = ACT[m["activation"]]
    return ops.mm(act(ops.mm(x, p["wi"])) * ops.mm(x, p["wu"]), p["wo"])
