"""Device selection: the port runs on the card unless told otherwise."""
from __future__ import annotations

import torch


def default_device() -> torch.device:
    """``cuda`` when a card is present; otherwise raise (never the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain reference path")
    return torch.device("cuda")


def resolve(device: torch.device | str | None) -> torch.device:
    return default_device() if device is None else torch.device(device)
