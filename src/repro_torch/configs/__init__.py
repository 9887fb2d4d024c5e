"""Config registry of the port.

Each module exposes ``config()`` (the exact published configuration) and
``smoke_config()`` (a reduced same-family config for CPU tests).  Every
architecture of :mod:`repro.configs` is registered; any other name raises.
"""
from __future__ import annotations

import importlib

ARCHS = ["gemma_7b", "gemma2_27b", "llama3_2_1b", "deepseek_coder_33b",
         "zamba2_2_7b", "grok_1_314b", "deepseek_v3_671b", "xlstm_350m",
         "llama3_2_vision_90b", "musicgen_medium"]

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}
_ALIASES.update({
    "gemma-7b": "gemma_7b",
    "gemma2-27b": "gemma2_27b",
    "llama3.2-1b": "llama3_2_1b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "zamba2-2.7b": "zamba2_2_7b",
    "grok-1-314b": "grok_1_314b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "xlstm-350m": "xlstm_350m",
    "llama-3.2-vision-90b": "llama3_2_vision_90b",
    "musicgen-medium": "musicgen_medium",
})


def canonical(name: str) -> str:
    return _ALIASES.get(name, name)


def get_config(name: str, smoke: bool = False):
    arch = canonical(name)
    if arch not in ARCHS:
        raise NotImplementedError(f"{name}: not ported yet")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.smoke_config() if smoke else mod.config()


def all_arch_names() -> list[str]:
    return list(ARCHS)
