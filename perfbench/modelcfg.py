"""A configuration file's ``model`` block as the port's ``ModelConfig``.

The block holds the fields of ``repro_torch.models.config.ModelConfig``:
``groups`` as a list of ``{"pattern": [layer specs], "repeat": n}``, and
``mamba`` as a dict where the model has Mamba-2 layers.  Keys the port's
dataclasses do not know are refused.
"""
from __future__ import annotations

import dataclasses


def build(doc: dict):
    from repro_torch.models.config import (GroupSpec, LayerSpec, MambaConfig,
                                           ModelConfig)
    m = dict(doc["model"])
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = set(m) - known
    if unknown:
        raise ValueError(f"{doc['name']}: model keys {sorted(unknown)} are "
                         f"not ModelConfig fields")
    m["groups"] = tuple(
        GroupSpec(pattern=tuple(LayerSpec(**spec) for spec in g["pattern"]),
                  repeat=g["repeat"]) for g in m["groups"])
    if m.get("mamba") is not None:
        mamba = {k: v for k, v in m["mamba"].items() if k != "ref_chunk"}
        m["mamba"] = MambaConfig(**mamba)
    return ModelConfig(**m)
