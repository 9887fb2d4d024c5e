"""Wrapper of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

Counterpart of :mod:`repro.kernels.flash_attention`.  Takes CUDA tensors
only; :mod:`repro_torch.kernels.ops` sends CPU tensors to the plain
version in :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

NAME = "flash_attention"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None, scale: float = 1.0,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B,S,H,hd); k,v: (B,T,KV,hd) -> (B,S,H,hd) in q.dtype."""
    for arg, t in (("q", q), ("k", k), ("v", v)):
        build.check_operand(NAME, arg, t, 4, None if arg == "q" else q.dtype)
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"{NAME}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if hd not in build.HEAD_DIMS:
        raise ValueError(f"{NAME}: head_dim {hd} not in {build.HEAD_DIMS}")
    if kv == 0 or h % kv:
        raise ValueError(f"{NAME}: {h} query heads over {kv} kv heads")
    if min(b, s, t) == 0 or q_offset < 0:
        raise ValueError(f"{NAME}: empty input or negative q_offset")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = build.entry(NAME)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        build.DTYPE_CODES[str(q.dtype).removeprefix("torch.")],
        b, s, t, h, kv, hd, int(causal), int(window or 0), float(scale),
        float(softcap or 0.0), int(q_offset), stream)
    build.launch_check(NAME, err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
