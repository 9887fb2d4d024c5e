"""Wrapper of the CUDA decode-attention kernel (``csrc/decode_attention.cu``).

Counterpart of :mod:`repro.kernels.decode_attention`.  Takes CUDA tensors
only; :mod:`repro_torch.kernels.ops` sends CPU tensors to the plain
version in :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

NAME = "decode_attention"
GROUP_SIZES = (1, 2, 4, 8, 16)  # H/KV values the kernel is instantiated for


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     lengths: torch.Tensor, window: int | None = None,
                     softcap: float | None = None,
                     scale: float = 1.0) -> torch.Tensor:
    """q: (B,1,H,hd); k,v: (B,T,KV,hd); lengths: (B,) int32 -> (B,1,H,hd).
    Serving only: it has no backward, and raises under autograd."""
    build.check_no_grad(NAME, q, k, v)
    for arg, t in (("q", q), ("k", k), ("v", v)):
        build.check_operand(NAME, arg, t, 4, None if arg == "q" else q.dtype)
    build.check_operand(NAME, "lengths", lengths, 1, torch.int32)
    b, one, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    if (one != 1 or k.shape != v.shape or k.shape[0] != b
            or k.shape[3] != hd or lengths.shape[0] != b):
        raise ValueError(f"{NAME}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, lengths "
                         f"{tuple(lengths.shape)} do not match")
    if hd not in build.HEAD_DIMS:
        raise ValueError(f"{NAME}: head_dim {hd} not in {build.HEAD_DIMS}")
    if kv == 0 or h % kv or h // kv not in GROUP_SIZES:
        raise ValueError(f"{NAME}: {h} query heads over {kv} kv heads; "
                         f"group size must be one of {GROUP_SIZES}")
    if b == 0 or t == 0:
        raise ValueError(f"{NAME}: empty input")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = build.entry(NAME)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), build.DTYPE_CODES[str(q.dtype).removeprefix("torch.")],
        b, t, h, kv, hd, int(window or 0), float(scale),
        float(softcap or 0.0), stream)
    build.launch_check(NAME, err)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
