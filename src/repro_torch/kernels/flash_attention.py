"""Wrappers of the CUDA flash-attention kernels: the forward
(``csrc/flash_attention.cu``), optionally with the per-row log-sum-exp,
and the backward (``csrc/flash_attention_bwd.cu``).

Counterpart of :mod:`repro.kernels.flash_attention` (forward); the JAX
package has no backward kernel.  Takes CUDA tensors only;
:mod:`repro_torch.kernels.ops` sends CPU tensors to the plain versions in
:mod:`repro_torch.kernels.ref` and wires both directions into autograd.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

NAME = "flash_attention"
BWD_NAME = "flash_attention_bwd"


def _check(kernel: str, q, k, v, q_offset: int) -> None:
    for arg, t in (("q", q), ("k", k), ("v", v)):
        build.check_operand(kernel, arg, t, 4,
                            None if arg == "q" else q.dtype)
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"{kernel}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if hd not in build.HEAD_DIMS:
        raise ValueError(f"{kernel}: head_dim {hd} not in {build.HEAD_DIMS}")
    if kv == 0 or h % kv:
        raise ValueError(f"{kernel}: {h} query heads over {kv} kv heads")
    if min(b, s, t) == 0 or q_offset < 0:
        raise ValueError(f"{kernel}: empty input or negative q_offset")


def _dtype_code(t: torch.Tensor) -> int:
    return build.DTYPE_CODES[str(t.dtype).removeprefix("torch.")]


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        softcap: float | None = None, scale: float = 1.0,
                        q_offset: int = 0, return_lse: bool = True):
    """q: (B,S,H,hd); k,v: (B,T,KV,hd) -> (out (B,S,H,hd) in q.dtype,
    lse (B,H,S) fp32, or None unless ``return_lse``)."""
    build.check_no_grad(NAME, q, k, v)
    _check(NAME, q, k, v, q_offset)
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if return_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = build.entry(NAME)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), _dtype_code(q),
        b, s, t, h, kv, hd, int(causal), int(window or 0), float(scale),
        float(softcap or 0.0), int(q_offset), stream)
    build.launch_check(NAME, err)
    flash_attention.launches += 1
    return out, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None, scale: float = 1.0,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B,S,H,hd); k,v: (B,T,KV,hd) -> (B,S,H,hd) in q.dtype."""
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               softcap=softcap, scale=scale,
                               q_offset=q_offset, return_lse=False)[0]


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        window: int | None = None,
                        softcap: float | None = None, scale: float = 1.0,
                        q_offset: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) in the dtypes of q, k, v from the forward's
    output ``o``, its log-sum-exp ``lse`` (B,H,S) fp32 and the output
    gradient ``do``.  Query row i sits at position q_offset + i, as in
    the forward."""
    build.check_no_grad(BWD_NAME, q, k, v, o, lse, do)
    _check(BWD_NAME, q, k, v, q_offset)
    for arg, t in (("o", o), ("do", do)):
        build.check_operand(BWD_NAME, arg, t, 4, q.dtype)
        if t.shape != q.shape:
            raise ValueError(f"{BWD_NAME}: {arg} {tuple(t.shape)}, expected "
                             f"{tuple(q.shape)}")
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    build.check_operand(BWD_NAME, "lse", lse, 3, torch.float32)
    if lse.shape != (b, h, s):
        raise ValueError(f"{BWD_NAME}: lse {tuple(lse.shape)}, expected "
                         f"{(b, h, s)}")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    # D = rowsum(dO * O), written by the bf16 path's first kernel
    delta = torch.empty_like(lse) if q.dtype == torch.bfloat16 else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = build.entry(BWD_NAME)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), None if delta is None else delta.data_ptr(),
        _dtype_code(q), b, s, t, h, kv, hd, int(causal),
        int(window or 0), float(scale), float(softcap or 0.0), int(q_offset),
        stream)
    build.launch_check(BWD_NAME, err)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention.launches = 0
flash_attention_bwd.launches = 0
