"""Op dispatch by the tensor's device; the model code only imports this
module.

A CPU tensor runs the plain PyTorch version (:mod:`.ref`); a CUDA tensor
runs the hand-written kernel, which raises on what it does not take.
There is no switch that routes CUDA tensors to the plain version.

``flash_attention`` and ``rmsnorm`` are differentiable: when autograd
records the call they run as a :class:`torch.autograd.Function` whose
forward and backward each dispatch by device in the same way (the CUDA
backward kernels on the card, ``ref.*_bwd`` on the CPU).  Otherwise (no
grad mode, or no input that requires grad, as on the serving paths) the
forward runs alone and saves nothing: the flash kernel then writes no
log-sum-exp.  ``decode_attention`` and ``mamba_chunk_scan`` have no
backward; their kernels raise under autograd rather than return a
detached result.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels.decode_attention import \
    decode_attention as _decode_kernel
from repro_torch.kernels.mamba_chunk_scan import \
    mamba_chunk_scan as _ssd_kernel


def _records(*tensors) -> bool:
    """Whether autograd records an op on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, q_offset):
        kw = dict(causal=causal, window=window, softcap=softcap,
                  scale=scale, q_offset=q_offset)
        if q.device.type == "cpu":
            o, lse = ref.flash_attention_fwd(q, k, v, **kw)
        else:
            o, lse = _fa.flash_attention_fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = (ref.flash_attention_bwd if q.device.type == "cpu"
               else _fa.flash_attention_bwd)
        dq, dk, dv = bwd(q, k, v, o, lse, do.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None,
                    scale=1.0, q_offset=0):
    if _records(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window, softcap, scale,
                                     q_offset)
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale,
                                   q_offset=q_offset)
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, scale=scale,
                               q_offset=q_offset)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps, zero_centered):
        if x.device.type == "cpu":
            y, rstd = ref.rmsnorm(x, scale, eps=eps,
                                  zero_centered=zero_centered), None
        else:
            y, rstd = _rn.rmsnorm_fwd(x, scale, eps=eps,
                                      zero_centered=zero_centered)
        ctx.save_for_backward(x, scale, rstd)
        ctx.eps, ctx.zero_centered = eps, zero_centered
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, rstd = ctx.saved_tensors
        if x.device.type == "cpu":
            dx, dscale = ref.rmsnorm_bwd(x, scale, g, eps=ctx.eps,
                                         zero_centered=ctx.zero_centered)
        else:
            dx, dscale = _rn.rmsnorm_bwd(x, scale, rstd, g.contiguous(),
                                         zero_centered=ctx.zero_centered)
        return dx, dscale, None, None


def rmsnorm(x, scale, *, eps=1e-6, zero_centered=True):
    """x: (..., d); scale: (d,) -> x's shape and dtype."""
    x = x.contiguous()
    if _records(x, scale):
        return _RMSNorm.apply(x, scale, eps, zero_centered)
    if x.device.type == "cpu":
        return ref.rmsnorm(x, scale, eps=eps, zero_centered=zero_centered)
    return _rn.rmsnorm_fwd(x, scale, eps=eps,
                           zero_centered=zero_centered)[0]


def decode_attention(q, k, v, *, lengths, window=None, softcap=None,
                     scale=1.0):
    if q.device.type == "cpu":
        return ref.decode_attention(q, k, v, lengths=lengths, window=window,
                                    softcap=softcap, scale=scale)
    return _decode_kernel(q, k, v, lengths=lengths, window=window,
                          softcap=softcap, scale=scale)


def mamba_chunk_scan(x, dt, a, b, c, d, *, chunk=256, h0=None):
    if x.device.type == "cpu":
        return ref.mamba_chunk_scan(x, dt, a, b, c, d, chunk=chunk, h0=h0)
    return _ssd_kernel(x, dt, a, b, c, d, chunk=chunk, h0=h0)
