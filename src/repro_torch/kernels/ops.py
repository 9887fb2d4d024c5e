"""Op dispatch by the tensor's device; the model code only imports this
module.

A CPU tensor runs the plain PyTorch version (:mod:`.ref`); a CUDA tensor
runs the hand-written kernel, which raises on what it does not take.
There is no switch that routes CUDA tensors to the plain version.

``flash_attention``, ``rmsnorm`` and ``mamba_chunk_scan`` are
differentiable: when autograd records the call they run as a
:class:`torch.autograd.Function` whose forward and backward each dispatch
by device in the same way (the CUDA backward kernels on the card,
``ref.*_bwd`` on the CPU).  Otherwise (no grad mode, or no input that
requires grad, as on the serving paths) the forward runs alone and saves
nothing: the flash kernel then writes no log-sum-exp, and the rmsnorm
kernel no rstd.  ``decode_attention`` has no backward; its kernel raises
under autograd rather than return a detached result, as every kernel
wrapper does when called directly.  ``mlstm`` is the quadratic xLSTM
oracle, which no Pallas kernel computes: plain torch on either device,
as the JAX package's ``ops.mlstm`` is its jnp oracle.

Two more routes sit in front of the device dispatch.  A DTensor input
(a step sharded over a ``DeviceMesh``) goes to :mod:`.sharded`, which runs
the op on each rank's local shard through ``local_map`` (so on the card
the hand-written kernel runs on the shard) or raises where the placements
do not make the op's work local.  Inside :func:`fake_kernels` (the
dry-run) a ``meta`` tensor goes to :mod:`.meta`'s custom ops, whose fakes
give the kernels' output shapes and whose FLOP formulas count the kernels'
work, and reaches no CUDA wrapper; outside it a meta tensor dispatches as
a CUDA one (the tests drive the wrappers, their library mocked, so).
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mamba_chunk_scan as _ssd
from repro_torch.kernels import meta, ref
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import sharded
from repro_torch.kernels.decode_attention import \
    decode_attention as _decode_kernel


_FAKE_META = False


@contextlib.contextmanager
def fake_kernels():
    """Send ``meta`` tensors to the fakes of :mod:`.meta` in this block."""
    global _FAKE_META
    prev, _FAKE_META = _FAKE_META, True
    try:
        yield
    finally:
        _FAKE_META = prev


def _fake(t: torch.Tensor) -> bool:
    return _FAKE_META and t.is_meta


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
        elif _fake(q):
            o, lse = meta.flash_fwd(q, k, v, **kw)
        else:
            o, lse = _fa.flash_attention_fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if _fake(q):
            dq, dk, dv = meta.flash_bwd(q, k, v, o, lse, do, **ctx.kw)
            return dq, dk, dv, None, None, None, None, None
        bwd = (ref.flash_attention_bwd if q.device.type == "cpu"
               else _fa.flash_attention_bwd)
        dq, dk, dv = bwd(q, k, v, o, lse, do.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None,
                    scale=1.0, q_offset=0):
    if sharded.any_dtensor(q, k, v):
        return sharded.flash_attention(
            flash_attention, q, k, v, causal=causal, window=window,
            softcap=softcap, scale=scale, q_offset=q_offset)
    # the kernels take contiguous operands (a fused QKV projection's v is
    # a strided view of the projection's output)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if _records(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window, softcap, scale,
                                     q_offset)
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale,
                                   q_offset=q_offset)
    if _fake(q):
        return meta.flash_fwd(q, k, v, causal=causal, window=window,
                              softcap=softcap, scale=scale,
                              q_offset=q_offset)[0]
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, scale=scale,
                               q_offset=q_offset)


def flash_attention_lse(q, k, v, *, causal=True, window=None, softcap=None,
                        scale=1.0, q_offset=0):
    """The forward alone, with its log-sum-exp: (out (B,S,H,hd), lse
    (B,H,S) fp32), for merging attention over shards of the keys (no
    autograd)."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              q_offset=q_offset)
    if q.device.type == "cpu":
        return ref.flash_attention_fwd(q, k, v, **kw)
    if _fake(q):
        return meta.flash_fwd(q, k, v, **kw)
    return _fa.flash_attention_fwd(q, k, v, **kw)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps, zero_centered):
        if x.device.type == "cpu":
            y, rstd = ref.rmsnorm(x, scale, eps=eps,
                                  zero_centered=zero_centered), None
        elif _fake(x):
            y, rstd = meta.rmsnorm_fwd(x, scale, eps, zero_centered), None
        else:
            y, rstd = _rn.rmsnorm_fwd(x, scale, eps=eps,
                                      zero_centered=zero_centered,
                                      with_rstd=True)
        ctx.save_for_backward(x, scale, rstd)
        ctx.eps, ctx.zero_centered = eps, zero_centered
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, rstd = ctx.saved_tensors
        if x.device.type == "cpu":
            dx, dscale = ref.rmsnorm_bwd(x, scale, g, eps=ctx.eps,
                                         zero_centered=ctx.zero_centered)
        elif _fake(x):
            dx, dscale = meta.rmsnorm_bwd(x, scale, g, ctx.eps,
                                          ctx.zero_centered)
        else:
            dx, dscale = _rn.rmsnorm_bwd(x, scale, rstd, g.contiguous(),
                                         zero_centered=ctx.zero_centered)
        return dx, dscale, None, None


def rmsnorm(x, scale, *, eps=1e-6, zero_centered=True):
    """x: (..., d); scale: (d,) -> x's shape and dtype."""
    if sharded.any_dtensor(x, scale):
        return sharded.rmsnorm(rmsnorm, x, scale, eps=eps,
                               zero_centered=zero_centered)
    x = x.contiguous()
    if _records(x, scale):
        return _RMSNorm.apply(x, scale, eps, zero_centered)
    if x.device.type == "cpu":
        return ref.rmsnorm(x, scale, eps=eps, zero_centered=zero_centered)
    if _fake(x):
        return meta.rmsnorm_fwd(x, scale, eps, zero_centered)
    return _rn.rmsnorm_fwd(x, scale, eps=eps, zero_centered=zero_centered,
                           with_rstd=False)[0]


def decode_attention(q, k, v, *, lengths, window=None, softcap=None,
                     scale=1.0):
    if sharded.any_dtensor(q, k, v):
        return sharded.decode_attention(
            decode_attention, q, k, v, lengths=lengths, window=window,
            softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        return ref.decode_attention(q, k, v, lengths=lengths, window=window,
                                    softcap=softcap, scale=scale)
    if _fake(q):
        return meta.decode(q, k, v, lengths, window, softcap, scale)
    return _decode_kernel(q, k, v, lengths=lengths, window=window,
                          softcap=softcap, scale=scale)


class _MambaChunkScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, a, b, c, d, h0, chunk):
        y, hf = _ssd_fwd(x, dt, a, b, c, d, chunk=chunk, h0=h0)
        ctx.save_for_backward(x, dt, a, b, c, d, h0)
        ctx.set_materialize_grads(False)  # an unused h_final: no zeros
        return y, hf

    @staticmethod
    def backward(ctx, dy, dhf):
        x, dt, a, b, c, d, h0 = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        dhf = None if dhf is None else dhf.contiguous()
        if _fake(x):
            *grads, dh0 = meta.ssd_bwd(x, dt, a, b, c, d, dy, dhf, h0)
            return (*grads, None if h0 is None else dh0, None)
        bwd = (ref.mamba_chunk_scan_bwd if x.device.type == "cpu"
               else _ssd.mamba_chunk_scan_bwd)
        dx, ddt, da, db, dc, dd, dh0 = bwd(x, dt, a, b, c, d, dy, dhf, h0=h0)
        return dx, ddt, da, db, dc, dd, dh0, None


def _ssd_fwd(x, dt, a, b, c, d, *, chunk, h0):
    if x.device.type == "cpu":
        return ref.mamba_chunk_scan(x, dt, a, b, c, d, chunk=chunk, h0=h0)
    if _fake(x):
        return meta.ssd_fwd(x, dt, a, b, c, d, h0, chunk)
    return _ssd.mamba_chunk_scan(x, dt, a, b, c, d, chunk=chunk, h0=h0)


def mamba_chunk_scan(x, dt, a, b, c, d, *, chunk=256, h0=None):
    if sharded.any_dtensor(x, dt, a, b, c, d, h0):
        return sharded.mamba_chunk_scan(mamba_chunk_scan, x, dt, a, b, c, d,
                                        chunk=chunk, h0=h0)
    if _records(x, dt, a, b, c, d, *(() if h0 is None else (h0,))):
        return _MambaChunkScan.apply(x, dt, a, b, c, d, h0, chunk)
    return _ssd_fwd(x, dt, a, b, c, d, chunk=chunk, h0=h0)


def mlstm(q, k, v, i_gate, f_gate, *, eps=1e-6, chunk=256):
    # the chunked mLSTM runs through the model's own path
    # (models/xlstm.py); the quadratic stabilised oracle has no kernel,
    # on the card as on the CPU.  The JAX package's ops.mlstm likewise,
    # with this argument list: ``chunk`` is accepted and unused there too
    return ref.mlstm_chunkwise(q, k, v, i_gate, f_gate, eps=eps)
