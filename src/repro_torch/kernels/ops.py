"""Op dispatch by the tensor's device; the model code only imports this
module.

A CPU tensor runs the plain PyTorch version (:mod:`.ref`); a CUDA tensor
runs the hand-written kernel, which raises on what it does not take.
There is no switch that routes CUDA tensors to the plain version.
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import \
    decode_attention as _decode_kernel
from repro_torch.kernels.flash_attention import \
    flash_attention as _flash_kernel
from repro_torch.kernels.mamba_chunk_scan import \
    mamba_chunk_scan as _ssd_kernel


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None,
                    scale=1.0, q_offset=0):
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale,
                                   q_offset=q_offset)
    return _flash_kernel(q, k, v, causal=causal, window=window,
                         softcap=softcap, scale=scale, q_offset=q_offset)


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
