"""Mamba-2 (SSD) block: fused in-projection, causal depthwise conv, chunked
state-space scan, gated RMSNorm, out-projection (counterpart of
:mod:`repro.models.mamba2`).

A prompt (S > 1, or no cache) runs the SSD through
``ops.mamba_chunk_scan``: the CUDA kernel on the card, the sequential
recurrence on the CPU.  Both take any S, so the chunk padding of the JAX
version is not needed here: the kernel pads its ragged last chunk itself
with the same inert rows (dt = 0, x = 0).  A one-token decode step runs the
recurrence in plain torch, as the JAX version does in jnp.  Caches are
written in place.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import dense_init, rmsnorm, rmsnorm_init
from repro_torch.models.config import ModelConfig, dtype_of
from repro_torch.parallel.annotate import hint

Params = Any


def _dims(cfg: ModelConfig):
    mc = cfg.mamba
    d_inner = mc.expand * cfg.d_model
    nh = d_inner // mc.head_dim
    return d_inner, nh, mc.d_state, mc.d_conv


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, spec,
                device: torch.device) -> Params:
    dt = dtype_of(cfg)
    d_inner, nh, ns, k = _dims(cfg)
    conv_dim = d_inner + 2 * ns
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # fused in-proj -> [z, x, B, C, dt]
        "in_proj": dense_init(gen, cfg.d_model,
                              (2 * d_inner + 2 * ns + nh,), dt, device),
        "conv_w": (torch.randn((k, conv_dim), generator=gen, device=device)
                   * 0.1).to(dt),
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=device),
        "a_log": torch.zeros((nh,), **f32),
        "dt_bias": torch.zeros((nh,), **f32),
        "d_skip": torch.ones((nh,), **f32),
        "norm": rmsnorm_init(d_inner, dt, device),
        "out_proj": dense_init(gen, d_inner, (cfg.d_model,), dt, device),
    }


def init_mamba_cache(cfg: ModelConfig, spec, batch: int, max_len: int,
                     dtype: torch.dtype, device: torch.device) -> Params:
    d_inner, nh, ns, k = _dims(cfg)
    conv_dim = d_inner + 2 * ns
    return {
        "conv": torch.zeros((batch, k - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, nh, cfg.mamba.head_dim, ns),
                           dtype=torch.float32, device=device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d. x: (B,S,C), w: (K,C). Returns (y, new_tail)."""
    k = w.shape[0]
    pad = tail if tail is not None else x.new_zeros(
        (x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([pad.to(x.dtype), x], dim=1)  # (B, S+K-1, C)
    y = sum(xp[:, i:i + x.shape[1]] * w[i][None, None] for i in range(k))
    new_tail = xp[:, -(k - 1):] if k > 1 else pad
    return F.silu(y + b[None, None]), new_tail


def apply_mamba2(params: Params, cfg: ModelConfig, spec, x: torch.Tensor,
                 cache: Params | None = None
                 ) -> tuple[torch.Tensor, Params | None]:
    bsz, s, _ = x.shape
    d_inner, nh, ns, k = _dims(cfg)
    hd = cfg.mamba.head_dim
    proj = x @ params["in_proj"]
    z, xi, bmat, cmat, dtv = torch.split(
        proj, [d_inner, d_inner, ns, ns, nh], dim=-1)
    dtv = F.softplus(dtv.float() + params["dt_bias"][None, None])
    a = -torch.exp(params["a_log"])

    conv_in = torch.cat([xi, bmat, cmat], dim=-1)
    tail = cache["conv"] if cache is not None else None
    conv_out, new_tail = _causal_conv(conv_in, params["conv_w"],
                                      params["conv_b"], tail)
    xi, bmat, cmat = torch.split(conv_out, [d_inner, ns, ns], dim=-1)
    xh = hint(xi.reshape(bsz, s, nh, hd), "batch", "seq", "mamba_heads",
              None)

    if s == 1 and cache is not None:  # decode step
        h = cache["ssm"]
        dt1 = dtv[:, 0]                                   # (B,NH)
        decay = torch.exp(dt1 * a[None])
        dbx = torch.einsum("bh,bn,bhd->bhdn", dt1, bmat[:, 0].float(),
                           xh[:, 0].float())
        h = h * decay[..., None, None] + dbx
        y = torch.einsum("bhdn,bn->bhd", h, cmat[:, 0].float())
        y = y + params["d_skip"][None, :, None] * xh[:, 0].float()
        y = y.reshape(bsz, 1, d_inner)
    else:
        h0 = cache["ssm"] if cache is not None else None
        y, h = ops.mamba_chunk_scan(
            xh.contiguous(), dtv, a, bmat.contiguous(), cmat.contiguous(),
            params["d_skip"], chunk=cfg.mamba.chunk, h0=h0)
        y = y.reshape(bsz, s, d_inner)
    if cache is not None:
        cache["conv"].copy_(new_tail)
        cache["ssm"].copy_(h)

    y = y.to(x.dtype) * F.silu(z)
    # the gated norm reads whole rows of d_inner: a mamba_heads-sharded y
    # is gathered here (XLA all-reduces the rows' sums of squares instead)
    y = rmsnorm(params["norm"], hint(y, "batch", "seq", None),
                eps=cfg.norm_eps)
    return y @ params["out_proj"], cache
