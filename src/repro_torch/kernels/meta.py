"""The kernels' route for ``meta`` tensors: custom ops with a fake
(shape-only) implementation and a FLOP formula each.

The dry-run (:mod:`repro_torch.launch.dryrun`) runs a whole step on
``meta`` tensors, where no CUDA wrapper can run and the plain versions
would count work the kernels do not do (a causal flash forward's masked
half, the SSD's sequential loop).  :mod:`.ops` sends a meta tensor here:
each op's fake returns outputs of the kernel's shapes and dtypes, and its
formula, registered with :mod:`torch.utils.flop_counter`, counts the work
the kernel does on those shapes:

* flash forward ``4 B H hd P`` and backward ``10 B H hd P``, P the live
  (query, key) pairs under the causal, window and ``q_offset`` masks (two
  products forward; the backward recomputes the scores and makes four);
* decode, with or without its log-sum-exp, ``4 B H hd T`` (on meta the
  cache lengths are unknown: every position counts);
* rmsnorm ``4 N`` forward and ``8 N`` backward, N the elements of x;
* SSD forward ``2 B nc (L^2 NS + L^2 NH HD + 2 L NS NH HD)`` over nc
  chunks of L = ``chunk`` (the C B^T products, the intra-chunk mix and
  the state in and out), and twice that backward.

Each op's body, on a real tensor, runs the plain version, so the ops are
also correct where they are not meant to run.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.library import custom_op
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import ref


def live_pairs(s: int, t: int, *, causal: bool, window: int | None,
               q_offset: int = 0) -> int:
    """(query, key) pairs the masks leave live: query i at position
    ``q_offset + i`` sees key j if j <= it (causal) and within
    ``window``, as ``ref._mask`` rules."""
    pos = np.arange(s, dtype=np.int64) + q_offset
    hi = np.minimum(pos, t - 1) if causal else np.full_like(pos, t - 1)
    lo = np.maximum(0, pos - window + 1) if window else np.zeros_like(pos)
    return int(np.maximum(0, hi - lo + 1).sum())


# --- flash attention -------------------------------------------------------

@custom_op("repro_torch::flash_fwd", mutates_args=())
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, window: int | None, softcap: float | None,
              scale: float, q_offset: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    return ref.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale,
                                   q_offset=q_offset)


@flash_fwd.register_fake
def _(q, k, v, causal, window, softcap, scale, q_offset):
    b, s, h, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, s), dtype=torch.float32)


@custom_op("repro_torch::flash_bwd", mutates_args=())
def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
              causal: bool, window: int | None, softcap: float | None,
              scale: float, q_offset: int
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return ref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                   window=window, softcap=softcap,
                                   scale=scale, q_offset=q_offset)


@flash_bwd.register_fake
def _(q, k, v, o, lse, do, causal, window, softcap, scale, q_offset):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _flash_flops(q_shape, k_shape, causal, window, q_offset, per_pair):
    b, s, h, hd = q_shape
    return per_pair * b * h * hd * live_pairs(
        s, k_shape[1], causal=causal, window=window, q_offset=q_offset)


@register_flop_formula(torch.ops.repro_torch.flash_fwd)
def _(q_shape, k_shape, v_shape, causal, window, softcap, scale, q_offset,
      *args, out_shape=None, **kwargs) -> int:
    return _flash_flops(q_shape, k_shape, causal, window, q_offset, 4)


@register_flop_formula(torch.ops.repro_torch.flash_bwd)
def _(q_shape, k_shape, v_shape, o_shape, lse_shape, do_shape, causal,
      window, softcap, scale, q_offset, *args, out_shape=None,
      **kwargs) -> int:
    return _flash_flops(q_shape, k_shape, causal, window, q_offset, 10)


# --- decode attention ------------------------------------------------------

@custom_op("repro_torch::decode", mutates_args=())
def decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           lengths: torch.Tensor, window: int | None, softcap: float | None,
           scale: float) -> torch.Tensor:
    return ref.decode_attention(q, k, v, lengths=lengths, window=window,
                                softcap=softcap, scale=scale)


@decode.register_fake
def _(q, k, v, lengths, window, softcap, scale):
    return torch.empty_like(q)


def _decode_flops(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    b, _, h, hd = q_shape
    return 4 * b * h * hd * k_shape[1]


register_flop_formula(torch.ops.repro_torch.decode)(_decode_flops)


@custom_op("repro_torch::decode_lse", mutates_args=())
def decode_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lengths: torch.Tensor, window: int | None,
               softcap: float | None, scale: float
               ) -> tuple[torch.Tensor, torch.Tensor]:
    return ref.decode_attention_lse(q, k, v, lengths=lengths, window=window,
                                    softcap=softcap, scale=scale)


@decode_lse.register_fake
def _(q, k, v, lengths, window, softcap, scale):
    b, _, h, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h), dtype=torch.float32)


register_flop_formula(torch.ops.repro_torch.decode_lse)(_decode_flops)


# --- rmsnorm ---------------------------------------------------------------

@custom_op("repro_torch::rmsnorm_fwd", mutates_args=())
def rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor, eps: float,
                zero_centered: bool) -> torch.Tensor:
    return ref.rmsnorm(x, scale, eps=eps, zero_centered=zero_centered)


@rmsnorm_fwd.register_fake
def _(x, scale, eps, zero_centered):
    return torch.empty_like(x)


@custom_op("repro_torch::rmsnorm_bwd", mutates_args=())
def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                eps: float, zero_centered: bool
                ) -> tuple[torch.Tensor, torch.Tensor]:
    return ref.rmsnorm_bwd(x, scale, g, eps=eps, zero_centered=zero_centered)


@rmsnorm_bwd.register_fake
def _(x, scale, g, eps, zero_centered):
    return torch.empty_like(x), torch.empty_like(scale)


@register_flop_formula(torch.ops.repro_torch.rmsnorm_fwd)
def _(x_shape, *args, out_shape=None, **kwargs) -> int:
    return 4 * math.prod(x_shape)


@register_flop_formula(torch.ops.repro_torch.rmsnorm_bwd)
def _(x_shape, *args, out_shape=None, **kwargs) -> int:
    return 8 * math.prod(x_shape)


# --- Mamba-2 SSD -----------------------------------------------------------

@custom_op("repro_torch::ssd_fwd", mutates_args=())
def ssd_fwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
            h0: torch.Tensor | None, chunk: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    return ref.mamba_chunk_scan(x, dt, a, b, c, d, chunk=chunk, h0=h0)


@ssd_fwd.register_fake
def _(x, dt, a, b, c, d, h0, chunk):
    bs, _, nh, hd = x.shape
    return (torch.empty_like(x),
            x.new_empty((bs, nh, hd, b.shape[-1]), dtype=torch.float32))


@custom_op("repro_torch::ssd_bwd", mutates_args=())
def ssd_bwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
            dy: torch.Tensor, dh_final: torch.Tensor | None,
            h0: torch.Tensor | None
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor, torch.Tensor, torch.Tensor]:
    out = ref.mamba_chunk_scan_bwd(x, dt, a, b, c, d, dy, dh_final, h0=h0)
    # no None output: without h0, dh0 is an fp32 scalar ops drops
    return (*out[:6], x.new_zeros((), dtype=torch.float32)
            if out[6] is None else out[6])


@ssd_bwd.register_fake
def _(x, dt, a, b, c, d, dy, dh_final, h0):
    f32 = dict(dtype=torch.float32)
    return (torch.empty_like(x), dt.new_empty(dt.shape, **f32),
            a.new_empty(a.shape, **f32), torch.empty_like(b),
            torch.empty_like(c), d.new_empty(d.shape, **f32),
            h0.new_empty(h0.shape, **f32) if h0 is not None
            else x.new_empty((), **f32))


def _ssd_flops(x_shape, b_shape, chunk: int) -> int:
    bs, s, nh, hd = x_shape
    ns = b_shape[-1]
    el = min(chunk, s)
    nc = -(-s // el)
    return 2 * bs * nc * (el * el * ns + el * el * nh * hd
                          + 2 * el * ns * nh * hd)


@register_flop_formula(torch.ops.repro_torch.ssd_fwd)
def _(x_shape, dt_shape, a_shape, b_shape, *args, out_shape=None,
      **kwargs) -> int:
    chunk = args[-1] if args else kwargs.get("chunk", 256)
    return _ssd_flops(x_shape, b_shape, chunk)


@register_flop_formula(torch.ops.repro_torch.ssd_bwd)
def _(x_shape, dt_shape, a_shape, b_shape, *args, out_shape=None,
      **kwargs) -> int:
    return 2 * _ssd_flops(x_shape, b_shape, SSD_BWD_CHUNK)


# the backward takes no chunk argument (as the kernels' does not): its
# formula counts chunks of this length, the forward's default
SSD_BWD_CHUNK = 256
