"""GQA attention (full / sliding-window / soft-capped).

Three execution modes share one code path, as in
:mod:`repro.models.attention`:
  * train:   full sequence, causal mask, no cache.
  * prefill: full sequence, causal mask, writes the KV cache.
  * decode:  q_len == 1 against a pre-filled cache at ``pos``.

Unlike the JAX version, prefill and decode write the KV cache in place and
return the same cache dict.  ``cfg.fuse_qkv`` keeps one (D, (H + 2 KV) hd)
projection ``wqkv`` in place of ``wq``/``wk``/``wv``, as the JAX version
does.  ``spec.qk_norm`` adds an RMSNorm over head_dim on q and k (leaves
``q_norm``, ``k_norm``) after the projections and before RoPE.  Not
ported yet: MLA and cross-attention.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.models.common import dense_init, rmsnorm, rmsnorm_init
from repro_torch.models.config import LayerSpec, ModelConfig, dtype_of

Params = Any


def init_attn(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
              device: torch.device) -> Params:
    dt = dtype_of(cfg)
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if cfg.fuse_qkv:
        p = {"wqkv": dense_init(gen, d, ((h + 2 * kv) * hd,), dt, device),
             "wo": dense_init(gen, h * hd, (d,), dt, device)}
    else:
        p = {
            "wq": dense_init(gen, d, (h * hd,), dt, device),
            "wk": dense_init(gen, d, (kv * hd,), dt, device),
            "wv": dense_init(gen, d, (kv * hd,), dt, device),
            "wo": dense_init(gen, h * hd, (d,), dt, device),
        }
    if spec.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dt, device)
        p["k_norm"] = rmsnorm_init(hd, dt, device)
    return p


def init_attn_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                    max_len: int, dtype: torch.dtype,
                    device: torch.device) -> Params:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _attn_scale(cfg: ModelConfig) -> float:
    if cfg.attn_scale > 0:
        return cfg.attn_scale
    return 1.0 / math.sqrt(cfg.head_dim)


def apply_attn(params: Params, cfg: ModelConfig, spec: LayerSpec,
               x: torch.Tensor, positions: torch.Tensor,
               cache: Params | None = None
               ) -> tuple[torch.Tensor, Params | None]:
    """x: (B, S, D); positions: (B, S) absolute positions.

    When ``cache`` is given and S > 1 this is prefill (cache written at
    [0, S)); when S == 1 it is a decode step at ``positions[:, 0]``.
    """
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if "wqkv" in params:  # one projection matmul instead of three
        q, k, v = torch.split(x @ params["wqkv"], [h * hd, kv * hd, kv * hd],
                              dim=-1)
    else:
        q, k, v = (x @ params[w] for w in ("wq", "wk", "wv"))
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)
    if spec.qk_norm:
        q = rmsnorm(params["q_norm"], q, eps=cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, eps=cfg.norm_eps)
    q = common.apply_rope(q, positions, theta=cfg.rope_theta)
    k = common.apply_rope(k, positions, theta=cfg.rope_theta)

    scale = _attn_scale(cfg)
    softcap = cfg.attn_softcap or None
    window = spec.window or None

    if cache is None or s > 1:  # train, or prefill
        if cache is not None:
            cache["k"][:, :s].copy_(k)
            cache["v"][:, :s].copy_(v)
        out = ops.flash_attention(q, k, v, causal=True, window=window,
                                  softcap=softcap, scale=scale)
        return out.reshape(b, s, h * hd) @ params["wo"], cache

    # decode: write (k, v) at pos then attend to the whole cache with a
    # validity mask (<= pos, > pos - window).
    pos = positions[:, 0]  # (B,)
    _scatter_time(cache["k"], k[:, 0], pos)
    _scatter_time(cache["v"], v[:, 0], pos)
    out = ops.decode_attention(q, cache["k"], cache["v"],
                               lengths=(pos + 1).to(torch.int32),
                               window=window, softcap=softcap, scale=scale)
    return out.reshape(b, s, h * hd) @ params["wo"], cache


def _scatter_time(buf: torch.Tensor, val: torch.Tensor,
                  pos: torch.Tensor) -> None:
    """buf: (B, S, ...), val: (B, ...), pos: (B,): writes val at pos in
    place (the JAX version returns an updated copy)."""
    b = buf.shape[0]
    buf[torch.arange(b, device=buf.device), pos] = val.to(buf.dtype)
